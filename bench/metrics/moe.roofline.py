"""moe.roofline: the least time of every MoE channel call in the traced
window (the larger of its active-expert operations at the bf16 peak and
every expert's weights read once at HBM's rate) over the device time of
the kernels launched inside the wrapped ``moe_ffn``, in %."""
from benchkit import counts, peaks
from benchkit.trace import span_name

TARGET = "repro_torch.models.transformer.moe_ffn"
WRAPS = [TARGET]


def read(run):
    device_s = run.summary.span_device_s.get(span_name(TARGET), 0.0) if run.summary else 0.0
    calls = run.calls.by_target.get(TARGET, [])
    if not device_s or not calls:
        return None
    least = 0.0
    for args in calls:
        B, S, _ = args[1][0]
        least += peaks.least_seconds(counts.moe_flops(B * S, run.sizes),
                                     counts.moe_bytes(B * S, run.sizes))
    return 100.0 * least / device_s
