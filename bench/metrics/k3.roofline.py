"""k3.roofline: K3, causal prefill attention. The least time of every call
in the traced window (the larger of its operations over the kept (query,
key) pairs at the bf16 peak and q, k, v read and o written once at HBM's
rate) over the device time of the kernels launched inside the wrapped
``flash_attention_op``, in %."""
from benchkit import counts, peaks
from benchkit.trace import span_name

TARGET = "repro_torch.models.attention.flash_attention_op"
WRAPS = [TARGET]
ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run):
    device_s = run.summary.span_device_s.get(span_name(TARGET), 0.0) if run.summary else 0.0
    calls = run.calls.by_target.get(TARGET, [])
    if not device_s or not calls:
        return None
    least = 0.0
    for args in calls:
        (B, S, H, D), dt = args[0]
        (_, T, G, _), _ = args[1]
        nbytes = ITEM[dt] * (2 * B * S * H * D + 2 * B * T * G * D)
        least += peaks.least_seconds(counts.attention_flops(B, H, S, T, D), nbytes)
    return 100.0 * least / device_s
