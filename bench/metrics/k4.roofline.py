"""k4.roofline: K4 and the SSD scan around it. The least time of every
``ssd_op`` call in the traced window (the larger of the chunked SSD's
operations at the bf16 peak and its inputs read and outputs written once
at HBM's rate) over the device time of the kernels launched inside the
wrapped ``ssd_op``, in %."""
from benchkit import counts, peaks
from benchkit.trace import span_name

TARGET = "repro_torch.models.ssm.ssd_op"
WRAPS = [TARGET]


def read(run):
    device_s = run.summary.span_device_s.get(span_name(TARGET), 0.0) if run.summary else 0.0
    calls = run.calls.by_target.get(TARGET, [])
    if not device_s or not calls:
        return None
    least = 0.0
    chunk = int(run.sizes["ssm_chunk"])
    for args in calls:
        (b, l, h, p), dt = args[0]
        (_, _, g, n), _ = args[2]
        item = 4 if dt == "float32" else 2
        least += peaks.least_seconds(counts.ssd_flops(b, l, h, p, g, n, chunk),
                                     counts.ssd_bytes(b, l, h, p, g, n, item))
    return 100.0 * least / device_s
