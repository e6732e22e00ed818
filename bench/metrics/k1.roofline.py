"""k1.roofline: K1, the reassembly of a wake's chunks. Each call's slab
read once and its output written once at HBM's rate, over the device time
of the kernels launched inside the wrapped ``relay_assemble``, in %."""
from benchkit import peaks
from benchkit.trace import span_name

TARGET = "repro_torch.core.torch_backend.relay_assemble"
WRAPS = [TARGET]
ITEM = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1, "uint8": 1}


def read(run):
    device_s = run.summary.span_device_s.get(span_name(TARGET), 0.0) if run.summary else 0.0
    calls = run.calls.by_target.get(TARGET, [])
    if not device_s or not calls:
        return None
    nbytes = 0
    for args in calls:
        (rows, cols), dt = args[0]
        nbytes += 2 * rows * cols * ITEM[dt]
    return 100.0 * peaks.least_seconds(0.0, nbytes) / device_s
