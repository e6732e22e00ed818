"""The traced window's reduction on hand-made events: busy time is the
union of kernels and copies (annotations are not work), a wrapper's
device time is the kernels inside its device range, H2D copy time is
taken inside the host spans, and idle gaps are named by the host span
they fall in."""
from torch.autograd import DeviceType

from benchkit.trace import reduce_events, span_name


class Ev:
    def __init__(self, name, start, dur, cpu=False, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._cpu, self._a = cpu, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def is_user_annotation(self):
        return self._a


def test_reduce_events():
    w = span_name("m.f")
    ev = [
        Ev("bench.window", 0, 1000, cpu=True),
        Ev("bench.wake", 100, 400, cpu=True),          # host span 100..500
        Ev("bench.prefill", 600, 300, cpu=True),
        Ev(w, 650, 100, cpu=True),
        Ev(w, 700, 200, annotation=True),              # its device range 700..900
        Ev("Memcpy HtoD (Pinned -> Device)", 150, 200),
        Ev("k_a", 700, 50),
        Ev("k_b", 800, 100),
        Ev("k_c", 950, 30),                            # outside the wrapper
        Ev("bench.prefill", 600, 380, annotation=True),
    ]
    s = reduce_events(ev)
    assert s.window_s == 1000 / 1e9
    assert s.busy_s == (200 + 50 + 100 + 30) / 1e9
    assert s.span_device_s[w] == 150 / 1e9
    assert s.span_h2d_s["bench.wake"] == 200 / 1e9 and s.span_s["bench.wake"] == 400 / 1e9
    assert "bench.prefill" not in s.device_ops and s.device_ops["k_b"] == 100 / 1e9
    assert s.idle_by_host["bench.wake"] == (50 + 150) / 1e9     # 100..150 and 350..500
    assert s.idle_by_host["bench.host"] == (100 + 100 + 50 + 20) / 1e9   # ..100, 500..600, 900..950, 980..
    assert s.idle_by_host["bench.prefill"] == (100 + 50) / 1e9       # 600..700, 750..800
    assert s.breakdown()["device_ops"][0][0] == "Memcpy HtoD (Pinned -> Device)"
