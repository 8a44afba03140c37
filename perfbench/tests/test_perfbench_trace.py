"""Reading a profiled slice: busy time is the union of the device's
operations, a kernel wrapper's device time is what was launched inside its
range, idle gaps go to the innermost host range open at their middle, and
a device clock on another base is moved onto the host's."""

import pytest

from perfbench.trace import summarize


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, ann=False):
        self._v = (name, dev, start, dur, corr, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self._v[5]


def _events(shift=0):
    return [Ev("decode_step", "CPU", 0, 1000, 90, ann=True),
            Ev("perfbench.moe_gmm", "CPU", 100, 100, 91, ann=True),
            Ev("cudaLaunchKernel", "CPU", 150, 10, 5),
            Ev("mma_kernel", "CUDA", 300 + shift, 100, 5),
            Ev("cudaLaunchKernel", "CPU", 420, 10, 6),
            Ev("gemm", "CUDA", 450 + shift, 200, 6),
            Ev("cudaLaunchKernel", "CPU", 430, 10, 7),
            Ev("elementwise", "CUDA", 600 + shift, 100, 7),
            # the device's mirror of a host range is no operation
            Ev("decode_step", "CUDA", 0 + shift, 1000, 0),
            Ev("wait", "CPU", 1200, 700, 92, ann=True)]


@pytest.mark.parametrize("shift", [0, -10**12, 10**12])
def test_summarize_a_slice(shift):
    got = summarize(_events(shift), 0, 2000, ("perfbench.moe_gmm",))
    assert got["busy_s"] == pytest.approx(350e-9)     # 300-400, 450-700
    assert got["window_s"] == pytest.approx(2000e-9)
    rng = got["by_range"]["perfbench.moe_gmm"]
    assert rng["ops"] == 1 and rng["seconds"] == pytest.approx(100e-9)
    assert dict(got["device_ops"])["gemm"] == pytest.approx(200e-9)
    # moved by the least launch-to-start delay (the gemm's, 30 ns)
    assert got["diag"]["clock_shift_ns"] == (0 if shift == 0
                                             else shift + 30)


def test_idle_gaps_by_host_range():
    gaps = dict(summarize(_events(), 0, 2000,
                          ("perfbench.moe_gmm",))["idle_gaps"])
    # 0-300, 400-450, 700-1000 in decode_step (the kernel wrapper's range
    # is not a host activity); 1200-1900 in wait; 1000-1200 and 1900-2000
    # in no range
    assert gaps["decode_step"] == pytest.approx(650e-9)
    assert gaps["wait"] == pytest.approx(700e-9)
    assert gaps["no host range"] == pytest.approx(300e-9)
