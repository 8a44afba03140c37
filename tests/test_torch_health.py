"""The port's NaN guard on bf16 outputs (port-only, on the CPU).

The reference's guard screens a leaf only when ``np.asarray(leaf).dtype
.kind == "f"`` (``src/repro/serving/health.py:151-152``); a bf16 JAX array
becomes ml_dtypes ``bfloat16``, whose kind is ``"V"``, so a NaN in a bf16
output passes it unflagged. The port screens every floating tensor
(``is_floating_point``), bf16 included, which the bf16 serving path on the
card relies on. So the two packages are compared on NaN detection in fp32
only (``test_torch_faults.py``), and this file states the bf16 behaviour
of the port alone.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import serving as tserving  # noqa: E402


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")],
                         ids=["nan", "inf", "-inf"])
def test_non_finite_bf16_leaf_is_flagged(bad):
    mon = tserving.HealthMonitor()
    clean = {"logits": torch.ones(2, 3, dtype=torch.bfloat16),
             "len": torch.tensor([4])}
    assert mon.observe_output(clean, 0)
    poisoned = {"logits": torch.tensor([[1.0, bad]], dtype=torch.bfloat16),
                "len": torch.tensor([5])}
    assert not mon.observe_output(poisoned, 1)
    assert not mon.observe_output(poisoned, 1)          # one event a step
    events = mon.drain()
    assert [(e.kind, e.step) for e in events] == [("nan", 1)]
