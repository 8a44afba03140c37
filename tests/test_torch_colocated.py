"""The port's dual-model colocated engines and expert re-seating against
the JAX reference, on the CPU.

Reduced phi3.5-MoE (2 layers, d 256, 4 experts, fp32); every tenant's
weights are made by the JAX package and carried across by
``repro_torch.bridge``. Greedy token streams must be identical to the JAX
engines', re-plan events equal, and re-seated params bit-equal. The port
re-seats params in place, so every port engine gets fresh tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_colocation import (ARCH, JAX, N_E, PAIR0, PORT,  # noqa: E402
                               colocated_run, events, leaves_equal)
from _torch_colocation import weights  # noqa: E402,F401 (fixture)
from repro import serving as jserving  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402


# -- placement --------------------------------------------------------------

def test_apply_and_reseat_pairing_bit_equal(weights):
    """``apply_pairing`` equals the reference's; the in-place composed
    ``reseat_pairing`` equals its undo-then-apply, bit for bit, moves no
    other leaf, and round-trips back to the logical params."""
    cfg = JAX.cfg
    pj = JAX.params(weights[1])
    leaves_equal(tserving.apply_pairing(PORT.params(weights[1]), PAIR0, cfg),
                  jserving.apply_pairing(pj, PAIR0, cfg))
    new = [1, 3, 0, 2]
    want = jserving.reseat_pairing(jserving.apply_pairing(pj, PAIR0, cfg),
                                   PAIR0, new, cfg)
    pt = PORT.params(weights[1])
    embed = pt["embed"].data_ptr()
    assert tserving.reseat_pairing(pt, list(range(N_E)), PAIR0, cfg) is pt
    got = tserving.reseat_pairing(pt, PAIR0, new, cfg)
    assert got is pt and pt["embed"].data_ptr() == embed
    leaves_equal(got, want)
    tserving.reseat_pairing(pt, new, list(range(N_E)), cfg)
    leaves_equal(pt, pj)
    assert tserving.inverse_pair(PAIR0) == jserving.inverse_pair(PAIR0)
    with pytest.raises(tserving.PlanError, match="permutation"):
        tserving.reseat_pairing(pt, [0, 0, 1, 2], new, cfg)


# -- dual-model continuous engine --------------------------------------------

@pytest.mark.parametrize("replan", [False, True], ids=["static", "replan"])
@pytest.mark.parametrize("chunked", [False, True], ids=["one_shot", "chunk4"])
def test_colocated_streams_equal_jax(weights, chunked, replan):
    eng_j, want = colocated_run(JAX, weights, chunked, replan)
    eng_t, got = colocated_run(PORT, weights, chunked, replan)
    assert got == want
    assert eng_t.decode_steps == eng_j.decode_steps
    assert events(eng_t) == events(eng_j)
    assert eng_t.pair == list(eng_j.pair)
    if replan:
        applied = [e for e in eng_t.replan_events if e.applied]
        assert applied and eng_t.pair == applied[-1].pair
        assert eng_t.monitor_b.slot_to_expert == eng_t.pair
        leaves_equal(eng_t.pool_b.params, eng_j.pool_b.params)


def test_colocated_static_engine_equals_jax(weights):
    """``ColocatedEngine``: two static batches decoded in lockstep."""
    pa = np.random.default_rng(0).integers(1, 500, (2, 6))
    pb = np.random.default_rng(1).integers(1, 500, (2, 6))
    outs = []
    for s in (JAX, PORT):
        eng = s.m.ColocatedEngine(s.model(), s.model(), s.params(weights[0]),
                                  s.params(weights[1]))
        outs.append([np.asarray(o).tolist()
                     for o in eng.serve(pa, pb, max_new_tokens=4,
                                        cache_cap=16)])
    assert outs[1] == outs[0]


def test_launch_colocated_replan_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--colocate-with", ARCH, "--kernels",
                       "--num-requests", "3", "--batch", "2",
                       "--cache-cap", "32", "--max-new-tokens", "4",
                       "--arrival-rate", "0.5",
                       "--prefill-chunk", "4", "--replan-interval", "2",
                       "--replan-threshold", "-1"]) == 0
    out = capsys.readouterr().out
    assert "aurora colocation pairing" in out
    assert "lockstep decode steps" in out and "replan @ step 2" in out
    with pytest.raises(KeyError):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--colocate-with", "mamba3-unknown"])
    # An SSM tenant colocates (no pairing: it has no experts); the
    # encoder-decoder does not, as its engines pass no frames.
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--colocate-with", "mamba2-1.3b", "--kernels",
                       "--num-requests", "2", "--batch", "2",
                       "--cache-cap", "32", "--max-new-tokens", "3",
                       "--arrival-rate", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "lockstep decode steps" in out
    assert "aurora colocation pairing" not in out
    with pytest.raises(ValueError, match="no frames"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--colocate-with", "seamless-m4t-large-v2"])
