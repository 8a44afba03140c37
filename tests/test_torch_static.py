"""The port's static engines, and the dense families in every engine,
against the JAX reference on the CPU.

The four reduced dense archs (phi4-mini, gemma-7b, qwen3-32b, gemma3-27b
with a sliding window of 16) through ``ServingEngine`` and
``ContinuousEngine``, kernel path and plain; reduced phi3.5-MoE beside
reduced phi4-mini in ``ColocatedEngine`` and ``ColocatedContinuousEngine``;
and the launcher's static and dense-colocation paths. Weights come from the
JAX package through ``repro_torch.bridge``; request streams from numpy
seeds. Greedy token streams must be identical.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "gemma-7b", "qwen3-32b", "gemma3-27b"]
MOE = "phi3.5-moe-42b-a6.6b"


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=0):
    """JAX params of the reduced config as numpy leaves, made once."""
    cfg = jax_get_config(arch).reduced()
    params = jax.jit(JaxModel(cfg).init)(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _jax(arch, seed=0):
    cfg = jax_get_config(arch).reduced()
    return JaxModel(cfg), jax.tree.map(jnp.asarray, _weights(arch, seed))


def _port(arch, seed=0):
    return (Model(get_config(arch).reduced(), device="cpu"),
            bridge.to_torch(_weights(arch, seed), device="cpu"))


def _streams(reqs):
    return [list(map(int, r.out_tokens)) for r in reqs]


def _t0_requests(m):
    """Four 4-token prompts, all at t = 0; the longest generation (20)
    wraps gemma3's reduced ring of 16."""
    return [m.Request(prompt=[1, 2, 3, 4], max_new_tokens=20),
            m.Request(prompt=[5, 6, 7, 8], max_new_tokens=3),
            m.Request(prompt=[9, 10, 11, 12], max_new_tokens=12),
            m.Request(prompt=[2, 4, 6, 8], max_new_tokens=5)]


def _poisson(m, seed, n=6):
    """Ragged prompts (5-12 tokens), 4-20 new tokens, arrivals at rate 0.7:
    more requests than slots, so slots are reused and vacant ones decode."""
    rng = np.random.default_rng(seed)
    reqs = m.poisson_requests(rng, n, 0.7, 500, 12, 4, 20)
    for r in reqs:
        r.prompt = [int(t) for t in r.prompt[:int(rng.integers(5, 13))]]
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_static_engine_matches_jax_and_the_continuous_engine(arch):
    """``ServingEngine`` (kernel path and plain) emits the JAX
    ``ServingEngine``'s streams after as many decode steps; with every
    request at t = 0 and the pad length of the static batch, the port's
    ``ContinuousEngine`` emits the same (``tests/test_continuous.py``'s
    property)."""
    mj, pj = _jax(arch)
    ref_eng = jserving.ServingEngine(mj, pj, batch_slots=4, cache_cap=32)
    want = _streams(ref_eng.serve(_t0_requests(jserving)))
    mt, pt = _port(arch)
    for kernels in (True, False):
        eng = tserving.ServingEngine(mt, pt, batch_slots=4, cache_cap=32,
                                     kernels=kernels)
        assert _streams(eng.serve(_t0_requests(tserving))) == want
        assert eng.decode_steps == ref_eng.decode_steps == 20
    cont = tserving.ContinuousEngine(
        mt, pt, batch_slots=4, cache_cap=32,
        config=tserving.EngineConfig(prefill_len=4, kernels=True))
    assert _streams(cont.serve(_t0_requests(tserving))) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_streams_match_jax(arch):
    """A Poisson stream through 3 slots: the port's ``ContinuousEngine``
    (kernel path and plain) emits the JAX engine's streams."""
    mj, pj = _jax(arch)
    want = _streams(jserving.ContinuousEngine(
        mj, pj, batch_slots=3, cache_cap=40,
        config=jserving.EngineConfig(kernels=True)).serve(
            _poisson(jserving, 3)))
    mt, pt = _port(arch)
    for kernels in (True, False):
        eng = tserving.ContinuousEngine(
            mt, pt, batch_slots=3, cache_cap=40,
            config=tserving.EngineConfig(kernels=kernels))
        assert _streams(eng.serve(_poisson(tserving, 3))) == want


CHUNK4 = dict(prefill_chunk=4)


@pytest.mark.parametrize("arch,config", [
    ("phi4-mini-3.8b", CHUNK4), ("gemma-7b", CHUNK4), ("qwen3-32b", CHUNK4),
    ("gemma3-27b", CHUNK4),
    ("gemma3-27b", dict(prefill_chunk=4, prefill_pool=2,
                        step_token_budget=7)),
], ids=["phi4-mini-chunk4", "gemma-7b-chunk4", "qwen3-chunk4",
        "gemma3-chunk4", "gemma3-chunk4_pool2_budget7"])
def test_chunked_streams_match_jax(arch, config):
    """Chunked admission: the port's streams (kernel path) equal the JAX
    engine's, and the serialised chunked stream equals the one-shot one
    (a dense model's rows do not interact). For gemma3 the chunking
    limit is the ring (16): prompts pad to at most 16, generations wrap
    the ring, and a longer prompt is refused."""
    mj, pj = _jax(arch)
    want = _streams(jserving.ContinuousEngine(
        mj, pj, batch_slots=3, cache_cap=40,
        config=jserving.EngineConfig(kernels=True, **config)).serve(
            _poisson(jserving, 4)))
    mt, pt = _port(arch)
    got = _streams(tserving.ContinuousEngine(
        mt, pt, batch_slots=3, cache_cap=40,
        config=tserving.EngineConfig(kernels=True, **config)).serve(
            _poisson(tserving, 4)))
    assert got == want
    if config == CHUNK4:
        one_shot = _streams(tserving.ContinuousEngine(
            mt, pt, batch_slots=3, cache_cap=40,
            config=tserving.EngineConfig(kernels=True)).serve(
                _poisson(tserving, 4)))
        assert got == one_shot
    if arch != "gemma3-27b":
        assert mt.chunkable_len(40) is None
        return
    assert mt.chunkable_len(40) == 16
    eng = tserving.ContinuousEngine(
        mt, pt, batch_slots=1, cache_cap=40,
        config=tserving.EngineConfig(prefill_chunk=4, bucket_policy="exact"))
    with pytest.raises(ValueError, match="cannot be chunked"):
        eng.submit(tserving.Request(prompt=[1] * 17, max_new_tokens=2))


def test_static_colocated_engine_moe_beside_dense_matches_jax():
    """Reduced phi3.5-MoE beside reduced phi4-mini in the static
    ``ColocatedEngine`` (kernel path): both batches equal the JAX
    engine's, and each equals its model served alone."""
    pa = np.random.default_rng(0).integers(1, 500, (2, 6))
    pb = np.random.default_rng(1).integers(1, 500, (2, 6))
    (mja, pja), (mjb, pjb) = _jax(MOE), _jax("phi4-mini-3.8b", 1)
    want = [np.asarray(o).tolist() for o in jserving.ColocatedEngine(
        mja.with_kernels(), mjb.with_kernels(), pja, pjb).serve(
            pa, pb, max_new_tokens=5, cache_cap=16)]
    (mta, pta), (mtb, ptb) = _port(MOE), _port("phi4-mini-3.8b", 1)
    mta, mtb = mta.with_kernels(), mtb.with_kernels()
    got = [o.tolist() for o in tserving.ColocatedEngine(
        mta, mtb, pta, ptb).serve(pa, pb, max_new_tokens=5, cache_cap=16)]
    assert got == want
    solo_b = tserving.ColocatedEngine(mtb, mtb, ptb, ptb).serve(
        pb, pb, max_new_tokens=5, cache_cap=16)[0]
    assert solo_b.tolist() == want[1]


def test_colocated_continuous_moe_beside_dense_matches_jax():
    """Reduced phi3.5-MoE beside reduced phi4-mini in
    ``ColocatedContinuousEngine`` (kernel path, no pairing: tenant B has no
    experts): each tenant's stream equals the JAX engine's and its solo
    ``ContinuousEngine`` stream."""
    (mja, pja), (mjb, pjb) = _jax(MOE), _jax("phi4-mini-3.8b", 1)
    cfg_j = jserving.EngineConfig(kernels=True)
    ra, rb = _poisson(jserving, 5), _poisson(jserving, 6)
    jserving.ColocatedContinuousEngine(mja, mjb, pja, pjb, batch_slots=3,
                                       cache_cap=40, config=cfg_j).serve(
        ra, rb)
    (mta, pta), (mtb, ptb) = _port(MOE), _port("phi4-mini-3.8b", 1)
    cfg = tserving.EngineConfig(kernels=True)
    ta, tb = _poisson(tserving, 5), _poisson(tserving, 6)
    eng = tserving.ColocatedContinuousEngine(mta, mtb, pta, ptb,
                                             batch_slots=3, cache_cap=40,
                                             config=cfg)
    assert eng.pair == []
    eng.serve(ta, tb)
    assert _streams(ta) == _streams(ra) and _streams(tb) == _streams(rb)
    solo = tserving.ContinuousEngine(mtb, ptb, batch_slots=3, cache_cap=40,
                                     config=cfg).serve(_poisson(tserving, 6))
    assert _streams(solo) == _streams(tb)


@pytest.mark.parametrize("extra,expect", [
    (["--arch", "gemma3-27b", "--max-new-tokens", "20", "--cache-cap", "40"],
     "40 tokens in 20 decode steps (static batch of 2)"),
    (["--arch", MOE, "--colocate-with", "phi4-mini-3.8b"], "model B:"),
    (["--arch", MOE, "--colocate-with", "phi4-mini-3.8b",
      "--arrival-rate", "0.5"], "lockstep decode steps"),
], ids=["static_dense", "static_colocated_dense",
        "continuous_colocated_dense"])
def test_launch_static_and_dense_colocation(capsys, extra, expect):
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--device", "cpu", "--kernels",
                       "--batch", "2", "--cache-cap", "32",
                       "--num-requests", "3", "--max-new-tokens", "4"]
                      + extra) == 0
    out = capsys.readouterr().out
    assert expect in out
    assert "aurora colocation pairing" not in out


@pytest.mark.parametrize("extra,match", [
    (["--prefill-chunk", "4"], "--prefill-chunk configure the continuous"),
    (["--ttft-slo", "8", "--mesh", "4"], "--ttft-slo/--mesh configure"),
    (["--colocate-with", "phi4-mini-3.8b", "--arrival-rate", "0.5",
      "--replan-interval", "2"], "two MoE models"),
], ids=["chunk_needs_a_stream", "slo_mesh_need_a_stream",
        "replan_needs_two_moe_models"])
def test_launch_refuses_what_the_path_cannot_serve(extra, match):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", MOE, "--reduced", "--device", "cpu"] + extra)
