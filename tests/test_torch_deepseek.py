"""The port's DeepSeek-V3 slice against the JAX reference, on the CPU.

Reduced DeepSeek-V3 in fp32: 2 layers (one leading dense layer D and one
MoE layer E), d 256, MLA (q_lora 64, kv_lora 64, rope 16, nope 32, v 32),
4 experts top-2 with the sigmoid router and one shared expert. Weights
are made by the JAX package and carried across by ``repro_torch.bridge``.
Tolerances: the MoE layer 2e-5 with routing counts exactly equal and aux
1e-6 relative (the reference's own kernel-path test), logits 1e-4 (two
layers and the head in another summation order), greedy streams byte for
byte.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import cut_depth, get_config  # noqa: E402
from repro_torch.distributed import LocalGroup  # noqa: E402
from repro_torch.models import KernelConfig, Model, init_params  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCH = "deepseek-v3-671b"
CFG_J = jax_get_config(ARCH).reduced()
CFG = get_config(ARCH).reduced()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops (the in-process EP ranks above
    all), several test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Seed-0 params of the reduced model, made by the JAX package."""
    return jax.tree.map(np.asarray, JaxModel(CFG_J).init(
        jax.random.PRNGKey(0)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _streams(reqs):
    return [list(map(int, r.out_tokens)) for r in reqs]


def test_segments_match_reference():
    """D then E segments, for the full config, the reduced one and a depth
    cut that keeps the 3 dense layers (``cut_depth`` takes MoE layers
    first, down to one)."""
    full_j, full_t = jax_get_config(ARCH), get_config(ARCH)
    for cj, ct in ((full_j, full_t), (CFG_J, CFG)):
        assert ([(s.kinds, s.count) for s in tt.segments_of(ct)]
                == [(s.kinds, s.count) for s in jt.segments_of(cj)])
    assert [(s.kinds, s.count) for s in tt.segments_of(full_t)] == [
        (("D",), 3), (("E",), 58)]
    assert [(s.kinds, s.count) for s in tt.segments_of(
        cut_depth(full_t, 5))] == [(("D",), 3), (("E",), 2)]
    assert [(s.kinds, s.count) for s in tt.segments_of(
        cut_depth(full_t, 2))] == [(("D",), 1), (("E",), 1)]
    assert tt.moe_layer_count(cut_depth(full_t, 5)) == 2
    with pytest.raises(ValueError):
        cut_depth(full_t, 0)


def test_init_params_tree_matches_jax(weights):
    """The port's seeded init has exactly the JAX tree's leaf paths, shapes
    and dtypes: the MLA leaves, the D layer's ``ffn`` at ``dense_d_ff``,
    the E layer's ``moe.shared`` at ``shared_d_ff``, the fp32 router."""
    ours = init_params(CFG, seed=0, device="cpu")
    paths = bridge.leaf_paths(weights)
    assert sorted(map(str, bridge.leaf_paths(ours))) == sorted(map(str, paths))
    for path in paths:
        a, b = weights, ours
        for key in path:
            a, b = a[key], b[key]
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    d_seg, e_seg = ours["segments"]
    assert set(d_seg[0]["attn"]) == {"wq_a", "q_norm", "wq_b", "wkv_a",
                                     "kv_norm", "wk_b", "wv_b", "wo"}
    assert d_seg[0]["ffn"]["w_gate"].shape == (1, 256, CFG.moe.dense_d_ff)
    assert e_seg[0]["moe"]["shared"]["w_down"].shape == (
        1, CFG.moe.shared_d_ff, 256)


@pytest.mark.parametrize("t", [2, 4, 33])
@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_moe_apply_sigmoid_shared_matches_jax(weights, t, impl):
    """The E layer's MoE (sigmoid router, shared expert) through the port's
    kernel route (the plain ``moe_gmm`` on the CPU) and its dense route,
    against the JAX ``moe_apply``."""
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      weights["segments"][1][0]["moe"])
    pt = bridge.map_tree(lambda a: _t(a[0]), weights["segments"][1][0]["moe"])
    assert "shared" in pt and CFG.moe.router == "sigmoid"
    x = np.random.default_rng(t).standard_normal(
        (t, CFG.d_model)).astype(np.float32)
    y_j, aux_j, c_j = jm.moe_apply(pj, jnp.asarray(x), CFG_J.moe, CFG_J.act,
                                   return_counts=True)
    if impl == "kernel":
        y_t, aux_t, c_t = tm.moe_apply_kernel(pt, _t(x), CFG.moe, CFG.act,
                                              KernelConfig(block_c=8),
                                              return_counts=True)
    else:
        y_t, aux_t, c_t = tm.moe_apply_dense(pt, _t(x), CFG.moe, CFG.act,
                                             return_counts=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    _, idx_j, _ = jm.route(pj["router"], jnp.asarray(x), CFG_J.moe)
    _, idx_t, _ = tm.route(pt["router"], _t(x), CFG.moe)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel", "plain"])
def test_model_logits_match_jax(weights, kernels):
    """Batch-1 prefills into slots 0 and 1 of a 3-slot cache, then three
    per-slot decodes with slot 2 frozen (``row_mask``): logits within 1e-4
    of the JAX ``Model``, the latent caches too, the frozen row's cache
    unchanged and the fill levels equal."""
    mj = JaxModel(CFG_J).with_kernels(kernels)
    mt = Model(CFG, device="cpu").with_kernels(kernels)
    params_j = jax.tree.map(jnp.asarray, weights)
    params_t = bridge.to_torch(weights, device="cpu")
    rng = np.random.default_rng(3)
    cap, tol = 32, dict(rtol=1e-4, atol=1e-4)
    cache_j = mj.init_cache(3, cap, per_slot_len=True)
    cache_t = mt.init_cache(3, cap, per_slot_len=True)
    for slot, n in enumerate((8, 16)):
        toks = rng.integers(1, CFG.vocab, (1, n))
        lj, cache_j = mj.prefill_slot(params_j, {"tokens": jnp.asarray(toks)},
                                      cache_j, slot, cap=cap)
        lt, cache_t = mt.prefill_slot(params_t, {"tokens": _t(toks)},
                                      cache_t, slot, cap=cap)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    mask = np.array([True, True, False])
    tok = rng.integers(1, CFG.vocab, (3, 1))
    leaves_t = tt.cache_leaves(cache_t)
    assert len(leaves_t) == 4                # (ckv, k_rope) of D and of E
    for _ in range(3):
        frozen = [leaf[:, 2].clone() for leaf in leaves_t]
        lj, cache_j = mj.decode_step(params_j, jnp.asarray(tok), cache_j,
                                     jnp.asarray(mask))
        lt, cache_t = mt.decode_step(params_t, _t(tok), cache_t, _t(mask))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
        for leaf, before in zip(leaves_t, frozen):
            assert torch.equal(leaf[:, 2], before)
        tok = np.asarray(jnp.argmax(lj[:, :, :CFG.vocab], -1))
    np.testing.assert_array_equal(cache_t["len"].numpy(),
                                  np.asarray(cache_j["len"]))
    got = bridge.to_numpy(cache_t["segments"])
    want = jax.tree.map(np.asarray, cache_j["segments"])
    for path in bridge.leaf_paths(want):
        a, b = want, got
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(b, a, **tol)


def _poisson(m, n=7):
    rng = np.random.default_rng(7)
    reqs = m.poisson_requests(rng, n, 0.8, CFG.vocab, 9, 3, 10)
    for i, r in enumerate(reqs):                  # ragged prompt lengths
        r.prompt = r.prompt[: 5 + (i * 3) % 9]
    return reqs


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's greedy streams on a Poisson stream of 7 requests
    over 3 slots (slots are reused, vacant slots decode)."""
    eng = jserving.ContinuousEngine(
        JaxModel(CFG_J), jax.tree.map(jnp.asarray, weights), batch_slots=3,
        cache_cap=48, config=jserving.EngineConfig(kernels=True))
    reqs = eng.serve(_poisson(jserving))
    return _streams(reqs), eng.decode_steps


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel", "plain"])
def test_greedy_streams_match_jax_engine(weights, jax_streams, kernels):
    eng = tserving.ContinuousEngine(
        Model(CFG, device="cpu"), bridge.to_torch(weights, device="cpu"), batch_slots=3,
        cache_cap=48, config=tserving.EngineConfig(kernels=kernels))
    got = eng.serve(_poisson(tserving))
    assert (_streams(got), eng.decode_steps) == jax_streams
    assert all(len(r.out_tokens) == r.max_new_tokens for r in got)


def test_chunked_engine_refuses_deepseek_prompt(weights):
    """As the reference (``tests/test_chunked_prefill.py``): MLA writes its
    latent cache from offset 0 only, so a chunked engine refuses the
    prompt at submit time; one-shot admission takes it."""
    model = Model(CFG, device="cpu")
    assert model.chunkable_len(32) == 0
    assert not model.supports_chunked_prefill(4, 32)
    for m, mdl, params in (
            (jserving, JaxModel(CFG_J), jax.tree.map(jnp.asarray, weights)),
            (tserving, model, bridge.to_torch(weights, device="cpu"))):
        eng = m.ContinuousEngine(mdl, params, 1, 32,
                                 config=m.EngineConfig(prefill_chunk=2))
        with pytest.raises(ValueError, match="chunk"):
            eng.submit(m.Request(prompt=[1, 2, 3, 4], max_new_tokens=2))
    eng = tserving.ContinuousEngine(model, bridge.to_torch(weights, device="cpu"), 1, 32)
    assert eng.submit(tserving.Request(prompt=[1, 2, 3, 4],
                                       max_new_tokens=2)) is None


def test_launch_serve_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--kernels", "--batch", "3", "--cache-cap", "32",
                       "--num-requests", "4", "--arrival-rate", "0.5"]) == 0
    assert "tokens in" in capsys.readouterr().out
    with pytest.raises(ValueError, match="chunk"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--cache-cap", "32", "--num-requests",
                    "2", "--arrival-rate", "0.5", "--prefill-chunk", "4"])


# Expert parallelism: capacity factor 8.0, so that no assignment drops on
# either side (per-rank and unsharded capacities both clamp to the tokens).
CFG_EP_J = dataclasses.replace(CFG_J, moe=dataclasses.replace(
    CFG_J.moe, capacity_factor=8.0))
CFG_EP = dataclasses.replace(CFG, moe=dataclasses.replace(
    CFG.moe, capacity_factor=8.0))


@pytest.mark.parametrize("impl", ["ep", "aurora"])
def test_distributed_engine_matches_jax_engine(weights, impl):
    """``DistributedEngine`` over ``LocalGroup(4)``: one expert a rank
    (views of the served leaves), the shared expert and the D layer
    replicated; the greedy streams equal the single-device JAX engine's."""
    def reqs(m):
        rng = np.random.default_rng(5)
        return [m.Request(prompt=[int(t) for t in rng.integers(
            1, CFG.vocab, int(rng.integers(5, 12)))], max_new_tokens=6,
            arrival=float(i // 2)) for i in range(5)]

    ref = jserving.ContinuousEngine(
        JaxModel(CFG_EP_J), jax.tree.map(jnp.asarray, weights),
        batch_slots=2, cache_cap=32, config=jserving.EngineConfig())
    want = _streams(ref.serve(reqs(jserving)))
    eng = tserving.DistributedEngine(
        Model(CFG_EP, device="cpu"), bridge.to_torch(weights, device="cpu"),
        batch_slots=2,
        cache_cap=32, group=LocalGroup(4, "cpu"), moe_impl=impl,
        config=tserving.EngineConfig(kernels=True))
    assert eng.n_ep == 4 and eng.model.pc.moe_impl == impl
    assert _streams(eng.serve(reqs(tserving))) == want
