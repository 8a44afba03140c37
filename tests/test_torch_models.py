"""The port's model modules against the JAX reference, on the CPU.

Reduced phi3.5-MoE (2 layers, d 256, 4 experts, fp32). Weights come from
the JAX package through ``repro_torch.bridge``; other inputs are made with
numpy from a seed. Integer dispatch outputs must be exactly equal.
Floating outputs are held to 1e-4 (rtol and atol): both sides compute in
fp32, but sums run in another order over d = 256 terms and two layers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models.layers import KernelConfig as JaxKC  # noqa: E402
from repro.models.layers import ParallelContext  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, init_params  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_get_config(ARCH).reduced()
    params_j = JaxModel(cfg_j).init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params_j)
    return cfg_j, params_j, bridge.to_torch(params_np, device="cpu")


def _moe_layer(params_j, params_t):
    """Layer 0's MoE params on both sides."""
    pj = jax.tree.map(lambda a: a[0], params_j["segments"][0][0]["moe"])
    pt = bridge.map_tree(lambda a: a[0], params_t["segments"][0][0]["moe"])
    return pj, pt


@pytest.mark.parametrize("t", [3, 33])
def test_dispatch_integers_exactly_equal(setup, t):
    """route idx, sort_dispatch (order, sizes, slot, keep) and the one-hot
    reference agree bit for bit, at decode and prefill token counts, and on
    a skewed routing whose groups overflow capacity (drops)."""
    cfg_j, params_j, params_t = setup
    moe = cfg_j.moe
    pj, pt = _moe_layer(params_j, params_t)
    x = np.random.default_rng(t).standard_normal((t, cfg_j.d_model)).astype(np.float32)
    gj, idx_j, aux_j = jm.route(pj["router"], jnp.asarray(x), moe)
    gt, idx_t, aux_t = tm.route(pt["router"], _t(x), get_config(ARCH).reduced().moe)
    np.testing.assert_array_equal(idx_t.numpy(), _np(idx_j))
    np.testing.assert_allclose(gt.numpy(), _np(gj), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    cap = tm.capacity(t, moe.top_k, moe.n_experts, moe.capacity_factor)
    assert cap == jm.capacity(t, moe.top_k, moe.n_experts, moe.capacity_factor)
    first = np.random.default_rng(t).integers(0, 2, (t, 1))
    skew = np.concatenate([first, 1 - first], axis=1).astype(np.int32)
    for idx in (_np(idx_j), skew):
        ij, it = jnp.asarray(idx), _t(idx)
        for got, want in zip(tm.sort_dispatch(it, moe.n_experts, cap),
                             jm.sort_dispatch(ij, moe.n_experts, cap)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
        for got, want in zip(tm.dispatch_indices(it, moe.n_experts, cap),
                             jm.dispatch_indices(ij, moe.n_experts, cap)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
    if t == 33:
        assert not tm.sort_dispatch(_t(skew), moe.n_experts, cap)[3].all()


@pytest.mark.parametrize("t", [4, 64])
@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_moe_apply_matches_jax(setup, t, impl):
    cfg_j, params_j, params_t = setup
    pj, pt = _moe_layer(params_j, params_t)
    x = np.random.default_rng(t).standard_normal((t, cfg_j.d_model)).astype(np.float32)
    y_j, aux_j = jm.moe_apply_dense(pj, jnp.asarray(x), cfg_j.moe, cfg_j.act)
    moe_t = get_config(ARCH).reduced().moe
    if impl == "kernel":
        y_t, aux_t = tm.moe_apply_kernel(pt, _t(x), moe_t, "swiglu",
                                         tl.KernelConfig(block_c=8))
        pc = ParallelContext(moe_impl="kernel", kernels=JaxKC(block_c=8))
        y_k, _ = jm.moe_apply_kernel(pj, jnp.asarray(x), cfg_j.moe,
                                     cfg_j.act, pc)
        np.testing.assert_allclose(y_t.numpy(), _np(y_k), **TOL)
    else:
        y_t, aux_t = tm.moe_apply_dense(pt, _t(x), moe_t, "swiglu")
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    """rmsnorm (1 + w in fp32), RoPE (fp32, cast back) and attention_core
    (prefill causal form, decode per-slot fill levels)."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else TOL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32) * 0.1
    k = rng.standard_normal((2, 12, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None] + 5, (2, 12))

    def both(a):
        return jnp.asarray(a, jd), _t(a).to(td)

    (xj, xt), (wj, wt), (kj, kt), (vj, vt) = map(both, (x, w, k, v))
    pairs = [
        (tl.rmsnorm(wt, xt, 1e-6), jl.rmsnorm(wj, xj, 1e-6)),
        (tl.apply_rope(xt, _t(pos), 1e4), jl.apply_rope(xj, jnp.asarray(pos), 1e4)),
        (tl.attention_core(xt, kt, vt, causal_offset=0, valid_len=None),
         jl.attention_core(xj, kj, vj, causal_offset=0, window=None,
                           valid_len=None)),
        (tl.attention_core(xt[:, :1], kt, vt, causal_offset=None,
                           valid_len=torch.tensor([3, 12])),
         jl.attention_core(xj[:, :1], kj, vj, causal_offset=None, window=None,
                           valid_len=jnp.asarray([3, 12]))),
    ]
    for got, want in pairs:
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_init_params_shapes_match_jax(setup):
    """The port's own seeded init has the reference's leaf paths, shapes and
    dtypes (the router is fp32 even in a bf16 model)."""
    _, params_j, _ = setup
    ref = jax.tree.map(np.asarray, params_j)
    ours = init_params(get_config(ARCH).reduced(), seed=0, device="cpu")
    assert (sorted(map(str, bridge.leaf_paths(ours)))
            == sorted(map(str, bridge.leaf_paths(ref))))
    for path in bridge.leaf_paths(ref):
        a, b = ref, ours
        for key in path:
            a, b = a[key], b[key]
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    import dataclasses
    bf = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    p = init_params(bf, seed=0, device="cpu")
    assert p["segments"][0][0]["moe"]["router"].dtype == torch.float32
    assert p["segments"][0][0]["attn"]["wq"].dtype == torch.bfloat16
    torch.testing.assert_close(
        p["embed"], init_params(bf, seed=0, device="cpu")["embed"])


def test_model_logits_match_jax_kernel_model(setup):
    """Prefill and per-slot decode logits of the port's kernel-path Model
    match the JAX Model.with_kernels(), with a frozen (row_mask) row whose
    cache and length must stay unchanged."""
    cfg_j, params_j, params_t = setup
    mj = JaxModel(cfg_j).with_kernels()
    mt = Model(get_config(ARCH).reduced(), device="cpu").with_kernels()
    rng = np.random.default_rng(3)
    cap, prompts = 32, [rng.integers(1, 500, (1, n)) for n in (8, 16)]
    cache_j = mj.init_cache(3, cap, per_slot_len=True)
    cache_t = mt.init_cache(3, cap, per_slot_len=True)
    for slot, toks in enumerate(prompts):
        lj, cache_j = mj.prefill_slot(params_j, {"tokens": jnp.asarray(toks)},
                                      cache_j, slot, cap=cap)
        lt, cache_t = mt.prefill_slot(params_t, {"tokens": _t(toks)},
                                      cache_t, slot, cap=cap)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    mask = np.array([True, True, False])
    tok = rng.integers(1, 500, (3, 1))
    for _ in range(3):
        frozen = cache_t["segments"][0][0]["k"][:, 2].clone()
        lj, cache_j = mj.decode_step(params_j, jnp.asarray(tok), cache_j,
                                     jnp.asarray(mask))
        lt, cache_t = mt.decode_step(params_t, _t(tok), cache_t, _t(mask))
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        torch.testing.assert_close(cache_t["segments"][0][0]["k"][:, 2],
                                   frozen, rtol=0, atol=0)
        tok = np.asarray(jnp.argmax(lj[:, :, :cfg_j.vocab], -1))
    np.testing.assert_array_equal(cache_t["len"].numpy(), _np(cache_j["len"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t["segments"][0][0][name].numpy(),
                                   _np(cache_j["segments"][0][0][name]), **TOL)


def test_dense_geglu_variant_logits_match_jax():
    """The dense (G) layer kind and ffn_apply's tanh gelu, on a phi3.5
    variant without MoE (geglu, d_ff 128): prefill and decode logits."""
    import dataclasses
    kw = dict(moe=None, family="dense", d_ff=128, act="geglu")
    cfg_j = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    mj = JaxModel(cfg_j).with_kernels()
    params_j = mj.init(jax.random.PRNGKey(1))
    mt = Model(dataclasses.replace(get_config(ARCH).reduced(), **kw),
               device="cpu").with_kernels()
    params_t = bridge.to_torch(jax.tree.map(np.asarray, params_j), device="cpu")
    toks = np.random.default_rng(5).integers(1, 500, (2, 8))
    lj, cj = mj.prefill(params_j, {"tokens": jnp.asarray(toks)},
                        mj.init_cache(2, 16))
    lt, ct = mt.prefill(params_t, {"tokens": _t(toks)}, mt.init_cache(2, 16))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    tok = toks[:, -1:]
    lj, _ = mj.decode_step(params_j, jnp.asarray(tok), cj)
    lt, _ = mt.decode_step(params_t, _t(tok), ct)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
