"""The port's Mamba2 (SSD) blocks against ``repro.models.ssm`` on the CPU.

Inputs are made with numpy from a seed at the reduced mamba2 widths
(d_model 256, 16 heads of 32, d_state 16, chunk 32, fp32); the block's
weights are the JAX package's ``init_mamba``, carried over through
``repro_torch.bridge``. Tolerance: 1e-5 (fp32) everywhere, the chunked
scan's cumulative ``exp`` included: it needed no loosening.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
CFG = get_config("mamba2-1.3b").reduced()
CFG_J = jax_get_config("mamba2-1.3b").reduced()
H, P, N = tssm.n_heads_of(CFG), CFG.ssm.head_dim, CFG.ssm.d_state


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _ssd_inputs(rng, b, s, g=1):
    x = _rand(rng, b, s, H, P)
    dt = np.abs(_rand(rng, b, s, H, scale=0.1)) + 0.01
    a = -np.linspace(1.0, 16.0, H).astype(np.float32)
    return x, dt, a, _rand(rng, b, s, g, N), _rand(rng, b, s, g, N)


@pytest.mark.parametrize("s,groups,with_state", [
    (64, 1, False),          # two whole chunks
    (45, 1, False),          # a zero-padded tail chunk
    (45, 1, True),           # continued from a carried state
    (20, 4, True),           # one short chunk, grouped B/C (H/G = 4)
], ids=["whole_chunks", "padded_tail", "padded_with_state",
        "short_grouped_with_state"])
def test_ssd_chunked_matches_jax(s, groups, with_state):
    rng = np.random.default_rng(s + groups)
    x, dt, a, bm, cm = _ssd_inputs(rng, 2, s, groups)
    init = _rand(rng, 2, H, P, N) if with_state else None
    fn = jax.jit(jssm.ssd_chunked, static_argnums=(5,))
    yj, sj = fn(x, dt, a, bm, cm, CFG.ssm.chunk,
                None if init is None else jnp.asarray(init))
    yt, st = tssm.ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm),
                              CFG.ssm.chunk,
                              None if init is None else _t(init))
    assert yt.shape == (2, s, H, P) and st.shape == (2, H, P, N)
    _close(yt, yj, FP32)
    _close(st, sj, FP32)


def test_ssd_pad_leaves_the_state_as_a_shorter_scan_does():
    """The zero pad of a tail chunk (dt = 0) carries the state unchanged:
    a 45-token scan's final state equals the state after its 45 tokens in
    a 64-token scan of the same prefix. Checked on the port alone, against
    the reference's own property."""
    rng = np.random.default_rng(7)
    x, dt, a, bm, cm = _ssd_inputs(rng, 1, 64)
    _, s45 = tssm.ssd_chunked(*(_t(v[:, :45]) for v in (x, dt)), _t(a),
                              *(_t(v[:, :45]) for v in (bm, cm)), 32)
    dt0 = dt.copy()
    dt0[:, 45:] = 0.0
    _, s64 = tssm.ssd_chunked(_t(x), _t(dt0), _t(a), _t(bm), _t(cm), 32)
    np.testing.assert_allclose(s45.numpy(), s64.numpy(), **FP32)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(1)
    x, dt, a, bm, cm = _ssd_inputs(rng, 3, 1)
    state = _rand(rng, 3, H, P, N)
    yj, sj = jax.jit(jssm.ssd_decode_step)(x[:, 0], dt[:, 0], a, bm[:, 0],
                                          cm[:, 0], state)
    yt, st = tssm.ssd_decode_step(_t(x[:, 0]), _t(dt[:, 0]), _t(a),
                                  _t(bm[:, 0]), _t(cm[:, 0]), _t(state))
    _close(yt, yj, FP32)
    _close(st, sj, FP32)


@pytest.mark.parametrize("s", [1, 3, 9])
def test_conv_scan_matches_jax(s):
    rng = np.random.default_rng(s)
    c = tssm.conv_dim_of(CFG)
    k = CFG.ssm.conv_kernel
    w, b = _rand(rng, k, c, scale=0.3), _rand(rng, c)
    x, init = _rand(rng, 2, s, c), _rand(rng, 2, k - 1, c)
    oj, nj = jax.jit(jssm._conv_scan)(w, b, x, init)
    ot, nt = tssm._conv_scan(_t(w), _t(b), _t(x), _t(init))
    _close(ot, oj, FP32)
    _close(nt, nj, FP32)


def _mamba_params(seed=0):
    p = jax.jit(lambda k: jssm.init_mamba(k, CFG_J, jnp.float32))(
        jax.random.PRNGKey(seed))
    p = jax.tree.map(np.asarray, p)
    # The reference inits norm and conv_b at zero: give them values, so the
    # gated norm's scale and the conv bias are exercised.
    rng = np.random.default_rng(seed)
    p["norm"] = _rand(rng, *p["norm"].shape, scale=0.1)
    p["conv_b"] = _rand(rng, *p["conv_b"].shape, scale=0.1)
    p["dt_bias"] = _rand(rng, *p["dt_bias"].shape, scale=0.5)
    return p


def test_init_mamba_matches_the_reference_shapes():
    ours = tssm.init_mamba(2, CFG, torch.float32, "cpu",
                           torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: jssm.init_mamba(jax.random.PRNGKey(0),
                                                 CFG_J, jnp.float32))
    assert sorted(ours) == sorted(ref)
    for name, leaf in ours.items():
        assert tuple(leaf.shape) == (2,) + tuple(ref[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(ref[name].dtype), name
    np.testing.assert_allclose(ours["A_log"][1].numpy(),
                               np.log(np.linspace(1.0, 16.0, H)), rtol=1e-6)


@pytest.mark.parametrize("s,cached", [(7, False), (40, False), (7, True),
                                      (40, True)],
                         ids=["fresh7", "fresh40", "continued7",
                              "continued40"])
def test_mamba_block_matches_jax(s, cached):
    """Sequence mode, fresh (no cache) and continued from a cache whose
    conv window and state are not zero; the port writes the new window and
    state into the cache in place."""
    rng = np.random.default_rng(s)
    p = _mamba_params()
    x = _rand(rng, 2, s, CFG.d_model)
    cache = None
    if cached:
        cache = {"conv": _rand(rng, 2, CFG.ssm.conv_kernel - 1,
                               tssm.conv_dim_of(CFG)),
                 "state": _rand(rng, 2, H, P, N, scale=0.1)}
    fn = jax.jit(lambda p, x, c: jssm.mamba_block(p, x, CFG_J, c))
    yj, cj = fn(p, x, cache)
    cache_t = bridge.to_torch(cache, device="cpu") if cached else None
    yt = tssm.mamba_block(bridge.to_torch(p, device="cpu"), _t(x), CFG, cache_t)
    _close(yt, yj, FP32)
    if cached:
        _close(cache_t["conv"], cj["conv"], FP32)
        _close(cache_t["state"], cj["state"], FP32)


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows",
                                                       "row1_frozen"])
def test_mamba_decode_matches_jax(masked):
    """One-token decode over a non-zero cache. With a ``row_mask`` that
    freezes row 1, that row's conv window and state stay as they were (the
    reference's ``gate`` in ``transformer._apply_layer``) and every other
    row's advance as the JAX ``mamba_decode``'s; every row's output is the
    reference's."""
    rng = np.random.default_rng(11)
    p = _mamba_params(1)
    x = _rand(rng, 3, 1, CFG.d_model)
    cache = {"conv": _rand(rng, 3, CFG.ssm.conv_kernel - 1,
                           tssm.conv_dim_of(CFG)),
             "state": _rand(rng, 3, H, P, N, scale=0.1)}
    yj, cj = jax.jit(lambda p, x, c: jssm.mamba_decode(p, x, CFG_J, c))(
        p, x, cache)
    cache_t = bridge.to_torch(cache, device="cpu")
    mask = torch.tensor([True, not masked, True])
    yt = tssm.mamba_decode(bridge.to_torch(p, device="cpu"), _t(x), CFG, cache_t,
                           mask if masked else None)
    _close(yt, yj, FP32)
    for name in ("conv", "state"):
        want = np.array(cj[name])
        if masked:
            want[1] = cache[name][1]
        _close(cache_t[name], want, FP32)
