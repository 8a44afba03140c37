"""The port's dense decoder families against the JAX reference, on the CPU.

phi4-mini (swiglu, tied embeddings), gemma-7b (geglu), qwen3-32b (q/k-norm)
and gemma3-27b (q/k-norm, geglu, ``LG`` sliding-window layers reduced to a
window of 16), all reduced (2 layers, d 256, fp32), plus the layer code
they bring: the windowed ``attention_core`` in its three forms, the blocked
``flash_attention`` and the sliding-window ring cache. Weights come from
the JAX package through ``repro_torch.bridge``; other inputs are made with
numpy from a seed. Tolerances are the reference's own: 1e-5 for fp32
attention, 1e-4 for model logits (sums over d = 256 and two layers in
another order).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ModelConfig, cut_depth, get_config  # noqa: E402
from repro_torch.models import Model, init_params  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "gemma-7b", "qwen3-32b", "gemma3-27b"]
ATTN = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reduced config and its JAX params (seed 0) as numpy leaves, made
    once per arch (jitted: the eager init takes seconds)."""
    cfg_j = jax_get_config(arch).reduced()
    params = jax.jit(JaxModel(cfg_j).init)(jax.random.PRNGKey(0))
    return cfg_j, jax.tree.map(np.asarray, params)


def _layer_attn(params_np, seg=0, pos=0):
    """Block 0's attention leaves of one segment position (numpy)."""
    return {k: v[0] for k, v in params_np["segments"][seg][pos]["attn"].items()}


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field the port keeps equals the reference's, full and reduced
    (q/k-norm kept, the pattern cut to "LG", the window capped at 16), and
    so do the layer kinds and the segments."""
    for cut in (lambda c: c, lambda c: c.reduced()):
        ours, ref = cut(get_config(arch)), cut(jax_get_config(arch))
        for f in dataclasses.fields(ModelConfig):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        assert ours.layer_kinds() == ref.layer_kinds()
        assert tt.segments_of(ours) == [
            tt.Segment(s.kinds, s.count) for s in jt.segments_of(ref)]
    red = get_config(arch).reduced()
    assert red.qk_norm == (arch in ("qwen3-32b", "gemma3-27b"))
    if arch == "gemma3-27b":
        assert (red.layer_pattern, red.sliding_window) == ("LG", 16)


def test_cut_depth_keeps_the_pattern_phase():
    """12 layers of gemma3 are 2 x LLLLLG; 8 end on a partial LL block, as
    the reference's segments of the same depth."""
    full_j = jax_get_config("gemma3-27b")
    for n, want in ((12, [(tuple("LLLLLG"), 2)]),
                    (8, [(tuple("LLLLLG"), 1), (("L", "L"), 1)])):
        cfg = cut_depth(get_config("gemma3-27b"), n)
        assert [(s.kinds, s.count) for s in tt.segments_of(cfg)] == want
        ref = jt.segments_of(dataclasses.replace(full_j, n_layers=n))
        assert [(s.kinds, s.count) for s in ref] == want
        assert cfg.layer_kinds() == dataclasses.replace(
            full_j, n_layers=n).layer_kinds()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_shapes_match_jax(arch):
    """The port's seeded init has the reference's leaf paths, shapes and
    dtypes (q/k-norm scales included), and its per-slot cache the
    reference's (an L layer's ring of min(cap, window) positions)."""
    cfg_j = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    for ours, ref in (
            (init_params(cfg, seed=0, device="cpu"),
             jax.eval_shape(lambda: JaxModel(cfg_j).init(
                 jax.random.PRNGKey(0)))),
            (tt.init_cache(cfg, 3, 40, per_slot_len=True, device="cpu"),
             jax.eval_shape(lambda: jt.init_cache(cfg_j, 3, 40,
                                                  per_slot_len=True)))):
        paths = bridge.leaf_paths(ours)
        assert sorted(map(str, paths)) == sorted(
            map(str, bridge.leaf_paths(ref)))
        for path in paths:
            a, b = ref, ours
            for key in path:
                a, b = a[key], b[key]
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    if arch == "gemma3-27b":
        ring, glob = tt.init_cache(cfg, 3, 40, device="cpu")["segments"][0]
        assert ring["k"].shape[2] == 16 and glob["k"].shape[2] == 40


# -- attention ----------------------------------------------------------------

def test_attn_block_qk_norm_matches_jax():
    """qwen3's attention with random q/k-norm scales: a fresh prefill, a
    chunked continuation and a decode step, outputs and caches."""
    cfg_j, params = _weights("qwen3-32b")
    cfg = get_config("qwen3-32b").reduced()
    rng = np.random.default_rng(11)
    p = _layer_attn(params)
    p["q_norm"] = _rand(rng, cfg.head_dim) * 0.5
    p["k_norm"] = _rand(rng, cfg.head_dim) * 0.5
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    x = _rand(rng, 2, 9, cfg.d_model)
    cap = 16
    cache_j = ja.init_attn_cache(cfg_j, 2, cap, jnp.float32)
    cache_t = ta.init_attn_cache(cfg, 2, cap, torch.float32, "cpu")
    steps = [("prefill", slice(0, 6), None), ("prefill", slice(6, 8), 6),
             ("decode", slice(8, 9), 8)]
    for mode, sl, length in steps:
        s = sl.stop - sl.start
        pos = np.broadcast_to(np.arange(sl.start, sl.stop)[None], (2, s))
        ln = None if length is None else np.int32(length)
        yj, cache_j = jax.jit(functools.partial(
            ja.attn_block, cfg=cfg_j, mode=mode))(
            pj, jnp.asarray(x[:, sl]), pos=jnp.asarray(pos), cache=cache_j,
            length=None if ln is None else jnp.asarray(ln))
        yt = ta.attn_block(pt, _t(x[:, sl]), cfg=cfg, pos=_t(pos),
                           cache=cache_t, mode=mode,
                           length=None if ln is None else _t(ln))
        np.testing.assert_allclose(yt.numpy(), _np(yj), **ATTN)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache_t[name].numpy(),
                                       _np(cache_j[name]), **ATTN)


def _qkv(rng, b, sq, sk, h=4, hkv=2, d=16):
    return (_rand(rng, b, sq, h, d), _rand(rng, b, sk, hkv, d),
            _rand(rng, b, sk, hkv, d))


@pytest.mark.parametrize("form", ["scalar", "per_row", "decode"])
def test_attention_core_window_matches_jax(form):
    """The window in each of attention_core's forms: one scalar offset and
    fill level (KV repeated per head), per-row offsets (chunked
    continuations), and a single query with a scalar fill level (causal
    and window terms) or per-slot fill levels (the decode form, no
    window)."""
    rng = np.random.default_rng({"scalar": 1, "per_row": 2, "decode": 3}[form])
    sq = 1 if form == "decode" else 10
    q, k, v = _qkv(rng, 2, sq, 13)
    cases = {
        "scalar": [dict(causal_offset=3, window=4, valid_len=12),
                   dict(causal_offset=0, window=5, valid_len=None)],
        "per_row": [dict(causal_offset=np.array([3, 0], np.int32),
                         window=4,
                         valid_len=np.array([13, 10], np.int32))],
        "decode": [dict(causal_offset=6, window=4, valid_len=11),
                   dict(causal_offset=None, window=4,
                        valid_len=np.array([5, 13], np.int32))],
    }[form]
    for kw in cases:
        def conv(a, f):
            return f(a) if isinstance(a, np.ndarray) else a
        got = tl.attention_core(
            _t(q), _t(k), _t(v), window=kw["window"],
            causal_offset=conv(kw["causal_offset"], _t),
            valid_len=conv(kw["valid_len"], _t))
        want = jl.attention_core(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            window=kw["window"],
            causal_offset=conv(kw["causal_offset"], jnp.asarray),
            valid_len=conv(kw["valid_len"], jnp.asarray))
        np.testing.assert_allclose(got.numpy(), _np(want), **ATTN)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_matches_jax(window):
    """The blocked online softmax at block_k = 8 over 27 keys (a padded
    last block), causal at offset 7, with and without a window: equal to
    the reference's flash and to the materialised plain form."""
    rng = np.random.default_rng(7)
    q = _rand(rng, 2, 20, 2, 2, 16)
    k, v = _rand(rng, 2, 27, 2, 16), _rand(rng, 2, 27, 2, 16)

    def mask(xp):
        def fn(qi, kj):
            m = kj <= qi + 7
            if window is not None:
                m = m & (kj > qi + 7 - window)
            return m
        return fn
    got = tl.flash_attention(_t(q), _t(k), _t(v), mask(torch), block_k=8)
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask(jnp), block_k=8)
    np.testing.assert_allclose(got.numpy(), _np(want), **ATTN)
    full = mask(torch)(torch.arange(20)[:, None], torch.arange(27)[None])
    plain = tl.plain_attention(_t(q), _t(k), _t(v), full[None, None])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **ATTN)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_core_takes_flash_above_the_threshold(window, monkeypatch):
    """Sq = Sk = 2050 (Sq*Sk just above 4,194,304): attention_core goes
    through flash_attention (blocks of 1024), as the reference does, and
    agrees with it; with gemma3's reduced window too."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 2050, 2050, h=2, hkv=1, d=8)
    calls = []
    flash = tl.flash_attention
    monkeypatch.setattr(tl, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    got = tl.attention_core(_t(q), _t(k), _t(v), causal_offset=0,
                            window=window, valid_len=None)
    want = jl.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal_offset=0, window=window, valid_len=None)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), _np(want), **ATTN)


def test_mla_prefill_past_2048_matches_jax(monkeypatch):
    """Reduced DeepSeek-V3's MLA prefill of a 2050-token prompt takes the
    flash branch on both sides; outputs and latent cache agree."""
    cfg_j, params = _weights("deepseek-v3-671b")
    cfg = get_config("deepseek-v3-671b").reduced()
    p = _layer_attn(params)
    x = np.random.default_rng(4).standard_normal(
        (1, 2050, cfg.d_model)).astype(np.float32) * 0.5
    pos = np.arange(2050)[None]
    calls = []
    flash = tl.flash_attention
    monkeypatch.setattr(tl, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    cache_t = ta.init_mla_cache(cfg, 1, 2050, torch.float32, "cpu")
    yt = ta.mla_block({k: _t(v) for k, v in p.items()}, _t(x), cfg=cfg,
                      pos=_t(pos), cache=cache_t, mode="prefill")
    yj, cache_j = jax.jit(functools.partial(
        ja.mla_block, cfg=cfg_j, mode="prefill"))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        pos=jnp.asarray(pos),
        cache=ja.init_mla_cache(cfg_j, 1, 2050, jnp.float32))
    assert calls == [1]
    # The latent and the rope key are projections over d = 256: the
    # model-level tolerance, as the output's.
    np.testing.assert_allclose(yt.numpy(), _np(yj), **LOGITS)
    for name in ("ckv", "k_rope"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   _np(cache_j[name]), **LOGITS)


def test_ring_prefill_longer_than_the_ring_matches_jax():
    """A fresh 13-token prefill into a ring of 8 (window 8) keeps the last
    8 keys at pos % 8; a continuation into a cache smaller than the chunk
    raises, as in the reference."""
    cfg_j, params = _weights("gemma3-27b")
    cfg = get_config("gemma3-27b").reduced()
    p = _layer_attn(params)
    x = _rand(np.random.default_rng(8), 2, 13, cfg.d_model)
    pos = np.broadcast_to(np.arange(13)[None], (2, 13))
    cache_t = ta.init_attn_cache(cfg, 2, 8, torch.float32, "cpu")
    yt = ta.attn_block({k: _t(v) for k, v in p.items()}, _t(x), cfg=cfg,
                       pos=_t(pos), cache=cache_t, mode="prefill", window=8)
    yj, cache_j = jax.jit(functools.partial(
        ja.attn_block, cfg=cfg_j, window=8, mode="prefill"))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        pos=jnp.asarray(pos),
        cache=ja.init_attn_cache(cfg_j, 2, 8, jnp.float32))
    np.testing.assert_allclose(yt.numpy(), _np(yj), **ATTN)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   _np(cache_j[name]), **ATTN)
    with pytest.raises(ValueError, match="smaller than the chunk"):
        ta.attn_block({k: _t(v) for k, v in p.items()}, _t(x), cfg=cfg,
                      pos=_t(pos), cache=cache_t, mode="prefill",
                      length=torch.tensor(0), window=8)


# -- the Model -----------------------------------------------------------------

def _jit_model(mj):
    return (jax.jit(mj.prefill_slot, static_argnames=("cap",)),
            jax.jit(mj.decode_step))


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "row_mask"])
def test_decode_past_the_ring_matches_jax(masked):
    """Reduced gemma3 (LG, ring of 16, global cache of 24): two prompts of
    6 and 10 tokens, then 14 decode steps, so both rings wrap. Logits
    of the kernel-path Model equal the JAX kernel-path Model's at every
    step; with a row mask the frozen row's ring and global cache stay as
    they were, as does its length."""
    cfg_j, params = _weights("gemma3-27b")
    mj = JaxModel(cfg_j).with_kernels()
    mt = Model(get_config("gemma3-27b").reduced(), device="cpu").with_kernels()
    pt = bridge.to_torch(params, device="cpu")
    pj = jax.tree.map(jnp.asarray, params)
    prefill_j, decode_j = _jit_model(mj)
    rng = np.random.default_rng(9)
    cap = 24
    cache_j = mj.init_cache(3, cap, per_slot_len=True)
    cache_t = mt.init_cache(3, cap, per_slot_len=True)
    for slot, n in ((0, 6), (1, 10), (2, 3)):
        toks = rng.integers(1, 500, (1, n))
        lj, cache_j = prefill_j(pj, {"tokens": jnp.asarray(toks)}, cache_j,
                                slot, cap=cap)
        lt, cache_t = mt.prefill_slot(pt, {"tokens": _t(toks)}, cache_t,
                                      slot, cap=cap)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **LOGITS)
    mask = np.array([True, not masked, True])
    tok = rng.integers(1, 500, (3, 1))
    frozen = [t[:, 1].clone() for t in tt.cache_leaves(cache_t)]
    for _ in range(14):
        lj, cache_j = decode_j(pj, jnp.asarray(tok), cache_j,
                               jnp.asarray(mask))
        lt, cache_t = mt.decode_step(pt, _t(tok), cache_t, _t(mask))
        np.testing.assert_allclose(lt.numpy(), _np(lj), **LOGITS)
        tok = np.asarray(jnp.argmax(lj[:, :, :cfg_j.vocab], -1))
    np.testing.assert_array_equal(cache_t["len"].numpy(),
                                  _np(cache_j["len"]))
    assert int(cache_t["len"][0]) > 16                   # the rings wrapped
    for got, want in zip(tt.cache_leaves(cache_t),
                         jax.tree.leaves(cache_j["segments"])):
        np.testing.assert_allclose(got.numpy(), _np(want), **LOGITS)
    if masked:
        for got, old in zip(tt.cache_leaves(cache_t), frozen):
            torch.testing.assert_close(got[:, 1], old, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_match_jax(arch):
    """Prefill (one-shot and a chunked continuation) and per-slot decode
    logits of the port's Model, kernel path and plain, equal the JAX
    Model's; a frozen row keeps its cache."""
    cfg_j, params = _weights(arch)
    pt = bridge.to_torch(params, device="cpu")
    pj = jax.tree.map(jnp.asarray, params)
    mj = JaxModel(cfg_j).with_kernels()
    prefill_j, decode_j = _jit_model(mj)
    cap = 32
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, (1, n)) for n in (8, 16)]
    tok0 = rng.integers(1, 500, (3, 1))
    want = []
    cache_j = mj.init_cache(3, cap, per_slot_len=True)
    for slot, toks in enumerate(prompts):
        lj, cache_j = prefill_j(pj, {"tokens": jnp.asarray(toks)}, cache_j,
                                slot, cap=cap)
        want.append(_np(lj))
    mask = np.array([True, True, False])
    tok = tok0
    for _ in range(3):
        lj, cache_j = decode_j(pj, jnp.asarray(tok), cache_j,
                               jnp.asarray(mask))
        want.append(_np(lj))
        tok = np.asarray(jnp.argmax(lj[:, :, :cfg_j.vocab], -1))
    for kernels in (True, False):
        mt = Model(get_config(arch).reduced(), device="cpu").with_kernels(
            kernels)
        cache_t = mt.init_cache(3, cap, per_slot_len=True)
        got = []
        for slot, toks in enumerate(prompts):
            # The second prompt in two chunks: 8 fresh, 8 continued.
            if slot == 1:
                mt.prefill_chunk_slot(pt, {"tokens": _t(toks[:, :8])},
                                      cache_t, slot, first=True, cap=cap)
                lt, _ = mt.prefill_chunk_slot(
                    pt, {"tokens": _t(toks[:, 8:])}, cache_t, slot,
                    first=False, cap=cap)
                np.testing.assert_allclose(lt.numpy(), want[1][:, 8:],
                                           **LOGITS)
                continue
            lt, _ = mt.prefill_slot(pt, {"tokens": _t(toks)}, cache_t, slot,
                                    cap=cap)
            got.append(lt.numpy())
        tok = tok0
        for _ in range(3):
            lt, _ = mt.decode_step(pt, _t(tok), cache_t, _t(mask))
            got.append(lt.numpy())
            tok = lt[:, :, :cfg_j.vocab].argmax(-1).numpy()
        for g, w in zip(got, want[:1] + want[2:]):
            np.testing.assert_allclose(g, w, **LOGITS)
        np.testing.assert_array_equal(cache_t["len"].numpy(),
                                      _np(cache_j["len"]))
