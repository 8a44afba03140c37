"""The port's chunked prefill against the JAX reference, on the CPU.

``attention_core`` with fill levels, the ``attn_block`` continuation,
``Model.prefill_chunk_slot`` and the frozen row of an in-flight prefill.
Weights are made by the JAX package and carried across with
``repro_torch.bridge``; other inputs come from numpy with a seed. Reduced
phi3.5-MoE (2 layers, d 256, 4 experts, fp32) and its dense variant.
Tolerances: 1e-5 for one attention call (fp32, one reduction over at most
a few dozen keys), 1e-4 through the whole model, as in
tests/test_torch_models.py; rows a call must not touch are compared bit
for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
TOL_CALL = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
DENSE = dict(moe=None, family="dense", d_ff=128, act="geglu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def moe_models():
    cfg_j = jax_get_config(ARCH).reduced()
    mj = JaxModel(cfg_j).with_kernels()
    params_j = mj.init(jax.random.PRNGKey(0))
    mt = Model(get_config(ARCH).reduced(), device="cpu").with_kernels()
    return mj, params_j, mt, bridge.to_torch(jax.tree.map(np.asarray, params_j))


@pytest.fixture(scope="module")
def dense_models():
    mj = JaxModel(dataclasses.replace(jax_get_config(ARCH).reduced(), **DENSE))
    params_j = mj.init(jax.random.PRNGKey(1))
    mt = Model(dataclasses.replace(get_config(ARCH).reduced(), **DENSE),
               device="cpu")
    return mj, params_j, mt, bridge.to_torch(jax.tree.map(np.asarray, params_j))


# (Sq, causal_offset, valid_len): scalar offsets, (B,) vectors, and
# one-token chunks, which take the single-query branch.
CORE_CASES = {
    "scalar": (5, 3, 8),
    "vector": (4, [2, 7], [6, 11]),
    "one_token_scalar": (1, 6, 7),
    "one_token_vector": (1, [0, 9], [1, 10]),
    "vector_offset_only": (3, [1, 4], None),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_attention_core_fill_levels_match_jax(case):
    sq, off, vl = CORE_CASES[case]
    rng = np.random.default_rng(sorted(CORE_CASES).index(case))
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)

    def arg(a, conv):
        return None if a is None else conv(np.asarray(a, np.int32))

    want = jl.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal_offset=arg(off, jnp.asarray), window=None,
                             valid_len=arg(vl, jnp.asarray))
    got = tl.attention_core(_t(q), _t(k), _t(v), causal_offset=arg(off, _t),
                            valid_len=arg(vl, _t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_CALL)


# (chunk length, fill level before the chunk): scalar, per-row, one token.
BLOCK_CASES = {"scalar": (5, 4), "vector": (3, [2, 6]),
               "one_token": (1, 9), "one_token_vector": (1, [0, 5])}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_attn_block_continuation_matches_jax(moe_models, case):
    """The chunk's keys land at the fill level (a slice for a scalar, one
    indexed write per row for a vector); the output and the whole cache
    agree with the reference; rows outside the chunk keep their bytes."""
    _, params_j, _, params_t = moe_models
    cfg = get_config(ARCH).reduced()
    s, length = BLOCK_CASES[case]
    rng = np.random.default_rng(10 + sorted(BLOCK_CASES).index(case))
    pj = jax.tree.map(lambda a: a[0], params_j["segments"][0][0]["attn"])
    pt = bridge.map_tree(lambda a: a[0], params_t["segments"][0][0]["attn"])
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    ln = np.broadcast_to(np.asarray(length, np.int32), (2,))
    pos = (ln[:, None] + np.arange(s)[None]).astype(np.int32)
    cache = {n: rng.standard_normal((2, 16, cfg.n_kv_heads, cfg.head_dim)
                                    ).astype(np.float32) for n in ("k", "v")}
    ln_arg = np.asarray(length, np.int32)
    yj, cj = ja.attn_block(pj, jnp.asarray(x), cfg=jax_get_config(ARCH).reduced(),
                           pos=jnp.asarray(pos),
                           cache={n: jnp.asarray(a) for n, a in cache.items()},
                           length=jnp.asarray(ln_arg), mode="prefill")
    ct = {n: _t(a) for n, a in cache.items()}
    yt = ta.attn_block(pt, _t(x), cfg=cfg, pos=_t(pos), cache=ct,
                       length=_t(ln_arg), mode="prefill")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL_CALL)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct[n].numpy(), np.asarray(cj[n]),
                                   **TOL_CALL)
        for b in range(2):
            keep = np.ones(16, bool)
            keep[ln[b]:ln[b] + s] = False
            np.testing.assert_array_equal(ct[n][b].numpy()[keep],
                                          cache[n][b][keep])


def test_attn_block_continuation_longer_than_cache_raises(moe_models):
    _, params_j, _, params_t = moe_models
    cfg = get_config(ARCH).reduced()
    pt = bridge.map_tree(lambda a: a[0], params_t["segments"][0][0]["attn"])
    pj = jax.tree.map(lambda a: a[0], params_j["segments"][0][0]["attn"])
    x = np.zeros((1, 6, cfg.d_model), np.float32)
    pos = np.arange(6)[None].astype(np.int32)
    shape = (1, 4, cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="smaller than the chunk"):
        ja.attn_block(pj, jnp.asarray(x), cfg=jax_get_config(ARCH).reduced(),
                      pos=jnp.asarray(pos),
                      cache={n: jnp.zeros(shape) for n in ("k", "v")},
                      length=jnp.int32(0), mode="prefill")
    with pytest.raises(ValueError, match="smaller than the chunk"):
        ta.attn_block(pt, _t(x), cfg=cfg, pos=_t(pos),
                      cache={n: torch.zeros(shape) for n in ("k", "v")},
                      length=torch.tensor(0, dtype=torch.int32),
                      mode="prefill")


def _leaves_t(cache):
    return [t for seg in cache["segments"] for e in seg
            for t in (e["k"], e["v"])]


def _leaves_j(cache):
    return [np.asarray(t) for seg in cache["segments"] for e in seg
            for t in (e["k"], e["v"])]


def test_prefill_chunk_slot_matches_jax(moe_models):
    """Chunks [8, 8, 3] into the middle slot of a three-slot cache whose
    rows all hold other state: logits and cache at 1e-4, ``len`` equal,
    the other rows bit for bit as before. The first chunk must clear the
    slot's previous occupant: zeros past the written prefix."""
    mj, params_j, mt, params_t = moe_models
    cap, slot = 32, 1
    rng = np.random.default_rng(4)
    cache_j = mj.init_cache(3, cap, per_slot_len=True)
    cache_t = mt.init_cache(3, cap, per_slot_len=True)
    for s, n in enumerate((12, 20, 6)):           # slot 1's old occupant: 20
        toks = rng.integers(1, 500, (1, n))
        _, cache_j = mj.prefill_slot(params_j, {"tokens": jnp.asarray(toks)},
                                     cache_j, s, cap=cap)
        _, cache_t = mt.prefill_slot(params_t, {"tokens": _t(toks)},
                                     cache_t, s, cap=cap)
    before = [t.clone() for t in _leaves_t(cache_t)]
    prompt = rng.integers(1, 500, (1, 19))
    done = 0
    for c in (8, 8, 3):
        inp = prompt[:, done:done + c]
        lj, cache_j = mj.prefill_chunk_slot(
            params_j, {"tokens": jnp.asarray(inp)}, cache_j, slot,
            first=done == 0, cap=cap)
        lt, cache_t = mt.prefill_chunk_slot(
            params_t, {"tokens": _t(inp)}, cache_t, slot, first=done == 0,
            cap=cap)
        done += c
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_MODEL)
        np.testing.assert_array_equal(cache_t["len"].numpy(),
                                      np.asarray(cache_j["len"]))
        for got, want in zip(_leaves_t(cache_t), _leaves_j(cache_j)):
            np.testing.assert_allclose(got.numpy(), want, **TOL_MODEL)
        for got, old in zip(_leaves_t(cache_t), before):
            for other in (0, 2):
                assert torch.equal(got[:, other], old[:, other])
            assert not got[:, slot, done:].any()
    assert cache_t["len"].tolist() == [12, 19, 6]


def test_dense_chunked_equals_one_shot(dense_models):
    """On the dense variant chunked continuation over one batch-1 cache
    equals a one-shot prefill (the reference's
    test_model_level_chunk_matches_one_shot)."""
    _, _, mt, params = dense_models
    prompt = _t(np.random.default_rng(0).integers(1, 500, (1, 8)))
    one = mt.init_cache(1, 32)
    l_one, one = mt.prefill(params, {"tokens": prompt}, one)
    chd = mt.init_cache(1, 32)
    for sl in (slice(0, 4), slice(4, 6), slice(6, 8)):
        l_chd, chd = mt.prefill(params, {"tokens": prompt[:, sl]}, chd,
                                continuation=True)
    np.testing.assert_allclose(l_chd[0, -1].numpy(), l_one[0, -1].numpy(),
                               **TOL_CALL)
    assert int(chd["len"]) == int(one["len"]) == 8
    for a, b in zip(_leaves_t(one), _leaves_t(chd)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-5)


def test_dense_vector_continuation_matches_per_row(dense_models):
    """A continuation over a per-slot (vector length) cache, each row at its
    own offset, equals each row's one-shot prefill (the reference's
    test_vector_len_continuation_matches_per_row), and matches JAX's."""
    mj, params_j, mt, params_t = dense_models
    rng = np.random.default_rng(3)
    pre = [rng.integers(1, 500, n) for n in (4, 6)]
    tail = rng.integers(1, 500, (2, 3))
    cache = mt.init_cache(2, 32, per_slot_len=True)
    cache_j = mj.init_cache(2, 32, per_slot_len=True)
    for i, p in enumerate(pre):
        _, cache = mt.prefill_slot(params_t, {"tokens": _t(p[None])}, cache,
                                   i, cap=32)
        _, cache_j = mj.prefill_slot(params_j, {"tokens": jnp.asarray(p[None])},
                                     cache_j, i, cap=32)
    logits, cache = mt.prefill(params_t, {"tokens": _t(tail)}, cache,
                               continuation=True)
    lj, cache_j = mj.prefill(params_j, {"tokens": jnp.asarray(tail)}, cache_j,
                             continuation=True)
    assert cache["len"].tolist() == [7, 9]
    np.testing.assert_allclose(logits.numpy(), np.asarray(lj), **TOL_MODEL)
    for i, p in enumerate(pre):
        one = mt.init_cache(1, 32)
        full = np.concatenate([p, tail[i]])[None]
        l_one, one = mt.prefill(params_t, {"tokens": _t(full)}, one)
        np.testing.assert_allclose(logits[i].numpy(),
                                   l_one[0, len(p):].numpy(), **TOL_CALL)
        for a, b in zip(_leaves_t(one), _leaves_t(cache)):
            np.testing.assert_allclose(b[:, i].numpy(), a[:, 0].numpy(),
                                       rtol=1e-4, atol=1e-5)


def test_pending_row_frozen_across_interleaved_decode(moe_models):
    """A slot between two chunks keeps every byte of its row and its fill
    level while decode steps run over the other slots. The decode writes
    the frozen row at ``len`` (inside the region the next chunk writes) and
    puts the old bytes back; the next chunk then matches JAX."""
    mj, params_j, mt, params_t = moe_models
    cap = 32
    rng = np.random.default_rng(6)
    first = rng.integers(1, 500, (1, 12))
    prompt = rng.integers(1, 500, (1, 9))
    cache_t = mt.init_cache(3, cap, per_slot_len=True)
    cache_j = mj.init_cache(3, cap, per_slot_len=True)
    _, cache_t = mt.prefill_slot(params_t, {"tokens": _t(first)}, cache_t, 0,
                                 cap=cap)
    _, cache_j = mj.prefill_slot(params_j, {"tokens": jnp.asarray(first)},
                                 cache_j, 0, cap=cap)
    _, cache_t = mt.prefill_chunk_slot(params_t, {"tokens": _t(prompt[:, :4])},
                                       cache_t, 2, first=True, cap=cap)
    _, cache_j = mj.prefill_chunk_slot(
        params_j, {"tokens": jnp.asarray(prompt[:, :4])}, cache_j, 2,
        first=True, cap=cap)
    row = [t[:, 2].clone() for t in _leaves_t(cache_t)]
    mask = np.array([True, False, False])
    tok = rng.integers(1, 500, (3, 1))
    for i in range(2):
        _, cache_t = mt.decode_step(params_t, _t(tok), cache_t, _t(mask))
        _, cache_j = mj.decode_step(params_j, jnp.asarray(tok), cache_j,
                                    jnp.asarray(mask))
        for got, old in zip(_leaves_t(cache_t), row):
            assert torch.equal(got[:, 2], old)
        assert cache_t["len"].tolist() == [13 + i, 0, 4]
    lt, cache_t = mt.prefill_chunk_slot(params_t, {"tokens": _t(prompt[:, 4:])},
                                        cache_t, 2, first=False, cap=cap)
    lj, cache_j = mj.prefill_chunk_slot(
        params_j, {"tokens": jnp.asarray(prompt[:, 4:])}, cache_j, 2,
        first=False, cap=cap)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_MODEL)
    for got, want in zip(_leaves_t(cache_t), _leaves_j(cache_j)):
        np.testing.assert_allclose(got.numpy(), want, **TOL_MODEL)


def test_slice_and_merge_slot_match_jax(moe_models):
    """``slice_cache_slot`` (views here, a copy in the reference) and
    ``Model.merge_slot`` move one slot's row and fill level to another
    slot exactly as the reference does; the view shares storage."""
    from repro.models import transformer as jt
    from repro_torch.models import slice_cache_slot
    mj, _, mt, _ = moe_models
    rng = np.random.default_rng(8)
    cache_np = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, mj.init_cache(3, 16, per_slot_len=True)))
    cache_np["len"] = np.array([5, 11, 2], np.int32)
    cache_j = jax.tree.map(jnp.asarray, cache_np)
    cache_t = bridge.to_torch(cache_np)
    view = slice_cache_slot(cache_t, 1)
    assert int(view["len"]) == 11
    assert view["segments"][0][0]["k"].data_ptr() == (
        cache_t["segments"][0][0]["k"][:, 1].data_ptr())
    cache_j = mj.merge_slot(cache_j, jt.slice_cache_slot(cache_j, 1), 2)
    cache_t = mt.merge_slot(cache_t, view, 2)
    assert cache_t["len"].tolist() == np.asarray(cache_j["len"]).tolist()
    assert cache_t["len"].tolist() == [5, 11, 11]
    for got, want in zip(_leaves_t(cache_t), _leaves_j(cache_j)):
        np.testing.assert_array_equal(got.numpy(), want)
