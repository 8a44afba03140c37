"""The port's kernel modules against the JAX reference, on the CPU.

A CPU tensor makes each wrapper run its plain PyTorch version; the JAX side
runs the Pallas kernel body in interpret mode and its jnp oracle. Inputs
are made with numpy from a seed and handed to both. Tolerances: the
reference's own (``tests/test_kernels.py::_tol``): 1e-5 in fp32 (sums in
another order), 2e-2 in bf16 (the h cast and bf16 outputs round at
different places in the two frameworks).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attn import decode_attn as jax_decode_attn  # noqa: E402
from repro.kernels.moe_gmm import align_capacity as jax_align  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm  # noqa: E402
from repro.kernels.ops import decode_attn_auto as jax_decode_attn_auto  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import geometry as da_geometry  # noqa: E402
from repro_torch.kernels.moe_gmm import align_capacity, moe_gmm  # noqa: E402
from repro_torch.kernels.moe_gmm import geometry as moe_geometry  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _pair(a, name):
    """The same numpy array as a JAX array and a torch tensor of dtype
    ``name`` (both round fp32 -> bf16 to nearest even)."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _moe_inputs(seed, e, c, d, f, sizes=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    if sizes is not None:                       # zero-padded buckets
        x[np.arange(c)[None, :] >= np.asarray(sizes)[:, None]] = 0.0
    wg = rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5
    wu = rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5
    wd = rng.standard_normal((e, f, d)).astype(np.float32) * f ** -0.5
    return x, wg, wu, wd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_moe_gmm_plain_matches_pallas(act, dtype):
    """geglu catches an exact (not tanh) gelu."""
    arrays = _moe_inputs(0, 2, 128, 64, 128)
    (xj, xt), (gj, gt), (uj, ut), (dj, dt) = (_pair(a, dtype) for a in arrays)
    got = moe_gmm(xt, gt, ut, dt, act=act)
    assert got.dtype == DTYPES[dtype][1] and moe_gmm.launches == 0
    want = jax_moe_gmm(xj, gj, uj, dj, act=act, interpret=True)
    oracle = jref.moe_ffn_ref(xj, gj, uj, dj, act)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol(dtype))


@pytest.mark.parametrize("sizes", [(0, 0), (128, 0), (37, 200)])
def test_moe_gmm_group_sizes_match_pallas(sizes):
    """Rows at or past group_sizes[e] are zero: equal to the Pallas block
    skip (block_c=64) on zero-padded buckets and to the jnp oracle."""
    arrays = _moe_inputs(5, 2, 256, 64, 128, sizes)
    (xj, xt), (gj, gt), (uj, ut), (dj, dt) = (_pair(a, "float32")
                                              for a in arrays)
    gs = np.asarray(sizes, np.int32)
    got = ops.moe_ffn(xt, gt, ut, dt, group_sizes=torch.from_numpy(gs))
    want = jax_moe_gmm(xj, gj, uj, dj, group_sizes=jnp.asarray(gs),
                       block_c=64, interpret=True)
    oracle = jref.moe_ffn_ref(xj, gj, uj, dj, group_sizes=jnp.asarray(gs))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol("float32"))
    dead = np.arange(256)[None, :] >= gs[:, None]
    assert not _f32(got)[dead].any()


@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 8, 8, 256, 64),      # MHA
    (2, 8, 2, 512, 64),      # GQA 4:1
    (3, 4, 1, 256, 128),     # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_plain_matches_pallas(b, h, hkv, s, d, dtype):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    valid = np.concatenate([[3], rng.integers(1, s + 1, b - 1)]).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    got = decode_attn(qt, kt, vt, torch.from_numpy(valid))
    assert decode_attn.launches == 0
    want = jax_decode_attn(qj, kj, vj, jnp.asarray(valid), block_s=128,
                           interpret=True)
    oracle = jref.decode_attn_ref(qj, kj, vj, jnp.asarray(valid))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol(dtype))


def test_decode_attn_auto_broadcasts_scalar_fill_level():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 96, 4, 64))
                             .astype(np.float32)) for _ in range(2))
    got = ops.decode_attn_auto(q, k, v, 40)
    want = ref.decode_attn_ref(q, k, v, torch.tensor([40, 40]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("block", [1, 3, 8, 64, 128])
def test_align_capacity_and_divisor_block_match(block):
    """align_capacity as in the reference; and decode_attn_auto at any
    ``block_s``, where the reference runs its kernel on the largest block
    that divides S (1, 3, 8 and 24 of S = 24 here), gives the reference's
    answer: the port's kernel takes no block of S."""
    for n in range(1, 600, 7):
        assert align_capacity(n, block) == jax_align(n, block)
    rng = np.random.default_rng(block)
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
            for _ in range(2))
    valid = np.asarray([24, 7], np.int32)
    got = ops.decode_attn_auto(*map(torch.from_numpy, (q, k, v, valid)),
                               block_s=block)
    want = jax_decode_attn_auto(*map(jnp.asarray, (q, k, v, valid)),
                                block_s=block, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def test_wrappers_check_shapes():
    x = torch.zeros(2, 8, 16)
    w = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="w_down"):
        moe_gmm(x, w, w, w)
    with pytest.raises(ValueError, match="act"):
        moe_gmm(x, w, w, torch.zeros(2, 32, 16), act="relu")
    with pytest.raises(ValueError, match="valid_len"):
        decode_attn(torch.zeros(2, 4, 32), torch.zeros(2, 8, 2, 32),
                    torch.zeros(2, 8, 2, 32), torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_plain_matches_pallas_at_zero_fill(dtype):
    """A row with valid_len = 0 has every score masked to -1e30: the Pallas
    kernel and the plain version both give the mean of V over all S."""
    rng = np.random.default_rng(6)
    b, h, hkv, s, d = 4, 8, 2, 256, 64
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    valid = np.asarray([0, 1, 77, s], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    got = decode_attn(qt, kt, vt, torch.from_numpy(valid))
    want = jax_decode_attn(qj, kj, vj, jnp.asarray(valid), block_s=128,
                           interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    mean_v = _f32(vt)[0].mean(axis=0).repeat(h // hkv, axis=0)   # (H, D)
    np.testing.assert_allclose(_f32(got)[0], mean_v, **_tol(dtype))


# Launch geometry: the main path's shapes and reduced ones.
ATTN_SHAPES = [
    (8, 32, 8, 512, 128, torch.bfloat16),     # served phi3.5-MoE, cache 512
    (3, 4, 2, 64, 64, torch.float32),         # reduced phi3.5-MoE
    (3, 8, 2, 200, 64, torch.float32),        # chip_smoke's fp32 case
    (1, 8, 8, 4096, 256, torch.bfloat16),     # one row, long cache, MHA
    (64, 64, 8, 32768, 128, torch.bfloat16),  # many rows, G = 8
]


@pytest.mark.parametrize("b,h,hkv,s,d,dtype", ATTN_SHAPES)
def test_decode_attn_geometry_within_hopper_limits(b, h, hkv, s, d, dtype):
    geo = da_geometry(b, h, hkv, s, d, dtype)
    assert geo["smem"] <= 227 * 1024
    assert 1 <= geo["split"] <= 32
    assert geo["grid"] == (geo["split"], hkv, b)
    lpp = geo["lpp"]
    assert lpp & (lpp - 1) == 0 and lpp <= 32
    assert geo["chunks"] * 16 == d * dtype.itemsize <= lpp * 16
    share = -(-s // geo["split"])                   # a block's largest share
    assert 1 <= geo["tile"] <= share and geo["buffers"] in (1, 2)
    assert (geo["buffers"] == 1) == (geo["tile"] == share)
    assert geo["work"] == b * hkv * geo["split"] * (h // hkv) * (d + 2)


@pytest.mark.parametrize("split", [1, 2, 4, 8, 32])
def test_decode_attn_split_covers_each_live_position_once(split):
    """csrc/decode_attn.cu's split of n live positions among a row's
    blocks: share = ceil(n / split), lo = min(n, rank * share),
    hi = min(n, lo + share)."""
    for n in range(1, 530):
        share = -(-n // split)
        los = [min(n, rank * share) for rank in range(split)]
        ranges = [(lo, min(n, lo + share)) for lo in los]
        assert ranges[0][0] == 0 < ranges[0][1]
        covered = [p for lo, hi in ranges for p in range(lo, hi)]
        assert covered == list(range(n))            # disjoint, in order
        assert max(hi - lo for lo, hi in ranges) == -(-n // split)
    geo = da_geometry(8, 32, 8, 512, 128, torch.bfloat16)       # served shape
    assert geo["split"] == 2 and geo["grid"][0] * 64 <= 132
    assert geo["tile"] == 256 and geo["buffers"] == 1


MOE_SHAPES = [
    (16, 8, 4096, 6400, torch.bfloat16),      # decode step, 8 slots
    (16, 16, 4096, 6400, torch.bfloat16),     # batch-1 prefill, 64 tokens
    (16, 24, 4096, 6400, torch.bfloat16),     # 128 tokens
    (16, 48, 4096, 6400, torch.bfloat16),     # 256 tokens
    (16, 3, 4096, 6400, torch.bfloat16),      # prompt of 1-2 tokens
    (3, 40, 96, 136, torch.bfloat16),         # ragged d and F
    (4, 200, 256, 384, torch.bfloat16),       # bucket taller than a block
    (4, 8, 256, 384, torch.float32),          # reduced phi3.5-MoE
]


@pytest.mark.parametrize("e,c,d,f,dtype", MOE_SHAPES)
def test_moe_gmm_geometry_within_hopper_limits(e, c, d, f, dtype):
    geo = moe_geometry(e, c, d, f, dtype)
    assert geo["route"] == ("mma" if dtype == torch.bfloat16 else "fma")
    assert max(geo["smem_up"], geo["smem_down"]) <= 227 * 1024
    rows, feat = geo["rows"], 64
    # Every bucket row and every output feature in exactly one block.
    for grid, m in ((geo["grid_up"], f), (geo["grid_down"], d)):
        assert grid[2] == e
        assert (grid[0] - 1) * feat < m <= grid[0] * feat
        assert (grid[1] - 1) * rows < c <= grid[1] * rows
    if geo["route"] == "mma":
        # 16-byte rows of x, h and the weights; the ring's x rows hold a
        # whole row block; one row block (weights read once) up to C = 64.
        assert (d * 2) % 16 == 0 and (f * 2) % 16 == 0
        assert min(c, rows) <= geo["rows_pad"] <= rows
        assert geo["rows_pad"] % 8 == 0 and 3 <= geo["stages"] <= 6
        assert (geo["grid_up"][1] == 1) == (c <= 64)


def test_kernel_geometry_rejects_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="multiples of 8"):
        moe_geometry(2, 8, 100, 128, torch.bfloat16)      # 200-byte rows
    with pytest.raises(ValueError, match="multiples of 2"):
        moe_geometry(2, 8, 64, 127, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        moe_geometry(2, 8, 64, 128, torch.float16)
    assert moe_geometry(2, 8, 104, 136, torch.bfloat16)["route"] == "mma"
    with pytest.raises(ValueError, match="16-byte"):
        da_geometry(2, 8, 2, 64, 36, torch.bfloat16)      # 72-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        da_geometry(2, 8, 2, 64, 256, torch.float32)      # 64 chunks
    with pytest.raises(ValueError, match="query heads"):
        da_geometry(2, 32, 2, 64, 64, torch.bfloat16)     # G = 16
    big = da_geometry(1, 8, 8, 8192, 256, torch.bfloat16)  # share of 512
    assert big["smem"] <= 227 * 1024 and big["tile"] < 512    # tile capped
    assert big["buffers"] == 2
    assert da_geometry(2, 8, 2, 64, 72, torch.bfloat16)["lpp"] == 16
