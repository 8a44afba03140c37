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
from repro.kernels.ops import _divisor_block as jax_divisor  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn  # noqa: E402
from repro_torch.kernels.moe_gmm import align_capacity, moe_gmm  # noqa: E402

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
    for n in range(1, 600, 7):
        assert align_capacity(n, block) == jax_align(n, block)
        assert ops._divisor_block(n, block) == jax_divisor(n, block)


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
