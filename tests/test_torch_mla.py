"""The port's MLA block (``repro_torch.models.attention.mla_block``) against
the JAX ``mla_block``, on the CPU.

Reduced DeepSeek-V3 in fp32 (d 256, 4 heads, q_lora 64, kv_lora 64, rope
16, nope 32, v 32). The weights come from the JAX package's ``init_mla``
through ``repro_torch.bridge``; inputs and cache contents are made with
numpy from a seed. Outputs and cache leaves are held to 1e-5 (rtol and
atol): both sides compute in fp32 over at most 256 terms a sum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)
B, CAP = 4, 24


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_get_config(ARCH).reduced()
    p_j = ja.init_mla(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    p_t = bridge.to_torch(jax.tree.map(np.asarray, p_j), device="cpu")
    return cfg_j, get_config(ARCH).reduced(), p_j, p_t


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_cache(got: dict, want: dict):
    assert set(got) == set(want) == {"ckv", "k_rope"}
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL)


def test_reduced_config_matches_reference(setup):
    cfg_j, cfg_t, _, _ = setup
    assert cfg_t.mla.__dict__ == cfg_j.mla.__dict__
    assert (cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.d_model) == (
        cfg_j.n_heads, cfg_j.n_kv_heads, cfg_j.d_model)
    cache = ta.init_mla_cache(cfg_t, B, CAP, torch.float32, "cpu")
    want = ja.init_mla_cache(cfg_j, B, CAP, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("s", [1, 9])
def test_prefill_matches_jax(setup, s):
    """A fresh prefill: the direct form's output, and the latent and rope
    key written at positions [0, S) of an otherwise zero cache."""
    cfg_j, cfg_t, p_j, p_t = setup
    x = np.random.default_rng(s).standard_normal(
        (B, s, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (B, s))
    y_j, c_j = ja.mla_block(p_j, jnp.asarray(x), cfg=cfg_j,
                            pos=jnp.asarray(pos),
                            cache=ja.init_mla_cache(cfg_j, B, CAP,
                                                    jnp.float32),
                            mode="prefill")
    cache = ta.init_mla_cache(cfg_t, B, CAP, torch.float32, "cpu")
    y_t = ta.mla_block(p_t, _t(x), cfg=cfg_t, pos=_t(pos), cache=cache,
                       mode="prefill")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    _check_cache(cache, c_j)


def _filled_cache(cfg_t, seed):
    rng = np.random.default_rng(seed)
    m = cfg_t.mla
    return {"ckv": rng.standard_normal((B, CAP, m.kv_lora_rank)
                                       ).astype(np.float32),
            "k_rope": rng.standard_normal((B, CAP, m.qk_rope_head_dim)
                                          ).astype(np.float32)}


@pytest.mark.parametrize("lengths", [[0, 5, CAP - 1, CAP + 3], 7],
                         ids=["per_slot_with_clamp", "scalar"])
@pytest.mark.parametrize("frozen", [False, True], ids=["all", "row_mask"])
def test_decode_matches_jax(setup, lengths, frozen):
    """The absorbed decode over a filled latent cache: per-slot fill levels
    0 (only the new token is live), cap - 1 and past the capacity (both
    clamped to the last slot), or one scalar fill level. With a
    ``row_mask`` freezing row 1, its cache is what it was (the
    reference's gate in ``transformer._apply_layer``) and its output is
    computed all the same."""
    cfg_j, cfg_t, p_j, p_t = setup
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 1, cfg_j.d_model)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    pos = np.broadcast_to(np.reshape(length, (-1, 1)), (B, 1))
    filled = _filled_cache(cfg_t, 12)
    y_j, c_j = ja.mla_block(p_j, jnp.asarray(x), cfg=cfg_j,
                            pos=jnp.asarray(pos),
                            cache=jax.tree.map(jnp.asarray, filled),
                            length=jnp.asarray(length), mode="decode")
    mask = None
    if frozen:
        mask = np.array([True, False, True, True])
        c_j = jax.tree.map(lambda new, old: jnp.where(
            jnp.asarray(mask)[:, None, None], new, old), c_j, filled)
    cache = bridge.to_torch(filled, device="cpu")
    y_t = ta.mla_block(p_t, _t(x), cfg=cfg_t, pos=_t(pos), cache=cache,
                       length=_t(length), mode="decode",
                       row_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    _check_cache(cache, c_j)
    if frozen:
        for name in cache:
            assert np.array_equal(cache[name][1].numpy(), filled[name][1])


def test_prefill_continuation_is_refused(setup):
    """A prefill given a fill level raises: the latent cache is written
    from position 0 only (the reference's engines refuse chunked prefill
    for MLA upstream)."""
    _, cfg_t, _, p_t = setup
    cache = ta.init_mla_cache(cfg_t, 1, CAP, torch.float32, "cpu")
    x = torch.zeros((1, 4, cfg_t.d_model))
    with pytest.raises(ValueError, match="fill level"):
        ta.mla_block(p_t, x, cfg=cfg_t, pos=torch.arange(4)[None] + 3,
                     cache=cache, length=torch.tensor(3), mode="prefill")
