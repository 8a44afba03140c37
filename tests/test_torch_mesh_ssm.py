"""The Mamba2 block's rank program (``ssm.mamba_block`` and
``ssm.mamba_decode`` with a mesh ``pc``) against the unsharded port and
the JAX reference on the CPU.

Four in-process ranks (``ThreadMesh``, a (1, 4) mesh) each hold one M
layer's leaves and cache as ``sharding.param_specs`` and ``cache_specs``
place them, and run a prefill of 40 tokens (a whole chunk of 32 and a
padded tail) from a non-zero cache, then two decode steps, the second
with row 1 frozen. Their outputs (the same on every rank) and their
cache shards, put back together, hold within 1e-5 (fp32) of the JAX
``mamba_block`` and ``mamba_decode`` and of the unsharded port. The
configs are cut so each branch of the layout runs:

- ``misaligned``: the reduced mamba2 (d_model 256, 16 heads of 32). Its
  in_proj's 1072 columns split in blocks of 268 (rank 1's straddles z and
  xBC), its 544 conv channels in blocks of 136 (rank 3's holds the tail
  of x and all of B and C), its heads in blocks of 4.
- ``heads_replicated``: d_model 96, so 6 heads (not a multiple of 4) and
  in_proj's 422 columns stay whole on every rank, while the 224 conv
  channels and out_proj's 192 rows still split.
- ``grouped``: the reduced mamba2 with 2 groups of B and C, each rank's 4
  heads reading the group they belong to.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import ThreadMesh  # noqa: E402
from repro_torch.launch.mesh import MeshLayout  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.sharding import cache_specs, make_pc, param_specs  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
LAYOUT = MeshLayout((1, 4), ("data", "model"))
B, S, CAP = 3, 40, 16
CASES = {"misaligned": {}, "heads_replicated": {"d_model": 96},
         "grouped": {"n_groups": 2}}


def _configs(case):
    """(port config, JAX config) of one case."""
    out = []
    for cfg in (get_config("mamba2-1.3b").reduced(),
                jax_get_config("mamba2-1.3b").reduced()):
        kw = dict(CASES[case])
        if "n_groups" in kw:
            kw["ssm"] = dataclasses.replace(cfg.ssm, n_groups=kw.pop(
                "n_groups"))
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX block's params (norm, conv_b and dt_bias given values), the
    inputs, the starting cache, and the JAX outputs and caches of the
    prefill and of each decode step (row 1 kept as it was at the second:
    the reference's ``gate``)."""
    cfg, cfg_j = _configs(case)
    p = jax.jit(lambda k: jssm.init_mamba(k, cfg_j, jnp.float32))(
        jax.random.PRNGKey(0))
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(3)
    p["norm"] = _rand(rng, *p["norm"].shape, scale=0.1)
    p["conv_b"] = _rand(rng, *p["conv_b"].shape, scale=0.1)
    p["dt_bias"] = _rand(rng, *p["dt_bias"].shape, scale=0.5)
    h = tssm.n_heads_of(cfg)
    cache = {"conv": _rand(rng, B, cfg.ssm.conv_kernel - 1,
                           tssm.conv_dim_of(cfg)),
             "state": _rand(rng, B, h, cfg.ssm.head_dim, cfg.ssm.d_state,
                            scale=0.1)}
    xs = [_rand(rng, B, S, cfg.d_model)] + [
        _rand(rng, B, 1, cfg.d_model) for _ in range(2)]
    y, c = jax.jit(lambda p, x, c: jssm.mamba_block(p, x, cfg_j, c))(
        p, xs[0], cache)
    outs, caches = [np.asarray(y)], [jax.tree.map(np.asarray, c)]
    decode = jax.jit(lambda p, x, c: jssm.mamba_decode(p, x, cfg_j, c))
    for i, x in enumerate(xs[1:]):
        y, new = decode(p, x, caches[-1])
        new = jax.tree.map(np.array, new)
        if i == 1:
            for name in new:
                new[name][1] = caches[-1][name][1]
        outs.append(np.asarray(y))
        caches.append(new)
    return p, xs, cache, outs, caches


def _layer_specs(cfg):
    """The one M layer's param and cache specs, without the count axis."""
    pspec = param_specs(cfg, LAYOUT)["segments"][0][0]["mamba"]
    cspec = cache_specs(cfg, LAYOUT, B, CAP)["segments"][0][0]
    return ({k: v[1:] for k, v in pspec.items()},
            {k: v[1:] for k, v in cspec.items()})


def _steps(cfg, p, xs, cache, pc=None):
    """The prefill and the two decode steps on ``cache`` (in place);
    returns each call's output and a copy of the cache after it."""
    mask = torch.tensor([True, False, True])
    outs = [tssm.mamba_block(p, xs[0], cfg, cache, pc=pc)]
    caches = [{k: v.clone() for k, v in cache.items()}]
    for i, x in enumerate(xs[1:]):
        outs.append(tssm.mamba_decode(p, x, cfg, cache,
                                      mask if i == 1 else None, pc=pc))
        caches.append({k: v.clone() for k, v in cache.items()})
    return outs, caches


def _whole(shards, spec):
    """A cache leaf from the ranks' shards: concatenated along its split
    dim, or rank 0's when it is whole."""
    dims = [i for i, e in enumerate(spec) if e == "model"]
    if not dims:
        return shards[0]
    return torch.cat(shards, dims[0])


@pytest.mark.parametrize("case", list(CASES))
def test_mamba_rank_program_matches_jax_and_the_unsharded_port(case):
    cfg, _ = _configs(case)
    p, xs, cache, want_outs, want_caches = _reference(case)
    pspec, cspec = _layer_specs(cfg)
    splits = {k: "model" in v for k, v in pspec.items()}
    want_splits = {"misaligned": dict(in_proj=True, conv_w=True,
                                      out_proj=True),
                   "heads_replicated": dict(in_proj=False, conv_w=True,
                                            out_proj=True),
                   "grouped": dict(in_proj=True, conv_w=True,
                                   out_proj=True)}[case]
    assert {k: splits[k] for k in want_splits} == want_splits
    assert ("model" in cspec["state"]) == (case != "heads_replicated")
    assert not any(splits[k] for k in ("norm", "A_log", "D", "dt_bias"))
    pt = bridge.to_torch(p, device="cpu")
    xt = [torch.from_numpy(x) for x in xs]
    plain_outs, plain_caches = _steps(cfg, pt, xt, bridge.to_torch(cache, device="cpu"))
    ct = bridge.to_torch(cache, device="cpu")

    def body(rm):
        ps = {k: bridge.shard_tensor(v, pspec[k], rm, rm.rank)
              for k, v in pt.items()}
        cs = {k: bridge.shard_tensor(v, cspec[k], rm, rm.rank)
              for k, v in ct.items()}
        return _steps(cfg, ps, xt, cs, pc=make_pc(cfg, rm, batch=B,
                                                  cap=CAP))

    res = ThreadMesh(LAYOUT, "cpu").run(body)
    for i in range(3):
        for outs, _ in res:
            np.testing.assert_allclose(outs[i].numpy(), want_outs[i],
                                       **FP32)
            np.testing.assert_allclose(outs[i].numpy(),
                                       plain_outs[i].numpy(), **FP32)
        for name, spec in cspec.items():
            got = _whole([caches[i][name] for _, caches in res], spec)
            np.testing.assert_allclose(got.numpy(), want_caches[i][name],
                                       **FP32)
            np.testing.assert_allclose(got.numpy(),
                                       plain_caches[i][name].numpy(), **FP32)


def test_an_m_layer_moves_its_named_collective_bytes():
    """One decode step of the misaligned layer on the thread transport
    moves what the layout names: the projection gathered (B x 1072 fp32),
    the conv output gathered (B x 544), the norm's sum of squares (B x 1)
    and out_proj's fp32 partial sums (B x 256), each a result's bytes on
    every rank."""
    cfg, _ = _configs("misaligned")
    p, xs, cache, _, _ = _reference("misaligned")
    pspec, cspec = _layer_specs(cfg)
    want = 4 * B * (1072 + 544 + 1 + cfg.d_model)

    pt, ct = bridge.to_torch(p, device="cpu"), bridge.to_torch(cache, device="cpu")

    def body(rm):
        ps = {k: bridge.shard_tensor(v, pspec[k], rm, rm.rank)
              for k, v in pt.items()}
        cs = {k: bridge.shard_tensor(v, cspec[k], rm, rm.rank)
              for k, v in ct.items()}
        tssm.mamba_decode(ps, torch.from_numpy(xs[1]), cfg, cs,
                          pc=make_pc(cfg, rm, batch=B, cap=CAP))
        return rm.collective_bytes

    assert ThreadMesh(LAYOUT, "cpu").run(body) == [want] * 4
