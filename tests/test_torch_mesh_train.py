"""Sharded training on the port's mesh rank program, against the JAX
reference on the CPU.

The reference is ``jax.value_and_grad`` of the JAX ``make_loss_fn`` on the
unsharded JAX ``Model`` (dense dispatch), from the port's seeded weights
carried across with numpy, on a numpy-seeded batch of 4 x 16 tokens (and
8 frames a row for SeamlessM4T). The MoE configs take a capacity factor
of E, so no token is dropped either way (a rank's capacity is sized on
its own token slice). The reference's EP layer averages the load-balance
loss of each rank's token shard (``pmean``; the port's ``ep_mean``),
where the unsharded dense layer takes it over the whole batch: so for
the MoE archs the reference runs with the JAX ``route``'s aux taken as
the mean over the mesh's contiguous token shards (``_sharded_aux``), the
value the reference's ``moe_apply_ep`` computes.

- The ten reduced archs at (1, 4) and (2, 2) on ``ThreadMesh`` with remat:
  the loss within 1e-5 relative and every grad leaf, reassembled by
  ``bridge.unshard_params``, within 1e-5 + 1e-4 x its largest magnitude;
  phi3.5-MoE and DeepSeek-V3 under "aurora" as well as "ep".
- phi3.5-MoE under Aurora's rounds through the round-pipelined EP body
  (``ep_overlap``) at (1, 4) and (2, 2) with remat: the loss and grads
  within 1e-5 of the synchronous body's, and of JAX's as above.
- One ``make_train_step`` on (2, 2) against JAX's unsharded step: updated
  params and AdamW moments, the clip active.
- Three planted faults (a grad reduction that skips ``data``, an
  ``all_gather`` whose backward slices where the convention sums, AdamW's
  norm summing a replicated leaf over its replicas) each put a leaf past
  the tolerance.
- A checkpoint saved from (2, 2) restores exactly into the unsharded
  port, into JAX's ``restore_checkpoint`` and back into the (2, 2) shards.

The gloo transport against the thread transport, the EP exchanges over a
``LocalGroup``, ``train_loop`` on a mesh and the dry run's train
reckoning are in ``test_torch_mesh_train_ranks.py``.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge, training  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import ThreadMesh  # noqa: E402
from repro_torch.distributed import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import MeshLayout  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.sharding import (ep_axes_for, input_sharding,  # noqa: E402
                                  make_pc, param_specs, rules)
from repro_torch.training import loop  # noqa: E402

B, S, SRC = 4, 16, 8
MESHES = ((1, 4), (2, 2))
CASES = [(a, m) for a in ARCH_IDS for m in MESHES]
EP_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
MOE = EP_ARCHS[0]
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def _cfgs(arch):
    return (_no_drop(get_config(arch).reduced()),
            _no_drop(jax_get_config(arch).reduced()))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The port's seeded params (seed 0) as numpy leaves."""
    return bridge.to_numpy(init_params(_cfgs(arch)[0], 0, "cpu"))


@functools.lru_cache(maxsize=None)
def _batch(arch):
    cfg = _cfgs(arch)[0]
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, SRC, cfg.frontend_dim)).astype(np.float32)
    return batch


def _sharded_aux(n: int):
    """The JAX ``route`` with its aux loss taken as the mean over ``n``
    contiguous token shards (the reference EP's ``pmean``); gates and
    expert choices are the whole batch's."""
    route = jmoe.route

    def sharded(router_w, x, moe):
        gates, idx, _ = route(router_w, x, moe)
        aux = jnp.mean(jnp.stack([route(router_w, c, moe)[2]
                                  for c in jnp.split(x, n)]))
        return gates, idx, aux
    return sharded


def _jax_run(arch, fn):
    """``fn()`` under the EP aux of a 4-rank mesh when the arch's experts
    shard over it (both test meshes have 4 ranks)."""
    cfg = _cfgs(arch)[0]
    with pytest.MonkeyPatch.context() as mp:
        if ep_axes_for(cfg, MeshLayout((2, 2), ("data", "model"))):
            mp.setattr(jmoe, "route", _sharded_aux(4))
        return fn()


# XLA's CPU backend at its lowest optimisation level: the references
# compile ~35 % faster (the file runs within its minute on one worker).
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """JAX's unsharded (loss, grads) as numpy."""
    model = JaxModel(_cfgs(arch)[1])
    params = jax.tree.map(jnp.asarray, _weights(arch))
    batch = jax.tree.map(jnp.asarray, _batch(arch))
    vg = jax.value_and_grad(jtraining.loop.make_loss_fn(model), has_aux=True)
    (loss, _), grads = _jax_run(arch, lambda: _compiled(vg, params, batch))
    return float(loss), jax.tree.map(np.asarray, grads)


def _ratio(got, want) -> float:
    """The worst leaf's error over its bound, 1e-5 + 1e-4 x max|leaf|."""
    worst = 0.0
    got, want = bridge.tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape
        tol = 1e-5 + 1e-4 * float(np.abs(w).max(initial=0.0))
        worst = max(worst, float(np.abs(g - w).max(initial=0.0)) / tol)
    return worst


def _rank_setup(arch, rm, impl="ep", overlap=False):
    """(model, specs, params, batch) of one rank: its shards of the
    carried weights and of the batch. ``overlap``: the EP layer runs the
    round-pipelined body."""
    cfg = _cfgs(arch)[0]
    model = Model(cfg, device="cpu", pc=dataclasses.replace(
        make_pc(cfg, rm, impl, batch=B, cap=S), ep_overlap=overlap))
    pspecs = param_specs(cfg, rm)
    params = bridge.shard_params(bridge.to_torch(_weights(arch), device="cpu"), pspecs,
                                 rm, rm.rank)
    spec = input_sharding(cfg, rm, B)
    batch = {k: bridge.shard_tensor(torch.from_numpy(v), spec, rm, rm.rank)
             for k, v in _batch(arch).items()}
    return model, pspecs, params, batch


def _sharded_grads(arch, shape, impl="ep", overlap=False):
    """Every rank's loss and the grads reassembled from their shards."""
    layout = MeshLayout(shape, ("data", "model"))

    def body(rm):
        model, pspecs, params, batch = _rank_setup(arch, rm, impl, overlap)
        loss, _, grads = loop.loss_and_grads(loop.make_loss_fn(model),
                                             params, batch, rm, pspecs)
        return float(loss), grads

    res = ThreadMesh(layout, "cpu").run(body)
    grads = bridge.unshard_params([g for _, g in res],
                                  param_specs(_cfgs(arch)[0], layout),
                                  layout)
    return [lo for lo, _ in res], grads


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in CASES])
def test_sharded_loss_and_grads_match_jax(arch, shape):
    want_loss, want = _reference(arch)
    losses, grads = _sharded_grads(arch, shape)
    assert len(set(losses)) == 1            # every rank the global loss
    assert abs(losses[0] - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert _ratio(grads, want) <= 1.0


@pytest.mark.parametrize("arch,shape", [(a, m) for a in EP_ARCHS
                                        for m in MESHES])
def test_aurora_rounds_train_like_the_all_to_all(arch, shape):
    want_loss, want = _reference(arch)
    losses, grads = _sharded_grads(arch, shape, "aurora")
    assert abs(losses[0] - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert _ratio(grads, want) <= 1.0


def _ratio_strict(got, want) -> float:
    """The worst leaf's error over 1e-5 + 1e-5 x its largest magnitude."""
    worst = 0.0
    for g, w in zip(bridge.tree_leaves(got), bridge.tree_leaves(want),
                    strict=True):
        tol = 1e-5 + 1e-5 * float(w.abs().max())
        worst = max(worst, float((g - w).abs().max()) / tol)
    return worst


@pytest.mark.parametrize("shape", MESHES)
def test_pipelined_rounds_train_like_the_synchronous_body(shape):
    """phi3.5-MoE's sharded step with remat under Aurora's rounds through
    the round-pipelined EP body: the loss and every grad leaf within 1e-5
    (+ 1e-5 x the leaf's largest magnitude) of the synchronous body's,
    and within the file's tolerance of JAX's."""
    sync_losses, sync = _sharded_grads(MOE, shape, "aurora")
    losses, grads = _sharded_grads(MOE, shape, "aurora", overlap=True)
    assert len(set(losses)) == 1
    assert abs(losses[0] - sync_losses[0]) <= 1e-5 * abs(sync_losses[0])
    assert _ratio_strict(grads, sync) <= 1.0
    want_loss, want = _reference(MOE)
    assert abs(losses[0] - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert _ratio(grads, want) <= 1.0


# -- one train step -------------------------------------------------------------

CLIP = training.AdamWConfig(grad_clip=0.5)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's unsharded train step from zero moments (its
    ``make_train_step`` is ``value_and_grad`` then ``adamw_update``: the
    update applied to ``_reference``'s grads), and the grads' global norm
    (which the clip must exceed)."""
    jcfg = jtraining.AdamWConfig(grad_clip=CLIP.grad_clip)
    params = jax.tree.map(jnp.asarray, _weights(MOE))
    grads = jax.tree.map(jnp.asarray, _reference(MOE)[1])
    p, opt = _compiled(lambda p_, g_, o_: jtraining.adamw_update(
        p_, g_, o_, jcfg), params, grads, jtraining.adamw_init(params, jcfg))
    gnorm = math.sqrt(sum(float(np.sum(np.square(g)))
                          for g in jax.tree.leaves(_reference(MOE)[1])))
    return jax.tree.map(np.asarray, (p, opt["m"], opt["v"])), gnorm


def _sharded_step():
    layout = MeshLayout((2, 2), ("data", "model"))

    def body(rm):
        model, _, params, batch = _rank_setup(MOE, rm)
        step = loop.make_train_step(model, CLIP)
        params, opt, _ = step(params, training.adamw_init(params, CLIP),
                              batch)
        return params, opt["m"], opt["v"]

    res = ThreadMesh(layout, "cpu").run(body)
    pspecs = param_specs(_cfgs(MOE)[0], layout)
    return [bridge.unshard_params([r[i] for r in res], pspecs, layout)
            for i in range(3)]


def test_train_step_matches_jax_step():
    want, gnorm = _jax_step()
    assert gnorm > CLIP.grad_clip                    # the clip is active
    for got, w in zip(_sharded_step(), want):
        assert _ratio(got, w) <= 1.0


def _skip_data(spec, mesh):
    return tuple(a for a in rules.replica_axes(spec, mesh) if a != "data")


def _sliced_gather_backward(ctx, *gs):
    """The transpose of another convention (each member's grad whole):
    a slice of its own grad, no sum over the members."""
    return (None, None, None) + tuple(g.chunk(len(gs), ctx.dim)[i]
                                      for i, g in enumerate(gs))


@pytest.mark.parametrize("fault", ["skip_data_reduction",
                                   "gather_backward_slices",
                                   "norm_counts_replicas"])
def test_planted_faults_fail_the_tolerance(fault, monkeypatch):
    if fault == "skip_data_reduction":
        monkeypatch.setattr(loop, "replica_axes", _skip_data)
    elif fault == "gather_backward_slices":
        monkeypatch.setattr(mesh_mod._AllGather, "backward",
                            staticmethod(_sliced_gather_backward))
    else:
        monkeypatch.setattr(training.optim, "split_axes",
                            lambda spec: ("data", "model"))
    if fault == "norm_counts_replicas":
        want, _ = _jax_step()
        worst = max(_ratio(g, w) for g, w in zip(_sharded_step(), want))
    else:
        _, grads = _sharded_grads(MOE, (2, 2))
        worst = _ratio(grads, _reference(MOE)[1])
    assert worst > 1.0, fault


# -- checkpoints ------------------------------------------------------------------

def test_sharded_checkpoint_round_trip(tmp_path):
    """A state saved from (2, 2) after one step: the files hold the whole
    leaves (equal to the reassembled shards, for the port and for JAX's
    ``restore_checkpoint``), and restoring with ``shardings`` gives each
    rank its shards back exactly."""
    layout = MeshLayout((2, 2), ("data", "model"))
    path = str(tmp_path / "ck")

    def body(rm):
        model, pspecs, params, batch = _rank_setup(MOE, rm)
        opt_cfg = training.AdamWConfig()
        params, opt, _ = loop.make_train_step(model, opt_cfg)(
            params, training.adamw_init(params, opt_cfg), batch)
        state = {"params": params, "opt": opt}
        sspecs = {"params": pspecs,
                  "opt": {"m": pspecs, "v": pspecs, "step": ()}}
        training.save_checkpoint(path, state, step=1, shardings=(sspecs, rm))
        rm.all_reduce(torch.zeros(2), ("data", "model"))  # the file is out
        like = {"params": init_params(model.cfg, 0, "meta"),
                "opt": {"m": init_params(model.cfg, 0, "meta"),
                        "v": init_params(model.cfg, 0, "meta"),
                        "step": torch.zeros((), dtype=torch.int32)}}
        like = bridge.map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                               like)
        back = training.restore_checkpoint(path, like,
                                           shardings=(sspecs, rm))
        same = all(torch.equal(a, b) for a, b in zip(
            bridge.tree_leaves(state), bridge.tree_leaves(back)))
        return state, same, like

    res = ThreadMesh(layout, "cpu").run(body)
    assert all(same for _, same, _ in res)
    pspecs = param_specs(_cfgs(MOE)[0], layout)
    sspecs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                        "step": ()}}
    whole = bridge.unshard_params([s for s, _, _ in res], sspecs, layout)
    assert training.checkpoint_step(path) == 1
    port = training.restore_checkpoint(path, res[0][2])
    for a, b in zip(bridge.tree_leaves(port), bridge.tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jax_back = jtraining.restore_checkpoint(
        path, jax.tree.map(np.asarray, bridge.to_numpy(whole)))
    for a, b in zip(jax.tree.leaves(jax_back), bridge.tree_leaves(whole)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
