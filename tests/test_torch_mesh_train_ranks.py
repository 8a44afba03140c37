"""Sharded training over the transports, without JAX, on the CPU.

- Four gloo ranks (``DistMesh``, spawned as ``tests/_torch_mesh.py``
  does, one spawn for every check) run the reduced phi3.5-MoE's sharded
  train step on a (2, 2) mesh with remat, under "ep", "aurora" and
  Aurora's rounds through the round-pipelined body ("overlap"): their
  loss, their grads reassembled by ``bridge.unshard_params`` (within
  1e-6) and each rank's collective bytes (exactly) equal the
  ``ThreadMesh`` ranks'. They save their shards of the weights with
  ``shardings``, which gathers each leaf over gloo: the file holds the
  whole weights, exactly. Over the world as a ``DistGroup`` the EP
  layer's grads (``ep_dispatch_combine``: the exchanges', ``ep_all_gather``'s
  and ``ep_mean``'s backward over gloo), summed over the processes, equal
  one ``LocalGroup`` process's within 1e-6 of each leaf's largest
  magnitude (at least 1).
- The EP exchanges' grads over a ``LocalGroup`` equal the dense layer's;
  ``train_loop`` on (2, 2) equals the unsharded loop; the dry run's train
  reckoning of the EP rounds equals rank 0's traced exchanges, through
  the synchronous and the round-pipelined body.

The rank program's loss and grads against JAX are in
``test_torch_mesh_train.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import ep_layer_grads, gloo_run, gloo_train_body, \
    train_rank_body  # noqa: E402
from repro_torch import bridge, training  # noqa: E402
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.distributed import CountingMesh, LocalGroup, \
    ThreadMesh  # noqa: E402
from repro_torch.distributed.alltoall import ep_dispatch_combine  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import MeshLayout  # noqa: E402
from repro_torch.models import Model, ParallelContext  # noqa: E402
from repro_torch.models.moe import moe_apply_dense, route  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.sharding import input_sharding, make_pc, \
    param_specs  # noqa: E402
from repro_torch.training import loop  # noqa: E402

B, S = 4, 16
MESHES = ((1, 4), (2, 2))
ARCH = "phi3.5-moe-42b-a6.6b"
LAYOUT = MeshLayout((2, 2), ("data", "model"))
IMPLS = ("ep", "aurora", "overlap")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    """The reduced config with a capacity factor of E (no drops)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def _weights(arch):
    return bridge.to_numpy(init_params(_cfg(arch), 0, "cpu"))


def _rank_setup(arch, rm):
    """(model, specs, params, batch) of one rank: its shards of the
    weights and of ``_inputs``' batch."""
    cfg = _cfg(arch)
    model = Model(cfg, device="cpu", pc=make_pc(cfg, rm, batch=B, cap=S))
    pspecs = param_specs(cfg, rm)
    params = bridge.shard_params(bridge.to_torch(_weights(arch), device="cpu"), pspecs,
                                 rm, rm.rank)
    tokens = torch.from_numpy(_inputs()[2]["tokens"])
    batch = {"tokens": bridge.shard_tensor(
        tokens, input_sharding(cfg, rm, B), rm, rm.rank)}
    return model, pspecs, params, batch


def _inputs():
    cfg = _cfg(ARCH)
    params = _weights(ARCH)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
    moe = params["segments"][0][0]["moe"]
    layer = ({"router": moe["router"][0],
              "experts": {k: v[0] for k, v in moe["experts"].items()}},
             rng.standard_normal((30, cfg.d_model)).astype(np.float32),
             rng.standard_normal((30, cfg.d_model)).astype(np.float32))
    return cfg, params, batch, layer


def test_gloo_ranks_train_as_the_thread_ranks(tmp_path):
    cfg, params, batch, layer = _inputs()
    ck = str(tmp_path / "ck")
    gloo = gloo_run(str(tmp_path / "gloo"), LAYOUT.size, gloo_train_body,
                    (LAYOUT.dims, LAYOUT.axis_names, cfg, params, batch,
                     layer, ck))
    specs = param_specs(cfg, LAYOUT)
    for impl in IMPLS:
        thread = ThreadMesh(LAYOUT, "cpu").run(
            lambda rm, impl=impl: train_rank_body(cfg, params, batch, rm,
                                                  impl))
        got = [r[impl] for r in gloo]
        assert [g[0] for g in got] == pytest.approx(
            [t[0] for t in thread], rel=1e-6)
        assert [g[2] for g in got] == [t[2] for t in thread]
        whole = [bridge.to_torch(bridge.unshard_params(
            [bridge.to_torch(r[1], device="cpu") for r in res], specs,
            LAYOUT), device="cpu")
            for res in (got, thread)]
        for a, b in zip(bridge.tree_leaves(whole[0]),
                        bridge.tree_leaves(whole[1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        want = ep_layer_grads(cfg, *layer, LocalGroup(4, "cpu"), impl)
        summed = [sum(parts) for parts in
                  zip(*(r["layer"][impl] for r in gloo))]
        for a, b in zip(summed, want):       # sums in another order
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-6 * max(1.0, np.abs(b).max()))
    back = training.restore_checkpoint(
        ck, bridge.map_tree(torch.zeros_like, bridge.to_torch(params, device="cpu")))
    for a, b in zip(bridge.tree_leaves(back),
                    bridge.tree_leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_train_loop_on_a_mesh_matches_the_unsharded_loop():
    """``train_loop`` on (2, 2), every rank fed the same data stream and
    cutting its rows by ``input_sharding``: 3 steps of qwen3-32b (lr
    1e-3, warmup 2) equal the port's unsharded loop (held against JAX in
    ``test_torch_training``): metrics within 1e-4 relative at each step
    (each step's loss is taken at the params the last one left), and
    every replicated block of the params bit-identical over its ranks at
    the end."""
    arch = "qwen3-32b"
    cfg = _cfg(arch)
    opt = training.AdamWConfig(lr=1e-3, warmup_steps=2)

    def data():
        return training.SyntheticLMData(cfg.vocab, seq_len=S, batch=B,
                                        seed=2)

    state, want = training.train_loop(
        Model(cfg, device="cpu"), data(), steps=3, opt_cfg=opt, log_every=1,
        params=bridge.to_torch(_weights(arch), device="cpu"))
    layout = MeshLayout((2, 2), ("data", "model"))

    def body(rm):
        model = Model(cfg, device="cpu", pc=make_pc(cfg, rm, batch=B, cap=S))
        params = bridge.shard_params(bridge.to_torch(_weights(arch), device="cpu"),
                                     param_specs(cfg, rm), rm, rm.rank)
        return training.train_loop(model, data(), steps=3, opt_cfg=opt,
                                   log_every=1, params=params)

    res = ThreadMesh(layout, "cpu").run(body)
    for mesh_state, got in res:
        assert mesh_state.step == 3 and int(mesh_state.opt["step"]) == 3
        for g, w in zip(got, want):
            for k in ("ce", "aux", "loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4)
    # The replicas of every block stay bit-identical over the steps.
    specs_l = bridge.spec_leaves(state.params, param_specs(cfg, layout))
    leaves = [bridge.tree_leaves(st.params) for st, _ in res]
    for i, spec in enumerate(specs_l):
        blocks = {}
        for r in range(layout.size):
            at = tuple(layout.axis_index(r, e) if e else 0 for e in spec)
            blocks.setdefault(at, []).append(leaves[r][i])
        for copies in blocks.values():
            assert all(torch.equal(copies[0], c) for c in copies[1:])




# -- the EP exchanges, the pipeline, the dry run ---------------------------------

@pytest.mark.parametrize("impl", ["ep", "aurora"])
def test_local_group_exchange_grads_equal_the_dense_layer(impl):
    """``ep_dispatch_combine`` over 4 in-process ranks: the grads of a
    weighted sum of its output (the exchanges' and ``ep_all_gather``'s
    transposes) equal the dense layer's, and ``ep_mean``'s grad reaches
    the router as the mean of the ranks' aux."""
    cfg = _cfg(ARCH)
    torch.manual_seed(0)
    p = bridge.to_torch(_weights(ARCH), device="cpu")["segments"][0][0]["moe"]
    p = {"router": p["router"][0], "experts": {k: v[0] for k, v in
                                               p["experts"].items()}}
    xt = torch.randn(30, cfg.d_model)
    w = torch.randn(30, cfg.d_model)
    pc = ParallelContext(group=LocalGroup(4, "cpu"), moe_impl=impl)

    def grads(fn):
        leaves = [xt, p["router"], *p["experts"].values()]
        for t in leaves:
            t.requires_grad_(True)
        y, aux = fn()
        out = torch.autograd.grad((y * w).sum(), leaves, retain_graph=True)
        g_aux = torch.autograd.grad(aux, p["router"])[0]
        for t in leaves:
            t.requires_grad_(False)
        return out, g_aux

    got, g_aux = grads(lambda: ep_dispatch_combine(
        xt, p["router"], p["experts"], cfg.moe, cfg.act, pc))
    want, _ = grads(lambda: moe_apply_dense(p, xt, cfg.moe, cfg.act))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)
    def mean_aux():                  # T padded to 32: rank 3 routes 2 pads
        x = torch.nn.functional.pad(xt, (0, 0, 0, 2))
        return sum(route(p["router"], c, cfg.moe)[2]
                   for c in x.chunk(4)) / 4
    p["router"].requires_grad_(True)
    want_aux = torch.autograd.grad(mean_aux(), p["router"])[0]
    p["router"].requires_grad_(False)
    torch.testing.assert_close(g_aux, want_aux, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sync", "overlap"])
@pytest.mark.parametrize("shape", MESHES)
def test_train_reckoning_equals_the_traced_exchanges(shape, overlap):
    """``dryrun.collective_bytes`` of a train step (the EP rounds, forward
    and backward) equals the exchange bytes of rank 0's traced rank
    program on a (1, 4) and a (2, 2) mesh under Aurora's rounds (the
    rounds move what the reckoning counts: no self-traffic), through the
    synchronous body and through the round-pipelined one (the same
    rounds, each chunk moved once each way)."""
    cfg = _cfg(ARCH)
    layout = MeshLayout(shape, ("data", "model"))
    train = InputShape("t_train", S, B, "train")
    _, args, _ = specs.lowering_args(cfg, train, layout)
    rm = CountingMesh(layout)
    model = Model(cfg, device="meta", pc=dataclasses.replace(
        make_pc(cfg, rm, "aurora", batch=B, cap=S), ep_overlap=overlap))
    dryrun.trace_step(loop.make_train_step(model, specs.opt_config_for(cfg)),
                      args)
    assert rm.exchange_bytes == dryrun.collective_bytes(cfg, train, 4) > 0
