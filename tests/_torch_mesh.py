"""Shared machinery of the port's mesh-layout tests
(``test_torch_mesh_model``).

- ``rank_body``: one rank of the rank program (the reduced model's
  carried weights cut to this rank's shards, a prefill of this rank's
  rows of the inputs, the tokens and an encoder-decoder's ``SRC``
  frames, and greedy decode steps); it imports only torch, numpy and the
  port.
- ``assemble``: the global (B, S, V) logits from the ranks' rows (each
  batch shard's rows from its ``model``-index-0 rank).
- ``train_rank_body``: one rank of the sharded train step's loss and
  grads (``test_torch_mesh_train_ranks``), and ``ep_layer_grads``, one
  process's grads through ``ep_dispatch_combine`` over an EP group.
- ``gloo_mesh_run``: ``rank_body`` on one gloo rank per mesh device
  (spawned processes, ``file://`` rendezvous, 60 s timeout), each over a
  ``DistMesh``; ``gloo_run`` any such body.
"""

import os
import pickle

import numpy as np

B, PROMPT, CAP = 2, 8, 32
EP_IMPLS = ("ep", "aurora", "overlap")
# An encoder-decoder's source frames: 6 splits over a model axis of 2
# but not of 4, so the cross K/V runs both as sequence shards and whole.
SRC = 6


def rank_body(cfg, params_np, inputs, steps, rm, kernels=False):
    """This rank's logits of a prefill of ``inputs`` ({"tokens": (B,
    PROMPT)}, and "frames" (B, SRC, frontend_dim) for an encoder-decoder)
    and of ``steps`` greedy decode steps, and its rows' greedy stream."""
    import torch
    from repro_torch.bridge import shard_params, shard_tensor, to_torch
    from repro_torch.models import Model
    from repro_torch.sharding import input_sharding, make_pc, param_specs
    b = inputs["tokens"].shape[0]
    src = inputs["frames"].shape[1] if "frames" in inputs else 0
    model = Model(cfg, device="cpu", pc=make_pc(
        cfg, rm, batch=b, cap=CAP, src_len=src)).with_kernels(kernels)
    params = shard_params(to_torch(params_np, device="cpu"), param_specs(cfg, rm), rm,
                          rm.rank)
    cache = model.init_cache(b, CAP, src_len=src)
    spec = input_sharding(cfg, rm, b)
    logits, _ = model.prefill(params, {
        k: shard_tensor(torch.from_numpy(v), spec, rm, rm.rank)
        for k, v in inputs.items()}, cache)
    out = [logits.numpy()]
    tok = logits[:, -1:, :cfg.vocab].argmax(-1)
    stream = [tok]
    for _ in range(steps):
        logits, _ = model.decode_step(params, tok, cache)
        out.append(logits.numpy())
        tok = logits[:, :, :cfg.vocab].argmax(-1)
        stream.append(tok)
    return out, torch.cat(stream, 1).numpy(), rm.collective_bytes


def assemble(layout, cfg, per_rank, b):
    """Global arrays from per-rank row blocks: ``per_rank[r]`` is rank r's
    list of arrays (rows first)."""
    from repro_torch.sharding import batch_axes_for
    ax = batch_axes_for(layout, b)
    rows = {}
    for r, arrays in enumerate(per_rank):
        if layout.coords(r)["model"] == 0:
            rows.setdefault(layout.axis_index(r, ax) if ax else 0, arrays)
    return [np.concatenate([rows[k][i] for k in sorted(rows)])
            for i in range(len(per_rank[0]))]


def _ep_pc(impl: str) -> dict:
    """The ``ParallelContext`` fields of an EP exchange: "ep", "aurora", or
    "overlap" (Aurora's rounds through the round-pipelined body)."""
    return {"moe_impl": "aurora" if impl == "overlap" else impl,
            "ep_overlap": impl == "overlap"}


def train_rank_body(cfg, params_np, batch_np, rm, impl="ep"):
    """This rank's sharded train loss and grads (numpy leaves) of
    ``batch_np`` (the global batch), with remat, over ``rm`` (``impl``:
    an ``_ep_pc`` name)."""
    import dataclasses

    import torch
    from repro_torch.bridge import (shard_params, shard_tensor, to_numpy,
                                    to_torch)
    from repro_torch.models import Model
    from repro_torch.sharding import input_sharding, make_pc, param_specs
    from repro_torch.training.loop import loss_and_grads, make_loss_fn
    b, s = batch_np["tokens"].shape
    kw = _ep_pc(impl)
    model = Model(cfg, device="cpu", pc=dataclasses.replace(
        make_pc(cfg, rm, kw["moe_impl"], batch=b, cap=s),
        ep_overlap=kw["ep_overlap"]))
    specs = param_specs(cfg, rm)
    params = shard_params(to_torch(params_np, device="cpu"), specs, rm, rm.rank)
    spec = input_sharding(cfg, rm, b)
    batch = {k: shard_tensor(torch.from_numpy(v), spec, rm, rm.rank)
             for k, v in batch_np.items()}
    loss, _, grads = loss_and_grads(make_loss_fn(model), params, batch, rm,
                                    specs)
    return float(loss), to_numpy(grads), rm.collective_bytes


def ep_layer_grads(cfg, p_np, x_np, w_np, group, impl):
    """The grads of ``(y * w).sum() + aux`` through ``ep_dispatch_combine``
    over ``group`` with respect to the tokens, the router and the expert
    leaves, from this process's held ranks: each process seeds its
    backward with 1/n of its loss (the copies of the replicated loss
    summed once), so the grads summed over the processes are the
    layer's."""
    import torch
    from repro_torch.distributed.alltoall import ep_dispatch_combine
    from repro_torch.models import ParallelContext
    xt = torch.from_numpy(x_np).requires_grad_(True)
    router = torch.from_numpy(p_np["router"]).requires_grad_(True)
    experts = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in p_np["experts"].items()}
    pc = ParallelContext(group=group, **_ep_pc(impl))
    y, aux = ep_dispatch_combine(xt, router, experts, cfg.moe, cfg.act, pc)
    loss = (y * torch.from_numpy(w_np)).sum() + aux
    held = len(group.ranks)
    leaves = [xt, router, *experts.values()]
    return [g.numpy() for g in torch.autograd.grad(
        loss * held / group.n, leaves)]


def _entry(rank, world, init, out_dir, body, args):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = body(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _serve_body(shape, axes, cfg, params_np, inputs, steps):
    from repro_torch.distributed import DistMesh
    from repro_torch.launch.mesh import MeshLayout
    return rank_body(cfg, params_np, inputs, steps,
                     DistMesh(MeshLayout(shape, axes), "cpu"))


def gloo_run(tmp, world: int, body, args) -> list:
    """``body(*args)`` on ``world`` gloo ranks (spawned processes; ``body``
    a module-level function); results in rank order."""
    import torch.multiprocessing as mp
    os.makedirs(tmp, exist_ok=True)
    init = os.path.join(tmp, "rendezvous")
    mp.start_processes(_entry, args=(world, init, tmp, body, args),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def gloo_mesh_run(tmp, layout, cfg, params_np, inputs, steps) -> list:
    """``rank_body`` on ``layout.size`` gloo ranks; results in rank order."""
    return gloo_run(tmp, layout.size, _serve_body,
                    (layout.dims, layout.axis_names, cfg, params_np, inputs,
                     steps))


def gloo_train_body(shape, axes, cfg, params_np, batch_np, layer, ck):
    """One gloo rank of ``test_torch_mesh_train_ranks``: the sharded train
    loss and grads under each of ``EP_IMPLS`` over a ``DistMesh``, its
    shards of ``params_np`` saved whole to ``ck``, and ``ep_layer_grads``
    over the world as a ``DistGroup`` (``layer``: (params, tokens,
    weights) numpy)."""
    from repro_torch.bridge import shard_params, to_torch
    from repro_torch.distributed import DistGroup, DistMesh
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.sharding import param_specs
    from repro_torch.training import save_checkpoint
    rm = DistMesh(MeshLayout(shape, axes), "cpu")
    out = {}
    for impl in EP_IMPLS:
        rm.collective_bytes = 0
        out[impl] = train_rank_body(cfg, params_np, batch_np, rm, impl)
    specs = param_specs(cfg, rm)
    save_checkpoint(ck, shard_params(to_torch(params_np, device="cpu"), specs, rm,
                                     rm.rank), step=0, shardings=(specs, rm))
    out["layer"] = {impl: ep_layer_grads(cfg, *layer,
                                         DistGroup(device="cpu"), impl)
                    for impl in EP_IMPLS}
    return out
