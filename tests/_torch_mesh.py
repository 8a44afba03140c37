"""Shared machinery of the port's mesh-layout tests
(``test_torch_mesh_model``).

- ``rank_body``: one rank of the rank program (the reduced model's
  carried weights cut to this rank's shards, a prefill and greedy decode
  steps); it imports only torch, numpy and the port.
- ``assemble``: the global (B, S, V) logits from the ranks' rows (each
  batch shard's rows from its ``model``-index-0 rank).
- ``gloo_mesh_run``: ``rank_body`` on one gloo rank per mesh device
  (spawned processes, ``file://`` rendezvous, 60 s timeout), each over a
  ``DistMesh``.
"""

import os
import pickle

import numpy as np

B, PROMPT, CAP = 2, 8, 32


def rank_body(cfg, params_np, tokens, steps, rm, kernels=False):
    """This rank's logits of a prefill of ``tokens`` (B, PROMPT) and of
    ``steps`` greedy decode steps, and its rows' greedy stream."""
    import torch
    from repro_torch.bridge import shard_params, shard_tensor, to_torch
    from repro_torch.models import Model
    from repro_torch.sharding import input_sharding, make_pc, param_specs
    b = tokens.shape[0]
    model = Model(cfg, device="cpu",
                  pc=make_pc(cfg, rm, batch=b, cap=CAP)).with_kernels(kernels)
    params = shard_params(to_torch(params_np), param_specs(cfg, rm), rm,
                          rm.rank)
    cache = model.init_cache(b, CAP)
    toks = shard_tensor(torch.from_numpy(tokens),
                        input_sharding(cfg, rm, b), rm, rm.rank)
    logits, _ = model.prefill(params, {"tokens": toks}, cache)
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


def _entry(rank, world, init, out_dir, args):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from repro_torch.distributed import DistMesh
        from repro_torch.launch.mesh import MeshLayout
        shape, axes, cfg, params_np, tokens, steps = args
        res = rank_body(cfg, params_np, tokens, steps,
                        DistMesh(MeshLayout(shape, axes)))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def gloo_mesh_run(tmp, layout, cfg, params_np, tokens, steps) -> list:
    """``rank_body`` on ``layout.size`` gloo ranks; results in rank order."""
    import torch.multiprocessing as mp
    os.makedirs(tmp, exist_ok=True)
    init = os.path.join(tmp, "rendezvous")
    mp.start_processes(
        _entry, args=(layout.size, init, tmp,
                      (layout.dims, layout.axis_names, cfg, params_np,
                       tokens, steps)),
        nprocs=layout.size, start_method="spawn")
    out = []
    for r in range(layout.size):
        with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
