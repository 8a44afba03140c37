"""Shared machinery of the port's expert-parallel tests
(``test_torch_alltoall``, ``test_torch_ep_layer``,
``test_torch_distributed_serving``).

- ``jax_mesh_run``: the JAX references that need a 4-device host mesh run
  in ONE child process per test file (``XLA_FLAGS`` must be set before jax
  starts); the child reads its inputs from an npz file and writes its
  outputs to another.
- ``gloo_run``: one 4-rank ``torch.distributed`` run on the CPU (gloo,
  ``file://`` rendezvous under a temporary directory). Each rank calls one
  of the worker functions below, which import only torch, numpy and the
  port, and pickles what it returns.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4


def jax_mesh_run(body: str, tmp, inputs: dict, timeout: int = 300) -> dict:
    """Run ``body`` (python source; ``IN`` is the dict of ``inputs``,
    ``OUT`` a dict it fills with arrays) under jax on a host mesh of
    ``N_RANKS`` CPU devices. Returns ``OUT``."""
    src, dst = os.path.join(tmp, "jax_in.npz"), os.path.join(tmp, "jax_out.npz")
    np.savez(src, **inputs)
    code = ("import sys, numpy as np\n"
            "IN = dict(np.load(sys.argv[1]))\nOUT = {}\n"
            + textwrap.dedent(body)
            + "\nnp.savez(sys.argv[2], **OUT)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS}",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code, src, dst], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return dict(np.load(dst))


def _entry(rank, fn_name, init, args, out_dir):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = globals()[fn_name](*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def gloo_run(fn_name: str, tmp, *args) -> list:
    """``fn_name(*args)`` on each of ``N_RANKS`` gloo ranks (spawned
    processes); returns their results in rank order."""
    import torch.multiprocessing as mp
    os.makedirs(tmp, exist_ok=True)
    init = os.path.join(tmp, "rendezvous")
    mp.start_processes(_entry, args=(fn_name, init, args, tmp),
                       nprocs=N_RANKS, start_method="spawn")
    out = []
    for r in range(N_RANKS):
        with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# -- worker functions (run on every gloo rank) ---------------------------------

def exchange_worker(bufs, variants):
    """``ep_all_to_all`` of this rank's buffer under each named rounds
    variant (None: the monolithic all-to-all)."""
    import torch
    from repro_torch.distributed import DistGroup, ep_all_to_all
    group = DistGroup(device="cpu")
    mine = torch.from_numpy(bufs[group.rank])
    return {name: ep_all_to_all([mine], group, rounds)[0].numpy()
            for name, rounds in variants.items()}


def layer_worker(cases):
    """The EP layer (``ep_dispatch_combine``) on this rank for each named
    case: (inputs dict, ParallelContext fields, kernels flag, spec
    counts). Returns (y, aux, counts) per case."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed import DistGroup, ep_dispatch_combine
    from repro_torch.models import KernelConfig, ParallelContext
    from repro_torch.models.moe import ReplicationSpec
    group = DistGroup(device="cpu")
    out = {}
    for name, (inp, pc_kw, kernels, counts) in cases.items():
        moe = MoEConfig(n_experts=inp["router"].shape[1], top_k=2,
                        d_ff=inp["w_gate"].shape[-1],
                        capacity_factor=float(inp["cf"]))
        pc = ParallelContext(group=group, **pc_kw)
        experts = {k: torch.from_numpy(inp[k])
                   for k in ("w_gate", "w_up", "w_down")}
        y, aux, c = ep_dispatch_combine(
            torch.from_numpy(inp["x"]), torch.from_numpy(inp["router"]),
            experts, moe, "swiglu", pc, return_counts=True,
            kernels=KernelConfig() if kernels else None,
            spec=ReplicationSpec.from_counts(counts) if counts else None)
        out[name] = (y.numpy(), float(aux), c.numpy())
    return out


def engine_worker(cfg, weights, prompts, new, moe_impl, overlap):
    """A ``DistributedEngine`` over this rank's ``DistGroup``: every rank
    serves the same requests (``new`` tokens each, two arrivals per step);
    returns the greedy streams."""
    import torch  # noqa: F401
    from repro_torch import bridge
    from repro_torch.distributed import DistGroup
    from repro_torch.models import Model
    from repro_torch.serving import DistributedEngine, EngineConfig, Request
    eng = DistributedEngine(
        Model(cfg, device="cpu"), bridge.to_torch(weights, device="cpu"), batch_slots=2,
        cache_cap=32, group=DistGroup(device="cpu"), moe_impl=moe_impl,
        overlap=overlap,
        config=EngineConfig(prefill_len=8, kernels=True))
    reqs = [Request(prompt=list(p), max_new_tokens=new, arrival=float(i // 2))
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [list(map(int, r.out_tokens)) for r in reqs]


def square_loss_grads(inp, group, rounds, counts, overlap):
    """The grads of ``sum(y**2) + aux`` through ``ep_dispatch_combine``
    ("aurora" over ``rounds``, round robin when None; the pipeline when
    ``overlap``) with respect to x, the router and the expert leaves, in
    that order, from this process's held ranks. Each process seeds its
    backward with its share of the replicated loss (held ranks / n), so the
    grads summed over the processes are the layer's."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed import ep_dispatch_combine
    from repro_torch.models import ParallelContext
    from repro_torch.models.moe import ReplicationSpec
    moe = MoEConfig(n_experts=inp["router"].shape[1], top_k=2,
                    d_ff=inp["w_gate"].shape[-1],
                    capacity_factor=float(inp["cf"]))
    leaves = [torch.from_numpy(inp[k]).requires_grad_(True)
              for k in ("x", "router", "w_gate", "w_up", "w_down")]
    x, router, *ws = leaves
    experts = dict(zip(("w_gate", "w_up", "w_down"), ws))
    pc = ParallelContext(group=group, moe_impl="aurora",
                         aurora_rounds=rounds, ep_overlap=overlap)
    y, aux = ep_dispatch_combine(
        x, router, experts, moe, "swiglu", pc,
        spec=ReplicationSpec.from_counts(counts) if counts else None)
    loss = (y ** 2).sum() + aux
    share = len(group.ranks) / group.n
    return [g.numpy() for g in torch.autograd.grad(loss * share, leaves)]


def overlap_grads_worker(cases):
    """``square_loss_grads`` on this rank for each named case (inputs,
    rounds, replication counts, overlap flag)."""
    from repro_torch.distributed import DistGroup
    group = DistGroup(device="cpu")
    return {name: square_loss_grads(inp, group, rounds, counts, overlap)
            for name, (inp, rounds, counts, overlap) in cases.items()}
