"""The backward of the port's round-pipelined EP body against JAX's grad,
on the CPU.

The reference is ``jax.jit(jax.grad(...))`` of ``sum(y**2) + aux`` through
the JAX ``ep_dispatch_combine`` with ``ep_overlap=True`` (its software
pipeline over permutation rounds), on a 4-device host mesh in one child
process, with respect to x, the router, w_gate, w_up and w_down. Three
cases of ``test_torch_ep_layer``: capacity factor 8.0 over round robin,
1.0 over Aurora's partial rounds (drops), and 1.0 with a hot-expert
replication (4 logical experts as 8 physical). The port's pipelined grads
on ``LocalGroup(4, "cpu")`` and on 4 gloo ranks (``DistGroup``, their
grads summed over the processes) lie within 1e-5 + 1e-5 x each leaf's
largest magnitude of JAX's, and of the port's synchronous-body grads. A
round whose backward re-sends the grads through its forward round instead
of its transpose fails that check.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import LocalGroup  # noqa: E402
from repro_torch.distributed import overlap  # noqa: E402
from repro_torch.distributed.group import inverse_round  # noqa: E402

from _torch_ep import (N_RANKS, gloo_run, jax_mesh_run,  # noqa: E402
                       square_loss_grads)
from test_torch_ep_layer import COUNTS, _inputs, _rounds  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEAVES = ("x", "router", "w_gate", "w_up", "w_down")
# name -> (inputs, rounds (None: round robin), replication counts)
CASES = {
    "cf8_round_robin": (_inputs(8, 8, 8.0, 0), None, None),
    "cf1_aurora": (_inputs(8, 8, 1.0, 0), _rounds(), None),
    "cf1_replicated": (_inputs(4, 8, 1.0, 1), _rounds(), COUNTS),
}

_JAX_GRADS = """
import json
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs.base import MoEConfig
from repro.distributed.alltoall import ep_dispatch_combine
from repro.models.layers import ParallelContext
from repro.models.moe import ReplicationSpec
mesh = jax.make_mesh((4,), ("model",))
for name, (rounds, counts) in json.loads(str(IN["cases"])).items():
    inp = {k[len(name) + 1:]: v for k, v in IN.items()
           if k.startswith(name + ".")}
    moe = MoEConfig(n_experts=inp["router"].shape[1], top_k=2,
                    d_ff=inp["w_gate"].shape[-1],
                    capacity_factor=float(inp["cf"]))
    pc = ParallelContext(
        mesh=mesh, ep_axes=("model",), token_axes=("model",),
        moe_impl="aurora", ep_overlap=True,
        aurora_rounds=None if rounds is None else tuple(map(tuple, rounds)),
        moe_replication=None if counts is None else ReplicationSpec(
            tuple(counts)))

    def loss(x, r, wg, wu, wd):
        y, aux = ep_dispatch_combine(
            x, r, {"w_gate": wg, "w_up": wu, "w_down": wd}, moe, "swiglu", pc)
        return jnp.sum(y ** 2) + aux

    keys = ("x", "router", "w_gate", "w_up", "w_down")
    with set_mesh(mesh):
        gs = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
            *(jnp.asarray(inp[k]) for k in keys))
    for k, g in zip(keys, gs):
        OUT[name + "." + k] = np.asarray(g)
"""


@pytest.fixture(scope="module")
def jax_grads(tmp_path_factory):
    inputs = {f"{name}.{k}": v for name, (inp, *_) in CASES.items()
              for k, v in inp.items()}
    meta = {name: (rounds, counts)
            for name, (_, rounds, counts) in CASES.items()}
    out = jax_mesh_run(_JAX_GRADS, tmp_path_factory.mktemp("jax"),
                       {**inputs, "cases": json.dumps(meta)})
    return {name: [out[f"{name}.{k}"] for k in LEAVES] for name in CASES}


def _ratio(got, want) -> float:
    """The worst leaf's error over its bound, 1e-5 + 1e-5 x max|leaf|."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        tol = 1e-5 + 1e-5 * float(np.abs(w).max())
        worst = max(worst, float(np.abs(g - w).max()) / tol)
    return worst


def _local(name, overlap_on=True):
    inp, rounds, counts = CASES[name]
    return square_loss_grads(inp, LocalGroup(N_RANKS, "cpu"), rounds,
                             counts, overlap_on)


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_grads_on_local_group_match_jax(jax_grads, name):
    got = _local(name)
    assert _ratio(got, jax_grads[name]) <= 1.0
    assert _ratio(got, _local(name, overlap_on=False)) <= 1.0


def test_pipelined_grads_on_gloo_ranks_match_jax(jax_grads, tmp_path):
    """One 4-rank gloo run of every case, pipelined and synchronous: the
    ranks' grads summed against JAX's."""
    cases = {f"{name}/{body}": (inp, rounds, counts, body == "overlap")
             for name, (inp, rounds, counts) in CASES.items()
             for body in ("overlap", "sync")}
    outs = gloo_run("overlap_grads_worker", str(tmp_path), cases)
    for key in cases:
        summed = [sum(parts) for parts in zip(*(o[key] for o in outs))]
        assert _ratio(summed, jax_grads[key.split("/")[0]]) <= 1.0, key


def _backward_through_forward_round(ctx, *grads):
    """A planted fault: the grads re-sent through the forward round (each
    rank's grad to the rank it sent to) instead of its transpose."""
    group, dst = ctx.group, ctx.dst
    at = {r: k for k, r in enumerate(group.ranks)}
    src = inverse_round(dst)
    ins = [torch.empty(shape, dtype=dtype, device=device)
           if src[me] >= 0 else None
           for me, (shape, dtype, device) in zip(group.ranks, ctx.like)]
    group.permute(dst, lambda i: grads[at[i]], lambda j: ins[at[j]]).wait()
    return (None,) * 4 + tuple(ins) + (None,) * len(ins)


def test_planted_backward_through_the_forward_round_fails(jax_grads,
                                                          monkeypatch):
    """Round robin's shifts by 1 and 3 of 4 are not their own transposes,
    so grads sent back the way the chunks came land on the wrong ranks."""
    monkeypatch.setattr(overlap._Round, "backward",
                        staticmethod(_backward_through_forward_round))
    name = "cf8_round_robin"
    assert _ratio(_local(name), jax_grads[name]) > 1.0
