"""The port's expert-parallel MoE layer against the JAX reference, on the CPU.

``repro_torch.distributed.ep_dispatch_combine`` (the monolithic all-to-all,
Aurora's rounds and the round-pipelined overlap) is held against the JAX
``ep_dispatch_combine``, called directly on a 4-device host mesh in one
child process (four jitted calls), at capacity factor 8.0 (no drops; also
against ``moe_apply_dense``) and at 1.0, where the per-source capacity
drops assignments that only the JAX EP layer can referee. Also a hot-expert
replication (8 physical experts over 4 ranks). y and aux within 1e-5
(``tests/test_kernels.py::_tol`` in fp32), counts exactly equal; the
overlap is bit-equal to the synchronous body. On ``LocalGroup(4)`` with the
plain FFN and with the kernel path (``moe_gmm``'s plain version here), and
on 4 gloo ranks.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import aurora_schedule  # noqa: E402
from repro_torch.distributed import (LocalGroup, ep_dispatch_combine,  # noqa: E402
                                     pipelined_dispatch_combine)
from repro_torch.distributed.alltoall import (  # noqa: E402
    aurora_rounds_from_schedule)
from repro_torch.models import KernelConfig, ParallelContext  # noqa: E402
from repro_torch.models.moe import ReplicationSpec  # noqa: E402

from _torch_ep import N_RANKS, gloo_run, jax_mesh_run  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the EP paths run many small ops per rank, and
    several test workers on one host make every multi-threaded op wait for
    descheduled threads (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 1e-5
T, D, F = 64, 32, 64
COUNTS = (3, 1, 2, 2)            # 4 logical experts -> 8 physical


def _rounds():
    """BvN rounds of a fixed-seed rank traffic matrix (partial rounds)."""
    rng = np.random.default_rng(3)
    d = rng.random((N_RANKS, N_RANKS)) * (rng.random((N_RANKS, N_RANKS))
                                          < 0.6)
    np.fill_diagonal(d, 0.0)
    return aurora_rounds_from_schedule(aurora_schedule(d), N_RANKS)


def _inputs(n_logical, n_phys, cf, seed):
    """Tokens with a common offset (so the router is skewed and cf 1.0
    drops), fp32 router and experts (``n_phys`` copies of ``n_logical``)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, D)) + 1.0).astype(np.float32)
    router = (rng.standard_normal((D, n_logical)) * D ** -0.5).astype(
        np.float32)
    ex = {k: (rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
          for k, s in (("w_gate", (n_logical, D, F)),
                       ("w_up", (n_logical, D, F)),
                       ("w_down", (n_logical, F, D)))}
    if n_phys != n_logical:
        p2l = ReplicationSpec(COUNTS).phys_to_logical
        ex = {k: v[list(p2l)] for k, v in ex.items()}
    return {"x": x, "router": router, **ex, "cf": np.float32(cf)}


# name -> (inputs, JAX moe_impl, rounds given to JAX, replication counts)
CASES = {
    "cf8_ep": (_inputs(8, 8, 8.0, 0), "ep", None, None),
    "cf1_ep": (_inputs(8, 8, 1.0, 0), "ep", None, None),
    "cf1_aurora": (_inputs(8, 8, 1.0, 0), "aurora", _rounds(), None),
    "cf1_replicated": (_inputs(4, 8, 1.0, 1), "aurora", _rounds(), COUNTS),
}

_JAX_LAYER = """
import json
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs.base import MoEConfig
from repro.distributed.alltoall import ep_dispatch_combine
from repro.models.layers import ParallelContext
from repro.models.moe import ReplicationSpec, moe_apply_dense
mesh = jax.make_mesh((4,), ("model",))
for name, (impl, rounds, counts) in json.loads(str(IN["cases"])).items():
    inp = {k[len(name) + 1:]: v for k, v in IN.items()
           if k.startswith(name + ".")}
    moe = MoEConfig(n_experts=inp["router"].shape[1], top_k=2,
                    d_ff=inp["w_gate"].shape[-1],
                    capacity_factor=float(inp["cf"]))
    pc = ParallelContext(
        mesh=mesh, ep_axes=("model",), token_axes=("model",),
        moe_impl=impl,
        aurora_rounds=None if rounds is None else tuple(map(tuple, rounds)),
        moe_replication=None if counts is None else ReplicationSpec(
            tuple(counts)))
    experts = {k: jnp.asarray(inp[k]) for k in ("w_gate", "w_up", "w_down")}
    with set_mesh(mesh):
        y, aux, c = jax.jit(lambda x, r, e: ep_dispatch_combine(
            x, r, e, moe, "swiglu", pc, return_counts=True))(
            jnp.asarray(inp["x"]), jnp.asarray(inp["router"]), experts)
    OUT[name + ".y"], OUT[name + ".aux"] = np.asarray(y), np.asarray(aux)
    OUT[name + ".counts"] = np.asarray(c)
    if counts is None and float(inp["cf"]) == 8.0:
        yd, _, cd = moe_apply_dense(
            {"router": jnp.asarray(inp["router"]), "experts": experts},
            jnp.asarray(inp["x"]), moe, "swiglu", return_counts=True)
        OUT[name + ".dense_y"], OUT[name + ".dense_counts"] = (
            np.asarray(yd), np.asarray(cd))
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    inputs = {f"{name}.{k}": v for name, (inp, *_) in CASES.items()
              for k, v in inp.items()}
    meta = {name: (impl, rounds, counts)
            for name, (_, impl, rounds, counts) in CASES.items()}
    return jax_mesh_run(_JAX_LAYER, tmp_path_factory.mktemp("jax"),
                        {**inputs, "cases": json.dumps(meta)})


def _port(inp, group, pc_kw, kernels, counts):
    moe = MoEConfig(n_experts=inp["router"].shape[1], top_k=2,
                    d_ff=inp["w_gate"].shape[-1],
                    capacity_factor=float(inp["cf"]))
    experts = {k: torch.from_numpy(inp[k])
               for k in ("w_gate", "w_up", "w_down")}
    return ep_dispatch_combine(
        torch.from_numpy(inp["x"]), torch.from_numpy(inp["router"]),
        experts, moe, "swiglu", ParallelContext(group=group, **pc_kw),
        return_counts=True, kernels=KernelConfig() if kernels else None,
        spec=ReplicationSpec.from_counts(counts) if counts else None)


def _paths(name):
    """The port's paths held against case ``name``: the synchronous body
    under the JAX case's own exchange, and the pipeline (rounds; round
    robin when the case has none). At cf 8.0 (no drops) every exchange
    gives the same layer, so "aurora" is held against it too."""
    _, impl, rounds, _ = CASES[name]
    paths = {"sync": dict(moe_impl=impl, aurora_rounds=rounds),
             "overlap": dict(moe_impl="aurora", aurora_rounds=rounds,
                             ep_overlap=True)}
    if name == "cf8_ep":
        paths["aurora"] = dict(moe_impl="aurora", aurora_rounds=_rounds())
    return paths


def _check(got, jax_out, name):
    y, aux, counts = (t.numpy() if torch.is_tensor(t) else t for t in got)
    np.testing.assert_allclose(y, jax_out[name + ".y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux, jax_out[name + ".aux"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(counts, jax_out[name + ".counts"])


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", list(CASES))
def test_layer_on_local_group_matches_jax(jax_out, name, kernels):
    """Every path of the port's layer on ``LocalGroup(4)`` against the JAX
    EP layer; the overlap bit-equal to the synchronous body."""
    inp, _, _, counts = CASES[name]
    outs = {path: _port(inp, LocalGroup(N_RANKS), kw, kernels, counts)
            for path, kw in _paths(name).items()}
    for got in outs.values():
        _check(got, jax_out, name)
    assert torch.equal(outs["overlap"][0], outs["sync"][0])
    if name == "cf8_ep":
        np.testing.assert_allclose(outs["sync"][0].numpy(),
                                   jax_out[name + ".dense_y"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(outs["sync"][2].numpy(),
                                      jax_out[name + ".dense_counts"])
    else:
        # cf 1.0 drops: the EP layer is not the dense layer.
        assert not np.allclose(jax_out[name + ".y"], _dense(inp, counts),
                               atol=1e-3)
    assert float(outs["sync"][2].sum()) == T * 2


def _dense(inp, counts):
    from repro_torch.models.moe import moe_apply_dense
    moe = MoEConfig(n_experts=inp["router"].shape[1], top_k=2, d_ff=F,
                    capacity_factor=float(inp["cf"]))
    p = {"router": torch.from_numpy(inp["router"]),
         "experts": {k: torch.from_numpy(inp[k])
                     for k in ("w_gate", "w_up", "w_down")}}
    return moe_apply_dense(p, torch.from_numpy(inp["x"]), moe, "swiglu",
                           replication=ReplicationSpec.from_counts(counts)
                           if counts else None)[0].numpy()


def test_pipeline_wrapper_and_errors():
    """``pipelined_dispatch_combine`` forces the pipeline on any context;
    the pipeline refuses to run without rounds; a replication whose
    physical count does not divide over the ranks is refused."""
    inp = CASES["cf1_ep"][0]
    moe = MoEConfig(n_experts=8, top_k=2, d_ff=F, capacity_factor=1.0)
    args = (torch.from_numpy(inp["x"]), torch.from_numpy(inp["router"]),
            {k: torch.from_numpy(inp[k])
             for k in ("w_gate", "w_up", "w_down")}, moe, "swiglu")
    group = LocalGroup(N_RANKS)
    pc = ParallelContext(group=group, moe_impl="ep")
    y_w, _ = pipelined_dispatch_combine(*args, pc)
    y_o, _ = ep_dispatch_combine(*args, ParallelContext(
        group=group, moe_impl="aurora", ep_overlap=True))
    assert torch.equal(y_w, y_o)
    from repro_torch.distributed.overlap import \
        pipelined_local_dispatch_combine
    with pytest.raises(ValueError, match="explicit permutation rounds"):
        pipelined_local_dispatch_combine([args[0][:16]], [None], *args[1:],
                                         group, None)
    with pytest.raises(ValueError, match="total_multiple=4"):
        ep_dispatch_combine(*args, pc, spec=ReplicationSpec((2,) + (1,) * 7))


def test_layer_on_gloo_ranks_matches_jax(jax_out, tmp_path):
    """One 4-rank gloo run (``DistGroup``) of every case and path, with the
    kernel path: each rank's y, aux and counts against the JAX layer."""
    cases = {}
    for name, (inp, _, _, counts) in CASES.items():
        for path, kw in _paths(name).items():
            cases[f"{name}/{path}"] = (inp, kw, True, counts)
    outs = gloo_run("layer_worker", str(tmp_path), cases)
    for rank_out in outs:
        for key, got in rank_out.items():
            _check(got, jax_out, key.split("/")[0])
    for key in cases:
        assert all(np.array_equal(o[key][0], outs[0][key][0]) for o in outs)
