"""The port's mesh layout rules against the JAX reference, on the CPU.

- ``param_specs``, ``cache_specs`` (at each input shape's batch and cache
  capacity), ``input_sharding`` and ``ep_axes_for`` equal the reference's
  entry for entry, for all ten archs, full and reduced, on stand-in meshes
  (16, 16), (2, 16, 16), (2, 4), (1, 4) and (1, 8) (the reference reads
  only ``axis_names`` and ``devices.shape``);
- ``launch.mesh``'s layouts (the production meshes, groups and indices in
  JAX's row-major order);
- ``bridge.shard_tensor`` / ``shard_params`` cut each leaf to the
  reference's per-device shape, and the shards of a leaf tile it;
- the EP engines' forms (``param_specs(cfg, n)``, ``make_pc(cfg, group)``)
  are unchanged.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.bridge import (local_shape, shard_params,  # noqa: E402
                                shard_tensor, spec_leaves, tree_leaves)
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.distributed import LocalGroup  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.launch.mesh import (MeshLayout, make_ep_mesh,  # noqa: E402
                                     make_production_mesh, make_test_mesh)
from repro_torch.sharding import (cache_specs, ep_axes_for,  # noqa: E402
                                  input_sharding, make_pc, param_specs)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 4), ("data", "model")),
          ((1, 8), ("data", "model"))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _entries(spec, ndim):
    """A reference PartitionSpec's entries padded to ``ndim``."""
    out = tuple(spec)
    return out + (None,) * (ndim - len(out))


def _ref_leaves(tree):
    return jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _assert_specs_equal(like, mine, ref_specs, ref_shapes):
    got = spec_leaves(like, mine)
    want = _ref_leaves(ref_specs)
    shapes = jax.tree.leaves(ref_shapes)
    assert len(got) == len(want) == len(shapes)
    for g, w, s in zip(got, want, shapes):
        assert g == _entries(w, len(s.shape)), (g, w, s.shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch):
    for reduced in (False, True):
        cfg = get_config(arch)
        cfg_j = jconfigs.get_config(arch)
        if reduced:
            cfg, cfg_j = cfg.reduced(), cfg_j.reduced()
        p_shapes = jax.eval_shape(lambda: jrules.tf.init_params(
            jax.random.PRNGKey(0), cfg_j))
        params = init_params(cfg, device="meta")
        for shape, axes in MESHES:
            ref_mesh = _stand_in(shape, axes)
            mesh = MeshLayout(shape, axes)
            assert ep_axes_for(cfg, mesh) == jrules.ep_axes_for(cfg_j,
                                                                 ref_mesh)
            _assert_specs_equal(params, param_specs(cfg, mesh),
                                jrules.param_specs(cfg_j, ref_mesh),
                                p_shapes)
            for sh in SHAPES.values():
                b, cap = sh.global_batch, sh.seq_len
                src = jspecs.SRC_LEN if cfg.is_encoder_decoder else 0
                c_shapes = jax.eval_shape(lambda: jrules.tf.init_cache(
                    cfg_j, b, cap, src_len=src))
                _assert_specs_equal(
                    init_cache(cfg, b, cap, src_len=src, device="meta"),
                    cache_specs(cfg, mesh, b, cap, src),
                    jrules.cache_specs(cfg_j, ref_mesh, b, cap, src),
                    c_shapes)
                for batch in (b, 1, 3, 16):
                    assert input_sharding(cfg, mesh, batch) == tuple(
                        jrules.input_sharding(cfg_j, ref_mesh, batch))


def test_production_and_test_meshes():
    pod = make_production_mesh()
    assert (pod.dims, pod.axis_names, pod.size) == ((16, 16),
                                                     ("data", "model"), 256)
    multi = make_production_mesh(multi_pod=True)
    assert multi.devices.shape == (2, 16, 16)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_test_mesh() == MeshLayout((2, 4), ("data", "model"))
    assert make_ep_mesh(4) == MeshLayout((1, 4), ("data", "model"))
    # Rank r is the row-major index of its coordinates; a group over a
    # tuple of axes is indexed row-major over them.
    for r in range(multi.size):
        c = multi.coords(r)
        assert multi.devices[c["pod"], c["data"], c["model"]] == r
        assert multi.rank_of(c) == r
        assert multi.axis_index(r, ("data", "model")) == (c["data"] * 16
                                                          + c["model"])
        assert multi.axis_index(r, "model") == c["model"]
    g = make_test_mesh().group(5, "data")
    assert g == (1, 5)
    assert make_test_mesh().group(5, ("model", "data")) == tuple(range(8))
    assert make_test_mesh().groups("model") == [(0, 1, 2, 3), (4, 5, 6, 7)]
    with pytest.raises(ValueError):
        MeshLayout((2, 4), ("data",))
    with pytest.raises(ValueError):
        make_test_mesh().axis_size("pod")


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                                  "gemma3-27b"])
def test_shards_have_the_reference_shapes_and_tile_each_leaf(arch):
    """Each rank's shard of every reduced param leaf has the local shape
    the reference's spec gives it, and the ranks' shards put back
    together (over the sharded dims) are the leaf."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    for shape, axes in MESHES[2:]:
        mesh = MeshLayout(shape, axes)
        specs = param_specs(cfg, mesh)
        shards = [shard_params(params, specs, mesh, r)
                  for r in range(mesh.size)]
        for i, (leaf, spec) in enumerate(zip(tree_leaves(params),
                                             spec_leaves(params, specs))):
            want = local_shape(tuple(leaf.shape), spec, mesh)
            for r in range(mesh.size):
                got = tree_leaves(shards[r])[i]
                assert tuple(got.shape) == want
            # Reassemble: each rank's shard sits at its block.
            back = torch.full_like(leaf, float("nan"))
            for r in range(mesh.size):
                idx = []
                for dim, entry in enumerate(spec):
                    n = want[dim]
                    if entry is None:
                        idx.append(slice(None))
                    else:
                        k = mesh.axis_index(r, entry)
                        idx.append(slice(k * n, (k + 1) * n))
                back[tuple(idx)] = tree_leaves(shards[r])[i]
            assert torch.equal(back, leaf)
    with pytest.raises(ValueError, match="does not divide"):
        shard_tensor(torch.zeros(6, 2), ("model",), make_test_mesh(), 0)


def test_ep_only_forms_unchanged():
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    specs = tree_leaves(param_specs(cfg, 4))
    assert set(specs) == {None, -3}
    assert tree_leaves(param_specs(cfg, 3)) == [None] * len(specs)
    pc = make_pc(cfg, LocalGroup(4))
    assert pc.moe_impl == "ep" and pc.mesh is None and pc.tp == 1
    assert make_pc(cfg, LocalGroup(3)).moe_impl == "dense"
    with pytest.raises(ValueError, match="batch"):
        make_pc(cfg, make_test_mesh())


def test_thread_transport_collectives_and_counts_under_contention():
    """16 thread ranks on a (4, 4) mesh with a 1 us switch interval: each
    collective equals its definition on every rank (sums in group order,
    gathers and all-to-alls in group order), the bytes counted are the
    results', the EP group's exchange lands row for row, and the kernel
    wrappers' launch counter loses no increment."""
    import sys
    import threading

    from repro_torch.distributed import ThreadMesh
    from repro_torch.kernels import _build
    layout = MeshLayout((4, 4), ("data", "model"))
    ROUNDS = 5
    old = sys.getswitchinterval()

    def fn():
        pass
    fn.launches = 0

    def body(rm):
        r = rm.rank
        x = torch.full((2, 3), float(r))
        got = {}
        for _ in range(ROUNDS):
            got["sum_model"] = rm.all_reduce(x, "model")
            got["sum_all"] = rm.all_reduce(x, ("data", "model"))
            got["gather"] = rm.all_gather(x, 1, "data")
            got["a2a"] = rm.all_to_all(
                torch.arange(8.0).reshape(4, 2) + 100 * r, 0, 1, "model")
            ep = rm.ep_group(("data", "model"))
            got["ep"] = ep.all_to_all([torch.arange(16.0)[:, None] + 100 * r])
            for _ in range(100):
                _build.count(fn)
        return got, rm.collective_bytes

    sys.setswitchinterval(1e-6)
    try:
        res = ThreadMesh(layout, timeout=60).run(body)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 16 * ROUNDS * 100
    for r, (got, nbytes) in enumerate(res):
        c = layout.coords(r)
        row = [layout.rank_of({"data": c["data"], "model": j})
               for j in range(4)]
        col = [layout.rank_of({"data": i, "model": c["model"]})
               for i in range(4)]
        assert torch.equal(got["sum_model"], torch.full((2, 3),
                                                        float(sum(row))))
        assert torch.equal(got["sum_all"], torch.full((2, 3), 120.0))
        assert torch.equal(got["gather"], torch.cat(
            [torch.full((2, 3), float(q)) for q in col], 1))
        assert torch.equal(got["a2a"], torch.cat(
            [(torch.arange(8.0).reshape(4, 2) + 100 * q)[c["model"]:
                                                         c["model"] + 1]
             for q in row], 1))
        assert torch.equal(got["ep"][0][:, 0],
                           torch.arange(16.0) * 100 + r)
        # fp32 results: two (2, 3) sums, a (2, 12) gather, a (1, 8)
        # all-to-all and the EP group's (16, 1) exchange.
        assert nbytes == ROUNDS * 4 * (6 + 6 + 24 + 8 + 16)

    def stray(rm):
        if rm.rank == 3:
            raise KeyError("rank 3 stops")
        rm.all_reduce(torch.ones(1), "model")

    t = threading.Thread(target=lambda: pytest.raises(
        RuntimeError, ThreadMesh(layout, timeout=30).run, stray))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
