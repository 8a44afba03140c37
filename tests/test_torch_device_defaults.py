"""The port's entry points run on the card unless the caller asks for the
CPU: without a card, ``ThreadMesh``, ``LocalGroup``, ``init_params``,
``init_cache``, ``DistGroup``, ``DistMesh``, the bridge's
``leaf_to_torch`` and ``to_torch`` and ``models.moe.replica_arrays``
raise at their default device instead of falling back to the CPU, and
each runs where ``device="cpu"`` puts it. ``DistGroup`` and ``DistMesh`` take the current
CUDA device by default; here they are built in a one-rank gloo world."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import (DistGroup, DistMesh,  # noqa: E402
                                     LocalGroup, ThreadMesh)
from repro_torch.launch.mesh import MeshLayout  # noqa: E402
from repro_torch.models import Model, init_cache, init_params  # noqa: E402
from repro_torch.models.moe import ReplicationSpec, replica_arrays  # noqa: E402

CFG = get_config("mamba2-1.3b").reduced()
LAYOUT = MeshLayout((1, 2), ("data", "model"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A one-rank gloo world (``DistGroup`` and ``DistMesh`` need one)."""
    import torch.distributed as dist
    path = tmp_path_factory.mktemp("gloo") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _device(x):
    if isinstance(x, dict):
        return x["len"].device if "len" in x else x["embed"].device
    return x.device


ENTRY_POINTS = {
    "ThreadMesh": lambda **kw: ThreadMesh(LAYOUT, **kw),
    "LocalGroup": lambda **kw: LocalGroup(2, **kw),
    "init_params": lambda **kw: init_params(CFG, 0, **kw),
    "init_cache": lambda **kw: init_cache(CFG, 2, 8, **kw),
    "DistGroup": lambda **kw: DistGroup(**kw),
    "DistMesh": lambda **kw: DistMesh(MeshLayout((1,), ("model",)), **kw),
    "leaf_to_torch": lambda **kw: bridge.leaf_to_torch(
        np.zeros(3, np.float32), **kw),
    "to_torch": lambda **kw: bridge.to_torch(
        {"embed": np.zeros(3, np.float32)}, **kw),
    "replica_arrays": lambda **kw: replica_arrays(
        ReplicationSpec((2, 1, 1)), **kw)[0],
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, world, monkeypatch):
    build = ENTRY_POINTS[name]
    assert _device(build(device="cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(CFG)
