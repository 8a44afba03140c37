"""Meshes (port of ``repro/launch/mesh.py``): the reference's mesh
layouts (``MeshLayout``, ``make_production_mesh``, ``make_test_mesh``,
``make_ep_mesh``) and the EP group a launcher serves over.

Under ``torchrun`` (``WORLD_SIZE`` set) every process holds one rank of a
``torch.distributed`` process group, initialised here from the launcher's
environment (NCCL on the card, gloo on the CPU); otherwise the ranks are
in-process (``LocalGroup``) on one device. The caller gets exactly the
transport its environment asks for: no fallback from one to the other.
"""

from __future__ import annotations

import os


def launched_ranks() -> int | None:
    """The world size ``torchrun`` launched, or None outside it."""
    ws = os.environ.get("WORLD_SIZE")
    return int(ws) if ws is not None else None


def local_device(device: str) -> str:
    """The device of this process: under ``torchrun`` on the card, the card
    of its local rank."""
    if launched_ranks() is not None and device.startswith("cuda"):
        return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return device


def make_ep_group(n: int, device: str):
    """An EP group of ``n`` ranks on ``device``: this process's rank of the
    ``torchrun`` process group (``n`` must equal its world size), else
    ``n`` in-process ranks."""
    from repro_torch.distributed import DistGroup, LocalGroup
    world = launched_ranks()
    if world is None:
        return LocalGroup(n, device)
    if n != world:
        raise SystemExit(f"--mesh {n} under torchrun needs {n} processes, "
                         f"WORLD_SIZE is {world}")
    import torch
    import torch.distributed as dist
    if not dist.is_initialized():
        cuda = device.startswith("cuda")
        if cuda:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group("nccl" if cuda else "gloo")
    return DistGroup(device=device)


# ---------------------------------------------------------------------------
# The reference's mesh layouts
# ---------------------------------------------------------------------------

class MeshLayout:
    """A device mesh's layout: its axis names and shape, and nothing bound
    to devices (the counterpart of a ``jax.sharding.Mesh`` as the
    sharding rules read it: ``axis_names``, ``devices.shape`` and
    ``shape[name]``). Rank r is the row-major flat index of its
    coordinates, as ``devices`` lays them out; a group over a tuple of
    axes holds the ranks that differ only on those axes, indexed
    row-major over them in mesh order (JAX's ``axis_index`` over the
    tuple). ``distributed.mesh`` binds a layout to ranks."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"a mesh needs one size >= 1 per distinct axis "
                             f"name, got {shape} over {axis_names}")
        self.axis_names = axis_names
        self.dims = shape
        self.size = 1
        for n in shape:
            self.size *= n

    def __repr__(self) -> str:
        return f"MeshLayout({self.dims}, {self.axis_names})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, MeshLayout) and self.dims == other.dims
                and self.axis_names == other.axis_names)

    def __hash__(self) -> int:
        return hash((self.dims, self.axis_names))

    @property
    def devices(self):
        """The rank ids laid out in the mesh's shape (``Mesh.devices``)."""
        import numpy as np
        return np.arange(self.size).reshape(self.dims)

    @property
    def shape(self) -> dict:
        """{axis name: size} (``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple of names) as a tuple in mesh
        order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(names) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes) -> int:
        n = 1
        for a in self.axes(axes):
            n *= self.shape[a]
        return n

    def coords(self, rank: int) -> dict:
        out, r = {}, int(rank)
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: dict) -> int:
        r = 0
        for name, n in zip(self.axis_names, self.dims):
            r = r * n + coords[name]
        return r

    def axis_index(self, rank: int, axes) -> int:
        """``rank``'s index in its group over ``axes``."""
        c, i = self.coords(rank), 0
        for a in self.axes(axes):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, rank: int, axes) -> tuple[int, ...]:
        """The ranks of ``rank``'s group over ``axes``, in group order."""
        axes = self.axes(axes)
        base = self.coords(rank)
        out = []
        for i in range(self.axis_size(axes)):
            c, rem = dict(base), i
            for a in reversed(axes):
                c[a] = rem % self.shape[a]
                rem //= self.shape[a]
            out.append(self.rank_of(c))
        return tuple(out)

    def groups(self, axes) -> list[tuple[int, ...]]:
        """Every group over ``axes``, ordered by its first rank."""
        seen, out = set(), []
        for r in range(self.size):
            g = self.group(r, axes)
            if g[0] not in seen:
                seen.add(g[0])
                out.append(g)
        return out


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """The reference's production meshes: (16, 16) over ("data",
    "model"), 256 devices, or with ``multi_pod`` (2, 16, 16) over ("pod",
    "data", "model"), 512. The reference's ``force_host_device_count``
    (XLA's flag that splits the host into devices) has no counterpart: a
    layout is bound to ranks by a transport (``distributed.mesh``)."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> MeshLayout:
    """A small mesh for the CPU tests (the reference's needs the host
    split into devices; this one is bound to in-process ranks)."""
    return MeshLayout(shape, axes)


def make_ep_mesh(n_devices: int) -> MeshLayout:
    """A flat EP mesh: every device on ``model``, a singleton ``data``."""
    return MeshLayout((1, n_devices), ("data", "model"))
