"""The EP group a launcher serves over (the counterpart of
``repro/launch/mesh.py``'s ``make_ep_mesh``).

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
