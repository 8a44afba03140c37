"""Cluster model: GPUs (or TPU slices) behind a non-blocking "big switch".

The paper (§2.4) models the inter-accelerator network as a single big switch:
every device i has a full-duplex link of bandwidth ``B_i`` into the fabric and
the fabric itself is non-blocking — contention only happens at endpoints.

``DeviceType`` carries both network bandwidth and a relative compute speed
(FLOPs ratio); the paper assumes a device with higher compute never has lower
bandwidth (footnote 2), which ``Cluster.validate`` enforces.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DeviceType:
    """A class of accelerator in the cluster."""

    name: str
    bandwidth: float  # link bandwidth into the switch (bytes or tokens / unit time)
    compute: float    # relative compute throughput (tokens / unit time, 1.0 = reference)

    def __post_init__(self) -> None:
        if self.bandwidth <= 0 or self.compute <= 0:
            raise ValueError(f"DeviceType {self.name}: bandwidth/compute must be > 0")


# The paper's evaluation setup (§8.1): homogeneous 100 Gbps; heterogeneous
# tiers of 100/80/50/40 Gbps ordered high→low performance. Compute scales are
# chosen proportional to tier (the paper orders tiers by overall performance).
V100G = DeviceType("gpu-100g", bandwidth=100.0, compute=1.00)
V80G = DeviceType("gpu-80g", bandwidth=80.0, compute=0.80)
V50G = DeviceType("gpu-50g", bandwidth=50.0, compute=0.50)
V40G = DeviceType("gpu-40g", bandwidth=40.0, compute=0.40)

PAPER_HET_TIERS: tuple[DeviceType, ...] = (V100G, V80G, V50G, V40G)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """An ordered set of devices behind one big switch.

    ``devices[i]`` is the device that hosts expert slot ``i`` (before any
    assignment optimization; assignment permutes the expert→device map).
    """

    devices: tuple[DeviceType, ...]

    def __post_init__(self) -> None:
        if not self.devices:
            raise ValueError("Cluster must have at least one device")

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def bandwidths(self) -> tuple[float, ...]:
        return tuple(d.bandwidth for d in self.devices)

    @property
    def computes(self) -> tuple[float, ...]:
        return tuple(d.compute for d in self.devices)

    @property
    def homogeneous(self) -> bool:
        return len({(d.bandwidth, d.compute) for d in self.devices}) == 1

    def validate(self) -> None:
        """Paper footnote 2: higher compute never pairs with lower bandwidth."""
        by_compute = sorted(self.devices, key=lambda d: d.compute)
        for lo, hi in zip(by_compute, by_compute[1:]):
            if hi.bandwidth < lo.bandwidth:
                raise ValueError(
                    f"device {hi.name} has more compute but less bandwidth than {lo.name}"
                )

    def sorted_indices_by_performance(self) -> list[int]:
        """Device indices from highest to lowest performance (Thm 5.1 order)."""
        return sorted(
            range(self.n),
            key=lambda i: (self.devices[i].compute, self.devices[i].bandwidth),
            reverse=True,
        )

    def subcluster(self, indices: Sequence[int]) -> "Cluster":
        """Survivor view for degraded re-planning: the same physical devices
        re-indexed 0..k-1 in the given order. ``indices`` are positions into
        this cluster; duplicates and out-of-range entries are rejected."""
        idx = [int(i) for i in indices]
        if len(set(idx)) != len(idx):
            raise ValueError(f"subcluster indices contain duplicates: {idx}")
        for i in idx:
            if not 0 <= i < self.n:
                raise ValueError(
                    f"subcluster index {i} out of range for {self.n} devices")
        return Cluster(devices=tuple(self.devices[i] for i in idx))


def homogeneous_cluster(n: int, device: DeviceType = V100G) -> Cluster:
    return Cluster(devices=(device,) * n)


def heterogeneous_cluster(
    n: int, tiers: Sequence[DeviceType] = PAPER_HET_TIERS
) -> Cluster:
    """Paper §8.1: equal device count per tier. ``n`` must divide evenly."""
    if n % len(tiers) != 0:
        raise ValueError(f"n={n} not divisible by {len(tiers)} tiers")
    per = n // len(tiers)
    devs: list[DeviceType] = []
    for t in tiers:
        devs.extend([t] * per)
    return Cluster(devices=tuple(devs))
