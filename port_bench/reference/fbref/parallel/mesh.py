"""The device mesh (``figbird_tpu/parallel/mesh.py``).

Two axes, as in the reference:

* ``reads`` — data parallelism over the read stream (alignment batches and
  gap-fill instances split over it);
* ``genome`` — the k-mer table (code ranges) or the flat genome itself
  (contig ranges) split over it, for indexes larger than one card.

Without XLA a mesh is a (reads, genome) grid of ``torch.device``s: the
sharded code runs each shard's work on its cell's device and gathers onto
the first device of its reads row.  A grid may name one device more than
once (``devices=``): its shards then run one after another there, which
drives every sharded path on one card or on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import canonical_device


class Mesh:
    """A (reads, genome) grid of devices; ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh is a non-empty (reads, genome) grid")
        self.devices = devices
        self.shape = {"reads": devices.shape[0], "genome": devices.shape[1]}

    def device(self, r: int = 0, g: int = 0) -> torch.device:
        return self.devices[r, g]

    @property
    def first(self) -> torch.device:
        """The device the mesh's results are gathered on."""
        return self.devices[0, 0]

    def distinct(self) -> list:
        """Every device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.reshape(-1)))


def make_mesh(n_devices: int | None = None, genome_shards: int = 1,
              devices=None) -> Mesh:
    """Mesh of shape (reads, genome) over the first ``n_devices`` of
    ``devices`` (default: every visible card); the genome axis defaults to
    1 (the index replicated).  ``devices`` may repeat a device: the stand-in
    for a virtual device count."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    n = n_devices or len(devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"{n} devices asked for, {len(devices)} available")
    if n % genome_shards != 0:
        raise ValueError(f"{n} devices not divisible by {genome_shards}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(n // genome_shards, genome_shards))
