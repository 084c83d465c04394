"""Device mesh construction helpers.

Meshes follow the algorithm, not a physical topology: devices are taken in
jax.devices() order (every GPU of a host reaches every other at the same
rate over NVLink)."""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    """1-D mesh over the doc-shard axis (postings + graph sharded)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def make_mesh2d(
    n_q: int, n_d: int, axes: tuple[str, str] = ("q", "d")
) -> Mesh:
    """2-D mesh: query batches data-parallel over `q` (no communication),
    docs sharded over `d` (per-shard top-k + all-gather merge along `d`).
    Index arrays are replicated across `q`."""
    import numpy as np

    devs = jax.devices()
    if len(devs) < n_q * n_d:
        raise ValueError(f"need {n_q * n_d} devices, have {len(devs)}")
    return Mesh(np.array(devs[: n_q * n_d]).reshape(n_q, n_d), axes)
