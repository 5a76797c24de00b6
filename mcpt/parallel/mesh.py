"""Device mesh construction for sharded rendering.

The renderer's parallel decomposition (SURVEY §2.3):
  * 'tiles' axis — data parallelism over image row blocks (each device owns a
    contiguous block of film rows; no cross-device traffic in the forward
    pass, gather only at display/save time);
  * 'spp'   axis — sample parallelism (devices render disjoint sample
    indices of the same pixels; film accumulators are psum-reduced).

Scene arrays are replicated on every device (they fit in device memory;
only rays move).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_tiles: Optional[int] = None, n_spp: int = 1, devices=None) -> Mesh:
    """Build a ('tiles', 'spp') mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_tiles is None:
        n_tiles = n // n_spp
    assert n_tiles * n_spp == n, f"{n_tiles}x{n_spp} != {n} devices"
    # the mesh follows the algorithm alone: every device reaches every
    # other at the same rate, so device order within the grid is free
    arr = np.array(devices, dtype=object).reshape(n_tiles, n_spp)
    return Mesh(arr, ("tiles", "spp"))


def film_sharding(mesh: Mesh) -> NamedSharding:
    """Film accum [H, W, 3]: rows sharded over 'tiles', replicated over 'spp'.

    Spelled P("tiles") — the form a pass's output carries — so a film laid
    out here matches one a pass returned and the pass does not recompile.
    """
    return NamedSharding(mesh, P("tiles"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
