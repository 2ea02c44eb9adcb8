"""Device mesh and sharding helpers.

Groups are THE parallel axis of JPEG XL (256x256 tiles are fully
independent on encode; SURVEY.md §2.2) — we shard the leading group axis
of every pixel-shaped array across the mesh and let XLA insert the
collectives (psum for global histograms/stats, all_gather for assembly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "groups") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_groups(mesh: Mesh, arr: jnp.ndarray, dim: int = 0):
    """Place ``arr`` with axis ``dim`` split over the mesh's one axis."""
    spec = [None] * arr.ndim
    spec[dim] = mesh.axis_names[0]
    return jax.device_put(arr, NamedSharding(mesh, P(*spec)))


def pad_groups_to_multiple(arr: np.ndarray, n: int):
    """Pad leading axis to a multiple of n (for even sharding)."""
    g = arr.shape[0]
    pad = (-g) % n
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)
    return arr, g
