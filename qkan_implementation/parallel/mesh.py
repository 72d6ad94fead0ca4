"""Mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def device_count() -> int:
    return len(jax.devices())


def make_mesh(
    n_devices: int | None = None, axis_name: str = "d"
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices.

    The cards of one host are joined all to all by NVLink, so the order
    needs no topology awareness; the mesh follows the algorithm.  With
    ``--xla_force_host_platform_device_count=N`` this builds the CPU test
    mesh.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"Requested {n_devices} devices, only {len(devices)} available"
        )
    return Mesh(np.array(devices[:n_devices]), (axis_name,))


def make_mesh_2d(
    shape: tuple[int, int], axis_names: tuple[str, str] = ("dp", "sv")
) -> Mesh:
    """A 2-D mesh, e.g. (data parallel, statevector shard)."""
    devices = jax.devices()
    n = shape[0] * shape[1]
    if n > len(devices):
        raise ValueError(f"Mesh {shape} needs {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]).reshape(shape), axis_names)


def shard_batch(x: jax.Array, mesh: Mesh, axis_name: str = "d") -> jax.Array:
    """Shard the leading (batch) axis of ``x`` across the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name)))
