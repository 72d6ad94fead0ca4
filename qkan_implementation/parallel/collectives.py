"""Named collective wrappers (the NCCL-equivalent surface).

One thin module so every collective the framework issues goes through a
single, swappable, CPU-testable interface (SURVEY.md section 5).  All
functions are meant to be called *inside* ``jax.shard_map``-decorated
functions with the mesh axis in scope; XLA lowers them to NCCL collectives
across GPUs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def psum(x, axis_name: str):
    """All-reduce sum over the mesh axis (gradient/data aggregation)."""
    return jax.lax.psum(x, axis_name)


def pmean(x, axis_name: str):
    return jax.lax.pmean(x, axis_name)


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = True):
    return jax.lax.all_gather(x, axis_name, axis=axis, tiled=tiled)


def ppermute(x, axis_name: str, perm):
    """Point-to-point permutation (ring / pairwise exchange primitive)."""
    return jax.lax.ppermute(x, axis_name, perm)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int):
    return jax.lax.all_to_all(x, axis_name, split_axis, concat_axis, tiled=True)


def pairwise_exchange(x, axis_name: str, partner_bit: int, n_devices: int):
    """Exchange ``x`` with the partner device differing in ``partner_bit``.

    The hypercube-edge exchange used by the sharded statevector's
    qubit-remapping step: device i swaps payloads with device i ^ (1 <<
    partner_bit).  Implemented as a single ppermute, which XLA maps to a
    bidirectional NCCL send/receive pair.
    """
    if n_devices & (n_devices - 1):
        raise ValueError(
            f"pairwise_exchange needs a power-of-two device count, got "
            f"{n_devices} (non-power counts leave some devices without a "
            f"hypercube partner)"
        )
    if (1 << partner_bit) >= n_devices:
        raise ValueError(
            f"partner_bit {partner_bit} out of range for {n_devices} "
            f"devices (need 1 << partner_bit < n_devices)"
        )
    perm = [(i, i ^ (1 << partner_bit)) for i in range(n_devices)]
    return jax.lax.ppermute(x, axis_name, perm)


def pairwise_exchange_a2a(x, axis_name: str, partner_bit: int, n_devices: int):
    """``pairwise_exchange`` lowered through ``all_to_all`` over 2-device
    groups instead of ``ppermute`` -- the second implementation behind the
    swappable comm surface (SURVEY.md section 5: collective choice
    swappable and testable).

    Each hypercube pair forms an ``axis_index_groups`` group; the payload is
    stacked [2, ...] so the all-to-all transpose delivers the partner's copy
    in the partner slot (the self-chunk stays device-local, so the traffic
    matches the ppermute lowering).
    """
    if n_devices & (n_devices - 1):
        raise ValueError(
            f"pairwise_exchange_a2a needs a power-of-two device count, got "
            f"{n_devices}"
        )
    if (1 << partner_bit) >= n_devices:
        raise ValueError(
            f"partner_bit {partner_bit} out of range for {n_devices} devices"
        )
    bit = 1 << partner_bit
    groups = [[i, i | bit] for i in range(n_devices) if not (i & bit)]
    stacked = jnp.stack([x, x])
    out = jax.lax.all_to_all(
        stacked, axis_name, split_axis=0, concat_axis=0,
        axis_index_groups=groups,
    )
    own = (jax.lax.axis_index(axis_name) >> partner_bit) & 1
    # out[k] holds group-member k's payload; the partner sits in slot 1-own
    return jnp.where(own == 0, out[1], out[0])
