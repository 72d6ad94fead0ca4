"""Checkpoint helper tests (npz + orbax round trips)."""

import numpy as np
import jax.numpy as jnp
import pytest

from qkan_implementation.utils.checkpoint import (
    load_npz,
    load_pytree,
    save_npz,
    save_pytree,
)


def test_npz_round_trip(tmp_path):
    path = str(tmp_path / "t.npz")
    save_npz(path, {"a": np.arange(5), "b": jnp.ones((2, 2))})
    loaded = load_npz(path)
    np.testing.assert_array_equal(loaded["a"], np.arange(5))
    np.testing.assert_array_equal(loaded["b"], np.ones((2, 2)))


def test_orbax_round_trip(tmp_path):
    tree = {
        "layer0": {"w": jnp.arange(6.0).reshape(2, 3), "d": jnp.asarray([1, 2])},
        "scale": jnp.asarray(2.5),
    }
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    restored = load_pytree(path)
    np.testing.assert_allclose(restored["layer0"]["w"], tree["layer0"]["w"])
    np.testing.assert_array_equal(restored["layer0"]["d"], tree["layer0"]["d"])
    np.testing.assert_allclose(restored["scale"], 2.5)
