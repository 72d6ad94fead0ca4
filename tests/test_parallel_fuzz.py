"""Property-based parity fuzz for the tp/pp layer paths.

The hand-written tests in test_parallel_tp.py / test_parallel_pp.py pin
specific shapes; this sweep draws random network shapes, mesh factorings,
and microbatch counts — the sharded/replicated layer MIXTURES and
psum_scatter chain lengths nobody enumerated — and requires exact (x64)
agreement with ``kan_apply``.  Layout bugs in parallel code are
composition bugs; composition bugs live in the shapes you didn't write
down.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh

from qkan_implementation.models.fixed_kan import kan_apply
from qkan_implementation.parallel.pp import kan_apply_pp
from qkan_implementation.parallel.tp import kan_apply_tp

MAX_DEGREE = 3


@pytest.fixture(scope="module")
def devs():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return np.array(jax.devices()[:8])


def _draw_params(draw, in_dim, n_layers, t_dim):
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    params, cur = [], in_dim
    for _ in range(n_layers):
        out = draw(st.integers(1, 7))
        params.append(
            {
                "degrees": jnp.asarray(
                    rng.integers(0, MAX_DEGREE + 1, out), jnp.int32
                ),
                "coefficients": jnp.asarray(
                    rng.normal(size=(out, cur, MAX_DEGREE + 1, t_dim)) * 0.3
                ),
                "horizontal_weights": jnp.asarray(rng.normal(size=out)),
            }
        )
        cur = t_dim
    return params


@given(data=st.data())
@settings(max_examples=12, deadline=None)
def test_tp_forward_matches_dense(devs, data):
    draw = data.draw
    n_tp = draw(st.sampled_from([2, 4, 8]))
    n_dp = 8 // n_tp
    mesh = Mesh(devs.reshape(n_dp, n_tp), ("dp", "tp"))
    # in_dim may or may not divide n_tp; t_dim likewise -> random
    # sharded/replicated layer mixtures, incl. all-replicated
    in_dim = draw(st.integers(1, 12))
    t_dim = draw(st.integers(1, 8))
    n_layers = draw(st.integers(1, 4))
    params = _draw_params(draw, in_dim, n_layers, t_dim)
    batch = n_dp * draw(st.integers(1, 3))
    x = jnp.asarray(
        np.random.default_rng(draw(st.integers(0, 2**31 - 1))).uniform(
            -2, 2, (batch, in_dim)
        )
    )
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_tp(params, x, MAX_DEGREE, mesh, dp_axis="dp")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-9)


@given(data=st.data())
@settings(max_examples=12, deadline=None)
def test_pp_forward_matches_dense(devs, data):
    draw = data.draw
    n_pp = draw(st.sampled_from([2, 4, 8]))
    n_dp = 8 // n_pp
    if n_dp > 1:
        mesh = Mesh(devs.reshape(n_dp, n_pp), ("dp", "pp"))
        dp_axis = "dp"
    else:
        mesh = Mesh(devs, ("pp",))
        dp_axis = None
    t_dim = draw(st.integers(1, 6))
    # lead iff in_dim != t_dim (both draws legal); body must split evenly
    in_dim = draw(st.integers(1, 9))
    k = draw(st.integers(1, 2))
    n_body = n_pp * k
    n_layers = n_body + (1 if in_dim != t_dim else 0)
    params = _draw_params(draw, in_dim, n_layers, t_dim)
    microbatches = draw(st.sampled_from([1, 2, 4]))
    batch = microbatches * max(1, n_dp) * draw(st.integers(1, 2))
    x = jnp.asarray(
        np.random.default_rng(draw(st.integers(0, 2**31 - 1))).uniform(
            -2, 2, (batch, in_dim)
        )
    )
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_pp(
        params, x, MAX_DEGREE, mesh, microbatches=microbatches,
        dp_axis=dp_axis,
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-9)
