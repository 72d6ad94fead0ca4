"""Pipeline-parallel parity: parallel/pp.py vs the single-device path.

GPipe-style microbatch pipelining over a ``pp`` mesh axis must be EXACT
against ``kan_apply`` (and a single-device SGD step) under x64: the
schedule only reorders whole-microbatch applications, never reassociates
within a reduction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from qkan_implementation.models.fixed_kan import kan_apply
from qkan_implementation.parallel.pp import (
    kan_apply_pp,
    make_pp_train_step,
    place_pipeline_params,
    stack_pipeline_params,
)

MAX_DEGREE = 3


def _params(seed, in_dim, outs, target_dim):
    rng = np.random.default_rng(seed)
    params = []
    cur = in_dim
    for out in outs:
        params.append(
            {
                "degrees": jnp.asarray(
                    rng.integers(0, MAX_DEGREE + 1, out), jnp.int32
                ),
                "coefficients": jnp.asarray(
                    rng.normal(size=(out, cur, MAX_DEGREE + 1, target_dim))
                    * 0.3
                ),
                "horizontal_weights": jnp.asarray(rng.normal(size=out) + 1.0),
            }
        )
        cur = target_dim
    return params


@pytest.fixture(scope="module")
def mesh_pp4():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    return Mesh(np.array(devs[:4]), ("pp",))


@pytest.fixture(scope="module")
def mesh_dp_pp():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]).reshape(2, 4), ("dp", "pp"))


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_forward_parity_with_lead(mesh_pp4, microbatches):
    # in=7 != target_dim=4 -> layer 0 runs replicated before the pipeline;
    # 4 body layers with RAGGED neuron counts (pad-to-max exactness)
    params = _params(0, 7, (6, 5, 3, 4, 6), 4)
    x = jnp.asarray(np.random.default_rng(1).uniform(-2, 2, (8, 7)))
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_pp(
        params, x, MAX_DEGREE, mesh_pp4, microbatches=microbatches
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_forward_parity_no_lead_two_layers_per_stage(mesh_pp4):
    # in == target_dim: every layer pipelines; 8 layers over 4 stages (k=2)
    params = _params(2, 4, (5, 3, 6, 4, 5, 3, 4, 6), 4)
    x = jnp.asarray(np.random.default_rng(3).uniform(-2, 2, (6, 4)))
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_pp(params, x, MAX_DEGREE, mesh_pp4, microbatches=3)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_forward_parity_dp_composed(mesh_dp_pp):
    params = _params(4, 7, (6, 5, 3, 4, 6), 4)
    x = jnp.asarray(np.random.default_rng(5).uniform(-2, 2, (8, 7)))
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_pp(
        params, x, MAX_DEGREE, mesh_dp_pp, microbatches=2, dp_axis="dp"
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_place_pipeline_params_layout(mesh_pp4):
    params = _params(6, 7, (6, 5, 3, 4, 6), 4)
    lead, stacked = place_pipeline_params(params, mesh_pp4)
    assert lead is not None
    # each stage holds ONE layer padded to max_out=6
    shapes = {s.data.shape for s in stacked["coefficients"].addressable_shards}
    assert shapes == {(1, 1, 6, 4, MAX_DEGREE + 1, 4)}
    # the pre-placed (lead, stacked) pair feeds kan_apply_pp directly (no
    # per-call restack) and must match the plain-list path exactly
    x = jnp.asarray(np.random.default_rng(7).uniform(-1, 1, (4, 7)))
    out = kan_apply_pp((lead, stacked), x, MAX_DEGREE, mesh_pp4, microbatches=2)
    ref = kan_apply(params, x, MAX_DEGREE)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)
    with pytest.raises(ValueError, match="stages"):
        bad = {k: v[:2] for k, v in stacked.items()}
        kan_apply_pp((lead, bad), x, MAX_DEGREE, mesh_pp4)


def test_train_step_parity(mesh_dp_pp):
    params = _params(8, 7, (6, 5, 3, 4, 5), 4)
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.uniform(-2, 2, (8, 7)))
    y = jnp.asarray(rng.normal(size=(8, 4)))
    lr = 0.05

    def ref_loss(tps):
        full = [
            dict(t, degrees=lp["degrees"]) for t, lp in zip(tps, params)
        ]
        return jnp.mean((kan_apply(full, x, MAX_DEGREE) - y) ** 2)

    train = [
        {k: v for k, v in lp.items() if k != "degrees"} for lp in params
    ]
    ref_l, ref_g = jax.value_and_grad(ref_loss)(train)
    ref_new = jax.tree.map(lambda p, g: p - lr * g, train, ref_g)

    lead, stacked = stack_pipeline_params(params, 4)
    lead_train = {k: v for k, v in lead.items() if k != "degrees"}
    stacked_train = {
        k: v for k, v in stacked.items() if k != "degrees"
    }
    step = make_pp_train_step(
        mesh_dp_pp, MAX_DEGREE, learning_rate=lr, microbatches=2
    )
    (new_lead, new_stacked), loss = step(
        lead_train, lead["degrees"], stacked_train, stacked["degrees"], x, y
    )
    np.testing.assert_allclose(float(loss), float(ref_l), atol=1e-12)
    for k in new_lead:
        np.testing.assert_allclose(
            np.asarray(new_lead[k]), np.asarray(ref_new[0][k]), atol=1e-10,
            err_msg=f"lead {k}",
        )
    # unstack stages (k=1 layer each) and compare the unpadded slices
    for s in range(4):
        want = ref_new[s + 1]
        out_dim = want["coefficients"].shape[0]
        for k in want:
            got = np.asarray(new_stacked[k][s, 0])[:out_dim]
            np.testing.assert_allclose(
                got, np.asarray(want[k]), atol=1e-10,
                err_msg=f"stage {s} {k}",
            )
        # padded rows stay exactly zero (hw=0 kills their gradients)
        pad = np.asarray(new_stacked["horizontal_weights"][s, 0])[out_dim:]
        np.testing.assert_array_equal(pad, 0.0)


def test_train_step_descends(mesh_pp4):
    params = _params(10, 4, (4, 4, 4, 4), 4)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.uniform(-2, 2, (8, 4)))
    y = jnp.asarray(rng.normal(size=(8, 4)))
    _, stacked = stack_pipeline_params(params, 4)
    stacked_train = {k: v for k, v in stacked.items() if k != "degrees"}
    # defaults must work on a 1-D pp mesh: dp_axis='auto' resolves to None
    step = make_pp_train_step(
        mesh_pp4, MAX_DEGREE, learning_rate=0.05, microbatches=2,
    )
    losses = []
    for _ in range(5):
        (_, stacked_train), loss = step(
            None, None, stacked_train, stacked["degrees"], x, y
        )
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_stack_errors():
    params = _params(12, 7, (6, 5, 3), 4)  # 3 body layers, 4 stages
    with pytest.raises(ValueError, match="do not split"):
        stack_pipeline_params(params, 4)
    bad = _params(13, 4, (5, 3), 4)
    bad[1]["coefficients"] = jnp.zeros((3, 5, MAX_DEGREE + 1, 4))
    with pytest.raises(ValueError, match="target_dim"):
        stack_pipeline_params(bad, 2)


def test_train_step_rejects_int8(mesh_pp4):
    # same guard as FixedKAN.train: rounded int8 operands have zero
    # tangent, so a train step through them silently mis-trains
    with pytest.raises(ValueError, match="int8"):
        make_pp_train_step(mesh_pp4, MAX_DEGREE, compute_dtype=jnp.int8)
