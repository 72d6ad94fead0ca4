"""Test configuration: run on a virtual 8-device CPU mesh with float64.

- 8 virtual CPU devices let the multi-device sharding paths (mesh
  collectives, sharded statevector) run without several GPUs, per SURVEY.md
  section 5.
- x64 is enabled because the reference's tightest golden tolerance is 1e-15
  (ChebyshevStep block-encoding test, reference ChebyshevStep.py:133).
- Tests marked ``gpu`` need the card; their ``gpu`` fixture skips them
  elsewhere.  ``python -m pytest tests/test_fused_layer.py
  tests/test_chip_smoke.py -m gpu`` on a GPU machine runs them on the
  card: that selection keeps JAX's default platform.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


# ---------------------------------------------------------------------------
# Slow-test marking (single source of truth).  The tests below each cost
# >= 10 s on one CPU core (measured with --durations).  Quick dev loop:
#
#     python -m pytest tests/ -q -m "not slow"      (~half the wall-clock)
#
# Full (unfiltered) runs remain the merge gate.
SLOW_TESTS = {
    "test_tp_forward_matches_dense",
    "test_pp_forward_matches_dense",
    "test_qr_sweep_matches_svd_scoring",
    "test_exact_amplitudes_20_qubits_both_exchange_impls",
    "test_h_wall_schedule_matches_both_exchange_impls_and_dense",
    "test_fanin_lr_scaling_stabilizes_deep_training",
    "test_optimize_data_parallel_matches_single_device",
    "test_qr_sweep_matches_svd_and_routes_big_f32_layers",
    "test_notebook_executes",
    "test_complex_noisy_piecewise_target",
    "test_sharded_engine_matches_dense",
    "test_train_tensor_parallel_matches_single_device",
    "test_train_tensor_axis_explicit_control",
    "test_exact_amplitudes_15_qubits_random_circuit",
    "test_mnist_n_times_ensemble",
    "test_train_data_parallel_matches_single_device",
    "test_forward_parity_with_lead",
    "test_run_experiment_end_to_end",
    "test_simple_function_fit_mse",
    "test_random_circuits_match",
    "test_delayed_kernel_block_size_invariance",
    "test_anneal_solver_on_small_model",
    "test_delayed_tempering_matches_reference_kernel_quality",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: >= 10 s on one CPU core (skip with -m 'not slow')"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skipped elsewhere)"
    )
    import jax

    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The test's device: skips unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    return jax.devices()[0]


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest

    for item in items:
        base = item.name.split("[")[0]
        if base in SLOW_TESTS:
            item.add_marker(_pytest.mark.slow)
