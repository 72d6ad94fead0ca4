"""Quantum step-pipeline walkthrough with per-stage verification + timing.

The library counterpart of running the reference's step tests by hand:
build the DILATE/CHEB -> MUL -> LCU -> SUM pipeline, block-encode each
stage with FABLE, verify the encodings on the statevector engine at the
1e-6 contract, and print the reference-style stage-timing breakdown
(LCUStep.py:126-161 shape).

Run:  PYTHONPATH=. python examples/quantum_pipeline_demo.py
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()


import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.encoding import fable
from qkan_implementation.ops import lcu_combine_diag, qkan_layer_forward
from qkan_implementation.ops.quantum import (
    qkan_layer_forward_quantum,
    quantum_verify_pipeline,
)
from qkan_implementation.sim import unitary
from qkan_implementation.utils.profiling import StageTimer


def main():
    if jax.devices()[0].platform == "cpu":
        jax.config.update("jax_enable_x64", True)
    N, K, d = 4, 4, 5
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.uniform(-1, 1, N))
    weights = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)))

    timer = StageTimer(annotate_trace=False)
    with timer.stage("weights"):
        w = weights  # already assembled
    with timer.stage("matrix"):
        lcu = np.asarray(lcu_combine_diag(x, w, K))
        expected = np.diag(lcu)
    with timer.stage("circuit"):
        circ, alpha = fable(expected)
    with timer.stage("verify"):
        u = np.asarray(unitary(circ))
        block = u[: N * K, : N * K] * alpha * N * K
        diff = np.linalg.norm(block - expected) / np.linalg.norm(expected)

    print(f"System size: {N}x{K} (dimension {N * K}) with degree {d}")
    print(f"Circuit: {circ}")
    print(f"Block-encoding relative error: {diff:.2e}  (contract: < 1e-6)")
    assert diff < 1e-6

    print("\nPer-stage quantum round-trip errors:")
    for stage, err in quantum_verify_pipeline(x, w, N, K).items():
        print(f"  {stage}: {err:.2e}")

    classical = qkan_layer_forward(x, w, N, K)
    quantum = qkan_layer_forward_quantum(x, w, N, K)
    print("\nclassical forward:", np.asarray(classical))
    print("quantum forward:  ", np.asarray(quantum))
    print("max |diff|:", float(jnp.max(jnp.abs(classical - quantum))))

    print()
    print(timer.report(memory_bytes=expected.nbytes))


if __name__ == "__main__":
    main()
