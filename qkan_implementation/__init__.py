"""QKAN: a JAX quantum-simulation + Chebyshev-KAN framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
QKAN_Implementation (Quantum Kolmogorov-Arnold Networks):

- ``ops``        -- the DILATE/CHEB -> MUL -> LCU -> SUM step pipeline as pure,
                    jit/vmap/grad-compatible functions (reference:
                    QKAN_Steps_original/*.py).
- ``sim``        -- a statevector / unitary circuit engine replacing Qiskit Aer,
                    with fused register passes for the hot gate paths and a mesh-sharded
                    statevector for 20+ qubits.
- ``encoding``   -- FABLE block encoding (arXiv:2205.00081) emitting gate IR,
                    replacing the ``fable`` package.
- ``anneal``     -- QUBO construction + on-device batched simulated annealing,
                    replacing pyqubo/cpp_pyqubo + neal.
- ``models``     -- FixedKAN (cumulative-Chebyshev KAN) and the MLP baseline as
                    JAX pytrees (reference: KAN_w_cumulative_polynomials.py,
                    train_utils.py).
- ``optim``      -- DegreeOptimizer fit/predict stack (reference:
                    original_degree_optimizer/, first_conversion_torch/).
- ``parallel``   -- mesh + collective helpers (the distributed comm backend).
- ``data``       -- market-data and MNIST pipelines (reference:
                    Testing and Visualization Framework/data_pipeline.py).
- ``experiments``-- YAML-driven experiment harness (reference: main.py).
- ``analysis``   -- model analysis / sampling diagnostics / sparsity metrics.
"""

__version__ = "0.1.0"
