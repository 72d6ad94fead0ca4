"""Block encoding at scale: a 2^n x 2^n matrix through the simulator.

The reference's largest exercised encoding is an N*K = 32 diagonal (a
7-qubit block + FABLE ancillas, LCUStep.py:111-116), bounded by Aer's
gate-by-gate unitary accumulation.  This demo block-encodes a matrix
thousands of times larger and recovers a column from ONE fused
statevector simulation with runtime rotation parameters
(``sim.fusion.simulate_fable_runtime`` -- H walls as register
contractions, the multiplexed rotation as one fused elementwise pass, the
register swap as one transpose).  On a GPU, n=13 (an 8192x8192 encoding, a
27-qubit / 134M-amplitude circuit) fits easily; its time there is not
measured yet.

Run:  PYTHONPATH=. python examples/block_encoding_at_scale.py --n 10
      (n=13 on a GPU; keep n <= 10 on CPU)
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.encoding import fable_runtime_params
from qkan_implementation.sim.fusion import simulate_fable_runtime


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10, help="encoded matrix is 2^n x 2^n")
    ap.add_argument("--column", type=int, default=3)
    args = ap.parse_args()
    n, col = args.n, args.column
    size = 2**n
    q = 2 * n + 1

    rng = np.random.default_rng(0)
    diag = rng.uniform(-1, 1, size)
    a = np.diag(diag)
    print(f"encoding a {size}x{size} matrix -> {q}-qubit circuit "
          f"({2**q:,} amplitudes) on {jax.devices()[0]}")

    t0 = time.time()
    cs, sn, alpha, _ = fable_runtime_params(a)
    print(f"host FABLE params: {time.time() - t0:.1f}s "
          f"({cs.nbytes / 1e6:.0f} MB per array, riding as runtime args)")
    cs = jnp.asarray(cs, dtype=jnp.float32)
    sn = jnp.asarray(sn, dtype=jnp.float32)

    @jax.jit
    def encode_column(cs, sn, e):
        psi = simulate_fable_runtime(cs, sn, n, psi0=e)
        return psi[:size] * (alpha * size)

    e = jnp.zeros(2**q, dtype=jnp.float32).at[col].set(1.0)
    t0 = time.time()
    recovered = np.asarray(encode_column(cs, sn, e))
    compile_s = time.time() - t0
    t0 = time.time()
    recovered = np.asarray(encode_column(cs, sn, e))
    run_s = time.time() - t0

    expected = a[:, col]
    err = np.max(np.abs(recovered - expected))
    print(f"compile {compile_s:.1f}s, steady {run_s * 1e3:.0f} ms per simulation")
    print(f"column {col}: recovered[{col}]={recovered[col]:.6f} "
          f"vs a[{col},{col}]={diag[col]:.6f}; max abs err {err:.2e}")
    assert err < 5e-4 * max(1.0, alpha)
    print("OK: block contract holds at scale")


if __name__ == "__main__":
    main()
