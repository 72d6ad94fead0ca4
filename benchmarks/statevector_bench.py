"""Statevector gate-throughput benchmark on the device.

Measures per-gate wall time and effective memory bandwidth for the FABLE
hot ops (MSB-targeted uniformly-controlled Ry, Hadamard) at a given qubit
count, plus a full FABLE block-encoding simulation.  Both gates are
streaming elementwise passes that XLA fuses into one loop each.  The
reference's equivalent runtime is Qiskit Aer's C++ gate loop (SURVEY.md
section 3.2):

    PYTHONPATH=. python benchmarks/statevector_bench.py --qubits 21
"""

from __future__ import annotations

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import json
import pathlib
import time

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--qubits", type=int, default=21)
    parser.add_argument("--iters", type=int, default=100)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from qkan_implementation.sim.circuit import Gate
    from qkan_implementation.sim.statevector import _apply_ucry, apply_gate
    from qkan_implementation.utils.profiling import timeit_chained

    q = args.qubits
    dim = 2**q
    print(f"device={jax.devices()[0]} qubits={q} amplitudes={dim:,}")

    rng = np.random.default_rng(0)
    psi = jnp.asarray(rng.normal(size=dim), dtype=jnp.float32)
    psi = psi / jnp.linalg.norm(psi)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, dim // 2), dtype=jnp.float32)

    results = {}
    controls = tuple(range(q - 2, -1, -1))
    # the angles ride as an operand, not a program constant
    dt = timeit_chained(
        lambda p, th: _apply_ucry(p, th, q - 1, controls, q),
        psi,
        iters=args.iters,
        consts=(thetas,),
    )
    results["xla_ucry_ms"] = dt * 1e3
    # psi read + written, angles read: 4 bytes each
    results["xla_ucry_gbps"] = (2 * dim + dim // 2) * 4 / dt / 1e9

    h_gate = Gate("h", (q // 2,))
    dt = timeit_chained(
        lambda p: apply_gate(p, h_gate, q), psi, iters=args.iters
    )
    results["xla_h_ms"] = dt * 1e3
    results["xla_h_gbps"] = 2 * dim * 4 / dt / 1e9

    # Aer-class CPU baseline (native/qkan_native.cpp dense gate loop): the
    # denominator of BASELINE.md's "gate-ops/sec vs Aer CPU" north star.
    # Per-gate rows on the same state size as the device rows above.
    from qkan_implementation.native_bindings import (
        native_available,
        statevector_native,
        sv_encode_circuit,
    )
    from qkan_implementation.sim.circuit import Circuit

    if native_available() and q <= 26:
        th_np = np.asarray(thetas, dtype=np.float64)
        cu = Circuit(q)
        cu.ucry(th_np, tuple(range(q - 2, -1, -1)), q - 1)
        ch = Circuit(q)
        ch.h(q // 2)
        psi0 = np.asarray(psi, dtype=np.complex128)
        for name, circn in (("ucry", cu), ("h", ch)):
            enc = sv_encode_circuit(circn)
            reps = max(1, args.iters // 20)
            statevector_native(circn, psi0=psi0, encoded=enc)  # warm cache
            t0 = time.perf_counter()
            for _ in range(reps):
                statevector_native(circn, psi0=psi0, encoded=enc)
            dt = (time.perf_counter() - t0) / reps
            results[f"native_{name}_ms"] = dt * 1e3
        results["ucry_vs_aer_class"] = (
            results["native_ucry_ms"] / results["xla_ucry_ms"]
        )

    # Full FABLE simulation (auto backend): circuit has 2n+1 = q qubits when
    # the encoded block is 2^((q-1)/2).  Static circuit params become
    # program constants, so this row stops at 25 qubits.
    if q % 2 == 1 and q <= 25:
        from qkan_implementation.encoding import fable
        from qkan_implementation.sim import simulate

        n = (q - 1) // 2
        a = rng.uniform(-1, 1, (2**n, 2**n))
        circ, _ = fable(a)
        dt = timeit_chained(
            lambda p: simulate(circ, psi0=p), psi, iters=max(args.iters // 5, 5)
        )
        results["fable_sim_ms"] = dt * 1e3
        results["fable_gates_per_sec"] = circ.gate_count / dt
        if native_available() and q <= 25:
            enc = sv_encode_circuit(circ)
            psi0 = np.asarray(psi, dtype=np.complex128)
            statevector_native(circ, psi0=psi0, encoded=enc)  # warm
            reps = max(1, args.iters // 50)
            t0 = time.perf_counter()
            for _ in range(reps):
                statevector_native(circ, psi0=psi0, encoded=enc)
            dt_n = (time.perf_counter() - t0) / reps
            results["native_fable_sim_ms"] = dt_n * 1e3
            results["native_fable_gates_per_sec"] = circ.gate_count / dt_n
            results["fable_vs_aer_class"] = dt_n / dt

    for k, v in results.items():
        print(f"{k}: {v:,.3f}")
    results.update({"qubits": q, "device": str(jax.devices()[0])})
    out = pathlib.Path(__file__).resolve().parent / "records"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"statevector_q{q}.json").write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
