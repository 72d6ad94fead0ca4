"""Sharded-statevector benchmark: exchange counts + wall-clock on a mesh.

On the virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8)
this quantifies the *schedule*: how many qubit-remap collectives the lazy
layout issues for real workloads vs the naive exchange-in/out-per-gate
bound, and the wall-clock effect of chunked exchanges.  On several GPUs the
same schedule runs as NCCL collectives over NVLink.

Run: PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         python benchmarks/sharded_bench.py --qubits 22
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import jax as _jax

# the exactness section compares f64 amplitudes; without x64 the float64
# request silently degrades to f32 and 1e-12 bars become unreachable
_jax.config.update("jax_enable_x64", True)

import argparse
import json
import pathlib
import time

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.parallel import make_mesh
from qkan_implementation.sim import Circuit
from qkan_implementation.sim.sharded import count_exchanges, sharded_simulate


def fable_circuit(n: int):
    from qkan_implementation.encoding import fable

    rng = np.random.default_rng(0)
    circ, _ = fable(np.diag(rng.uniform(-1, 1, 2**n)))
    return circ


def global_heavy_circuit(q: int, layers: int = 4):
    """Worst case: every layer acts on the top (global) qubits."""
    rng = np.random.default_rng(1)
    circ = Circuit(q)
    for _ in range(layers):
        for t in range(q - 4, q):
            circ.h(t)
            circ.cry(float(rng.uniform(0, np.pi)), t, (t + 3) % q)
    return circ


def naive_exchange_bound(circ: Circuit, q_local: int) -> int:
    """Exchange count of the strawman schedule: swap every global qubit in
    and back out around each gate that touches it."""
    count = 0
    for g in circ.gates:
        qubits = g.qubits if g.name != "ucry" else g.qubits[:1]
        if g.name == "diag":
            continue
        count += 2 * sum(1 for t in qubits if t >= q_local)
    return count


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--qubits", type=int, default=22)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument(
        "--exchange-impl", default="collective",
        choices=["collective", "all_to_all"],
        help="'all_to_all' uses the grouped all_to_all exchange lowering",
    )
    ap.add_argument(
        "--exact-qubits", type=int, default=20,
        help="amplitude-exact sharded-vs-dense comparison size (f64; 0 "
        "disables).  VERDICT r2 item 5: push exactness to the memory edge "
        "of the CPU mesh",
    )
    ap.add_argument(
        "--marginals-qubits", type=int, nargs="*", default=[27],
        help="large sharded runs checked via analytic marginals (f32; "
        "empty disables) -- 27 pairs with the single-chip dense record; "
        "30 is the per-device memory demo: the accounting shows each "
        "device holds 1/8 of the state",
    )
    args = ap.parse_args()

    n_dev = args.devices or min(8, len(jax.devices()))
    mesh = make_mesh(n_dev, axis_name="d")
    k = int(np.log2(n_dev))
    records = []

    workloads = {
        f"fable_diag_n{(args.qubits - 1) // 2}": fable_circuit(
            (args.qubits - 1) // 2
        ),
        f"global_heavy_q{args.qubits}": global_heavy_circuit(args.qubits),
    }
    for name, circ in workloads.items():
        q_local = circ.num_qubits - k
        lazy = count_exchanges(circ, n_dev)
        naive = naive_exchange_bound(circ, q_local)
        row = {
            "workload": name,
            "qubits": circ.num_qubits,
            "gates": circ.gate_count,
            "devices": n_dev,
            "exchanges_lazy_layout": lazy,
            "exchanges_naive_bound": naive,
        }
        row["exchange_impl"] = args.exchange_impl
        for chunks in (1, 4):
            f = jax.jit(
                lambda c=circ, ch=chunks: sharded_simulate(
                    c, mesh, dtype=jnp.float32, exchange_chunks=ch,
                    exchange_impl=args.exchange_impl,
                )
            )
            psi = f()
            jax.block_until_ready(psi)
            t0 = time.time()
            psi = f()
            jax.block_until_ready(psi)
            row[f"wall_s_chunks{chunks}"] = round(time.time() - t0, 4)
        row["platform"] = jax.devices()[0].platform
        records.append(row)
        print(row)

    if args.exact_qubits:
        from qkan_implementation.sim import simulate

        q = args.exact_qubits
        rng = np.random.default_rng(7)
        circ = Circuit(q)
        for t in range(q):
            circ.ry(float(rng.uniform(-2, 2)), t)
        for t in range(q - 5, q):  # global-qubit traffic
            circ.h(t)
        circ.cx(q - 1, 0).cx(3, q - 2).swap(q - 3, 1)
        circ.ucry(
            rng.uniform(-2, 2, 2 ** (q - 1)),
            tuple(range(q - 2, -1, -1)),
            q - 1,
        )
        dense = np.asarray(simulate(circ, dtype=jnp.float64))
        row = {
            "workload": f"exact_q{q}_random",
            "qubits": q,
            "gates": circ.gate_count,
            "devices": n_dev,
            "dtype": "float64",
            "platform": jax.devices()[0].platform,
        }
        for impl in ("collective", "all_to_all"):
            for chunks in (1, 4):
                t0 = time.time()
                shard = np.asarray(
                    jax.device_get(
                        sharded_simulate(
                            circ, mesh, dtype=jnp.float64,
                            exchange_impl=impl, exchange_chunks=chunks,
                        )
                    )
                )
                err = float(np.max(np.abs(shard - dense)))
                row[f"max_abs_err_{impl}_chunks{chunks}"] = err
                row[f"wall_s_{impl}_chunks{chunks}"] = round(
                    time.time() - t0, 3
                )
                assert err < 1e-12, (impl, chunks, err)
        records.append(row)
        print(row)

    from functools import partial

    for q in args.marginals_qubits:
        # q=0 is the historical "disable" value (the flag was a single int
        # before it took a list), and the workload's entanglers/probe
        # qubits (cx on 5 and q-2, marginals at t=5) need q >= 7: skip
        # rather than crash deep in circuit construction.
        if q < 7:
            print(f"skipping marginals q={q}: workload needs q >= 7")
            continue
        rng = np.random.default_rng(23)
        thetas = rng.uniform(0.2, np.pi - 0.2, q)
        circ = Circuit(q)
        for t in range(q):
            circ.ry(float(thetas[t]), t)
        circ.cx(q - 1, 0).cx(5, q - 2)
        t0 = time.time()
        psi = sharded_simulate(circ, mesh, dtype=jnp.float32)
        jax.block_until_ready(psi)
        wall = time.time() - t0

        p1 = np.sin(thetas / 2.0) ** 2
        expect = p1.copy()
        expect[0] = p1[q - 1] * (1 - p1[0]) + (1 - p1[q - 1]) * p1[0]
        expect[q - 2] = p1[5] * (1 - p1[q - 2]) + (1 - p1[5]) * p1[q - 2]

        @partial(jax.jit, static_argnames=("t",))
        def marginal(psi, t):
            probs = (psi.astype(jnp.float32) ** 2).reshape(-1, 2, 2**t)
            return jnp.sum(probs[:, 1, :])

        errs = [
            abs(float(marginal(psi, t)) - expect[t])
            for t in (0, 5, q // 2, q - 2, q - 1)
        ]
        norm = float(jnp.sum(psi.astype(jnp.float32) ** 2))
        # per-device memory accounting: read bytes off the live device
        # buffers, next to the DENSE engine's working set (in+out state
        # per gate application)
        from qkan_implementation.sim.sharded import shard_memory_report

        mem = shard_memory_report(psi)
        assert mem["balanced"] and mem["devices"] == n_dev, mem
        row = {
            "workload": f"marginals_q{q}_sharded",
            "qubits": q,
            "devices": n_dev,
            "dtype": "float32",
            "amplitudes": 2**q,
            "wall_s_first_call": round(wall, 3),
            "max_marginal_abs_err": float(np.max(errs)),
            "norm_err": abs(norm - 1.0),
            "state_gib": round(mem["logical_bytes"] / 2**30, 4),
            "bytes_per_device": mem["max_bytes_per_device"],
            "memory_balanced": mem["balanced"],
            "dense_single_chip_working_set_gib": round(
                2 * mem["logical_bytes"] / 2**30, 4
            ),
            "platform": jax.devices()[0].platform,
        }
        assert row["max_marginal_abs_err"] < 1e-4, row
        records.append(row)
        print(row)

    out = pathlib.Path(__file__).resolve().parent / "records"
    out.mkdir(parents=True, exist_ok=True)
    (out / "sharded_statevector.json").write_text(json.dumps(records, indent=1))
    print(f"records -> {out / 'sharded_statevector.json'}")


if __name__ == "__main__":
    main()
