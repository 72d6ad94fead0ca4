"""Smoke test of QKAN's main paths on one NVIDIA GPU.

    python chip_smoke.py           # phases 0-6 on one card
    python chip_smoke.py --multi   # the four-card paths only (4 cards)

Each phase drives the library's own entry points at the full width of the
models the repository supports, checks the result against a plain
reference, and prints one line: the phase, the max error against its
reference, the tolerance, the precision used and the wall time.  A phase
whose error exceeds its tolerance raises, and the script exits non-zero.
The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Without a GPU the script exits non-zero before printing any result.
Weights and data are made from fixed seeds; one process drives the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


class PhaseFailed(AssertionError):
    pass


def report(phase: str, err: float, tol: float, precision: str, t0: float,
           extra: str = "") -> None:
    """Print the phase line; raise when the error is not within tolerance."""
    line = (
        f"[{phase}] max_err={err:.3e} tol={tol:.1e} precision={precision} "
        f"wall={time.perf_counter() - t0:.2f}s"
    )
    print(line + (f" {extra}" if extra else ""), flush=True)
    if not np.isfinite(err) or err > tol:
        raise PhaseFailed(f"{phase}: error {err:.3e} exceeds tolerance {tol:.1e}")


def require_gpu():
    """Phase 0: refuse to run anywhere but on a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke needs a GPU; JAX found {dev.platform!r}")
    return jax


def phase0_device(jax) -> None:
    from qkan_implementation.utils.platform import enable_compile_cache

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    print(
        f"[device] jax={jax.__version__} devices={len(jax.devices())} "
        f"kind={jax.devices()[0].device_kind} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={enable_compile_cache()}",
        flush=True,
    )


# ---------------------------------------------------------------- phase 1
def phase1_flagship(jax, shape=(784, 32, 16, 16, 10), train_size=10000,
                    num_reads=1000, num_sweeps=1000, epochs=8,
                    batch_size=8192) -> None:
    """FixedKAN [784,32,16,16,10] on digits-784: structure search with the
    on-device annealer, a few epochs of training at B=8192, then serving."""
    import jax.numpy as jnp

    from qkan_implementation.data.mnist import (
        load_digits_784,
        sample_train_subset,
        to_one_hot,
    )
    from qkan_implementation.models import FixedKAN, FixedKANConfig
    from qkan_implementation.models.fixed_kan import kan_apply
    from qkan_implementation.serving import BatchedPredictor

    t0 = time.perf_counter()
    x_full, y_full, _ = load_digits_784(
        train=True, augment_to=train_size, seed=0
    )
    x_train, y_labels = sample_train_subset(x_full, y_full, train_size, seed=0)
    x_test, y_test, _ = load_digits_784(train=False)
    x_train = jnp.asarray(x_train, jnp.float32)
    # the improved config of benchmarks/mnist_shape_evidence.py, with the
    # default 'svd' structure search in place of its 'normal' one: the SVD
    # sweep runs through cuSOLVER here, on the rank-deficient T_0 columns
    kan = FixedKAN(FixedKANConfig(
        network_shape=list(shape), max_degree=5,
        complexity_weight=0.001, degree_objective="penalized_mse",
        consistent_tanh=True,
    ))
    kan.optimize(
        x_train, jnp.asarray(to_one_hot(y_labels, 10), jnp.float32),
        num_reads=num_reads, num_sweeps=num_sweeps, seed=0,
    )
    coeffs_finite = all(
        bool(jnp.isfinite(lp["coefficients"]).all()) for lp in kan.params
    )
    t_search = time.perf_counter() - t0
    losses = kan.train(
        x_train, jnp.asarray(y_labels), epochs=epochs, batch_size=batch_size,
        learning_rate=0.002, trainable="all", lr_scale="fanin",
        grad_clip=1.0, seed=0,
    )
    if not coeffs_finite or not np.all(np.isfinite(losses)):
        raise PhaseFailed(f"flagship: non-finite coefficients or losses {losses}")
    if not losses[-1] < losses[0]:
        raise PhaseFailed(f"flagship: loss did not decrease: {losses}")

    predictor = BatchedPredictor(kan, max_batch=4096)
    predictor.warmup()
    xt = np.asarray(x_test, np.float32)
    served = np.concatenate([
        predictor.predict(xt[a:b])
        for a, b in ((0, 1), (1, 8), (8, 45), (45, 300), (300, len(xt)))
    ])
    direct = np.asarray(kan(xt))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(
            lambda p, x: kan_apply(p, x, 5, backend="xla")
        )(kan.params, jnp.asarray(xt)))
    scale = float(np.max(np.abs(ref)))
    err = max(
        float(np.max(np.abs(served - ref))), float(np.max(np.abs(direct - ref)))
    ) / scale
    agree = float(np.mean(served.argmax(1) == ref.argmax(1)))
    acc = float(np.mean(served.argmax(1) == y_test))
    # relative to the logit scale: TF32 keeps 11 significant bits (2^-11
    # ~ 4.9e-4 per operand), and the 4704-term layer-0 contraction adds
    # that rounding up in random-walk fashion
    report(
        "flagship_train_serve", err, 5e-3,
        "train: default (TF32); serve: 'auto' (BF16_BF16_F32_X3 at fan-in "
        ">= 512, default below)", t0,
        f"losses={[round(v, 4) for v in losses]} argmax_agree={agree:.4f} "
        f"test_acc={acc:.4f} structure_search={t_search:.1f}s "
        f"requests={predictor.stats()['requests']}",
    )
    if agree < 0.99:
        raise PhaseFailed(f"flagship: argmax agreement {agree:.4f} < 0.99")


# ---------------------------------------------------------------- phase 2
def _numpy_layer_f64(x, w, N, K):
    """f64 NumPy forward of the batched QKAN layer and the gradient of
    sum(out^2) w.r.t. the weights (the reference fold, written out)."""
    dp1 = w.shape[0]
    xc = np.clip(x, -1.0, 1.0)
    T = np.cos(np.arange(dp1)[None, None, :] * np.arccos(xc)[:, :, None])
    j = np.arange(K)[:, None] * N + np.arange(N)[None, :]  # [K, N]
    n_idx = j // K
    Tg = T[:, n_idx, :]  # [B, K, N, dp1]
    wg = w[:, j]  # [dp1, K, N]
    out = np.einsum("bknd,dkn->bk", Tg, wg) / (N * dp1)
    g = 2.0 * np.einsum("bk,bknd->dkn", out, Tg) / (N * dp1)
    grad = np.zeros_like(w)
    grad[:, j] = g
    return out, grad


def phase2_layer_op(jax, batch=262144, rows=4096) -> None:
    """ops.qkan_layer_forward_batched at N=K=16, D=7, B=262144."""
    import jax.numpy as jnp

    from bench import reference_faithful_forward
    from qkan_implementation.ops import qkan_layer_forward_batched

    N = K = 16
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (batch, N))
    w = rng.uniform(-1, 1, (8, N * K))
    xs, ws = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
    ref_out, ref_grad = _numpy_layer_f64(x[:rows], w, N, K)
    faithful = np.stack(
        [reference_faithful_forward(x[i], w, N, K) for i in range(8)]
    )
    if np.max(np.abs(faithful - ref_out[:8])) > 1e-12:
        raise PhaseFailed("layer: vectorized f64 reference disagrees")

    def loss(w, x):
        return jnp.sum(qkan_layer_forward_batched(x, w, N, K) ** 2)

    # f32 everywhere; TF32 rounds each operand to 11 significant bits
    for prec, tol_out, tol_grad in (
        ("highest", 1e-5, 1e-5), ("default", 2e-3, 2e-3),
    ):
        t0 = time.perf_counter()
        with jax.default_matmul_precision(prec):
            fwd = jax.jit(lambda x, w: qkan_layer_forward_batched(x, w, N, K))
            out = np.asarray(fwd(xs, ws))
            grad = jax.jit(jax.grad(loss))
            g_full = jax.block_until_ready(grad(ws, xs))
            g_rows = np.asarray(grad(ws, xs[:rows]))
        if not np.all(np.isfinite(np.asarray(g_full))) or out.shape != (batch, K):
            raise PhaseFailed("layer: non-finite output or wrong shape")
        e_out = float(np.max(np.abs(out[:rows] - ref_out)) / np.max(np.abs(ref_out)))
        e_grad = float(np.max(np.abs(g_rows - ref_grad)) / np.max(np.abs(ref_grad)))
        report(f"layer_op_fwd[{prec}]", e_out, tol_out, prec, t0)
        report(f"layer_op_grad[{prec}]", e_grad, tol_grad, prec, t0)


# ---------------------------------------------------------------- phase 3
def phase3_fable(jax, ns=(10, 12)) -> None:
    """simulate(fable(A)) at 21 and 25 qubits, fused executor vs the
    unfused oracle, and the block-encoding contract at N=16."""
    import jax.numpy as jnp

    from qkan_implementation.encoding import fable
    from qkan_implementation.sim import simulate, unitary

    rng = np.random.default_rng(1)
    for n in ns:
        t0 = time.perf_counter()
        circ, _ = fable(rng.uniform(-1, 1, (2**n, 2**n)))
        auto = np.asarray(simulate(circ, dtype=jnp.float32, backend="auto"))
        oracle = np.asarray(simulate(circ, dtype=jnp.float32, backend="xla"))
        err = float(np.max(np.abs(auto - oracle)) / np.max(np.abs(oracle)))
        report(f"fable_simulate_q{circ.num_qubits}", err, 1e-5,
               "float32, HIGHEST gate contractions", t0)
    t0 = time.perf_counter()
    a = rng.uniform(-1, 1, (16, 16)).astype(np.float32)
    circ, alpha = fable(a)
    u = np.asarray(unitary(circ, dtype=jnp.float32))
    rec = u[:16, :16] * alpha * 16
    err = float(np.linalg.norm(rec - a) / np.linalg.norm(a))
    report("fable_block_encoding_N16", err, 1e-6,
           "float32, Precision.HIGHEST", t0)


# ---------------------------------------------------------------- phase 4
def phase4_quantum_training(jax) -> None:
    """One gradient step through the quantum-mode layer (the block
    encoding simulated in the loop) against the classical layer."""
    import jax.numpy as jnp

    from qkan_implementation.ops import qkan_layer_forward
    from qkan_implementation.ops.quantum import qkan_layer_forward_quantum

    N = K = 16
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.uniform(-1, 1, N), jnp.float32)
    w = jnp.asarray(rng.uniform(-1, 1, (8, N * K)), jnp.float32)
    t0 = time.perf_counter()
    gq = np.asarray(jax.jit(jax.grad(
        lambda w: jnp.sum(qkan_layer_forward_quantum(x, w, N, K) ** 2)
    ))(w))
    gc = np.asarray(jax.jit(jax.grad(
        lambda w: jnp.sum(qkan_layer_forward(x, w, N, K) ** 2)
    ))(w))
    err = float(np.max(np.abs(gq - gc)) / np.max(np.abs(gc)))
    # packed extraction rescales the f32 state by alpha * size^1.5 (4096 *
    # alpha at N*K=256), and arccos' slope grows near |x| = 1: the CPU's
    # exact f32 run of this phase measures 1.4e-4
    report("quantum_mode_grad_N16", err, 1e-3, "float32", t0)


# ---------------------------------------------------------------- phase 5
def phase5_annealer(jax, funcs=128, reads=1000, sweeps=1000,
                    native_reads=16) -> None:
    """Dense degree QUBO at n=1024: 128 functions x 8 degrees with weak
    dense cross-function couplings, 1000 reads x 1000 sweeps on the card,
    against the native C++ sampler."""
    from qkan_implementation.anneal import (
        QuboModel,
        degree_selection_qubo,
        polish_one_hot_blocks,
        simulated_annealing,
    )
    from qkan_implementation.native_bindings import anneal_native

    rng = np.random.default_rng(3)
    dp1 = 8
    scores = np.sort(rng.uniform(0.01, 1.0, dp1))[::-1]
    base = degree_selection_qubo(
        scores, num_functions=funcs, complexity_weight=0.001,
        objective="penalized_mse",
    )
    n = base.num_variables
    c = rng.normal(0.0, 0.01 / np.sqrt(n), (n, n))
    model = QuboModel(h=base.h, J=base.J + c + c.T, offset=base.offset)
    t0 = time.perf_counter()
    samples, _ = simulated_annealing(
        model, num_reads=reads, num_sweeps=sweeps, seed=0
    )
    samples = polish_one_hot_blocks(model, samples, dp1)
    e_dev = model.energy(samples)
    best = samples[int(np.argmin(e_dev))]
    one_hot = bool(np.all(best.reshape(funcs, dp1).sum(1) == 1))
    t_dev = time.perf_counter() - t0
    nat, _ = anneal_native(
        model, num_reads=native_reads, num_sweeps=sweeps, seed=0
    )
    e_nat = float(np.min(model.energy(polish_one_hot_blocks(model, nat, dp1))))
    # the card's 1000 reads must do at least as well as 16 native reads,
    # up to 0.5% of the energy scale
    gap = (float(np.min(e_dev)) - e_nat) / abs(e_nat)
    if not one_hot:
        raise PhaseFailed("annealer: best sample is not one-hot after polish")
    report("anneal_n1024", max(gap, 0.0), 5e-3, "float32", t0,
           f"E_device={float(np.min(e_dev)):.6f} E_native={e_nat:.6f} "
           f"device_anneal={t_dev:.2f}s")


# ---------------------------------------------------------------- phase 6
def phase6_kernel(jax) -> None:
    """The fused layer kernel at the flagship layer-0 shape against the
    plain XLA layer (benchmarks/fused_layer_bench.py): forward at TF32 and
    at BF16_BF16_F32_X3, weight gradient at TF32.  Errors against full f32;
    times are device time per call, read from a trace."""
    from benchmarks.fused_layer_bench import layer0_rows

    t0 = time.perf_counter()
    rows = layer0_rows(calls=20)
    # TF32 keeps 11 significant bits; three bf16 passes are about f32
    tols = {"fwd_tf32": 2e-3, "fwd_bf16x3": 1e-4, "dw_tf32": 2e-3}
    for name, row in rows.items():
        if not row["kernel_in_trace"]:
            raise PhaseFailed(f"{name}: no kan_layer_fused kernel in the trace")
        report(f"fused_kernel_layer0[{name}]", row["err_kernel"], tols[name],
               "BF16_BF16_F32_X3" if "bf16x3" in name else "default (TF32)",
               t0, f"kernel_ms={row['kernel_ms']:.4f} xla_ms={row['xla_ms']:.4f} "
               f"xla_err={row['err_xla']:.3e}")


# ---------------------------------------------------------------- --multi
def multi_sharded_fable(jax, n=12) -> None:
    """sharded_simulate of a 25-qubit FABLE circuit over the 4 cards with
    both exchange collectives, against single-card simulate."""
    import jax.numpy as jnp

    from qkan_implementation.encoding import fable
    from qkan_implementation.parallel import make_mesh
    from qkan_implementation.sim import sharded_simulate, simulate

    rng = np.random.default_rng(5)
    circ, _ = fable(rng.uniform(-1, 1, (2**n, 2**n)))
    mesh = make_mesh(4, axis_name="d")
    dense = np.asarray(simulate(circ, dtype=jnp.float32))
    for impl in ("collective", "all_to_all"):
        t0 = time.perf_counter()
        psi = sharded_simulate(circ, mesh, dtype=jnp.float32, exchange_impl=impl)
        got = np.asarray(jax.device_get(psi))
        err = float(np.max(np.abs(got - dense)) / np.max(np.abs(dense)))
        report(f"sharded_fable_q{circ.num_qubits}[{impl}]", err, 1e-5,
               "float32, HIGHEST gate contractions", t0)


def multi_dp_train(jax, shape=(784, 32, 16, 16, 10), rows=16384,
                   batch_size=8192) -> None:
    """FixedKAN.train(mesh=...) data-parallel over the 4 cards against the
    same training on one card, flagship shape, seeded random weights."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from qkan_implementation.models import FixedKAN, FixedKANConfig

    rng = np.random.default_rng(6)
    D = 5
    params, in_dim = [], shape[0]
    for out in shape[1:]:
        params.append({
            "degrees": jnp.asarray(rng.integers(1, D + 1, out), jnp.int32),
            "coefficients": jnp.asarray(
                rng.normal(0, 0.01, (out, in_dim, D + 1, 10)), jnp.float32
            ),
            "horizontal_weights": jnp.ones(out, jnp.float32),
        })
        in_dim = 10
    x = jnp.asarray(rng.uniform(0, 1, (rows, shape[0])), jnp.float32)
    y = jnp.asarray(rng.integers(0, 10, rows))
    kw = dict(epochs=3, batch_size=batch_size, learning_rate=0.002,
              trainable="all",
              lr_scale="fanin", grad_clip=1.0, seed=0,
              matmul_precision="highest")
    losses = {}
    for name, mesh in (
        ("one_card", None),
        ("dp4", Mesh(np.asarray(jax.devices()[:4]), ("dp",))),
    ):
        kan = FixedKAN(FixedKANConfig(network_shape=list(shape), max_degree=D))
        kan.params = params
        t0 = time.perf_counter()
        losses[name] = np.asarray(kan.train(x, y, mesh=mesh, **kw))
    # same global batches in the same order; only the cross-card gradient
    # all-reduce changes the f32 summation order
    err = float(np.max(np.abs(losses["dp4"] - losses["one_card"])
                       / np.abs(losses["one_card"])))
    report("dp_train_4cards", err, 1e-4, "highest", t0,
           f"losses_dp4={losses['dp4'].round(6).tolist()} "
           f"losses_one_card={losses['one_card'].round(6).tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    args = ap.parse_args()
    jax = require_gpu()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase0_device(jax)
    if args.multi:
        if len(jax.devices()) < 4:
            sys.exit(f"--multi needs 4 GPUs; JAX found {len(jax.devices())}")
        phases = (multi_sharded_fable, multi_dp_train)
    else:
        phases = (phase1_flagship, phase2_layer_op, phase3_fable,
                  phase4_quantum_training, phase5_annealer, phase6_kernel)
    for phase in phases:
        phase(jax)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
