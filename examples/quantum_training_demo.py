"""Training THROUGH the quantum simulator: gradients across block encodings.

The BASELINE north star the reference never reaches (its quantum path is
forward-only): fit QKAN layer weights by gradient descent where every
forward pass physically round-trips the LCU diagonal through its FABLE
circuit on the statevector engine -- d(loss)/d(weights) flows through
arccos -> gate application -> amplitude extraction.

Runs at the full headline size N=K=16 (a 17-qubit packed simulation per
sample; see ``ops.quantum.quantum_extract_diag_packed``) and records
wall-clock to ``benchmarks/records/quantum_training.json``.

Run:  PYTHONPATH=. JAX_PLATFORMS=cpu python examples/quantum_training_demo.py
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import json
import pathlib
import time

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.ops import qkan_layer_forward_batched
from qkan_implementation.ops.quantum import (
    qkan_layer_forward_quantum_batched,
)


def main(nk: int = 16, batch: int = 8, steps: int = 60):
    N = K = nk
    d = 7
    B = batch
    rng = np.random.default_rng(0)
    # target: outputs of a hidden "true" weight setting on a few probes
    w_true = jnp.asarray(rng.uniform(-0.8, 0.8, (d + 1, N * K)))
    xs = jnp.asarray(rng.uniform(-0.9, 0.9, (B, N)))
    targets = qkan_layer_forward_batched(xs, w_true, N, K)

    def loss(w):
        preds = qkan_layer_forward_quantum_batched(xs, w, N, K)
        return jnp.mean((preds - targets) ** 2)

    import optax

    w = jnp.asarray(rng.uniform(-0.5, 0.5, (d + 1, N * K)))
    tx = optax.adam(0.05)
    opt_state = tx.init(w)
    initial = float(loss(w))
    print(
        f"training QKAN(N={N},K={K},deg={d}) weights through the "
        f"block-encoding simulator ({2 * int(np.log2(N * K)) + 1}-qubit "
        f"packed circuits, batch {B}):"
    )

    # The WHOLE training run is one on-device scan program: no per-step
    # host fetches, and the two chain lengths give a slope-timed ms/step
    # with the fixed per-call cost cancelled.
    def train_chain(n):
        @jax.jit
        def run(w, opt_state):
            def body(carry, _):
                w, opt_state = carry
                l, g = jax.value_and_grad(loss)(w)
                updates, opt_state = tx.update(g, opt_state)
                w = jnp.clip(optax.apply_updates(w, updates), -1.0, 1.0)
                return (w, opt_state), l
            (w, opt_state), losses = jax.lax.scan(
                body, (w, opt_state), None, length=n
            )
            return w, opt_state, losses
        return run

    if steps < 2:
        raise SystemExit("--steps must be >= 2 (slope timing needs two "
                         "distinct chain lengths)")
    short_n = max(steps // 3, 1)
    run_short, run_long = train_chain(short_n), train_chain(steps)
    t_compile0 = time.time()
    np.asarray(run_short(w, opt_state)[2])
    np.asarray(run_long(w, opt_state)[2])
    compile_s = time.time() - t_compile0

    def timed(run):
        t0 = time.time()
        out = run(w, opt_state)
        np.asarray(out[2])  # fetch forces completion
        return time.time() - t0, out

    t_short = min(timed(run_short)[0] for _ in range(2))
    t_long, (w_fin, _, losses) = min(
        (timed(run_long) for _ in range(2)), key=lambda p: p[0]
    )
    ms_per_step = (t_long - t_short) / (steps - short_n) * 1e3
    losses = np.asarray(losses)
    for step in range(0, steps, 10):
        print(f"  step {step:3d}  loss {losses[step]:.3e}")
    final = float(loss(w_fin))
    print(f"loss: {initial:.3e} -> {final:.3e}")
    print(f"compile {compile_s:.1f}s, {steps}-step chain in {t_long:.2f}s "
          f"({ms_per_step:.1f} ms/step slope-timed)")
    assert final < initial / 10.0, "quantum-path training failed to converge"

    record = {
        "workload": f"gradient training through the simulator, "
        f"QKAN(N={N},K={K},deg={d}), batch {B}, {steps} Adam steps "
        f"(single on-device scan program)",
        "dataset": "synthetic probes (hidden true-weight targets)",
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "compile_s": round(compile_s, 2),
        "train_s": round(t_long, 2),
        "ms_per_step": round(ms_per_step, 2),
        "timing": "slope (two chain lengths)",
        "loss_initial": initial,
        "loss_final": final,
    }
    out = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "records"
    out.mkdir(parents=True, exist_ok=True)
    suffix = "" if N == 16 else f"_NK{N}"
    name = f"quantum_training_{jax.devices()[0].platform}{suffix}.json"
    (out / name).write_text(json.dumps(record, indent=1))
    print(f"record -> {out / name}")
    print("OK: gradients through the simulator train the layer")


def main_sharded():
    """Same training, but every per-sample block encoding SHARDS over the
    device mesh (``qkan_layer_forward_quantum_sharded``): the scaling mode
    for encodings past one device's memory.  On a CPU the mesh is
    virtual devices; on several GPUs the identical code spans cards.

    Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
          PYTHONPATH=. python examples/quantum_training_demo.py --sharded
    Add ``--all-to-all`` to exchange qubits with ``all_to_all`` instead of
    the pairwise ``ppermute``.
    """
    import sys
    import optax

    from qkan_implementation.ops.quantum import (
        qkan_layer_forward_quantum_sharded,
    )
    from qkan_implementation.parallel import make_mesh

    n_dev = 1 << (len(jax.devices()).bit_length() - 1)
    mesh = make_mesh(n_dev, axis_name="d")
    N = K = 16
    d = 7
    B = 4
    steps = 20
    rng = np.random.default_rng(0)
    w_true = jnp.asarray(rng.uniform(-0.8, 0.8, (d + 1, N * K)))
    xs = jnp.asarray(rng.uniform(-0.9, 0.9, (B, N)))
    targets = qkan_layer_forward_batched(xs, w_true, N, K)

    impl = "all_to_all" if "--all-to-all" in sys.argv else "collective"

    def loss(w):
        preds = jax.lax.map(
            lambda xi: qkan_layer_forward_quantum_sharded(
                xi, w, N, K, mesh, exchange_impl=impl
            )
        , xs)
        return jnp.mean((preds - targets) ** 2)

    w = jnp.asarray(rng.uniform(-0.5, 0.5, (d + 1, N * K)))
    tx = optax.adam(0.05)
    opt_state = tx.init(w)
    value_and_grad = jax.value_and_grad(loss)
    initial = float(loss(w))
    q = 2 * int(np.log2(N * K)) + 1
    print(
        f"training through MESH-SHARDED {q}-qubit block encodings "
        f"({n_dev} devices, {2**q // n_dev} amplitudes/device):"
    )
    t0 = time.time()
    for step in range(steps):
        l, g = value_and_grad(w)
        updates, opt_state = tx.update(g, opt_state)
        w = jnp.clip(optax.apply_updates(w, updates), -1.0, 1.0)
        if step % 5 == 0 or step == steps - 1:
            print(f"  step {step:3d}  loss {float(l):.3e}")
    train_s = time.time() - t0
    final = float(loss(w))
    print(f"loss: {initial:.3e} -> {final:.3e}  "
          f"({train_s / steps * 1e3:.0f} ms/step, mesh={n_dev})")
    assert final < initial, "sharded quantum-path training failed to improve"
    record = {
        "workload": f"gradient training through MESH-SHARDED block "
        f"encodings, QKAN(N={N},K={K},deg={d}), batch {B}, {steps} steps, "
        f"{n_dev}-device mesh",
        "dataset": "synthetic probes (hidden true-weight targets)",
        "platform": jax.devices()[0].platform,
        "n_devices": n_dev,
        "train_s": round(train_s, 2),
        "ms_per_step": round(train_s / steps * 1e3, 1),
        "loss_initial": initial,
        "loss_final": final,
    }
    out = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "records"
    out.mkdir(parents=True, exist_ok=True)
    name = f"quantum_training_sharded_{jax.devices()[0].platform}.json"
    (out / name).write_text(json.dumps(record, indent=1))
    print(f"record -> {out / name}")
    print("OK: sharded quantum-path training improves the loss")


if __name__ == "__main__":
    import sys

    if "--sharded" in sys.argv:
        main_sharded()
    else:
        nk = 16
        batch = 8
        steps = 60
        if "--nk" in sys.argv:
            nk = int(sys.argv[sys.argv.index("--nk") + 1])
        if "--batch" in sys.argv:
            batch = int(sys.argv[sys.argv.index("--batch") + 1])
        if "--steps" in sys.argv:
            steps = int(sys.argv[sys.argv.index("--steps") + 1])
        main(nk, batch, steps)
