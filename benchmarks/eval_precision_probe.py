"""Which matmul precision does the flagship model need on this device?

Trains the flagship FixedKAN ([784, 32, 16, 16, 10], degree 5, the
improved+trained recipe of ``mnist_shape_evidence.py``) on digits-784 for
a few seeds, once with every training matmul at 'highest' (full f32) and
once at the device default (TF32 tensor-core products on a GPU).  Each
trained model is then evaluated with the SAME parameters under every
forward precision the library or a caller could pick:

- ``highest``   full f32 (the reference);
- ``default``   device default, XLA (TF32 on a GPU);
- ``fused``     the fused layer kernel at its default (TF32) precision;
- ``bf16x3``    XLA's BF16_BF16_F32_X3 dot algorithm (three bf16 passes);
- ``bf16x2_w`` / ``bf16x2_x``  two bf16 passes, one operand split;
- ``bf16io``, ``int8``, ``int8x2``, ``int8x2w``  the serving recipes.

A mode matches 'highest' when its test accuracy is within ``TOLERANCE``
of the 'highest' row on every seed: one test image in 360 is 0.0028, so
0.006 allows two images either way on identical parameters.

Run: python benchmarks/eval_precision_probe.py [--seeds 0 1 2]
"""

import argparse
import json
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

TOLERANCE = 0.006


def _forward(params, x, max_degree, matmul):
    """Probe-local forward with a caller-supplied layer matmul."""
    from qkan_implementation.ops.chebyshev import chebyshev_basis

    cur = x
    for lp in params:
        basis = chebyshev_basis(jnp.tanh(cur), max_degree, clip=False)
        mask = jnp.arange(max_degree + 1)[None, :] <= lp["degrees"][:, None]
        W = jnp.einsum(
            "oidt,od->idt", lp["coefficients"],
            mask.astype(jnp.float32) * lp["horizontal_weights"][:, None],
        ).reshape(-1, lp["coefficients"].shape[-1])
        cur = matmul(basis.reshape(x.shape[0], -1), W)
    return cur


def _bf16x2(split_weights):
    def mm(a, w):
        split, keep = (w, a) if split_weights else (a, w)
        hi = split.astype(jnp.bfloat16)
        lo = (split - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        kb = keep.astype(jnp.bfloat16)
        dot = lambda p, q: jnp.matmul(p, q, preferred_element_type=jnp.float32)
        if split_weights:
            return dot(kb, hi) + dot(kb, lo)
        return dot(hi, kb) + dot(lo, kb)

    return mm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--train-size", type=int, default=10000)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument(
        "--out", default=None,
        help="record path (default benchmarks/records/"
        "eval_precision_probe_<platform>.json)",
    )
    args = ap.parse_args()

    from qkan_implementation.data.mnist import (
        load_digits_784,
        sample_train_subset,
        to_one_hot,
    )
    from qkan_implementation.models import FixedKAN, FixedKANConfig
    from qkan_implementation.models.fixed_kan import kan_apply

    x_test, y_test, _ = load_digits_784(train=False)
    D = 5
    modes = {
        "highest": dict(matmul_precision="highest", backend="xla"),
        "default": dict(matmul_precision=None, backend="xla"),
        "fused": dict(matmul_precision=None, backend="fused"),
        "bf16io": dict(compute_dtype=jnp.bfloat16, backend="xla"),
        "int8": dict(compute_dtype=jnp.int8, backend="xla"),
        "int8x2": dict(compute_dtype="int8x2", backend="xla"),
        "int8x2w": dict(compute_dtype="int8x2w", backend="xla"),
    }
    local = {
        "bf16x3": lambda a, w: jnp.matmul(
            a, w, precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
        ),
        "bf16x2_w": _bf16x2(True),
        "bf16x2_x": _bf16x2(False),
    }
    rec = {
        "device": jax.devices()[0].device_kind,
        "platform": jax.devices()[0].platform,
        "tolerance": TOLERANCE,
        "runs": [],
    }
    for seed in args.seeds:
        x_full, y_full, meta = load_digits_784(
            train=True, augment_to=args.train_size, seed=seed
        )
        x_train, y_labels = sample_train_subset(
            x_full, y_full, args.train_size, seed=seed
        )
        kan = FixedKAN(FixedKANConfig(
            network_shape=[784, 32, 16, 16, 10], max_degree=D,
            complexity_weight=0.001, degree_objective="penalized_mse",
            consistent_tanh=True, lstsq_method="normal",
        ))
        kan.optimize(
            jnp.asarray(x_train, jnp.float32),
            jnp.asarray(to_one_hot(y_labels, 10), jnp.float32), seed=seed,
        )
        searched = kan.params
        for train_prec in ("highest", None):
            kan.params = searched
            losses = kan.train(
                jnp.asarray(x_train, jnp.float32), jnp.asarray(y_labels),
                epochs=args.epochs, learning_rate=0.002, trainable="all",
                lr_scale="fanin", grad_clip=1.0, batch_size=64, seed=seed,
                matmul_precision=train_prec,
            )
            row = {
                "seed": seed,
                "train_precision": train_prec or "default",
                "final_loss": losses[-1],
            }
            xt = jnp.asarray(x_test, jnp.float32)
            for name, kw in modes.items():
                with jax.default_matmul_precision(None):
                    logits = jax.jit(
                        lambda p, xb: kan_apply(p, xb, D, **kw)
                    )(kan.params, xt)
                row[name] = float(
                    (np.asarray(logits).argmax(1) == y_test).mean()
                )
            for name, mm in local.items():
                try:
                    logits = jax.jit(
                        lambda p, xb: _forward(p, xb, D, mm)
                    )(kan.params, xt)
                    row[name] = float(
                        (np.asarray(logits).argmax(1) == y_test).mean()
                    )
                except Exception as e:  # an algorithm the device lacks
                    row[name] = f"unsupported: {type(e).__name__}"
            rec["runs"].append(row)
            print(json.dumps(row), flush=True)

    names = list(modes) + list(local)
    print(f"\n{'train':>8} {'seed':>4} " + " ".join(f"{n:>8}" for n in names))
    for r in rec["runs"]:
        cells = [
            f"{r[n]:8.4f}" if isinstance(r[n], float) else f"{'n/a':>8}"
            for n in names
        ]
        print(f"{r['train_precision']:>8} {r['seed']:>4} " + " ".join(cells))
    matches = {}
    for n in names:
        matches[n] = all(
            isinstance(r[n], float) and abs(r[n] - r["highest"]) <= TOLERANCE
            for r in rec["runs"]
        )
    rec["eval_matches_highest"] = matches
    by_train = {}
    for r in rec["runs"]:
        by_train.setdefault(r["train_precision"], []).append(r["highest"])
    rec["mean_test_acc_by_train_precision"] = {
        k: float(np.mean(v)) for k, v in by_train.items()
    }
    print("eval matches 'highest' within", TOLERANCE, ":", matches)
    print("mean test accuracy by training precision:",
          rec["mean_test_acc_by_train_precision"])
    out = args.out or str(
        pathlib.Path(__file__).resolve().parent / "records"
        / f"eval_precision_probe_{rec['platform']}.json"
    )
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    pathlib.Path(out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
