"""Faithfulness reconciliation: WHY the reference's committed code cannot
reproduce its own 0.5127 MNIST artifact, measured as a causal chain.

VERDICT r2 missing-item 1 / weak-item 1.  Two parts:

Part A -- the degree-reward degeneracy, demonstrated on the flagship
workload itself (not just asserted).  The reference builds its degree QUBO
from the marginal score differences (DegreeOptimizer.py:221-225):

    improvement[d] = scores[d] - scores[d-1],   improvement[0] = scores[0]
    H += -improvement[d] * q[i,d] + cw * d^2 * q[i,d]
    H += 10 * (sum_d q[i,d] - 1)^2              (:227-230)

Because improvement[0] is the RAW baseline MSE (not a difference), degree 0
receives reward equal to the entire baseline error while degree d>0 only
receives its marginal gain; degree d can win only if

    scores[d] - scores[d-1] + cw * d^2  <  -scores[0]

i.e. a single-degree marginal improvement LARGER than the whole baseline
MSE -- impossible while scores are positive.  This script computes the real
per-degree score vector on the reference's flagship shape
([784, 32, 16, 16, 10], layer 0, 10k samples), assembles the QUBO once via
the in-repo 'reference' objective and once via an INDEPENDENT numpy
transcription of the formulas above, verifies they agree, solves exactly,
and records the chosen degrees (all 0) plus the margin by which the escape
condition fails.

Part B -- the ablation from faithful to improved, one switch at a time:

    faithful          reference reward, inconsistent tanh, cw=0.1
    reward_fix_only   penalized_mse,    inconsistent tanh, cw=0.1
    tanh_fix_only     reference reward, consistent tanh,   cw=0.1
    cw_only           reference reward, inconsistent tanh, cw=0.001
    reward+cw         penalized_mse,    inconsistent tanh, cw=0.001
    improved          penalized_mse,    consistent tanh,   cw=0.001

Each step records train/test accuracy and the selected-degree histogram, so
the 0.10 -> 0.83 jump becomes a measured chain instead of one unexplained
step.  Dataset is digits-784 (upsampled+augmented sklearn digits -- real
MNIST is unavailable here; see benchmarks/mnist_shape_evidence.py).

Conclusion recorded in docs/parity.md section "Reconciling the reference's
0.5127 accuracy artifact": with the committed reference code the QUBO
always selects degree 0, every neuron reduces to a constant-plus-linear
readout of a tanh stack fitted layerwise to the same one-hot target, and
test accuracy lands at chance; the 0.5127/0.2671 artifacts
(analyze_model_utils.py:233-241) therefore predate the degenerate reward.

Run: PYTHONPATH=. python benchmarks/faithfulness_ablation.py          (GPU)
     PYTHONPATH=. JAX_PLATFORMS=cpu python benchmarks/faithfulness_ablation.py --quick
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.anneal import degree_selection_qubo
from qkan_implementation.experiments.mnist import run_mnist_experiment
from qkan_implementation.models.fixed_kan import FixedKAN, FixedKANConfig


def reference_qubo_numpy(scores, num_functions, complexity_weight):
    """Independent transcription of the reference's QUBO assembly
    (DegreeOptimizer.py:221-230): marginal-improvement reward, d^2
    complexity penalty, strength-10 one-hot constraint.  Returns (h, J,
    offset) in the same variable order as ``degree_selection_qubo``
    (function-major, degree-minor)."""
    scores = np.asarray(scores, dtype=np.float64)
    dp1 = scores.shape[0]
    n = num_functions * dp1
    improvement = np.empty(dp1)
    improvement[0] = scores[0]
    improvement[1:] = scores[1:] - scores[:-1]
    degrees = np.arange(dp1, dtype=np.float64)
    h = np.zeros(n)
    J = np.zeros((n, n))
    offset = 0.0
    P = 10.0
    for i in range(num_functions):
        base = i * dp1
        for d in range(dp1):
            h[base + d] += -improvement[d] + complexity_weight * d * d
        # P * (sum_d q - 1)^2 = P * (sum q + 2*sum_{d<e} q_d q_e - 2*sum q + 1)
        for d in range(dp1):
            h[base + d] += -P  # q^2 = q, so the square contributes +P, cross -2P
            for e in range(d + 1, dp1):
                J[base + d, base + e] += 2.0 * P
                J[base + e, base + d] += 2.0 * P
        offset += P
    return h, J, offset


def part_a_degeneracy(train_size: int, shape, max_degree: int, cw: float):
    from qkan_implementation.data.mnist import load_digits_784

    x_train, y_train, _ = load_digits_784(
        train=True, augment_to=train_size, seed=0
    )
    x_train = x_train[:train_size]
    y_onehot = np.eye(10)[y_train[:train_size]]

    cfg = FixedKANConfig(
        network_shape=shape,
        max_degree=max_degree,
        complexity_weight=cw,
        degree_objective="reference",
        consistent_tanh=False,
        lstsq_method="normal",
    )
    kan = FixedKAN(cfg)
    scores, _ = kan._evaluate_layer_degrees(
        jnp.asarray(x_train), jnp.asarray(y_onehot)
    )
    out_dim = shape[1]
    model = degree_selection_qubo(
        scores, num_functions=out_dim, complexity_weight=cw,
        objective="reference",
    )
    h2, J2, off2 = reference_qubo_numpy(scores, out_dim, cw)
    qubo_agreement = {
        "h_max_abs_diff": float(np.max(np.abs(model.h - h2))),
        "J_max_abs_diff": float(np.max(np.abs(model.J - J2))),
        "offset_diff": float(abs(model.offset - off2)),
    }
    # exact per-block optimum (blocks are independent one-hot selections)
    dp1 = max_degree + 1
    lin = model.h[:dp1]
    chosen = int(np.argmin(lin))
    # the escape condition: degree d beats degree 0 iff
    # scores[d] - scores[d-1] + cw*d^2 < -scores[0]
    marginal = np.diff(scores) + cw * np.arange(1, dp1) ** 2
    margins = marginal + scores[0]  # > 0 means degree 0 wins
    return {
        "workload": f"digits-784 flagship layer-0 scores, shape {shape}",
        "scores_per_degree": [float(s) for s in scores],
        "qubo_independent_assembly_agreement": qubo_agreement,
        "exact_qubo_choice_every_function": chosen,
        "escape_condition_margins_d1_to_D": [float(m) for m in margins],
        "escape_condition_min_margin": float(np.min(margins)),
        "conclusion": (
            "reference reward selects degree 0 for every function; a degree"
            " d>0 would need a single marginal MSE improvement larger than"
            " the entire baseline MSE (margins above are all positive)"
        ),
    }


ABLATION_STEPS = {
    "faithful": dict(
        degree_objective="reference", consistent_tanh=False,
        complexity_weight=0.1,
    ),
    "reward_fix_only": dict(
        degree_objective="penalized_mse", consistent_tanh=False,
        complexity_weight=0.1,
    ),
    "tanh_fix_only": dict(
        degree_objective="reference", consistent_tanh=True,
        complexity_weight=0.1,
    ),
    "cw_only": dict(
        degree_objective="reference", consistent_tanh=False,
        complexity_weight=0.001,
    ),
    "reward_fix_plus_cw": dict(
        degree_objective="penalized_mse", consistent_tanh=False,
        complexity_weight=0.001,
    ),
    "improved": dict(
        degree_objective="penalized_mse", consistent_tanh=True,
        complexity_weight=0.001,
    ),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny CPU smoke")
    ap.add_argument("--train-size", type=int, default=10000)
    args = ap.parse_args()

    train_size = 500 if args.quick else args.train_size
    shape = [784, 16, 10] if args.quick else [784, 32, 16, 16, 10]
    num_reads = 64 if args.quick else 1000
    max_degree = 5

    record = {
        "device": str(jax.devices()[0]),
        "dataset_note": (
            "digits-784 (upsampled+augmented sklearn digits), NOT MNIST;"
            " the reference's 0.5127 artifact is additionally"
            " un-reproducible for the algorithmic reasons recorded here"
        ),
        "part_a_degeneracy": part_a_degeneracy(
            train_size, shape, max_degree, cw=0.1
        ),
        "part_b_ablation": [],
    }
    print(json.dumps(record["part_a_degeneracy"], indent=1))

    for name, overrides in ABLATION_STEPS.items():
        print(f"=== ablation step: {name} ===")
        res = run_mnist_experiment(
            network_shape=shape,
            max_degree=max_degree,
            train_size=train_size,
            dataset="digits-784",
            lstsq_method="normal",
            num_reads=num_reads,
            weight_epochs=0,
            verbose=False,
            **overrides,
        )
        kan = res.pop("_model")
        hist = {}
        for layer in kan.params:
            for d in np.asarray(layer["degrees"]).tolist():
                hist[int(d)] = hist.get(int(d), 0) + 1
        step = {
            "step": name,
            **overrides,
            "train_accuracy": res["metrics"]["train_accuracy"],
            "test_accuracy": res["metrics"]["test_accuracy"],
            "selected_degree_histogram": hist,
        }
        record["part_b_ablation"].append(step)
        print(
            f"  acc train={step['train_accuracy']:.4f} "
            f"test={step['test_accuracy']:.4f} degrees={hist}"
        )

    out = pathlib.Path(__file__).resolve().parent / "records"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "faithfulness_ablation.json"
    path.write_text(json.dumps(record, indent=1))
    print(f"record -> {path}")


if __name__ == "__main__":
    main()
