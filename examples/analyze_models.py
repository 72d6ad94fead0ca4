"""Saved-model analysis walkthrough (the ``Kan_model_analysis.ipynb``
equivalent): train two small KANs, checkpoint them, and compare their
structure with the analysis tools.

Run:  PYTHONPATH=. python examples/analyze_models.py [out_dir]
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()


import sys
import tempfile
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from qkan_implementation.analysis import analyze_models
from qkan_implementation.models import FixedKAN, FixedKANConfig


def main(out_dir: str):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    x = jnp.asarray(np.linspace(-1, 1, 200).reshape(-1, 1))
    targets = {
        "quadratic": 0.5 * x**2 + 0.3 * x + 0.1,
        "oscillatory": jnp.sin(4 * x),
    }
    model_files = []
    for name, y in targets.items():
        kan = FixedKAN(
            FixedKANConfig(
                network_shape=[1, 4, 1],
                max_degree=5,
                degree_objective="penalized_mse",
                complexity_weight=0.001,
                consistent_tanh=True,
            )
        )
        kan.optimize(x, y, solver="anneal", num_reads=256, num_sweeps=400)
        mse = float(jnp.mean((kan(x) - y) ** 2))
        path = out / f"{name}.npz"
        kan.save_model(str(path))
        model_files.append(str(path))
        print(f"{name}: MSE={mse:.2e}, degrees={[np.asarray(lp['degrees']).tolist() for lp in kan.params]}")

    stats, fig = analyze_models(model_files, make_plots=True)
    fig.savefig(out / "model_comparison.png")
    for s in stats:
        print(Path(s["model_file"]).stem, "degree histogram:", s["degree_histogram"])
    print("wrote", out / "model_comparison.png")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="kan_analysis_"))
