"""Dataset sparsity walkthrough (the ``check_sparsity_ofJSData.ipynb``
equivalent): generate (or point at) a market parquet and print its sparsity
profile.

Run:  PYTHONPATH=. python examples/check_sparsity.py [parquet_path]
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()


import sys
import tempfile
from pathlib import Path

from qkan_implementation.analysis import compute_sparsity, print_sparsity_analysis
from qkan_implementation.data import generate_market_parquet


def main(path: str | None):
    if path is None:
        path = str(Path(tempfile.mkdtemp(prefix="sparsity_")) / "train.parquet")
        generate_market_parquet(path, n_rows=20000, n_features=20)
        print("generated synthetic market parquet at", path)
    metrics = compute_sparsity(path, chunk_size=4096)
    print_sparsity_analysis(metrics)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
