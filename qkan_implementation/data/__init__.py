"""Data pipelines: market parquet (Jane Street-style) + MNIST/digits."""

import importlib

# Submodules load on first use, so importing one part of the package does
# not pull in the optional dependencies of another (pandas for the market pipeline).
_EXPORTS = {
    "DataPipeline": "pipeline",
    "generate_market_parquet": "pipeline",
    "load_mnist": "mnist",
    "to_one_hot": "mnist",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
