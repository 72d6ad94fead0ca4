"""Analysis & diagnostics: saved-model inspection, sampling diagnostics,
dataset sparsity metrics (reference L6: analyze_model_utils.py,
mnist_sampling_diagnostics.py, Sparsity_check/)."""

import importlib

# Submodules load on first use, so importing one part of the package does
# not pull in the optional dependencies of another (pandas and pyarrow for the sparsity metrics).
_EXPORTS = {
    "analyze_models": "model_analysis",
    "extract_degrees_from_checkpoint": "model_analysis",
    "compute_model_stats": "model_analysis",
    "analyze_sample_distribution": "mnist_diagnostics",
    "compare_multiple_samples": "mnist_diagnostics",
    "SparsityMetrics": "sparsity",
    "compute_sparsity": "sparsity",
    "print_sparsity_analysis": "sparsity",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
