"""YAML-driven experiment harness (config, runner, evaluation, plots)."""

import importlib

# Submodules load on first use, so importing one part of the package does
# not pull in the optional dependencies of another (yaml, pandas, matplotlib).
_EXPORTS = {
    "DataConfig": "config",
    "ModelConfig": "config",
    "ExperimentConfig": "config",
    "load_config": "config",
    "get_default_features": "config",
    "ModelResult": "evaluation",
    "ModelEvaluator": "evaluation",
    "run_experiment": "main",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
