"""Shared optimizer plumbing: transform caching + time-series CV folds.

Rebuild of ``original_degree_optimizer/BaseOptimizer.py`` (reference
``:5-125``) with pandas/numpy in place of polars (the reference's polars
dependency; the data pipeline ships pandas+pyarrow anyway).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Tuple

import numpy as np


#: column names/prefixes that are never model inputs -- excluded from the
#: all-columns fallback so a frame carrying its target or date alongside
#: unprefixed features cannot silently leak them into the transforms
_NON_FEATURE_COLS = ("date_id", "weight", "weights")
_NON_FEATURE_PREFIXES = ("responder",)


def _extract_features(x_data) -> np.ndarray:
    """Accept a pandas DataFrame (select ``feature_*`` columns, like the
    reference's ``^feature_.*$`` polars selector, BaseOptimizer.py:23) or a
    plain array.  A frame with no ``feature_*`` columns falls back to every
    column EXCEPT known label/date/weight names (logged) -- feeding the
    target into the degree transforms would be silent leakage."""
    if hasattr(x_data, "filter") and hasattr(x_data, "columns"):  # DataFrame
        feats = [c for c in x_data.columns if str(c).startswith("feature_")]
        if feats:
            return x_data[feats].to_numpy()
        cols = [
            c
            for c in x_data.columns
            if str(c) not in _NON_FEATURE_COLS
            and not str(c).startswith(_NON_FEATURE_PREFIXES)
        ]
        dropped = [c for c in x_data.columns if c not in cols]
        if dropped:
            import logging

            logging.getLogger(__name__).warning(
                "No feature_* columns; using %d columns and excluding "
                "likely non-features %s", len(cols), dropped,
            )
        return x_data[cols].to_numpy()
    return np.asarray(x_data)


def _timestamp_values(timestamps, column: str = "date_id") -> np.ndarray:
    """Accept a DataFrame with a date column or a plain array of date ids."""
    if hasattr(timestamps, "columns"):
        return timestamps[column].to_numpy()
    return np.asarray(timestamps)


class BaseOptimizer(ABC):
    """Base class for QKAN optimizers implementing shared functionality."""

    def __init__(self):
        pass

    # NOTE: the reference's _compute_collapsed_combinations fold cache
    # (BaseOptimizer.py:12-28) lives in DegreeOptimizer._cached_transforms,
    # which adds the LRU cap these full-basis entries need; a second
    # uncapped cache here would reintroduce the leak and drift.

    @abstractmethod
    def _compute_transforms(self, feature_data: np.ndarray) -> Dict[int, np.ndarray]:
        """Compute optimizer-specific transforms (child classes implement)."""

    def _get_expanding_window_folds(
        self,
        timestamps,
        data=None,
        n_splits: int = 5,
        initial_ratio: float = 0.6,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Expanding-window CV folds over unique sorted date ids.

        Mirror of reference BaseOptimizer._get_expanding_window_folds
        (:38-69): train on the first ``initial + i*val_size`` dates, validate
        on the next ``val_size``.
        """
        ts = _timestamp_values(timestamps)
        unique = np.unique(ts)  # sorted
        n_times = len(unique)
        initial_train_size = int(n_times * initial_ratio)
        val_size = int((n_times - initial_train_size) / n_splits)

        folds = []
        for i in range(n_splits):
            train_end = initial_train_size + i * val_size
            train_times = unique[:train_end]
            val_times = unique[train_end : min(train_end + val_size, n_times)]
            folds.append(
                (np.isin(ts, train_times), np.isin(ts, val_times))
            )
        return folds

    def _get_time_based_folds(
        self, timestamps, data=None, n_splits: int = 5
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Time-based CV folds (reference BaseOptimizer :70-99)."""
        ts = _timestamp_values(timestamps)
        unique = np.unique(ts)
        n_times = len(unique)
        folds = []
        for i in range(n_splits):
            split_idx = int((i + 1) * n_times // (n_splits + 1))
            val_end_idx = int((i + 2) * n_times // (n_splits + 1))
            train_times = unique[:split_idx]
            val_times = unique[split_idx:val_end_idx]
            folds.append((np.isin(ts, train_times), np.isin(ts, val_times)))
        return folds

    def _compute_validation_score(
        self, predictions: np.ndarray, y_true: np.ndarray
    ) -> float:
        """MSE validation score (reference :100-111)."""
        return float(np.mean((np.asarray(y_true) - np.asarray(predictions)) ** 2))

    def save_state(self, filename: str) -> None:  # overridden by children
        pass

    def load_state(self, filename: str, current_query_params: dict) -> None:
        pass
