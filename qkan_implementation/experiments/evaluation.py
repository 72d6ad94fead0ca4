"""Model evaluation records + summaries.

Rebuild of ``Testing and Visualization Framework/evaluation.py`` (reference
``:9-49``).  The ``R2_score`` / ``R2_Score`` attribute typo of the reference
(``evaluation.py:45`` vs ``:13``) is fixed, and metrics come from the shared
``utils.metrics`` module instead of sklearn.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd

from qkan_implementation.utils.metrics import mse, r2_score


@dataclass
class ModelResult:
    model_name: str
    MSE_Score: float
    R2_Score: float
    train_time: float
    model_params: Dict[str, Any]
    train_metrics: Dict[str, float] = field(default_factory=dict)
    val_metrics: Dict[str, float] = field(default_factory=dict)


class ModelEvaluator:
    @staticmethod
    def evaluate_predictions(
        y_true: np.ndarray,
        y_pred: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ) -> Dict[str, float]:
        """MSE + R^2, optionally sample-weighted (reference :18-36)."""
        return {
            "mse": mse(y_true, y_pred, weights),
            "r2": r2_score(y_true, y_pred, weights),
        }

    @staticmethod
    def create_evaluation_summary(results: List[ModelResult]) -> pd.DataFrame:
        """Summary DataFrame of results (reference :37-49)."""
        return pd.DataFrame(
            [
                {
                    "model": r.model_name,
                    "mse": r.MSE_Score,
                    "r2": r.R2_Score,
                    "train_time": r.train_time,
                }
                for r in results
            ]
        )
