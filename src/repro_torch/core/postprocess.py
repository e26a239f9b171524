"""Phase 2 of decision-forest inference: per-tree score aggregation (torch).

Mirrors ``repro/core/postprocess.py``.  RandomForest averages the trees'
exit values (a clipped mean for classification); XGBoost / LightGBM sum
the exit leaves plus the base score and apply a sigmoid for
classification.  Padding trees carry zero leaves, so SUM is unaffected and
MEAN divides by the TRUE tree count.
"""

from __future__ import annotations

import torch

__all__ = ["aggregate_raw", "postprocess", "predict_proba"]


def aggregate_raw(raw: torch.Tensor) -> torch.Tensor:
    """[B, T] per-tree scores -> [B] summed raw margin."""
    return torch.sum(raw, dim=-1)


def postprocess(summed: torch.Tensor, *, model_type: str,
                task: str = "classification", num_trees: int,
                base_score: float = 0.0) -> torch.Tensor:
    """[B] summed raw scores -> [B] final prediction.  ``num_trees`` must
    be the TRUE (pre-padding) tree count."""
    if model_type == "randomforest":
        mean = summed / torch.tensor(num_trees, dtype=summed.dtype)
        if task == "classification":
            return torch.clamp(mean, 0.0, 1.0)
        if task == "regression":
            return mean
    elif model_type in ("xgboost", "lightgbm"):
        margin = summed + torch.tensor(base_score, dtype=summed.dtype)
        if task == "classification":
            return torch.sigmoid(margin)
        if task == "regression":
            return margin
    else:
        raise ValueError(f"unknown model_type {model_type!r}")
    raise ValueError(f"unknown task {task!r}")


def predict_proba(forest, x: torch.Tensor, *, algorithm: str = "predicated",
                  num_trees: int | None = None) -> torch.Tensor:
    """Single-device end-to-end predict (phase 1 + phase 2)."""
    from repro_torch.core.algorithms import predict_raw

    raw = predict_raw(forest, x, algorithm)
    return postprocess(
        aggregate_raw(raw), model_type=forest.model_type, task=forest.task,
        num_trees=int(num_trees if num_trees is not None
                      else forest.num_trees),
        base_score=forest.base_score)
