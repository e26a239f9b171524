"""Eager-torch oracles for the forest kernels.

Mirrors ``repro/kernels/ref.py``: each reference takes the same (forest, x)
signature as a kernel wrapper and returns raw per-tree scores [B, T] in
f32.  ``core.algorithms.naive_predict`` is the root oracle; the vectorized
algorithms are tested against it and against the JAX reference.
"""

from __future__ import annotations

import torch

from repro_torch.core.algorithms import (hummingbird_predict, naive_predict,
                                         predicated_predict,
                                         quickscorer_predict)
from repro_torch.core.forest import Forest

__all__ = ["ref_naive", "ref_predicated", "ref_hummingbird",
           "ref_quickscorer", "REFERENCES"]


def ref_naive(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    return naive_predict(forest, x).float()


def ref_predicated(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    return predicated_predict(forest, x).float()


def ref_hummingbird(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    return hummingbird_predict(forest, x).float()


def ref_quickscorer(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    return quickscorer_predict(forest, x).float()


REFERENCES = {
    "predicated_pallas": ref_predicated,
    "hummingbird_pallas": ref_hummingbird,
    "quickscorer_pallas": ref_quickscorer,
}
