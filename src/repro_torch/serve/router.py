"""Forest-based request router: the serving half (torch).

Mirrors the serving half of ``repro/serve/router.py``: the latency tiers,
the live arrival-load gauge, the request feature vector, the synthetic
router trace, and ``ForestRouter.route``, which scores request features
with a RandomForest through the port's ``predict_proba`` on the forest's
device and maps P(expensive) above the threshold to the batch tier.
``ForestRouter(forest=None)`` trains that RandomForest on
``synth_router_trace`` with ``core.train.train_forest``, as the reference
does.  The LM ``ServeEngine`` (``serve/engine.py``) feeds the same
``serve.queue_depth`` gauge.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.postprocess import predict_proba
from repro_torch.core.train import TrainConfig, train_forest
from repro_torch.obs import METRICS

__all__ = ["RouterConfig", "ForestRouter", "synth_router_trace",
           "request_features", "TIER_INTERACTIVE", "TIER_BATCH",
           "QUEUE_DEPTH_METRIC", "live_queue_depth", "FEATURES"]

#: the router's latency tiers.  The serve engine admits TIER_INTERACTIVE
#: requests at the queue front and SHEDS an interactive request that has
#: waited past its admission timeout down to TIER_BATCH
TIER_INTERACTIVE = 0
TIER_BATCH = 1


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    num_trees: int = 32
    max_depth: int = 6
    threshold: float = 0.5            # P(expensive) above => batch tier
    algorithm: str = "predicated"


FEATURES = ("prompt_len", "max_new_tokens", "queue_depth",
            "active_slots", "mean_prompt_len_recent")

#: the live arrival-load instrument: a serving engine increments this
#: process-global counter on submit and decrements it on admission, so the
#: router's ``queue_depth`` feature reads the load actually queued
QUEUE_DEPTH_METRIC = "serve.queue_depth"


def live_queue_depth() -> float:
    """The process-wide queued-request count, never negative (engines inc
    and dec the counter, and a reset mid-flight could otherwise show the
    forest a transient negative)."""
    return float(max(METRICS.counter(QUEUE_DEPTH_METRIC).value, 0))


def request_features(prompt_len: int, max_new_tokens: int,
                     queue_depth: float | None = None,
                     active_slots: int = 0,
                     mean_recent: float = 0.0) -> np.ndarray:
    """Feature vector [5] f32 for one request.  ``queue_depth=None`` reads
    the live ``serve.queue_depth`` gauge; a number is taken as given."""
    if queue_depth is None:
        queue_depth = live_queue_depth()
    return np.array([prompt_len, max_new_tokens, queue_depth,
                     active_slots, mean_recent], np.float32)


def synth_router_trace(n: int = 4096, seed: int = 0):
    """Synthetic request trace with a ground-truth cost rule: a request is
    'expensive' when its token budget dominates the current load."""
    rng = np.random.default_rng(seed)
    x = np.stack([
        rng.integers(1, 512, n),          # prompt_len
        rng.integers(1, 256, n),          # max_new_tokens
        rng.integers(0, 64, n),           # queue_depth
        rng.integers(0, 8, n),            # active_slots
        rng.uniform(8, 256, n),           # mean_prompt_len_recent
    ], axis=1).astype(np.float32)
    cost = x[:, 0] * 0.5 + x[:, 1] * 2.0 + x[:, 2] * 1.5
    y = (cost > np.median(cost)).astype(np.float32)
    return x, y


class ForestRouter:
    """Routes request features to a tier with a RandomForest: ``forest``,
    or one trained on ``synth_router_trace(seed=seed)`` on ``device`` (the
    card when None)."""

    def __init__(self, cfg: RouterConfig = RouterConfig(), *,
                 forest=None, seed: int = 0, device=None):
        self.cfg = cfg
        if forest is None:
            x, y = synth_router_trace(seed=seed)
            forest = train_forest(x, y, TrainConfig(
                model_type="randomforest", num_trees=cfg.num_trees,
                max_depth=cfg.max_depth, seed=seed), device=device)
        self.forest = forest

    def route(self, feats: np.ndarray):
        """[F] or [N, F] features -> ``TIER_INTERACTIVE`` / ``TIER_BATCH``
        (an int for one row, an int array for N)."""
        x = torch.as_tensor(np.atleast_2d(np.asarray(feats, np.float32)),
                            device=self.forest.device)
        p = predict_proba(self.forest, x, algorithm=self.cfg.algorithm)
        tiers = np.where(p.cpu().numpy() > self.cfg.threshold,
                         TIER_BATCH, TIER_INTERACTIVE).astype(int)
        return int(tiers[0]) if np.ndim(feats) == 1 else tiers
