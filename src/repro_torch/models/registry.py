"""Registry: one ``ModelBundle`` of entry points per architecture family
(torch).

Mirrors ``repro/models/registry.py`` for the decoder-only LM bundle (the
dense, vlm, moe, ssm and hybrid families): its ``init``, ``prefill``,
``decode`` and ``init_caches`` are what the serving engine calls.  ``loss``
raises until training is ported (ROADMAP queue 1 item 13d); the enc-dec
bundle waits for item 13c and ``input_specs`` (the dry-run's stand-ins) for
item 13f.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as LM

__all__ = ["ModelBundle", "get_bundle"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Family-dispatched entry points, all (cfg, params, ..., splan)."""
    init: Callable[..., Params]
    loss: Callable[..., Any]         # (cfg, params, batch, splan)
    prefill: Callable[..., tuple]    # (cfg, params, batch, splan)
    decode: Callable[..., tuple]     # (cfg, params, caches, token, splan)
    init_caches: Callable[..., Params]


def _lm_loss(cfg, params, batch, splan):
    raise NotImplementedError(
        "the LM loss (lm_hidden / lm_loss / chunked_xent) is ROADMAP queue 1 "
        "item 13d, not ported yet")


def _lm_prefill(cfg, params, batch, splan):
    return LM.lm_prefill(cfg, params, batch["tokens"], splan=splan)


def _lm_decode(cfg, params, caches, token, splan):
    return LM.lm_decode(cfg, params, caches, token, splan=splan)


_LM_BUNDLE = ModelBundle(init=LM.init_lm, loss=_lm_loss, prefill=_lm_prefill,
                         decode=_lm_decode, init_caches=LM.init_caches)


def get_bundle(cfg: ModelConfig) -> ModelBundle:
    """The LM bundle; an enc-dec config raises ``NotImplementedError``
    naming ROADMAP queue 1 item 13c."""
    LM.require_ported(cfg)
    return _LM_BUNDLE
