"""Registry: one ``ModelBundle`` of entry points per architecture family
(torch).

Mirrors ``repro/models/registry.py``: the decoder-only LM bundle (the
dense, vlm, moe, ssm and hybrid families) and the encoder-decoder bundle
(seamless).  Their ``init`` and ``loss`` are what the trainer calls, and
``prefill``, ``decode`` and ``init_caches`` what the serving engine and
the enc-dec decode call.  ``input_specs`` (the dry-run's stand-ins) waits
for ROADMAP queue 1 item 13f.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
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
    return LM.lm_loss(cfg, params, batch["tokens"], batch["labels"],
                      splan=splan)


def _lm_prefill(cfg, params, batch, splan):
    return LM.lm_prefill(cfg, params, batch["tokens"], splan=splan)


def _lm_decode(cfg, params, caches, token, splan):
    return LM.lm_decode(cfg, params, caches, token, splan=splan)


def _ed_loss(cfg, params, batch, splan):
    return ED.encdec_loss(cfg, params, batch["frames"], batch["tokens"],
                          batch["labels"], splan=splan)


def _ed_prefill(cfg, params, batch, splan):
    return ED.encdec_prefill(cfg, params, batch["frames"], batch["tokens"],
                             splan=splan)


def _ed_decode(cfg, params, caches, token, splan):
    return ED.encdec_decode(cfg, params, caches, token, splan=splan)


_LM_BUNDLE = ModelBundle(init=LM.init_lm, loss=_lm_loss, prefill=_lm_prefill,
                         decode=_lm_decode, init_caches=LM.init_caches)
_ED_BUNDLE = ModelBundle(init=ED.init_encdec, loss=_ed_loss,
                         prefill=_ed_prefill, decode=_ed_decode,
                         init_caches=ED.init_encdec_caches)


def get_bundle(cfg: ModelConfig) -> ModelBundle:
    return _ED_BUNDLE if cfg.encoder_layers else _LM_BUNDLE
