"""Encoder-decoder model (seamless-m4t-large-v2) (torch).

Mirrors ``repro/models/encdec.py``.  The speech frontend is a stub, as in
the reference: the encoder consumes precomputed frame embeddings ``[B,
S_enc, D]``.  The encoder is non-causal RoPE self-attention + MLP; the
decoder a causal transformer with cross-attention into the encoder
memory, decoder length = encoder length / ``cfg.dec_len_ratio``.  Both
stacks loop over their ``[L, ...]`` stacked layers (``scanctl.scan``), the
reference's ``enc_blocks/...`` and ``dec_blocks/...`` leaves, so a
reference tree carries across with ``lm.params_from_arrays``.  With
``cfg.remat`` each encoder layer runs under a full checkpoint whatever the
mode, and each decoder layer in training, as the reference's
``jax.checkpoint`` does.

Decode carries ``{self: K/V [L, B, Sc, KV, dh], memory [B, S_mem, D],
index}``, the memory fixed at ``DECODE_MEMORY_FRAMES`` by
``init_encdec_caches``; ``encdec_decode`` writes the new K/V into the
self cache in place and returns it, as ``lm.lm_decode`` does.

``encdec_prefill`` copies a reference defect (``docs/torch_lm_train.md``):
its self caches hold exactly the prefix (no free position), so a decode
after it writes ring slot ``index % Sc = 0`` over the first token's K/V.

Under a plan whose positions own their shards ``encode``,
``encdec_prefill``, ``encdec_decode`` and ``encdec_loss`` run
``models/positions.py`` (parameters and caches as ``Sharded``, the logits
and the loss back on the tokens' device).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import ShardingPlan, make_plan
from repro_torch.models import layers as L
from repro_torch.models import positions as PS
from repro_torch.models import scanctl
from repro_torch.models.lm import _checkpointed, chunked_xent, full_logits

__all__ = ["DECODE_MEMORY_FRAMES", "init_encdec", "encode", "encdec_loss",
           "encdec_prefill", "encdec_decode", "init_encdec_caches"]

Params = dict[str, Any]

DECODE_MEMORY_FRAMES = 4096  # fixed cross-attention memory at decode time

_SELF_SPEC = L.AttnSpec(use_rope=True, causal=True)
_CROSS_SPEC = L.AttnSpec(use_rope=False, causal=False, cross=True)
_ENC_SPEC = L.AttnSpec(use_rope=True, causal=False)


def _init_enc_layer(cfg: ModelConfig, gen, dtype, device) -> Params:
    D = cfg.d_model
    return {
        "norm1": L.init_norm(cfg, D, dtype, device=device),
        "attn": L.init_attention(cfg, gen, D, dtype, device=device),
        "norm2": L.init_norm(cfg, D, dtype, device=device),
        "mlp": L.init_mlp(cfg, gen, D, cfg.d_ff, dtype, device=device),
    }


def _init_dec_layer(cfg: ModelConfig, gen, dtype, device) -> Params:
    D = cfg.d_model
    return {
        "norm1": L.init_norm(cfg, D, dtype, device=device),
        "attn": L.init_attention(cfg, gen, D, dtype, device=device),
        "norm_x": L.init_norm(cfg, D, dtype, device=device),
        "xattn": L.init_attention(cfg, gen, D, dtype, device=device),
        "norm2": L.init_norm(cfg, D, dtype, device=device),
        "mlp": L.init_mlp(cfg, gen, D, cfg.d_ff, dtype, device=device),
    }


def init_encdec(cfg: ModelConfig, gen: torch.Generator, *,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random parameters drawn from ``gen`` (a generator on ``device``):
    the reference's tree, shapes and scales (``embed`` x 0.02, ``lm_head``
    / sqrt(d_model)), each stack's layers on a leading ``[L]`` axis."""
    device = resolve_device(device)
    D, Vp = cfg.d_model, cfg.vocab_padded
    return {
        "embed": L._dense_init(gen, (Vp, D), dtype, device, scale=0.02),
        "enc_blocks": scanctl.stack(
            [_init_enc_layer(cfg, gen, dtype, device)
             for _ in range(cfg.encoder_layers)]),
        "dec_blocks": scanctl.stack(
            [_init_dec_layer(cfg, gen, dtype, device)
             for _ in range(cfg.num_layers)]),
        "enc_norm": L.init_norm(cfg, D, dtype, device=device),
        "final_norm": L.init_norm(cfg, D, dtype, device=device),
        "lm_head": L._dense_init(gen, (D, Vp), dtype, device,
                                 scale=1.0 / math.sqrt(D)),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           splan: ShardingPlan | None = None) -> torch.Tensor:
    """frames [B, S_enc, D] (stub embeddings) -> memory [B, S_enc, D]."""
    splan = splan or make_plan(cfg, None)
    if splan.own_shards:
        return PS.encode(cfg, params, frames, splan)
    h = L.shard(frames.to(params["embed"].dtype), splan.hidden, splan.mesh)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def body(hh, p):
        n1 = L.apply_norm(cfg, p["norm1"], hh)
        hh = hh + L.attention_forward(cfg, p["attn"], n1, _ENC_SPEC,
                                      splan=splan, positions=positions)
        n2 = L.apply_norm(cfg, p["norm2"], hh)
        return L.shard(hh + L.apply_mlp(cfg, p["mlp"], n2), splan.hidden,
                       splan.mesh), None

    h, _ = scanctl.scan(_checkpointed(body) if cfg.remat else body, h,
                        params["enc_blocks"])
    return L.apply_norm(cfg, params["enc_norm"], h)


def _decoder(cfg: ModelConfig, params: Params, h: torch.Tensor,
             memory: torch.Tensor, splan: ShardingPlan, *, mode: str,
             caches=None):
    """mode: train | prefill | decode.  Returns (h, caches | None): prefill
    the new stacked self caches, decode the given ones, written in
    place."""
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    mem_positions = torch.arange(memory.shape[1], dtype=torch.int32,
                                 device=h.device)
    decode = mode == "decode"
    collect = mode == "prefill"
    index = caches["index"] if decode else None

    def body(hh, xs):
        p = xs["params"]
        new_cache = None
        n1 = L.apply_norm(cfg, p["norm1"], hh)
        if decode:
            a, _ = L.attention_decode(cfg, p["attn"], n1,
                                      {**xs["caches"], "index": index},
                                      _SELF_SPEC, splan=splan)
        elif collect:
            # no ctx: the cache holds exactly the prefix (the reference's)
            a, new_cache = L.attention_forward_with_cache(
                cfg, p["attn"], n1, _SELF_SPEC, splan=splan,
                positions=positions)
        else:
            a = L.attention_forward(cfg, p["attn"], n1, _SELF_SPEC,
                                    splan=splan, positions=positions)
        hh = hh + a
        nx = L.apply_norm(cfg, p["norm_x"], hh)
        hh = hh + L.attention_forward(cfg, p["xattn"], nx, _CROSS_SPEC,
                                      splan=splan, positions=positions,
                                      kv_x=memory,
                                      kv_positions=mem_positions)
        n2 = L.apply_norm(cfg, p["norm2"], hh)
        hh = L.shard(hh + L.apply_mlp(cfg, p["mlp"], n2),
                     splan.decode_hidden if decode else splan.hidden,
                     splan.mesh)
        return hh, new_cache

    body_fn = _checkpointed(body) if (cfg.remat and mode == "train") else body
    xs: dict[str, Any] = {"params": params["dec_blocks"]}
    if decode:
        xs["caches"] = caches["self"]
    h, ys = scanctl.scan(body_fn, h, xs)
    return h, (caches["self"] if decode else ys)


def encdec_loss(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                dec_tokens: torch.Tensor, labels: torch.Tensor, *,
                splan: ShardingPlan | None = None,
                vocab_chunk: int = 16_384) -> torch.Tensor:
    splan = splan or make_plan(cfg, None)
    if splan.own_shards:
        return PS.encdec_loss(cfg, params, frames, dec_tokens, labels, splan,
                              vocab_chunk=vocab_chunk)
    memory = encode(cfg, params, frames, splan=splan)
    h = L.shard(params["embed"][dec_tokens], splan.hidden, splan.mesh)
    h, _ = _decoder(cfg, params, h, memory, splan, mode="train")
    h = L.apply_norm(cfg, params["final_norm"], h)
    return chunked_xent(h, params["lm_head"], labels,
                        vocab_chunk=vocab_chunk)


def encdec_prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                   dec_tokens: torch.Tensor, *,
                   splan: ShardingPlan | None = None):
    """Returns (last-token logits [B, Vp], caches {self, memory, index})."""
    splan = splan or make_plan(cfg, None)
    if splan.own_shards:
        return PS.encdec_prefill(cfg, params, frames, dec_tokens, splan)
    memory = encode(cfg, params, frames, splan=splan)
    h = L.shard(params["embed"][dec_tokens], splan.hidden, splan.mesh)
    h, self_caches = _decoder(cfg, params, h, memory, splan,
                              mode="prefill")
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = full_logits(cfg, params, h[:, -1:])[:, 0]
    return logits, {"self": self_caches, "memory": memory,
                    "index": torch.tensor(dec_tokens.shape[1],
                                          dtype=torch.int32,
                                          device=h.device)}


def encdec_decode(cfg: ModelConfig, params: Params, caches: Params,
                  token: torch.Tensor, *,
                  splan: ShardingPlan | None = None):
    """token [B, 1] -> (logits [B, Vp], caches).  The self cache's K/V are
    written in place and returned (with ``index + 1``); the memory is
    passed through."""
    splan = splan or make_plan(cfg, None)
    if splan.own_shards:
        return PS.encdec_decode(cfg, params, caches, token, splan)
    h = L.shard(params["embed"][token], splan.decode_hidden, splan.mesh)
    h, self_caches = _decoder(cfg, params, h, caches["memory"], splan,
                              mode="decode", caches=caches)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = full_logits(cfg, params, h)[:, 0]
    return logits, {"self": self_caches, "memory": caches["memory"],
                    "index": caches["index"] + 1}


def init_encdec_caches(cfg: ModelConfig, batch: int, ctx: int, *,
                       mem_frames: int = DECODE_MEMORY_FRAMES,
                       dtype=torch.bfloat16, device=None) -> Params:
    """Zero caches: self K/V ``[num_layers, batch, ctx, KV, dh]``, a
    ``[batch, mem_frames, D]`` memory, all in ``dtype``, and a scalar int32
    ``index``."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, ctx, cfg.num_kv_heads, cfg.head_dim)
    return {
        "self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)},
        "memory": torch.zeros((batch, mem_frames, cfg.d_model), dtype=dtype,
                              device=device),
        "index": torch.tensor(0, dtype=torch.int32, device=device),
    }
