"""Decoder-only LM assembly: the training and serving paths (torch).

Mirrors ``repro/models/lm.py`` for its four decoder-only families:

  dense / vlm   attn + MLP every layer (yi, olmo, qwen2, minitron, chameleon)
  moe           llama4 scout / maverick: iRoPE (3 chunked-local RoPE layers
                + 1 global NoPE a period of 4), MoE every / every other
                layer with top-1 routing + a shared expert
  ssm           mamba2: every layer an SSD block, no attention, no MLP
  hybrid        zamba2: 6 Mamba2 layers a block + ONE SHARED attention block
                (on concat(hidden, embed0), per-block LoRA deltas)

The layer pattern within one period is a static list of ``LayerPlan``s; the
backbone loops over ``num_blocks`` stacked parameter trees
(``scanctl.scan``), the reference's ``blocks/p{i}/...`` (and ``lora/...``)
leaves with their leading ``[nB, ...]`` axis, so a reference parameter
tree carries across as a copy (``params_from_arrays``).  In training with
``cfg.remat`` each block's body runs under ``torch.utils.checkpoint``
(``_remat``: the reference's ``jax.checkpoint`` policies).

Entry points: ``lm_loss`` (the train-mode backbone and the chunked-vocab
cross-entropy, which never holds ``[B, S, V]`` logits), ``lm_prefill``
(stacked caches, last-token logits) and ``lm_decode`` (one token against
the caches, which it updates in place and returns; ``docs/torch_lm.md``).
All take the reference's ``splan`` and pass it to every constraint point
and MoE call the reference does (``docs/torch_lm_mesh.md``).
``init_lm``, ``init_caches`` and ``params_from_arrays`` run on ``cuda``
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import ShardingPlan, make_plan
from repro_torch.models import layers as L
from repro_torch.models import scanctl
from repro_torch.models import ssd as S

__all__ = ["LayerPlan", "make_layer_plans", "init_lm", "params_from_arrays",
           "chunked_xent", "full_logits", "lm_hidden", "lm_loss",
           "lm_prefill", "lm_decode", "init_caches"]

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    kind: str                 # "attn" | "ssm"
    use_moe: bool = False
    attn: L.AttnSpec | None = None


def make_layer_plans(cfg: ModelConfig) -> list[LayerPlan]:
    """Static per-period-position wiring."""
    period = cfg.block_period
    plans = []
    for i in range(period):
        if cfg.ssm_layers:
            plans.append(LayerPlan(kind="ssm"))
            continue
        is_global = cfg.global_every > 0 and (i + 1) % cfg.global_every == 0
        window = 0 if is_global else cfg.attn_window
        use_rope = cfg.pos_type != "nope" and not (
            cfg.pos_type == "irope" and is_global)
        use_moe = (cfg.num_experts > 0
                   and (i % cfg.moe_every) == (cfg.moe_every - 1))
        plans.append(LayerPlan(
            kind="attn", use_moe=use_moe,
            attn=L.AttnSpec(use_rope=use_rope, window=window,
                            causal=cfg.causal)))
    return plans


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_position(cfg: ModelConfig, plan: LayerPlan, gen, dtype,
                   device) -> Params:
    D, F = cfg.d_model, cfg.d_ff
    p: Params = {"norm1": L.init_norm(cfg, D, dtype, device=device)}
    if plan.kind == "ssm":
        p["ssm"] = S.init_ssd(cfg, gen, dtype, device=device)
        return p
    p["attn"] = L.init_attention(cfg, gen, D, dtype, device=device)
    p["norm2"] = L.init_norm(cfg, D, dtype, device=device)
    if plan.use_moe:
        p["moe"] = L.init_moe(cfg, gen, D, F, dtype, device=device)
    elif F > 0:
        p["mlp"] = L.init_mlp(cfg, gen, D, F, dtype, device=device)
    return p


def _init_shared_attn(cfg: ModelConfig, gen, dtype, device) -> Params:
    """Zamba2's shared block over the concat(h, embed0) 2·D stream; its MLP
    is gelu whatever ``cfg.mlp_type``."""
    D2 = 2 * cfg.d_model
    return {
        "norm1": L.init_norm(cfg, D2, dtype, device=device),
        "attn": L.init_attention(cfg, gen, D2, dtype, d_out=cfg.d_model,
                                 device=device),
        "norm2": L.init_norm(cfg, D2, dtype, device=device),
        "mlp": {"wi": L._dense_init(gen, (D2, cfg.d_ff), dtype, device),
                "wo": L._dense_init(gen, (cfg.d_ff, cfg.d_model), dtype,
                                    device)},
    }


def _init_lora(cfg: ModelConfig, gen, dtype, device) -> Params:
    """One block's LoRA delta on the shared block's ``wq``: ``a @ b``, with
    ``b`` zero at init."""
    D2, r = 2 * cfg.d_model, cfg.shared_attn_lora_rank
    return {"a": L._dense_init(gen, (D2, r), dtype, device),
            "b": torch.zeros((r, cfg.num_heads * cfg.head_dim), dtype=dtype,
                             device=device)}


def init_lm(cfg: ModelConfig, gen: torch.Generator, *,
            dtype=torch.bfloat16, device=None) -> Params:
    """Random parameters drawn from ``gen`` (a generator on ``device``):
    the reference's tree, shapes and scales, each block's leaves stacked
    on a leading ``[num_blocks]`` axis."""
    device = resolve_device(device)
    nB = cfg.num_blocks
    params: Params = {"blocks": {}}
    for i, plan in enumerate(make_layer_plans(cfg)):
        params["blocks"][f"p{i}"] = scanctl.stack(
            [_init_position(cfg, plan, gen, dtype, device)
             for _ in range(nB)])
    params["embed"] = L._dense_init(gen, (cfg.vocab_padded, cfg.d_model),
                                    dtype, device, scale=0.02)
    params["final_norm"] = L.init_norm(cfg, cfg.d_model, dtype,
                                       device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(
            gen, (cfg.d_model, cfg.vocab_padded), dtype, device)
    if cfg.shared_attn_every:
        params["shared_attn"] = _init_shared_attn(cfg, gen, dtype, device)
        params["lora"] = scanctl.stack(
            [_init_lora(cfg, gen, dtype, device) for _ in range(nB)])
    return params


def params_from_arrays(tree, *, device=None, dtype=None) -> Params:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as tensors on
    ``device``, path for path and copied: the same keys, the same stacked
    ``[nB, ...]`` leaves, the same ``[d_in, d_out]`` weights.  ``dtype``
    casts every leaf; None keeps each array's (bfloat16 included).  Any
    nested dict of arrays and scalars goes across the same way (a train
    state: ``train/trainer.py:state_from_arrays``)."""
    device = resolve_device(device)

    def one(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # ml_dtypes, as jax gives it
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return one(node)

    return walk(tree)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


#: the shared block's attention: RoPE and causal, whatever the config's
_SHARED_SPEC = L.AttnSpec(use_rope=True, causal=True)


def _apply_shared_attn(cfg: ModelConfig, shared: Params, lora: Params,
                       h: torch.Tensor, e0: torch.Tensor, positions, *,
                       splan: ShardingPlan | None = None,
                       decode_cache=None, collect=False, ctx=None):
    """Zamba2's shared block, on concat(h, e0) with this block's LoRA delta
    on ``wq``: attention and the gelu MLP both read the normed 2·D stream
    and add to ``h``.  Returns (h, its K/V cache or None)."""
    cat = torch.cat([h, e0], dim=-1)
    n1 = L.apply_norm(cfg, shared["norm1"], cat)
    attn_p = dict(shared["attn"])
    attn_p["wq"] = attn_p["wq"] + (lora["a"] @ lora["b"]).to(
        attn_p["wq"].dtype)
    if decode_cache is not None:
        a, new_cache = L.attention_decode(cfg, attn_p, n1, decode_cache,
                                          _SHARED_SPEC, splan=splan)
    elif collect:
        a, new_cache = L.attention_forward_with_cache(
            cfg, attn_p, n1, _SHARED_SPEC, splan=splan, positions=positions,
            ctx=ctx)
    else:
        a, new_cache = L.attention_forward(
            cfg, attn_p, n1, _SHARED_SPEC, splan=splan,
            positions=positions), None
    n2 = L.apply_norm(cfg, shared["norm2"], cat)
    m = L.apply_mlp(dataclasses.replace(cfg, mlp_type="gelu"),
                    shared["mlp"], n2)
    return h + a + m, new_cache


def _apply_position(cfg: ModelConfig, plan: LayerPlan, p: Params,
                    h: torch.Tensor, splan: ShardingPlan, positions, *,
                    cache=None, decode=False, ctx=None):
    """One layer (train/prefill: cache=None or "collect"; decode: cache is
    this layer's cache, updated in place).  Returns (h,
    new_cache_or_None)."""
    mesh = splan.mesh
    new_cache = None
    hs = splan.decode_hidden if decode else splan.hidden
    n1 = L.apply_norm(cfg, p["norm1"], h)
    if plan.kind == "ssm":
        n1 = L.shard(n1, splan.hidden, mesh)
        if decode:
            y, new_cache = S.ssd_decode(cfg, p["ssm"], n1, cache)
        elif cache == "collect":
            y, new_cache = S.ssd_forward_with_cache(cfg, p["ssm"], n1,
                                                    splan=splan)
        else:
            y = S.ssd_forward(cfg, p["ssm"], n1, splan=splan)
        return L.shard(h + y, hs, mesh), new_cache
    if decode:
        a, new_cache = L.attention_decode(cfg, p["attn"], n1, cache,
                                          plan.attn, splan=splan)
    elif cache == "collect":
        a, new_cache = L.attention_forward_with_cache(
            cfg, p["attn"], n1, plan.attn, splan=splan, positions=positions,
            ctx=ctx)
    else:
        a = L.attention_forward(cfg, p["attn"], n1, plan.attn, splan=splan,
                                positions=positions)
    h = L.shard(h + a, hs, mesh)
    n2 = L.apply_norm(cfg, p["norm2"], h)
    if plan.use_moe:
        m = (L.moe_decode(cfg, p["moe"], n2, splan=splan) if decode
             else L.apply_moe(cfg, p["moe"], n2, splan=splan))
    elif cfg.d_ff > 0:
        m = L.apply_mlp(cfg, p["mlp"], n2)
    else:
        m = 0.0
    return L.shard(h + m, hs, mesh), new_cache


def _save_products(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of matrix
    products without a batch dimension (the ``x @ W`` projections lower to
    ``aten.mm`` / ``aten.addmm``); recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_products)


def _checkpointed(fn, **kw):
    """``fn`` under a non-reentrant ``torch.utils.checkpoint``."""
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _remat(cfg: ModelConfig, fn):
    """Activation-checkpoint policy, the reference's ``jax.checkpoint``:
    full  recompute everything in backward
    dots  save the outputs of products without batch dims, recompute the
          rest (a selective checkpoint over ``_save_products``)
    none  store everything
    Values never change, only what backward keeps."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        return _checkpointed(fn, context_fn=_dots_context)
    return _checkpointed(fn)


def _backbone(cfg: ModelConfig, params: Params, h: torch.Tensor,
              splan: ShardingPlan, positions, *, mode: str,
              caches: Params | None = None, ctx: int | None = None):
    """mode: train | prefill | decode.  Returns (h, caches | None): prefill
    the new stacked caches, decode the given ones, written in place."""
    plans = make_layer_plans(cfg)
    # the hybrid's shared block reads the embedding (at decode: the current
    # token's) beside the hidden stream
    e0 = h if cfg.shared_attn_every else None
    collect = mode == "prefill"
    decode = mode == "decode"
    index = caches["index"] if decode else None

    def block(hh, xs):
        p_block = xs["params"]
        c_block = xs.get("caches")
        new_caches = {}
        if cfg.shared_attn_every:
            dc = {**c_block["shared"], "index": index} if decode else None
            hh, nc = _apply_shared_attn(cfg, params["shared_attn"],
                                        xs["lora"], hh, e0, positions,
                                        splan=splan, decode_cache=dc,
                                        collect=collect,
                                        ctx=ctx)
            if collect:
                new_caches["shared"] = {"k": nc["k"], "v": nc["v"]}
        for i, plan in enumerate(plans):
            if decode:
                c = c_block[f"p{i}"]
                if plan.kind == "attn":
                    c = {**c, "index": index}
            else:
                c = "collect" if collect else None
            hh, nc = _apply_position(cfg, plan, p_block[f"p{i}"], hh,
                                     splan, positions, cache=c,
                                     decode=decode, ctx=ctx)
            if collect:
                new_caches[f"p{i}"] = ({"k": nc["k"], "v": nc["v"]}
                                       if plan.kind == "attn" else nc)
        return hh, (new_caches if collect else None)

    body = block
    if cfg.remat and mode == "train":
        body = _remat(cfg, block)

    xs: dict[str, Any] = {"params": params["blocks"]}
    if cfg.shared_attn_every:
        xs["lora"] = params["lora"]
    if decode:
        xs["caches"] = {k: v for k, v in caches.items() if k != "index"}
    h, ys = scanctl.scan(body, h, xs)
    return h, (xs["caches"] if decode else ys)


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------


def _lm_head_weight(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def chunked_xent(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 *, vocab_chunk: int = 16_384) -> torch.Tensor:
    """Cross-entropy without materializing [B, S, V] logits.

    h [B, S, D]; w [D, V]; labels [B, S] integer (-1 = pad, out of the
    mean).  Loops over V chunks with a running (max, sumexp, target-logit)
    triple from (-inf, 0, 0); each chunk's f32 logits come from operands
    upcast to f32 (``layers._einsum_f32``), the padded tail of the last
    chunk masked to -inf.  Each chunk runs under a non-reentrant
    checkpoint, as the reference's body is ``jax.checkpoint``ed, so
    backward recomputes its logits instead of keeping them.
    """
    B, Sq, D = h.shape
    V = w.shape[1]
    nc = -(-V // vocab_chunk)
    pad = nc * vocab_chunk - V
    if pad:
        w = F.pad(w, (0, pad))
    labels = labels.long()
    labels_safe = labels.clamp_min(0)
    cols = torch.arange(vocab_chunk, device=h.device)

    def body(m, s, tgt, w_chunk, c: int):
        logits = L._einsum_f32("bsd,dv->bsv", h, w_chunk)
        if pad:  # mask the padded vocab tail in the LAST chunk
            vmask = (c * vocab_chunk + cols) < V
            logits = torch.where(vmask[None, None], logits, -math.inf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[..., None]).sum(dim=-1)
        idx = labels_safe - c * vocab_chunk
        inb = (idx >= 0) & (idx < vocab_chunk)
        picked = torch.gather(
            logits, -1, idx.clamp(0, vocab_chunk - 1)[..., None])[..., 0]
        tgt = tgt + torch.where(inb, picked, 0.0)
        return m_new, s, tgt

    stats = dict(dtype=torch.float32, device=h.device)
    m = torch.full((B, Sq), -math.inf, **stats)
    s = torch.zeros((B, Sq), **stats)
    tgt = torch.zeros((B, Sq), **stats)
    # split: backward joins the chunks' gradients in one copy, where a
    # slice a chunk would zero-fill a whole [D, V] gradient for each
    for c, w_chunk in enumerate(w.split(vocab_chunk, dim=1)):
        m, s, tgt = checkpoint(body, m, s, tgt, w_chunk, c,
                               use_reentrant=False)
    nll = (m + torch.log(s.clamp_min(1e-30))) - tgt
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def full_logits(cfg: ModelConfig, params: Params,
                h: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> f32 [B, S, Vp] -- only for small S (last token)."""
    return L._einsum_f32("bsd,dv->bsv", h, _lm_head_weight(cfg, params))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lm_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
              *, splan: ShardingPlan | None = None) -> torch.Tensor:
    """Train-mode backbone: tokens [B, S] -> normed hidden [B, S, D]."""
    splan = splan or make_plan(cfg, None)
    B, Sq = tokens.shape
    h = L.shard(params["embed"][tokens], splan.hidden, splan.mesh)
    positions = torch.arange(Sq, dtype=torch.int32, device=h.device)
    h, _ = _backbone(cfg, params, h, splan, positions, mode="train")
    return L.apply_norm(cfg, params["final_norm"], h)


def lm_loss(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor, *, splan: ShardingPlan | None = None,
            vocab_chunk: int = 16_384) -> torch.Tensor:
    h = lm_hidden(cfg, params, tokens, splan=splan)
    return chunked_xent(h, _lm_head_weight(cfg, params), labels,
                        vocab_chunk=vocab_chunk)


def lm_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               *, splan: ShardingPlan | None = None,
               ctx: int | None = None):
    """tokens [B, S] -> (last-token logits [B, Vp], caches).
    ``ctx``: total cache positions (> S for decode appends; serving)."""
    splan = splan or make_plan(cfg, None)
    B, Sq = tokens.shape
    h = L.shard(params["embed"][tokens], splan.hidden, splan.mesh)
    positions = torch.arange(Sq, dtype=torch.int32, device=h.device)
    h, caches = _backbone(cfg, params, h, splan, positions, mode="prefill",
                          ctx=ctx)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = full_logits(cfg, params, h[:, -1:])[:, 0]
    caches = dict(caches)
    caches["index"] = torch.tensor(Sq, dtype=torch.int32, device=h.device)
    return logits, caches


def lm_decode(cfg: ModelConfig, params: Params, caches: Params,
              token: torch.Tensor, *, splan: ShardingPlan | None = None):
    """token [B, 1] -> (logits [B, Vp], caches).  The K/V, conv and state
    tensors of ``caches`` are updated in place and returned (with ``index +
    1``): a caller that needs the old caches clones them first."""
    splan = splan or make_plan(cfg, None)
    h = L.shard(params["embed"][token], splan.decode_hidden, splan.mesh)
    h, new_caches = _backbone(cfg, params, h, splan, None, mode="decode",
                              caches=caches)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = full_logits(cfg, params, h)[:, 0]
    out = dict(new_caches)
    out["index"] = caches["index"] + 1
    return logits, out


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, ctx: int,
                *, dtype=torch.bfloat16, device=None) -> Params:
    """Zero caches for a [batch] decode stream with ``ctx`` total positions,
    every leaf stacked on a leading ``[nB]`` axis:

      * an attention position ``p{i}`` and the hybrid's ``shared`` block:
        K/V ``[nB, batch, ctx, KV, dh]`` in ``dtype`` (windowed layers get
        the full ctx too; the window masks at attend time);
      * an SSM position ``p{i}``: ``conv [nB, batch, W-1, C]`` in ``dtype``
        and ``state [nB, batch, H, P, N]`` in f32, O(1) in ``ctx``;

    and a scalar int32 ``index``."""
    device = resolve_device(device)
    nB = cfg.num_blocks
    shape = (nB, batch, ctx, cfg.num_kv_heads, cfg.head_dim)

    def kv() -> Params:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    caches: Params = {}
    for i, plan in enumerate(make_layer_plans(cfg)):
        if plan.kind == "ssm":
            caches[f"p{i}"] = {
                k: t.new_zeros((nB,) + t.shape) for k, t in
                S.init_ssd_cache(cfg, batch, dtype, device=device).items()}
        else:
            caches[f"p{i}"] = kv()
    if cfg.shared_attn_every:
        caches["shared"] = kv()
    caches["index"] = torch.tensor(0, dtype=torch.int32, device=device)
    return caches
