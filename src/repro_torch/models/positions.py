"""LM prefill and decode over positions that own their shards (torch).

The reference's LM on a mesh runs each device on its own shards: XLA
partitions the program at every ``with_sharding_constraint`` and the two
``shard_map``s exchange explicitly.  This module is that program for a
plan with ``own_shards`` (``dist/sharding.make_plan``), the dense and MoE
decoder-only families, prefill and decode.  Every value is a ``Sharded``:
each position computes its own piece from its own pieces
(``Sharded.map``), and every byte that crosses positions goes through
``dist/collectives`` (``relayout``, ``all_gather``, ``reduce_scatter``,
``psum``, ``all_to_all``), which records it.

At each of the reference's constraint points a value is moved to the
plan's spec (``hidden``, ``qkv``, ``kv_ctx``, ``decode_hidden``,
``decode_cache``) under the uneven-split rule of ``own_spec``:

  * parameters are held by ``param_specs`` (FSDP over ``data`` on the dim
    before the last, the last dim over ``model``, experts over
    ``model``); a use gathers a weight over ``data`` (``relayout``) and
    the gathered copy goes when the use ends;
  * ``tp``: each model position projects its own heads (the weight's
    column block), attends over them, and the output projection's
    partials (the weight's row block) are reduce-scattered over ``model``
    onto the hidden spec's d_model split; at decode they are summed;
  * ``cp``: each model position holds its own sequence block, projects
    it with the whole weight and all-gathers K/V over ``model`` every
    layer;
  * decode with the cache's sequence split (a batch smaller than the data
    axes: over every axis) attends over each position's block and merges
    the positions' (max, sum, output) in ascending position
    (flash-decoding);
  * MLPs whose weights are split over ``model`` run column then row
    parallel on rows replicated over ``model`` (reduced as above); on a
    sequence block, or with weights held whole, each position runs the
    whole MLP on its rows;
  * EP prefill (``moe_prefill``): each (data, model) position routes its
    own token block, and its ``[E, C, D]`` buffer crosses the model axis
    in two ``all_to_all``s around the local experts' product; EP decode
    (``moe_decode``): each model position runs its E/n experts on every
    token and the outputs are summed over ``model``.

The KV caches are stacked ``[nB, ...]`` pieces, written in place at the
positions that own each row's ring slot; a replicated piece is written at
every position that holds it.  Logits come back to the controller (the
device of the token tensor) in one gather.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import (P, Sharded, ShardingPlan, coord,
                                       own_spec, shard_tensor)
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.train.tree import tree_map

__all__ = ["prefill", "decode", "moe_layer", "moe_prefill", "moe_decode",
           "cache_index"]

Params = dict[str, Any]


def _entry(axes: tuple):
    """Axes as one spec entry."""
    return None if not axes else (axes[0] if len(axes) == 1 else axes)


def _local(fn, spec, *xs) -> Sharded:
    """``fn(pos, *pieces)`` at every position of the first ``Sharded`` in
    ``xs`` (other arguments passed as they are), under ``spec``."""
    lead = next(x for x in xs if isinstance(x, Sharded))
    return Sharded(lead.mesh, spec, {
        pos: fn(pos, *(x.pieces[pos] if isinstance(x, Sharded) else x
                       for x in xs))
        for pos in lead.pieces})


def _block(tree, i: int):
    """Block ``i`` of a stacked tree: each piece's view ``[i]``."""
    return tree_map(lambda w: w.map(lambda pos, t: t[i],
                                    spec=P(*w.spec[1:])), tree)


def _cols(w: Sharded, M) -> Sharded:
    """A ``[K, N]`` weight as each model position's column block (gathered
    over ``data``), or whole where N does not divide."""
    return C.relayout(w, P(None, M))


def _rows(w: Sharded, M) -> Sharded:
    """A ``[K, N]`` weight as each model position's row block."""
    return C.relayout(w, P(M, None))


def _whole(w: Sharded) -> Sharded:
    return C.relayout(w, P(*((None,) * w.ndim)))


def _split_by(x: Sharded, dim: int, axis) -> bool:
    return axis is not None and axis in x.entry(dim)


def _reduce_to(partial: Sharded, spec, axes) -> Sharded:
    """The sum of ``partial`` over ``axes``, under ``spec``: a reduce-
    scatter onto the dimension ``spec`` splits over ``axes`` (where the
    partial is whole), else an all-reduce."""
    want = own_spec(spec, partial.shape, partial.mesh)
    for d, e in enumerate(want):
        got = e if isinstance(e, tuple) else ((e,) if e else ())
        if got and got[-len(axes):] == tuple(axes) and \
                partial.entry(d) == got[:-len(axes)]:
            return C.relayout(C.reduce_scatter(partial, axes, d), spec)
    return C.relayout(C.psum(partial, axes), spec)


def _norm(cfg, p: Params, x: Sharded) -> Sharded:
    """A norm over d_model, on rows that hold it whole, with the scale and
    bias gathered whole at every position (``param_specs`` splits a
    stacked ``[nB, D]`` norm over ``model`` once it passes the size floor,
    as yi-34b's and chameleon-34b's do)."""
    w = {k: _whole(v) for k, v in p.items()}
    return _local(lambda pos, t, *ws: L.apply_norm(cfg, dict(zip(w, ws)), t),
                  x.spec, x, *w.values())


def _whole_d(x: Sharded) -> Sharded:
    """``x [B, S, D]`` with d_model whole at every position."""
    return C.relayout(x, P(x.spec[0], x.spec[1], None))


# -- dense MLP -----------------------------------------------------------------


def _mlp(cfg: ModelConfig, p: Params, x: Sharded, spec, M) -> Sharded:
    """``apply_mlp`` over rows ``x`` (d_model whole), the result under
    ``spec``.  Rows replicated over ``model`` and ``wi`` split over it:
    column then row parallel, the partials reduced; otherwise the whole
    MLP on each position's rows."""
    tp = (M is not None and not any(M in x.entry(d) for d in range(3))
          and _split_by(p["wi"], 1, M))
    if tp:
        w = {k: _cols(v, M) for k, v in p.items() if k != "wo"}
        w["wo"] = _rows(p["wo"], M)
        part = _local(lambda pos, t, *ws: L.apply_mlp(
            cfg, dict(zip(w, ws)), t), P(x.spec[0], x.spec[1], None),
            x, *w.values())
        return _reduce_to(part, spec, (M,))
    w = {k: _whole(v) for k, v in p.items()}
    y = _local(lambda pos, t, *ws: L.apply_mlp(cfg, dict(zip(w, ws)), t),
               x.spec, x, *w.values())
    return C.relayout(y, spec)


# -- attention -------------------------------------------------------------------


def _qkv(cfg: ModelConfig, p: Params, x: Sharded, heads: bool, M):
    """Each position's q / k / v ``[b, s, H(/n), dh]``: its own heads
    (``heads``: the column block of ``wq`` / ``wk`` / ``wv`` and their
    biases) or all of them (the whole weights)."""
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pick = (lambda w: C.relayout(w, P(*((None,) * (w.ndim - 1)), M))) \
        if heads else _whole
    names = ["wq", "wk", "wv"] + (["bq", "bk", "bv"] if cfg.qkv_bias
                                  else [])
    w = {k: pick(p[k]) for k in names}
    # the q / k norms over head_dim, gathered whole as the norms are
    w.update({k: _whole(p[k]) for k in ("q_norm", "k_norm")
              if cfg.qk_norm})
    n = x.mesh.shape[M] if heads else 1
    spec = P(x.spec[0], x.spec[1], M if heads else None, None)

    def one(pos, t, *ws):
        ww = dict(zip(w, ws))
        out = []
        for name, count in (("q", H), ("k", KV), ("v", KV)):
            y = t @ ww[f"w{name}"]
            if cfg.qkv_bias:
                y = y + ww[f"b{name}"]
            y = y.reshape(*t.shape[:-1], count // n, dh)
            if cfg.qk_norm and name != "v":
                y = L._rms_head(y, ww[f"{name}_norm"])
            out.append(y)
        return out

    outs = {pos: one(pos, x.pieces[pos], *(v.pieces[pos]
                                           for v in w.values()))
            for pos in x.pieces}
    return tuple(Sharded(x.mesh, spec, {q: o[i] for q, o in outs.items()})
                 for i in range(3))


def _out_proj(cfg: ModelConfig, p: Params, o: Sharded, heads: bool, spec,
              M) -> Sharded:
    """``o [b, s, H(/n) * dh] @ wo`` under ``spec``: own heads against
    ``wo``'s row block, summed over ``model``; all heads against the
    whole ``wo``."""
    if heads:
        part = _local(lambda pos, t, w: t @ w, P(o.spec[0], o.spec[1], None),
                      o, _rows(p["wo"], M))
        return _reduce_to(part, spec, (M,))
    y = _local(lambda pos, t, w: t @ w, P(o.spec[0], o.spec[1], None), o,
               _whole(p["wo"]))
    return C.relayout(y, spec)


def _attn_prefill(cfg, splan, p, x: Sharded, spec: L.AttnSpec, S: int,
                  ctx: int):
    """x: the normed rows (d_model whole).  Returns (out under ``hidden``,
    the K/V cache at ``ctx`` under ``decode_cache``)."""
    M = splan.model_axis
    heads = splan.attn_mode == "tp" and M is not None
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x, heads, M)

    def seq(lo: int, n: int, device) -> torch.Tensor:
        return torch.arange(lo, lo + n, dtype=torch.int32, device=device)

    def rope(y: Sharded) -> Sharded:
        if not spec.use_rope:
            return y
        return y.map(lambda pos, t: L.apply_rope(
            t, seq(y.offset(pos, 1), t.shape[1], t.device), cfg.rope_theta))

    q, k = rope(q), rope(k)
    q = C.relayout(q, splan.qkv)
    # cp: K/V gathered over ``model`` (kv_ctx holds the whole sequence)
    k, v = C.relayout(k, splan.kv_ctx), C.relayout(v, splan.kv_ctx)
    chunk = min(cfg.attn_kv_chunk, S)

    def attend(pos, qq, kk, vv):
        return L._chunked_sdpa(
            qq, kk, vv, kv_groups=H // KV,
            q_positions=seq(q.offset(pos, 1), qq.shape[1], qq.device),
            kv_positions=seq(0, S, qq.device), spec=spec, chunk=chunk
        ).reshape(*qq.shape[:2], -1)

    o = _local(attend, P(q.spec[0], q.spec[1], q.spec[2]), q, k, v)
    out = _out_proj(cfg, p, o, heads, splan.hidden, M)
    pad = ctx - S
    cache = {}
    for name, t in (("k", k), ("v", v)):
        if pad:
            t = t.map(lambda pos, y: F.pad(y, (0, 0, 0, 0, 0, pad)))
        cache[name] = C.relayout(t, splan.decode_cache)
    return out, cache


def _write(cache: Sharded, new: Sharded, index: Sharded, b0) -> None:
    """Each row's new K/V at ring slot ``index mod Sc`` of the positions
    that hold that slot, in place (every position holding a copy writes
    it)."""
    Sc = cache.shape[1]
    for pos, t in cache.pieces.items():
        lo, n = cache.offset(pos, 1), t.shape[1]
        idx = _rows_of(index.pieces[pos], b0(pos), t.shape[0])
        local = idx % Sc - lo
        mine = (local >= 0) & (local < n)
        at = local.clamp(0, n - 1)
        bix = torch.arange(t.shape[0], device=t.device)
        y = new.pieces[pos][:, 0].to(t.dtype)
        t[bix, at] = torch.where(mine[:, None, None], y, t[bix, at])


def _rows_of(index: torch.Tensor, lo: int, b: int) -> torch.Tensor:
    """The cache positions of rows ``lo .. lo + b`` (a scalar index: the
    same for every row)."""
    index = torch.atleast_1d(index)
    if index.numel() == 1:
        return index.expand(b)
    return index[lo:lo + b]


def _attn_decode(cfg, splan, p, x: Sharded, cache: dict, index: Sharded,
                 spec: L.AttnSpec):
    """One token against ``cache`` (its block's K/V pieces, written in
    place).  x: the normed rows under ``decode_hidden``."""
    M = splan.model_axis
    k_c, v_c = cache["k"], cache["v"]
    heads = M is not None and M in k_c.entry(2)
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    groups = H // KV
    Sc = k_c.shape[1]
    if x.entry(0) != k_c.entry(0):
        raise ValueError(f"decode rows {x.spec!r} and cache {k_c.spec!r} "
                         f"split the batch differently")
    q, k_new, v_new = _qkv(cfg, p, x, heads, M)

    def b0(pos):
        return x.offset(pos, 0)

    def pos_of(pos, t):
        return _rows_of(index.pieces[pos], b0(pos), t.shape[0])[:, None]

    if spec.use_rope:
        q = q.map(lambda pos, t: L.apply_rope(t, pos_of(pos, t),
                                              cfg.rope_theta))
        k_new = k_new.map(lambda pos, t: L.apply_rope(t, pos_of(pos, t),
                                                      cfg.rope_theta))
    _write(k_c, k_new, index, b0)
    _write(v_c, v_new, index, b0)
    seq_axes = k_c.entry(1)

    def attend(pos, qq, kk, vv):
        B = qq.shape[0]
        lo, n = k_c.offset(pos, 1), kk.shape[1]
        idx = _rows_of(index.pieces[pos], b0(pos), B)
        slots = lo + torch.arange(n, device=qq.device)
        valid = slots[None, :] <= idx[:, None]
        if spec.window > 0:
            valid &= (slots[None, :] // spec.window) == \
                (idx[:, None] // spec.window)
        qg = qq.reshape(B, 1, kk.shape[2], groups, dh)
        logits = L._einsum_f32("bqkgd,bskd->bkgqs", qg, kk) / math.sqrt(dh)
        logits = torch.where(valid[:, None, None, None], logits, -1e30)
        if not seq_axes:
            probs = torch.softmax(logits, dim=-1)
            return L._einsum_f32("bkgqs,bskd->bqkgd", probs.to(vv.dtype),
                                 vv).reshape(B, 1, -1).to(qq.dtype)
        m = logits.amax(dim=-1)                          # [B, KV, g, 1]
        e = torch.exp(logits - m[..., None])
        acc = L._einsum_f32("bkgqs,bskd->bkgqd", e.to(vv.dtype), vv)
        return torch.cat([m[..., None], e.sum(-1)[..., None], acc],
                         -1)[None]                       # [1, B, KV, g, 1, 2+dh]

    parts = _local(attend, P(_entry(seq_axes), x.spec[0], None, None, None,
                             None) if seq_axes else
                   P(x.spec[0], None, M if heads else None), q, k_c, v_c)
    if seq_axes:
        stats = C.all_gather(parts, 0)

        def merge(pos, st):
            m_all = st[..., 0]
            m = m_all.amax(dim=0)
            num = den = None
            for j in range(st.shape[0]):           # ascending position
                w = torch.exp(m_all[j] - m)
                a, d = st[j, ..., 2:] * w[..., None], st[j, ..., 1] * w
                num = a if num is None else num + a
                den = d if den is None else den + d
            out = (num / den[..., None]).permute(0, 3, 1, 2, 4)
            return out.reshape(out.shape[0], 1, -1).to(x.dtype)

        o = stats.map(merge, spec=P(x.spec[0], None, None))
    else:
        o = parts
    out = _out_proj(cfg, p, o, heads, splan.decode_hidden, M)
    return out


# -- the MoE -----------------------------------------------------------------------


def moe_prefill(cfg: ModelConfig, p: Params, x: Sharded,
                splan: ShardingPlan, *, with_routes: bool = False):
    """The EP ``apply_moe`` over rows ``x [B, S, D]`` (d_model whole) on
    positions that own their shards, the routed experts only: each (data,
    model) position routes its ``[B/data, S/model]`` token block at
    ``ep_capacity`` (``layers._dispatch``), its ``[E, C, D]`` buffer
    crosses the model axis (``all_to_all``), its E/n local experts run over
    ``[E/n, n * C, D]``, and the exchange back returns its rows
    (``layers._combine``).  Returns the output under ``[B -> data axes,
    S -> model]`` (with ``with_routes``, also each position's (expert
    index, keep) of its tokens)."""
    M = splan.model_axis
    D = x.shape[2]
    cap = L.ep_capacity(cfg, splan, x)       # raises on uneven blocks
    xb = C.relayout(x, P(_entry(splan.data_axes), M, None))
    router = _whole(p["router"])
    routes = {}

    def dispatch(pos, t, r):
        buf, *routes[pos] = L._dispatch({"router": r},
                                        t.reshape(1, -1, D), cap)
        return buf                                     # [1, E, C, D]

    sent = _local(dispatch, P(_entry(splan.data_axes), None, M, None), xb,
                  router)
    sent = C.all_to_all(sent, 1, 2)                 # [1, E/n, n * C, D]
    w = {k: C.relayout(p[k], P(M, None, None)) for k in ("wi", "wg", "wo")}
    y = _local(lambda pos, t, wi, wg, wo: L._experts(
        {"wi": wi, "wg": wg, "wo": wo}, t[0])[None], sent.spec, sent,
        *w.values())
    back = C.all_to_all(y, 2, 1)                    # [1, E, C, D]

    def combine(pos, t):
        eidx, keep, slot, gate = routes[pos]
        return L._combine(t, slot, gate, keep).reshape(
            xb.pieces[pos].shape)

    out = back.map(combine, spec=xb.spec)
    if with_routes:
        return out, {pos: (r[0][0], r[1][0]) for pos, r in routes.items()}
    return out


def moe_decode(cfg: ModelConfig, p: Params, x: Sharded,
               splan: ShardingPlan) -> Sharded:
    """The EP ``moe_decode`` over rows ``x [B, 1, D]`` (replicated over
    ``model``), the routed experts only: each model position routes every
    token and runs its E/n local experts (``layers._ep_decode_shard``),
    and the outputs are summed over ``model`` in ascending position (the
    ``psum``)."""
    M = splan.model_axis
    L._ep_decode_blocks(splan, x.shape[0])
    router = _whole(p["router"])
    w = {k: C.relayout(p[k], P(M, None, None)) for k in ("wi", "wg", "wo")}

    def local(pos, t, r, wi, wg, wo):
        tok = t.reshape(-1, t.shape[-1])
        logits, _, gate = L._route({"router": r}, tok)
        return L._ep_decode_shard(tok, logits.argmax(dim=-1), gate, wi, wg,
                                  wo, coord(x.mesh, pos, (M,))
                                  ).reshape(t.shape)

    part = _local(local, x.spec, x, router, *w.values())
    return C.psum(part, (M,))


def moe_layer(cfg, splan, p, x: Sharded, spec, *, decode: bool) -> Sharded:
    """The MoE layer (routed experts and the shared expert) over rows
    ``x`` (d_model whole), the result under ``spec``.  Without expert
    parallelism (a model axis that does not divide E, or decode without
    ``moe_decode_ep``) every position gathers the rows and the experts
    whole and runs the held-once layer."""
    mesh = x.mesh
    ep = (splan.model_axis is not None
          and cfg.num_experts % int(mesh.shape[splan.model_axis]) == 0
          and (cfg.moe_decode_ep or not decode))
    routed = {k: v for k, v in p.items() if k != "shared"}
    if ep:
        out = (moe_decode(cfg, routed, x, splan) if decode
               else moe_prefill(cfg, routed, x, splan))
    else:
        whole = _whole(x)
        ws = {k: _whole(v) for k, v in routed.items()}
        plain = dataclasses.replace(cfg, shared_expert=False)
        fn = L.moe_decode if decode else L.apply_moe
        out = _local(lambda pos, t, *w: fn(plain, dict(zip(ws, w)), t),
                     whole.spec, whole, *ws.values())
    out = C.relayout(out, spec)
    if cfg.shared_expert:
        sh = _mlp(dataclasses.replace(cfg, mlp_type="swiglu"), p["shared"],
                  x, spec, splan.model_axis)
        out = _local(lambda pos, a, b: a + b, out.spec, out, sh)
    return out


# -- the backbone and the entry points ---------------------------------------------


def _layer(cfg, splan, plan, p, h: Sharded, *, S: int, ctx: int,
           cache=None, index=None):
    """One attention layer.  Prefill (``cache`` None): returns (h, its
    K/V cache); decode: writes ``cache`` in place, returns (h, None)."""
    decode = cache is not None
    hs = splan.decode_hidden if decode else splan.hidden
    h = C.relayout(h, hs)
    x = _norm(cfg, p["norm1"], _whole_d(h))
    if decode:
        a = _attn_decode(cfg, splan, p["attn"], x, cache, index, plan.attn)
        new_cache = None
    else:
        a, new_cache = _attn_prefill(cfg, splan, p["attn"], x, plan.attn, S,
                                     ctx)
    h = _local(lambda pos, u, w: u + w, h.spec, h, C.relayout(a, h.spec))
    x = _norm(cfg, p["norm2"], _whole_d(h))
    if plan.use_moe:
        m = moe_layer(cfg, splan, p["moe"], x, h.spec, decode=decode)
    elif cfg.d_ff > 0:
        m = _mlp(cfg, p["mlp"], x, h.spec, splan.model_axis)
    else:
        return h, new_cache
    return _local(lambda pos, u, w: u + w, h.spec, h, m), new_cache


def _embed(params: Params, tokens: Sharded, spec, M) -> Sharded:
    """Each position's rows of the embedding table: its column block
    (gathered over ``data``) at its tokens, then moved to ``spec``."""
    table = _cols(params["embed"], M)
    h = _local(lambda pos, e, t: e[t.to(e.device)],
               P(tokens.spec[0], tokens.spec[1], table.spec[1]), table,
               tokens)
    return C.relayout(h, spec)


def _head(cfg, params, h: Sharded, M) -> Sharded:
    """f32 logits ``[B, 1, V]`` of rows ``h [B, 1, D]`` (d_model whole):
    each model position's block of the vocabulary."""
    x = _norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        e = params["embed"]
        w = e.map(lambda pos, t: t.T, spec=P(e.spec[1], e.spec[0]))
    else:
        w = params["lm_head"]
    w = _cols(w, M)
    return _local(lambda pos, t, ww: L._einsum_f32("bsd,dv->bsv", t, ww),
                  P(x.spec[0], None, w.spec[1]), x, w)


def _check(params: Params) -> None:
    """Own-shards plans exist only for the dense and MoE families
    (``make_plan`` refuses the others); the parameters must be pieces."""
    if not isinstance(params["embed"], Sharded):
        raise TypeError("positions that own their shards take parameters "
                        "placed as pieces (dist/sharding.shard_params)")


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            splan: ShardingPlan, ctx: int | None = None):
    """``lm_prefill`` on positions that own their shards: ``params`` a
    tree of ``Sharded`` (``dist/sharding.shard_params``), tokens ``[B, S]``
    on the controller.  Returns (last-token logits ``[B, Vp]`` on the
    controller, the stacked caches as ``Sharded`` by ``cache_specs``)."""
    _check(params)
    mesh, M = splan.mesh, splan.model_axis
    B, S = tokens.shape
    ctx = ctx or S
    da = _entry(splan.data_axes)
    toks = shard_tensor(tokens, mesh, P(da, None))
    h = _embed(params, toks, splan.hidden, M)
    plans = LM.make_layer_plans(cfg)
    per_block: list[dict] = []
    for i in range(cfg.num_blocks):
        pb = _block(params["blocks"], i)
        caches = {}
        for j, plan in enumerate(plans):
            h, caches[f"p{j}"] = _layer(cfg, splan, plan, pb[f"p{j}"], h,
                                        S=S, ctx=ctx)
        per_block.append(caches)
    last = C.relayout(h, P(h.spec[0], None, h.spec[2]))
    last = C.relayout(last.map(lambda pos, t: t[:, -1:],
                               spec=last.spec), P(h.spec[0], None, None))
    logits = C.gather_to(_head(cfg, params, last, M), tokens.device)[:, 0]
    out: Params = {}
    for j in range(len(plans)):
        out[f"p{j}"] = {}
        for name in ("k", "v"):
            parts = [blk[f"p{j}"][name] for blk in per_block]
            out[f"p{j}"][name] = Sharded(
                mesh, P(None, *parts[0].spec),
                {pos: torch.stack([x.pieces[pos] for x in parts])
                 for pos in parts[0].pieces})
    out["index"] = shard_tensor(torch.tensor(S, dtype=torch.int32), mesh,
                                P())
    return logits, out


def decode(cfg: ModelConfig, params: Params, caches: Params,
           token: torch.Tensor, splan: ShardingPlan):
    """``lm_decode`` on positions that own their shards: ``caches`` as
    ``prefill`` returns them (or an engine's slot caches), token ``[B, 1]``
    on the controller.  The K/V pieces are written in place; returns
    (logits ``[B, Vp]`` on the controller, the caches with every
    position's ``index`` copy advanced)."""
    _check(params)
    mesh, M = splan.mesh, splan.model_axis
    index = caches["index"]
    toks = shard_tensor(token, mesh, P(splan.decode_hidden[0], None))
    h = _embed(params, toks, splan.decode_hidden, M)
    plans = LM.make_layer_plans(cfg)
    for i in range(cfg.num_blocks):
        pb = _block(params["blocks"], i)
        cb = _block({k: v for k, v in caches.items() if k != "index"}, i)
        for j, plan in enumerate(plans):
            h, _ = _layer(cfg, splan, plan, pb[f"p{j}"], h, S=1, ctx=0,
                          cache=cb[f"p{j}"], index=index)
    h = C.relayout(h, P(h.spec[0], None, None))
    logits = C.gather_to(_head(cfg, params, h, M), token.device)[:, 0]
    out = dict(caches)
    out["index"] = index.map(lambda pos, t: t + 1)
    return logits, out


def cache_index(caches: Params, device) -> torch.Tensor:
    """The caches' ``index`` as the controller reads it: the first
    position's copy (every copy is equal), on ``device``."""
    return caches["index"].first.to(device)
