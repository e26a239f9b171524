"""LM prefill and decode over positions that own their shards (torch).

The reference's LM on a mesh runs each device on its own shards: XLA
partitions the program at every ``with_sharding_constraint`` and the two
``shard_map``s exchange explicitly.  This module is that program for a
plan with ``own_shards`` (``dist/sharding.make_plan``): the decoder-only
families (dense, MoE, SSD, hybrid) and the enc-dec, prefill and decode.
Every value is a ``Sharded``: each position computes its own piece from
its own pieces (``Sharded.map``), and every byte that crosses positions
goes through ``dist/collectives`` (``relayout``, ``all_gather``,
``reduce_scatter``, ``psum``, ``all_to_all``), which records it.

At each of the reference's constraint points a value is moved to the
plan's spec (``hidden``, ``qkv``, ``kv_ctx``, ``decode_hidden``,
``decode_cache``, ``ssm_state``) under the uneven-split rule of
``own_spec``:

  * parameters are held by ``param_specs`` (FSDP over ``data`` on the dim
    before the last, the last dim over ``model``, experts over
    ``model``); a use gathers a weight over ``data`` (``relayout``) and
    the gathered copy goes when the use ends;
  * ``tp``: each model position projects its own heads (the weight's
    column block), attends over them, and the output projection's
    partials (the weight's row block) are reduce-scattered over ``model``
    onto the hidden spec's d_model split; at decode they are summed.
    Every such row-parallel product forms its partials in f32 and rounds
    their sum once to the model dtype (``_row_parallel``), as the
    held-once product accumulates in f32 and rounds once;
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
    token and the outputs are summed over ``model``;
  * the SSD (``_ssd``): the scan runs along the sequence, so each
    position takes its rows' whole sequence (an all-gather over
    ``model`` under ``cp``, the d_model gather under ``tp``), projects
    them with its column block of ``in_proj`` and all-gathers the
    projection (the blocks cut across ``z | x B C | dt``), then convolves
    and scans its own heads (the plan's ``ssm_state``: heads over
    ``model``) with all of B and C; the gated norm over d_inner sums each
    position's sum of squares over ``model`` in ascending position, and
    ``out_proj``'s row-block partials are reduced onto the hidden spec;
  * the hybrid's shared block (``_shared_layer``): concat(h, e0) of the
    two streams made whole in d_model (a concat of d-split pieces is not
    a piece of the concat), ``wq``'s column block plus the block's LoRA
    ``a`` (whole) times ``b``'s column block, then attention and the gelu
    MLP as above;
  * the enc-dec (``encode``, ``encdec_prefill``, ``encdec_decode``): the
    encoder's non-causal and the decoder's causal self-attention as
    above; cross-attention projects each position's heads from the
    memory, which every position holds for its rows whole (the ``memory``
    cache spec: data rows, whole over ``model``).

The caches are stacked ``[nB, ...]`` pieces by ``cache_specs``: K/V
written in place at the positions that own each row's ring slot, the
SSD ``conv`` window (whole over ``model``) at every position that holds
its rows, the f32 ``state`` at the position of its heads; a replicated
piece is written at every position that holds it.  Logits come back to
the controller (the device of the token tensor) in one gather.
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
from repro_torch.models import ssd as SSD
from repro_torch.train.tree import tree_map

__all__ = ["prefill", "decode", "hidden", "loss", "encode", "encdec_prefill",
           "encdec_decode", "encdec_loss", "moe_layer", "moe_prefill",
           "moe_decode", "cache_index"]

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


def _batch(tokens: torch.Tensor, splan: ShardingPlan) -> Sharded:
    """``[B, ...]`` ids (or frames) on the controller, cut by the data
    axes: each position its rows."""
    return shard_tensor(tokens, splan.mesh,
                        P(_entry(splan.data_axes),
                          *((None,) * (tokens.ndim - 1))))


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


def _row_parallel(t: Sharded, w: Sharded, spec, M, dtype) -> Sharded:
    """``t [b, s, K] @ w [K, N]`` summed over ``M``, under ``spec``: each
    position's slice of K against its row block of ``w`` (both already
    so), the partial products in f32, their sum (reduce-scattered onto
    ``spec``'s split, or all-reduced) rounded once to ``dtype``, as the
    held-once product accumulates in f32 and rounds once."""
    part = _local(lambda pos, a, b: a.float() @ b.float(),
                  P(t.spec[0], t.spec[1], None), t, w)
    return _reduce_to(part, spec, (M,)).map(lambda pos, y: y.to(dtype))


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


def _add(h: Sharded, y: Sharded) -> Sharded:
    """The residual ``h + y`` at every position (``y`` under ``h``'s
    spec)."""
    return _local(lambda pos, u, w: u + w, h.spec, h, y)


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
        h = _local(lambda pos, t, *ws: L.mlp_hidden(cfg, dict(zip(w, ws)), t),
                   P(x.spec[0], x.spec[1], M), x, *w.values())
        return _row_parallel(h, _rows(p["wo"], M), spec, M, x.dtype)
    w = {k: _whole(v) for k, v in p.items()}
    y = _local(lambda pos, t, *ws: L.apply_mlp(cfg, dict(zip(w, ws)), t),
               x.spec, x, *w.values())
    return C.relayout(y, spec)


# -- attention -------------------------------------------------------------------


def _qkv(cfg: ModelConfig, p: Params, x: Sharded, heads: bool, M,
         kv: Sharded | None = None):
    """Each position's q / k / v ``[b, s, H(/n), dh]``: its own heads
    (``heads``: the column block of ``wq`` / ``wk`` / ``wv`` and their
    biases) or all of them (the whole weights).  K / V project ``kv``
    (cross-attention's memory, its rows those of ``x``) where given, in
    the dtype jnp promotes a mixed product to."""
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
    kv = x if kv is None else kv
    specs = [P(s.spec[0], s.spec[1], M if heads else None, None)
             for s in (x, kv, kv)]

    def one(pos, t, *ws):
        ww = dict(zip(w, ws))
        out = []
        for name, count in (("q", H), ("k", KV), ("v", KV)):
            src, wt = (t if name == "q" else kv.pieces[pos]), ww[f"w{name}"]
            if name != "q" and src.dtype != wt.dtype:
                dt = torch.promote_types(src.dtype, wt.dtype)
                src, wt = src.to(dt), wt.to(dt)
            y = src @ wt
            if cfg.qkv_bias:
                y = y + ww[f"b{name}"]
            y = y.reshape(*src.shape[:-1], count // n, dh)
            if cfg.qk_norm and name != "v":
                y = L._rms_head(y, ww[f"{name}_norm"])
            out.append(y)
        return out

    outs = {pos: one(pos, x.pieces[pos], *(v.pieces[pos]
                                           for v in w.values()))
            for pos in x.pieces}
    return tuple(Sharded(x.mesh, specs[i], {q: o[i] for q, o in outs.items()})
                 for i in range(3))


def _out_proj(cfg: ModelConfig, p: Params, o: Sharded, heads: bool, spec,
              M) -> Sharded:
    """``o [b, s, H(/n) * dh] @ wo`` under ``spec``: own heads against
    ``wo``'s row block, summed over ``model``; all heads against the
    whole ``wo``."""
    if heads:
        return _row_parallel(o, _rows(p["wo"], M), spec, M, o.dtype)
    y = _local(lambda pos, t, w: t @ w, P(o.spec[0], o.spec[1], None), o,
               _whole(p["wo"]))
    return C.relayout(y, spec)


def _attn_prefill(cfg, splan, p, x: Sharded, spec: L.AttnSpec, S: int,
                  ctx: int | None):
    """x: the normed rows (d_model whole).  Returns (out under ``hidden``,
    the K/V cache at ``ctx`` under ``decode_cache``; None without a
    ``ctx``: the encoder keeps none)."""
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
    if ctx is None:
        return out, None
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


# -- the SSD (mamba2, zamba2) ---------------------------------------------------------

#: the SSD's vector leaves, gathered whole where a position uses them
_SSD_SMALL = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")


def _ssd_split(splan: ShardingPlan) -> bool:
    """Whether the SSD heads are split over ``model`` (the plan's
    ``ssm_state``: where the axis divides the heads)."""
    M = splan.model_axis
    return M is not None and splan.ssm_state[1] == M


def _ssd_share(cfg, splan, pos) -> tuple[slice, slice]:
    """Position ``pos``'s share of an SSD layer: its slice of d_inner (its
    heads' z, x, norm and ``out_proj`` rows) and of the heads; all of them
    where the heads are not split."""
    M = splan.model_axis
    n = int(splan.mesh.shape[M]) if _ssd_split(splan) else 1
    m = coord(splan.mesh, pos, (M,)) if n > 1 else 0
    dl, hl = cfg.d_inner // n, cfg.ssm_heads // n
    return slice(m * dl, (m + 1) * dl), slice(m * hl, (m + 1) * hl)


def _conv_share(cfg, t: torch.Tensor, ds: slice) -> torch.Tensor:
    """The conv channels a share reads of ``t [..., d_inner + 2N]``: its x
    channels, then all of B and C (one group)."""
    return torch.cat([t[..., ds], t[..., cfg.d_inner:]], -1)


def _ssd(cfg, splan, p: Params, x: Sharded, spec, cache=None, *,
         collect: bool = True):
    """The SSD block on normed rows ``x [B, S, D]`` (d_model whole), the
    output under ``spec``.  Each position takes its rows' whole sequence,
    projects them with its column block of ``in_proj`` and all-gathers
    the projection, then convolves and scans its share of the heads
    (``_ssd_share``; ``ssd._scan_heads`` / ``ssd._step_heads``), gates and
    normalises them (``_ssd_out``).  Prefill (``cache`` None): returns
    (out, ``{conv, state}`` under the cache specs; None without
    ``collect``, the training forward); decode writes the conv window
    (whole channels, at every position holding its rows) and its heads'
    state into ``cache`` and returns (out, None)."""
    mesh, M = splan.mesh, splan.model_axis
    split = _ssd_split(splan)
    x = C.relayout(x, P(x.spec[0], None, None))
    w = _cols(p["in_proj"], M)
    proj = C.all_gather(_local(lambda pos, t, ww: t @ ww,
                               P(x.spec[0], None, w.spec[1]), x, w), 2)
    small = {k: _whole(p[k]) for k in _SSD_SMALL}
    S_true, W = x.shape[1], cfg.conv_width
    Q = min(cfg.ssm_chunk, S_true)
    S_pad = -(-S_true // Q) * Q
    if cache is not None and cache["state"].entry(1) != \
            ((M,) if split else ()):
        raise ValueError(f"an SSD state under {cache['state'].spec!r} for "
                         f"a plan whose ssm_state is {splan.ssm_state!r}")
    ys, zs, conv, state = {}, {}, {}, {}
    for pos, t in proj.pieces.items():
        ds, hs = _ssd_share(cfg, splan, pos)
        ws = {k: v.pieces[pos] for k, v in small.items()}
        local = {"conv_w": _conv_share(cfg, ws["conv_w"], ds),
                 "conv_b": _conv_share(cfg, ws["conv_b"], ds),
                 **{k: ws[k][hs] for k in ("A_log", "D", "dt_bias")}}
        if cache is not None:
            z, xBC, dt = SSD._split_proj(cfg, t[:, 0])
            c, st = cache["conv"].pieces[pos], cache["state"].pieces[pos]
            hist = torch.cat(SSD._promoted(c, xBC[:, None]), dim=1)
            y, new = SSD._step_heads(cfg, local, _conv_share(cfg, hist, ds),
                                     dt[:, hs], st, x.dtype)
            c.copy_(hist[:, 1:])
            st.copy_(new)
            ys[pos], zs[pos] = y[:, None], z[:, None, ds]
            continue
        if S_pad != S_true:
            t = F.pad(t, (0, 0, 0, S_pad - S_true))
        z, xBC, dt = SSD._split_proj(cfg, t)
        y, state[pos] = SSD._scan_heads(cfg, local, _conv_share(cfg, xBC, ds),
                                        dt[..., hs], S_true=S_true, Q=Q)
        ys[pos], zs[pos] = y[:, :S_true], z[:, :S_true, ds]
        conv[pos] = xBC[:, S_true - (W - 1):S_true] if W > 1 else xBC[:, :0]
    share = P(x.spec[0], None, M if split else None)
    out = _ssd_out(cfg, splan, p, Sharded(mesh, share, ys),
                   Sharded(mesh, share, zs), small["norm"], spec)
    if cache is not None or not collect:
        return out, None
    b = x.spec[0]
    return out, {
        "conv": C.relayout(Sharded(mesh, P(b, None, None), conv),
                           P(splan.decode_hidden[0], None, None)),
        "state": C.relayout(Sharded(mesh, P(b, share[2], None, None), state),
                            splan.ssm_state)}


def _ssd_out(cfg, splan, p: Params, y: Sharded, z: Sharded, norm: Sharded,
             spec) -> Sharded:
    """``rmsnorm(y * silu(z)) @ out_proj`` under ``spec``.  Heads split:
    each position's sum of squares over its d_inner slice is summed over
    ``model`` in ascending position before the rsqrt, and its rows of
    ``out_proj`` give partials reduced onto ``spec``; otherwise each
    position runs ``ssd._gated_rmsnorm`` and the whole ``out_proj``."""
    M = splan.model_axis
    if not _ssd_split(splan):
        o = _local(lambda pos, yy, zz, nn: SSD._gated_rmsnorm(yy, zz, nn),
                   y.spec, y, z, norm)
        out = _local(lambda pos, t, w: t @ w, P(o.spec[0], o.spec[1], None),
                     o, _whole(p["out_proj"]))
        return C.relayout(out, spec)
    g = _local(lambda pos, yy, zz: (yy * F.silu(zz)).float(), y.spec, y, z)
    ss = C.psum(g.map(lambda pos, t: (t * t).sum(-1, keepdim=True),
                      spec=P(g.spec[0], g.spec[1], None)), (M,))

    def gate(pos, t, s, nn):
        ds, _ = _ssd_share(cfg, splan, pos)
        t = t * torch.rsqrt(s / cfg.d_inner + 1e-6)
        return (t * nn[ds].float()).to(y.dtype)

    o = _local(gate, y.spec, g, ss, norm)
    return _row_parallel(o, _rows(p["out_proj"], M), spec, M, y.dtype)


def _ssm_layer(cfg, splan, p: Params, h: Sharded, *, cache=None,
               collect: bool = True):
    """One SSD layer: h + ssd(norm1(h)) under the hidden spec.  Prefill
    (``cache`` None): returns (h, its ``{conv, state}``, None without
    ``collect``); decode: writes ``cache`` in place, returns (h, None)."""
    h = C.relayout(h, splan.hidden if cache is None else splan.decode_hidden)
    x = _norm(cfg, p["norm1"], _whole_d(h))
    y, new_cache = _ssd(cfg, splan, p["ssm"], x, h.spec, cache,
                        collect=collect)
    return _add(h, y), new_cache


# -- the hybrid's shared block (zamba2) -----------------------------------------------


def _lora_wq(wq: Sharded, lora: Params, heads: bool, M) -> Sharded:
    """The shared block's ``wq`` plus this block's LoRA delta ``a @ b``
    (in ``wq``'s dtype) as each position uses it: its column block, ``wq``'s
    plus ``a`` (whole) times ``b``'s (``heads``), or the whole sum."""
    pick = (lambda w: _cols(w, M)) if heads else _whole
    w, b = pick(wq), pick(lora["b"])
    return _local(lambda pos, ww, aa, bb: ww + (aa @ bb).to(ww.dtype),
                  w.spec, w, _whole(lora["a"]), b)


def _shared_layer(cfg, splan, shared: Params, lora: Params, h: Sharded,
                  e0: Sharded, *, S: int, ctx: int, cache=None, index=None):
    """Zamba2's shared block on concat(h, e0), ``e0`` the embedding output
    with d_model whole: both streams whole in d_model before the concat,
    attention over this block's LoRA-modified ``wq``, the gelu MLP, both
    added to ``h``.  Prefill: returns (h, its K/V cache); decode: writes
    ``cache`` in place, returns (h, None)."""
    decode = cache is not None
    M = splan.model_axis
    h = C.relayout(h, splan.decode_hidden if decode else splan.hidden)
    hw = _whole_d(h)
    cat = _local(lambda pos, a, b: torch.cat([a, b], dim=-1), hw.spec, hw,
                 C.relayout(e0, hw.spec))
    heads = M is not None and (M in cache["k"].entry(2) if decode
                               else splan.attn_mode == "tp")
    attn = dict(shared["attn"])
    attn["wq"] = _lora_wq(attn["wq"], lora, heads, M)
    x = _norm(cfg, shared["norm1"], cat)
    if decode:
        a = _attn_decode(cfg, splan, attn, x, cache, index, LM._SHARED_SPEC)
        new_cache = None
    else:
        a, new_cache = _attn_prefill(cfg, splan, attn, x, LM._SHARED_SPEC,
                                     S, ctx)
    x = _norm(cfg, shared["norm2"], cat)
    m = _mlp(dataclasses.replace(cfg, mlp_type="gelu"), shared["mlp"], x,
             h.spec, M)
    return _add(_add(h, C.relayout(a, h.spec)), m), new_cache


# -- the backbone and the entry points ---------------------------------------------


def _layer(cfg, splan, plan, p, h: Sharded, *, S: int, ctx: int | None,
           cache=None, index=None):
    """One attention layer.  Prefill (``cache`` None): returns (h, its
    K/V cache, None without a ``ctx``); decode: writes ``cache`` in place,
    returns (h, None)."""
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
    h = _add(h, C.relayout(a, h.spec))
    x = _norm(cfg, p["norm2"], _whole_d(h))
    if plan.use_moe:
        m = moe_layer(cfg, splan, p["moe"], x, h.spec, decode=decode)
    elif cfg.d_ff > 0:
        m = _mlp(cfg, p["mlp"], x, h.spec, splan.model_axis)
    else:
        return h, new_cache
    return _add(h, m), new_cache


def _embed(params: Params, tokens: Sharded, spec, M) -> Sharded:
    """Each position's rows of the embedding table: its column block
    (gathered over ``data``) at its tokens, then moved to ``spec``."""
    table = _cols(params["embed"], M)
    h = _local(lambda pos, e, t: e[t.to(e.device)],
               P(tokens.spec[0], tokens.spec[1], table.spec[1]), table,
               tokens)
    return C.relayout(h, spec)


def _head_weight(cfg, params: Params) -> Sharded:
    """``lm_head`` ``[D, V]``, or the tied embedding's pieces transposed:
    the head's gradient lands in the embedding's own pieces beside the
    lookup's."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    e = params["embed"]
    return e.map(lambda pos, t: t.T, spec=P(e.spec[1], e.spec[0]))


def _head(cfg, params, h: Sharded, M) -> Sharded:
    """f32 logits ``[B, 1, V]`` of rows ``h [B, 1, D]`` (d_model whole):
    each model position's block of the vocabulary."""
    x = _norm(cfg, params["final_norm"], h)
    w = _cols(_head_weight(cfg, params), M)
    return _local(lambda pos, t, ww: L._einsum_f32("bsd,dv->bsv", t, ww),
                  P(x.spec[0], None, w.spec[1]), x, w)


def _logits(cfg, params, h: Sharded, M, device, *, last: bool):
    """The f32 logits ``[B, Vp]`` of ``h``'s last row (``last``; else its
    one row), gathered to ``device`` (the controller)."""
    if last:
        h = C.relayout(h, P(h.spec[0], None, h.spec[2]))
        h = h.map(lambda pos, t: t[:, -1:])
    h = C.relayout(h, P(h.spec[0], None, None))
    return C.gather_to(_head(cfg, params, h, M), device)[:, 0]


def _stack(mesh, per_block: list[Params]) -> Params:
    """Per-block cache trees (``{name: {leaf: Sharded}}``) stacked on a
    leading ``[nB]`` axis, piece by piece."""
    out: Params = {}
    for name, leaves in per_block[0].items():
        out[name] = {}
        for leaf, first in leaves.items():
            parts = [blk[name][leaf] for blk in per_block]
            out[name][leaf] = Sharded(
                mesh, P(None, *first.spec),
                {pos: torch.stack([x.pieces[pos] for x in parts])
                 for pos in first.pieces})
    return out


def _check(params: Params) -> None:
    """The parameters must be pieces (``dist/sharding.shard_params``)."""
    if not isinstance(params["embed"], Sharded):
        raise TypeError("positions that own their shards take parameters "
                        "placed as pieces (dist/sharding.shard_params)")


def _remat(cfg, fn):
    """``fn(h)`` (a ``Sharded`` in and out) under ``cfg``'s remat policy,
    as ``models/lm._remat`` wraps the held-once block: one checkpoint
    over every position's work, whose recompute runs the block's moves
    again.  The pieces go in as tensors."""
    def on_pieces(mesh, spec, keys, *pieces):
        return fn(Sharded(mesh, spec, dict(zip(keys, pieces))))

    run = LM._remat(cfg, on_pieces)
    if run is on_pieces:
        return fn
    return lambda h: run(h.mesh, h.spec, list(h.pieces), *h.pieces.values())


def _backbone(cfg, splan, params: Params, h: Sharded, *, S: int, ctx,
              caches=None, index=None, train: bool = False):
    """Every block: the hybrid's shared block first (on concat(h, e0),
    ``e0`` the embedding output ``h``), then each position of the period,
    an SSD or an attention layer.  Prefill (``caches`` None): returns (h,
    the caches stacked by block); decode: writes ``caches``' pieces in
    place, returns (h, None); ``train``: builds no cache, each block under
    ``cfg``'s remat policy, returns (h, None)."""
    decode = caches is not None
    plans = LM.make_layer_plans(cfg)
    e0 = _whole_d(h) if cfg.shared_attn_every else None
    per_block: list[Params] = []

    def block(i: int, h: Sharded, new: Params) -> Sharded:
        pb = _block(params["blocks"], i)
        cb = _block(caches, i) if decode else {}
        if cfg.shared_attn_every:
            h, new["shared"] = _shared_layer(
                cfg, splan, params["shared_attn"], _block(params["lora"], i),
                h, e0, S=S, ctx=ctx, cache=cb.get("shared"), index=index)
        for j, plan in enumerate(plans):
            c = cb.get(f"p{j}")
            if plan.kind == "ssm":
                h, new[f"p{j}"] = _ssm_layer(cfg, splan, pb[f"p{j}"], h,
                                             cache=c, collect=not train)
            else:
                h, new[f"p{j}"] = _layer(cfg, splan, plan, pb[f"p{j}"], h,
                                         S=S, ctx=ctx, cache=c, index=index)
        return h

    for i in range(cfg.num_blocks):
        if train:
            h = _remat(cfg, lambda hh, i=i: block(i, hh, {}))(h)
            continue
        new: Params = {}
        h = block(i, h, new)
        per_block.append(new)
    return h, (None if decode or train else _stack(splan.mesh, per_block))


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            splan: ShardingPlan, ctx: int | None = None):
    """``lm_prefill`` on positions that own their shards: ``params`` a
    tree of ``Sharded`` (``dist/sharding.shard_params``), tokens ``[B, S]``
    on the controller.  Returns (last-token logits ``[B, Vp]`` on the
    controller, the stacked caches as ``Sharded`` by ``cache_specs``)."""
    _check(params)
    mesh, M = splan.mesh, splan.model_axis
    B, S = tokens.shape
    toks = _batch(tokens, splan)
    h = _embed(params, toks, splan.hidden, M)
    h, out = _backbone(cfg, splan, params, h, S=S, ctx=ctx or S)
    logits = _logits(cfg, params, h, M, tokens.device, last=True)
    out["index"] = shard_tensor(torch.full((), S, dtype=torch.int32,
                                           device=tokens.device), mesh, P())
    return logits, out


def decode(cfg: ModelConfig, params: Params, caches: Params,
           token: torch.Tensor, splan: ShardingPlan):
    """``lm_decode`` on positions that own their shards: ``caches`` as
    ``prefill`` returns them (or an engine's slot caches), token ``[B, 1]``
    on the controller.  The K/V, conv and state pieces are written in
    place; returns (logits ``[B, Vp]`` on the controller, the caches with
    every position's ``index`` copy advanced)."""
    _check(params)
    mesh, M = splan.mesh, splan.model_axis
    index = caches["index"]
    toks = shard_tensor(token, mesh, P(splan.decode_hidden[0], None))
    h = _embed(params, toks, splan.decode_hidden, M)
    h, _ = _backbone(cfg, splan, params, h, S=1, ctx=0, index=index,
                     caches={k: v for k, v in caches.items() if k != "index"})
    logits = _logits(cfg, params, h, M, token.device, last=False)
    out = dict(caches)
    out["index"] = index.map(lambda pos, t: t + 1)
    return logits, out


# -- the training forward and the loss ------------------------------------------


def _xent(cfg, splan, norm: Params, h: Sharded, w: Sharded,
          labels: torch.Tensor, *, vocab_chunk: int,
          device) -> torch.Tensor:
    """``chunked_xent`` of the final-normed rows of ``h`` against ``w [D,
    V]`` over positions: the rows with d_model and the sequence whole,
    each model position scanning its own column block of the vocabulary
    (``_cols``) for its running (max, sumexp, target) triple
    (``lm._xent_stats``), the triples all-gathered over ``model`` and
    merged in ascending position; the masked mean's numerator and
    denominator summed over the axes that split the batch.  Returns the
    loss on ``device`` (the controller), read from the first position's
    copy."""
    M = splan.model_axis
    x = _norm(cfg, norm, C.relayout(h, P(h.spec[0], None, None)))
    w = _cols(w, M)
    lab = _batch(labels, splan)
    split = M is not None and w.entry(1) == (M,)

    def stats(pos, t, ww, lb):
        st = torch.stack(LM._xent_stats(t, ww, lb, vocab_chunk=vocab_chunk,
                                        col0=w.offset(pos, 1)))
        return st[None] if split else st           # [(1,) 3, b, S]

    tri = _local(stats, P(M, None, x.spec[0], None) if split
                 else P(None, x.spec[0], None), x, w, lab)
    if split:
        tri = C.all_gather(tri, 0)

    def nll_sums(pos, st, lb):
        if split:                                  # ascending position
            m = st[:, 0].amax(dim=0)
            s = t = None
            for j in range(st.shape[0]):
                sj = st[j, 1] * torch.exp(st[j, 0] - m)
                s = sj if s is None else s + sj
                t = st[j, 2] if t is None else t + st[j, 2]
        else:
            m, s, t = st[0], st[1], st[2]
        nll = (m + torch.log(s.clamp_min(1e-30))) - t
        mask = (lb >= 0).float()
        return torch.stack([(nll * mask).sum(), mask.sum()])

    sums = C.psum(_local(nll_sums, P(None), tri, lab), x.entry(0))
    loss = sums.map(lambda pos, v: v[0] / v[1].clamp_min(1.0), spec=P())
    return C.gather_to(loss, device)


def _train_forward(cfg, params: Params, tokens: torch.Tensor,
                   splan: ShardingPlan) -> Sharded:
    """The embedding and the train-mode backbone (no caches, each block
    under ``cfg``'s remat policy): ``h`` under the hidden spec."""
    _check(params)
    h = _embed(params, _batch(tokens, splan), splan.hidden,
               splan.model_axis)
    return _backbone(cfg, splan, params, h, S=tokens.shape[1], ctx=None,
                     train=True)[0]


def hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           splan: ShardingPlan) -> Sharded:
    """``lm_hidden`` on positions that own their shards: the train-mode
    backbone and the final norm, the rows with d_model whole (``[B, S,
    D]`` under ``[data axes, None, None]``)."""
    h = _train_forward(cfg, params, tokens, splan)
    return _norm(cfg, params["final_norm"], _whole_d(h))


def loss(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
         labels: torch.Tensor, splan: ShardingPlan, *,
         vocab_chunk: int = 16_384) -> torch.Tensor:
    """``lm_loss`` on positions that own their shards: the train-mode
    backbone and ``_xent``; tokens and labels ``[B, S]`` on the
    controller, the loss a scalar there."""
    h = _train_forward(cfg, params, tokens, splan)
    return _xent(cfg, splan, params["final_norm"], h,
                 _head_weight(cfg, params), labels, vocab_chunk=vocab_chunk,
                 device=tokens.device)


# -- the enc-dec (seamless) ------------------------------------------------------


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor,
           splan: ShardingPlan, *, train: bool = False) -> Sharded:
    """``encdec.encode`` on positions that own their shards: frames ``[B,
    S_enc, D]`` on the controller, cut by the data axes -> the memory with
    each position's rows whole (``[b, S_enc, D]``); ``train``: each layer
    under ``cfg``'s remat policy."""
    from repro_torch.models import encdec as ED
    _check(params)
    x = _batch(frames.to(params["embed"].dtype), splan)
    h = C.relayout(x, splan.hidden)
    plan = LM.LayerPlan(kind="attn", attn=ED._ENC_SPEC)
    for i in range(cfg.encoder_layers):
        def layer(hh, i=i):
            return _layer(cfg, splan, plan, _block(params["enc_blocks"], i),
                          hh, S=frames.shape[1], ctx=None)[0]
        h = (_remat(cfg, layer) if train else layer)(h)
    mem = _norm(cfg, params["enc_norm"], _whole_d(h))
    return C.relayout(mem, P(mem.spec[0], None, None))


def _cross_attn(cfg, splan, p: Params, x: Sharded, mem: Sharded,
                spec) -> Sharded:
    """Cross-attention of rows ``x`` (d_model whole) into the memory
    (non-causal, no RoPE), the output under ``spec``: under ``tp`` each
    position projects its own heads from both and its partials of ``wo``
    are reduced; otherwise all heads of its rows."""
    from repro_torch.models import encdec as ED
    M = splan.model_axis
    heads = splan.attn_mode == "tp" and M is not None
    mem = C.relayout(mem, P(x.spec[0], None, None))
    q, k, v = _qkv(cfg, p, x, heads, M, kv=mem)
    Sm = mem.shape[1]

    def attend(pos, qq, kk, vv):
        lo = q.offset(pos, 1)
        return L._chunked_sdpa(
            qq, kk, vv, kv_groups=cfg.num_heads // cfg.num_kv_heads,
            q_positions=torch.arange(lo, lo + qq.shape[1], dtype=torch.int32,
                                     device=qq.device),
            kv_positions=torch.arange(Sm, dtype=torch.int32,
                                      device=qq.device),
            spec=ED._CROSS_SPEC, chunk=min(cfg.attn_kv_chunk, Sm)
        ).reshape(*qq.shape[:2], -1)

    o = _local(attend, P(q.spec[0], q.spec[1], q.spec[2]), q, k, v)
    return _out_proj(cfg, p, o, heads, spec, M)


def _dec_layer(cfg, splan, p: Params, h: Sharded, mem: Sharded, *, S: int,
               cache=None, index=None, train: bool = False):
    """One decoder layer: causal self-attention (prefill: its cache holds
    exactly the prefix, as the reference's does), cross-attention into
    ``mem``, the MLP.  Prefill: returns (h, its K/V cache); decode: writes
    ``cache`` in place, returns (h, None); ``train``: returns (h, None)."""
    from repro_torch.models import encdec as ED
    decode = cache is not None
    M = splan.model_axis
    h = C.relayout(h, splan.decode_hidden if decode else splan.hidden)
    x = _norm(cfg, p["norm1"], _whole_d(h))
    if decode:
        a = _attn_decode(cfg, splan, p["attn"], x, cache, index,
                         ED._SELF_SPEC)
        new_cache = None
    else:
        a, new_cache = _attn_prefill(cfg, splan, p["attn"], x, ED._SELF_SPEC,
                                     S, None if train else S)
    h = _add(h, C.relayout(a, h.spec))
    x = _norm(cfg, p["norm_x"], _whole_d(h))
    h = _add(h, _cross_attn(cfg, splan, p["xattn"], x, mem, h.spec))
    x = _norm(cfg, p["norm2"], _whole_d(h))
    return _add(h, _mlp(cfg, p["mlp"], x, h.spec, M)), new_cache


def encdec_prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                   dec_tokens: torch.Tensor, splan: ShardingPlan):
    """``encdec_prefill`` on positions that own their shards: frames and
    decoder tokens on the controller.  Returns (last-token logits ``[B,
    Vp]`` on the controller, caches ``{self: K/V [L, ...] by
    decode_cache, memory by its rows (the cache spec), index}``)."""
    mesh, M = splan.mesh, splan.model_axis
    mem = encode(cfg, params, frames, splan)
    S = dec_tokens.shape[1]
    toks = _batch(dec_tokens, splan)
    h = _embed(params, toks, splan.hidden, M)
    per_layer = []
    for i in range(cfg.num_layers):
        h, kv = _dec_layer(cfg, splan, _block(params["dec_blocks"], i), h,
                           mem, S=S)
        per_layer.append({"self": kv})
    logits = _logits(cfg, params, h, M, dec_tokens.device, last=True)
    caches = _stack(mesh, per_layer)
    caches["memory"] = C.relayout(mem, P(splan.decode_hidden[0], None, None))
    caches["index"] = shard_tensor(torch.full((), S, dtype=torch.int32,
                                              device=dec_tokens.device),
                                   mesh, P())
    return logits, caches


def encdec_loss(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                dec_tokens: torch.Tensor, labels: torch.Tensor,
                splan: ShardingPlan, *,
                vocab_chunk: int = 16_384) -> torch.Tensor:
    """``encdec_loss`` on positions that own their shards: the encoder and
    the decoder in train mode (no caches, each layer under ``cfg``'s remat
    policy), ``lm_head`` by column blocks in ``_xent``; the loss a scalar
    on the controller."""
    M = splan.model_axis
    mem = encode(cfg, params, frames, splan, train=True)
    h = _embed(params, _batch(dec_tokens, splan), splan.hidden, M)
    for i in range(cfg.num_layers):
        def layer(hh, i=i):
            return _dec_layer(cfg, splan, _block(params["dec_blocks"], i), hh,
                              mem, S=dec_tokens.shape[1], train=True)[0]
        h = _remat(cfg, layer)(h)
    return _xent(cfg, splan, params["final_norm"], h, params["lm_head"],
                 labels, vocab_chunk=vocab_chunk, device=dec_tokens.device)


def encdec_decode(cfg: ModelConfig, params: Params, caches: Params,
                  token: torch.Tensor, splan: ShardingPlan):
    """``encdec_decode`` on positions that own their shards: the self K/V
    pieces written in place, the memory read as it is held; returns
    (logits ``[B, Vp]`` on the controller, the caches with ``index``
    advanced)."""
    _check(params)
    mesh, M = splan.mesh, splan.model_axis
    index = caches["index"]
    toks = shard_tensor(token, mesh, P(splan.decode_hidden[0], None))
    h = _embed(params, toks, splan.decode_hidden, M)
    for i in range(cfg.num_layers):
        h, _ = _dec_layer(cfg, splan, _block(params["dec_blocks"], i), h,
                          caches["memory"], S=1,
                          cache=_block(caches["self"], i), index=index)
    logits = _logits(cfg, params, h, M, token.device, last=False)
    return logits, {"self": caches["self"], "memory": caches["memory"],
                    "index": index.map(lambda pos, t: t + 1)}


def cache_index(caches: Params, device) -> torch.Tensor:
    """The caches' ``index`` as the controller reads it: the first
    position's copy (every copy is equal), on ``device``."""
    return caches["index"].first.to(device)
