"""Shared transformer building blocks (torch).

Mirrors ``repro/models/layers.py``: norms, QK-norm, RoPE, the three MLPs,
attention (projection, grouped SDPA, the blockwise attention over KV
chunks, prefill with its cache, one-token decode) and the MoE (top-1
dispatch with capacity at prefill, the per-token expert-weight gather at
decode, the shared expert, and both expert-parallel paths on a mesh).
Every function is a plain function over explicit parameter dicts of
tensors, in the reference's layout (``x @ w`` with ``w: [d_in, d_out]``),
so a reference parameter tree carries across as a copy
(``models/lm.py:params_from_arrays``).

On a mesh (``splan`` from ``dist/sharding.make_plan``) the positions stand
on one device (``docs/torch_lm_mesh.md``): ``shard`` checks a constraint
as the reference's ``with_sharding_constraint`` does and returns its
input, and the two MoE paths whose results a mesh changes run block by
block, one block a position:
  * ``apply_moe`` (the reference's ``shard_map`` over ``[B -> data axes, S
    -> model]``): each block routes its own tokens with its own capacity
    ``cap_src``, and the ``[E, C, D]`` buffers cross the model axis in the
    ``all_to_all``'s order, so expert shard m runs its E/n experts over the
    rows of every source block;
  * ``moe_decode`` with ``cfg.moe_decode_ep``: each model position's masked
    product over its E/n local experts, at the operands' dtype, summed in
    model order (the reference's ``psum``).

Numerics follow the reference's jnp:
  * every contraction the reference writes with
    ``preferred_element_type=jnp.float32`` upcasts both operands to f32 and
    contracts in f32 (``_einsum_f32``); where jnp would promote mixed
    operands (f32 queries against a bf16 cache), the same cast happens;
  * masks are ``where(mask, logits, -1e30)`` and the blockwise attention
    starts its running max at -inf (``exp(-inf - m)`` = 0, not NaN);
  * gelu is the tanh approximation (``jax.nn.gelu``'s default);
  * RoPE rotates half-split, its angles in f32.

``attention_decode`` writes the new K/V into the cache tensors it is given
and returns them: a kept divergence from the reference's functional update
(``docs/torch_lm.md``; ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import exchange, record_collective
from repro_torch.dist.sharding import check_spec
from repro_torch.models import scanctl

__all__ = ["shard", "init_norm", "apply_norm", "rope_freqs", "apply_rope",
           "init_mlp", "apply_mlp", "AttnSpec", "init_attention",
           "attention_forward", "attention_forward_with_cache",
           "attention_decode", "init_moe", "apply_moe", "moe_decode",
           "moe_dispatch_blocks", "ep_capacity"]

Params = dict[str, Any]

#: the blockwise attention's padding position (jnp.iinfo(jnp.int32).max)
_PAD_POSITION = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# sharding constraint helper
# ---------------------------------------------------------------------------


def shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Constraint point: ``x`` itself.  Under a mesh the spec is checked as
    the reference's constraint checks it (``ValueError`` for a spec longer
    than ``x``'s rank, an axis the mesh lacks, an axis used twice); the
    positions share one device, so nothing moves.  A no-op without a mesh
    or spec."""
    if mesh is None or spec is None:
        return x
    check_spec(spec, x.ndim, mesh)
    return x


def _on_mesh(splan) -> bool:
    return splan is not None and splan.mesh is not None


# ---------------------------------------------------------------------------
# initializers (an explicit torch.Generator; shapes as the reference's)
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: float | None = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * s).to(dtype)


def init_norm(cfg: ModelConfig, d: int, dtype, *, device=None) -> Params:
    device = resolve_device(device)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    if cfg.norm_type == "ln":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    if cfg.norm_type == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (y * p["scale"].float()).to(x.dtype)
    # (nonparam_)ln
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    if cfg.norm_type == "ln":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _rms_head(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head-dim RMS norm (chameleon / llama4 QK-norm)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (y * scale.float()).to(x.dtype)


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=jnp.float32)``: both
    operands upcast to f32, contracted in f32."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, dh]; positions [..., S] (broadcastable)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # [dh/2]
    ang = positions[..., None].float() * freqs              # [..., S, dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs (swiglu / squared-relu / gelu)
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d: int, f: int, dtype,
             *, device=None) -> Params:
    device = resolve_device(device)
    p = {"wi": _dense_init(gen, (d, f), dtype, device),
         "wo": _dense_init(gen, (f, d), dtype, device)}
    if cfg.mlp_type == "swiglu":
        p["wg"] = _dense_init(gen, (d, f), dtype, device)
    return p


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif cfg.mlp_type == "sq_relu":
        h = F.relu(h).square()
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention wiring for one layer position."""
    use_rope: bool = True
    window: int = 0          # >0: chunked-local (block-diagonal causal)
    causal: bool = True
    cross: bool = False      # cross-attention (enc-dec memory)


def init_attention(cfg: ModelConfig, gen: torch.Generator, d_in: int, dtype,
                   *, d_out: int | None = None, device=None) -> Params:
    device = resolve_device(device)
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d_out = d_out if d_out is not None else d_in
    p = {
        "wq": _dense_init(gen, (d_in, H * dh), dtype, device),
        "wk": _dense_init(gen, (d_in, KV * dh), dtype, device),
        "wv": _dense_init(gen, (d_in, KV * dh), dtype, device),
        "wo": _dense_init(gen, (H * dh, d_out), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * dh, dtype=dtype, device=device)
        p["bk"] = torch.zeros(KV * dh, dtype=dtype, device=device)
        p["bv"] = torch.zeros(KV * dh, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(dh, dtype=dtype, device=device)
    return p


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 kv_x: torch.Tensor | None = None):
    """x [B, S, Din] -> q [B, S, H, dh], k/v [B, Skv, KV, dh]."""
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_x = x if kv_x is None else kv_x
    q = x @ p["wq"]
    if kv_x.dtype != p["wk"].dtype:       # jnp promotes a mixed product
        dt = torch.promote_types(kv_x.dtype, p["wk"].dtype)
        k = kv_x.to(dt) @ p["wk"].to(dt)
        v = kv_x.to(dt) @ p["wv"].to(dt)
    else:
        k = kv_x @ p["wk"]
        v = kv_x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(*x.shape[:-1], H, dh)
    k = k.reshape(*kv_x.shape[:-1], KV, dh)
    v = v.reshape(*kv_x.shape[:-1], KV, dh)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"])
        k = _rms_head(k, p["k_norm"])
    return q, k, v


def _sdpa(q, k, v, mask, *, kv_groups: int) -> torch.Tensor:
    """Grouped scaled-dot-product attention.

    q [B, Sq, H, dh] with H = KV * kv_groups; k/v [B, Sk, KV, dh];
    mask [Sq, Sk] bool (True = attend) or None.  f32 softmax.
    """
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, kv_groups, dh)
    logits = _einsum_f32("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(dh)
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = _einsum_f32("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _chunked_sdpa(q, k, v, *, kv_groups: int, q_positions, kv_positions,
                  spec: AttnSpec, chunk: int) -> torch.Tensor:
    """Flash-style blockwise attention: a loop over KV chunks with running
    (m, l, acc); never materializes the [Sq, Sk] score matrix.

    q [B, Sq, H, dh]; k/v [B, Sk, KV, dh]; positions give the causal and
    window masks.  A KV length that is not a multiple of ``chunk`` is
    padded with position int32-max, which the mask drops.
    """
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    KV = k.shape[2]
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.cat([kv_positions, torch.full(
            (pad,), _PAD_POSITION, dtype=kv_positions.dtype,
            device=kv_positions.device)])
    kc = k.reshape(B, n_chunks, chunk, KV, dh).transpose(0, 1)
    vc = v.reshape(B, n_chunks, chunk, KV, dh).transpose(0, 1)
    pc = kv_positions.reshape(n_chunks, chunk)

    qg = q.reshape(B, Sq, KV, kv_groups, dh)
    scale = 1.0 / math.sqrt(dh)

    def body(carry, xs):
        m, l, acc = carry
        kj, vj, pj = xs
        logits = _einsum_f32("bqkgd,bskd->bkgqs", qg, kj) * scale
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        if spec.causal:
            mask &= q_positions[:, None] >= pj[None, :]
        if spec.window > 0:  # chunked-local (llama4 iRoPE)
            mask &= (q_positions[:, None] // spec.window) == \
                (pj[None, :] // spec.window)
        mask &= pj[None, :] < _PAD_POSITION  # padding
        logits = torch.where(mask[None, None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        pv = _einsum_f32("bkgqs,bskd->bkgqd", p.to(vj.dtype), vj)
        acc_new = acc * corr[..., None] + pv
        return (m_new, l_new, acc_new), None

    stats = dict(dtype=torch.float32, device=q.device)
    m0 = torch.full((B, KV, kv_groups, Sq), -math.inf, **stats)
    l0 = torch.zeros((B, KV, kv_groups, Sq), **stats)
    a0 = torch.zeros((B, KV, kv_groups, Sq, dh), **stats)
    (m, l, acc), _ = scanctl.scan(body, (m0, l0, a0), (kc, vc, pc))
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh)
    return out.to(q.dtype)


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      spec: AttnSpec, *, splan=None,
                      positions: torch.Tensor | None = None,
                      kv_x: torch.Tensor | None = None,
                      kv_positions: torch.Tensor | None = None,
                      attn_chunk: int | None = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  x [B, S, D]."""
    B, S = x.shape[:2]
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if positions is None:
        positions = _positions(S, x.device)
    if kv_positions is None:
        kv_positions = (positions if kv_x is None
                        else _positions(k.shape[1], x.device))
    if spec.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if not spec.cross:
            k = apply_rope(k, kv_positions, cfg.rope_theta)
    if _on_mesh(splan):
        q = shard(q, splan.qkv, splan.mesh)
        k = shard(k, splan.kv_ctx, splan.mesh)
        v = shard(v, splan.kv_ctx, splan.mesh)
    out = _chunked_sdpa(q, k, v, kv_groups=H // KV, q_positions=positions,
                        kv_positions=kv_positions, spec=spec,
                        chunk=min(attn_chunk or cfg.attn_kv_chunk,
                                  k.shape[1]))
    return out.reshape(B, S, H * cfg.head_dim) @ p["wo"]


def attention_forward_with_cache(cfg: ModelConfig, p: Params,
                                 x: torch.Tensor, spec: AttnSpec, *,
                                 splan=None,
                                 positions: torch.Tensor | None = None,
                                 ctx: int | None = None,
                                 attn_chunk: int | None = None):
    """Prefill: like attention_forward but also emits the {k, v} cache
    (post-RoPE), zero-padded to ``ctx`` positions for later decode appends."""
    B, S = x.shape[:2]
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        positions = _positions(S, x.device)
    if spec.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if _on_mesh(splan):
        q = shard(q, splan.qkv, splan.mesh)
        k = shard(k, splan.kv_ctx, splan.mesh)
        v = shard(v, splan.kv_ctx, splan.mesh)
    out = _chunked_sdpa(q, k, v, kv_groups=H // KV, q_positions=positions,
                        kv_positions=positions, spec=spec,
                        chunk=min(attn_chunk or cfg.attn_kv_chunk,
                                  k.shape[1]))
    out = out.reshape(B, S, H * cfg.head_dim) @ p["wo"]
    ctx = ctx or S
    if ctx > S:
        k = F.pad(k, (0, 0, 0, 0, 0, ctx - S))
        v = F.pad(v, (0, 0, 0, 0, 0, ctx - S))
    if _on_mesh(splan):
        k = shard(k, splan.decode_cache, splan.mesh)
        v = shard(v, splan.decode_cache, splan.mesh)
    return out, {"k": k, "v": v}


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache: dict[str, torch.Tensor], spec: AttnSpec, *,
                     splan=None) -> tuple[torch.Tensor, dict]:
    """One-token decode. x [B, 1, D]; cache {k,v: [B, Sc, KV, dh], index:
    [] or [B]}.

    Each row b writes its new K/V at ring position ``index[b] mod Sc`` of
    ``cache``'s own tensors (in place) and attends to positions <=
    ``index[b]`` (within its window block on windowed layers).  Returns
    the output and {k, v} (the given tensors) with ``index + 1``.
    """
    B = x.shape[0]
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_groups = H // KV
    Sc = cache["k"].shape[1]
    # index: [] (lockstep batch) or [B] (continuous batching, per-slot)
    index = torch.atleast_1d(cache["index"]).expand(B)
    q, k_new, v_new = _project_qkv(cfg, p, x)
    pos = index[:, None]
    if spec.use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        if not spec.cross:
            k_new = apply_rope(k_new, pos, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    if spec.cross:
        valid = torch.ones((B, Sc), dtype=torch.bool, device=x.device)
        new_cache = cache
    else:
        slot = index % Sc
        bix = torch.arange(B, device=x.device)
        k[bix, slot] = k_new[:, 0].to(k.dtype)
        v[bix, slot] = v_new[:, 0].to(v.dtype)
        slots = torch.arange(Sc, device=x.device)
        valid = slots[None, :] <= index[:, None]
        if spec.window > 0:  # chunked-local (iRoPE): same window block only
            valid &= (slots[None, :] // spec.window) == \
                (index[:, None] // spec.window)
        if _on_mesh(splan):
            k = shard(k, splan.decode_cache, splan.mesh)
            v = shard(v, splan.decode_cache, splan.mesh)
        new_cache = {"k": k, "v": v, "index": cache["index"] + 1}

    qg = q.reshape(B, 1, KV, kv_groups, dh)
    logits = _einsum_f32("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(dh)
    logits = torch.where(valid[:, None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = _einsum_f32("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    out = out.reshape(B, 1, H * dh).to(x.dtype)
    return out @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# Mixture of Experts (llama4): top-1 routing + shared expert, EP on a mesh
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, gen: torch.Generator, d: int, f: int, dtype,
             *, device=None) -> Params:
    """The reference's leaves and scales.  The expert weights ``(E, d, f)``
    take their fan-in from ``shape[0] = E``, as the reference's
    ``_dense_init`` does; the router is f32 whatever ``dtype``."""
    device = resolve_device(device)
    E = cfg.num_experts
    p = {
        "router": _dense_init(gen, (d, E), torch.float32, device),
        "wi": _dense_init(gen, (E, d, f), dtype, device),
        "wg": _dense_init(gen, (E, d, f), dtype, device),
        "wo": _dense_init(gen, (E, f, d), dtype, device),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(dataclasses.replace(cfg, mlp_type="swiglu"),
                               gen, d, f, dtype, device=device)
    return p


def _route(p: Params, tokens: torch.Tensor):
    """tokens [T, D] -> (router logits f32 [T, E], softmax probabilities,
    gate = the largest probability [T])."""
    logits = tokens.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    return logits, probs, probs.amax(dim=-1)


def _experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over their rows: buf [E, C, D] -> [E, C, D], each
    product in f32 and cast back, as the reference's
    ``preferred_element_type=f32`` einsums."""
    dt = buf.dtype
    h = _einsum_f32("ecd,edf->ecf", buf, p["wi"]).to(dt)
    g = _einsum_f32("ecd,edf->ecf", buf, p["wg"]).to(dt)
    return _einsum_f32("ecf,efd->ecd", F.silu(g) * h, p["wo"]).to(dt)


def _ep_blocks(splan, x: torch.Tensor) -> tuple[int, int]:
    """(data blocks, model blocks) of ``x`` [B, S, D] split as the
    reference's ``shard_map`` splits it (``[B -> data axes, S -> model]``);
    an uneven split raises ``ValueError``, as ``shard_map`` does."""
    n_data, n_model = splan.block_counts()
    B, S = x.shape[:2]
    if B % n_data or S % n_model:
        raise ValueError(
            f"expert parallelism splits [B, S] = [{B}, {S}] into {n_data} "
            f"x {n_model} blocks; the blocks must divide it evenly")
    return n_data, n_model


def moe_dispatch_blocks(p: Params, x: torch.Tensor, n_data: int,
                        n_model: int, capacity: int):
    """The reference's ``_moe_dispatch_compute`` over every block at once:
    one block (``n_data = n_model = 1``) is its mesh-less dispatch, more
    are its EP ``apply_moe`` body.

    x [B, S, D] is cut into ``n_data x n_model`` blocks (block (d, m) =
    rows d of B, columns m of S; ``[B, S]`` must divide).  Each block
    routes its ``t = B/n_data * S/n_model`` tokens on its own: top-1, each
    token's position in its expert the running count of the block's
    earlier tokens routed there, ``capacity`` a block and expert.  The
    blocks' ``[E, C, D]`` buffers then cross the model axis in the
    ``all_to_all``'s order: within data block d, expert shard m (experts
    ``m*E/n .. (m+1)*E/n``) takes its experts' rows from every source
    block, ``[E/n, n * C, D]``; here every shard's rows of every data
    block are one batched product, a permutation of the block axes away
    from the positions' own.  The exchange back restores each source's
    ``[E, C, D]``, whose rows go back to their tokens, weighted by the
    gate (dropped tokens: 0: a token past ``capacity`` goes to the dump
    row ``E * C``).

    Returns (out [B, S, D], expert index [blocks, t], keep [blocks, t]),
    the blocks in (d, m) order."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    nd, nm, C = n_data, n_model, capacity
    b, s = B // nd, S // nm
    t = b * s
    blocks = x.reshape(nd, b, nm, s, D).permute(0, 2, 1, 3, 4)
    tokens = blocks.reshape(nd * nm, t, D)                    # [nb, t, D]
    _, probs, gate = _route(p, tokens)
    eidx = probs.argmax(dim=-1)                               # [nb, t]
    # one-hot as a comparison: F.one_hot dispatches other ops on each
    # device (a value check on the CPU, a scatter on CUDA), this the same
    onehot = (eidx[..., None] == torch.arange(E, device=x.device)).to(
        torch.int32)
    pos = torch.gather(torch.cumsum(onehot, 1) - 1, 2,
                       eidx[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, eidx * C + pos, E * C)
    bix = torch.arange(nd * nm, device=x.device)[:, None]
    buf = torch.zeros((nd * nm, E * C + 1, D), dtype=x.dtype,
                      device=x.device)
    buf[bix, slot] = torch.where(keep[..., None], tokens, 0)
    buf = buf[:, :-1]
    # the all_to_all: [d, src, dst, E/n, C, D] -> [dst, E/n, d, src, C, D]
    El = E // nm
    sent = buf.reshape(nd, nm, nm, El, C, D).permute(2, 3, 0, 1, 4, 5)
    if nm > 1:
        sent = exchange(sent, "all-to-all", group=nm, members=nd * nm)
    y = _experts(p, sent.reshape(E, nd * nm * C, D))
    # and back: [dst, E/n, d, src, C, D] -> [d, src, dst, E/n, C, D]
    y = y.reshape(nm, El, nd, nm, C, D).permute(2, 3, 0, 1, 4, 5)
    if nm > 1:
        y = exchange(y, "all-to-all", group=nm, members=nd * nm)
    y = torch.cat([y.reshape(nd * nm, E * C, D),
                   torch.zeros((nd * nm, 1, D), dtype=y.dtype,
                               device=y.device)], 1)
    out = y[bix, slot] * (gate * keep)[..., None].to(y.dtype)
    out = out.reshape(nd, nm, b, s, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, S, D), eidx, keep


def _shared_expert(cfg: ModelConfig, p: Params, x: torch.Tensor):
    return apply_mlp(dataclasses.replace(cfg, mlp_type="swiglu"),
                     p["shared"], x)


def _ep_model(cfg: ModelConfig, splan) -> bool:
    """Expert parallelism applies: a mesh with a ``model`` axis that
    divides the experts."""
    mesh = splan.mesh if splan is not None else None
    return (mesh is not None and "model" in mesh.axis_names
            and cfg.num_experts % int(mesh.shape["model"]) == 0)


def ep_capacity(cfg: ModelConfig, splan, x: torch.Tensor) -> int:
    """The reference's capacity a source block and expert:
    ``max(1, int(t_local * capacity_factor / E))``."""
    n_data, n_model = _ep_blocks(splan, x)
    B, S = x.shape[:2]
    t_local = (B // n_data) * (S // n_model)
    return max(1, int(t_local * cfg.capacity_factor / cfg.num_experts))


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              splan=None) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D], plus the shared expert, through
    ``moe_dispatch_blocks``.  Without expert parallelism every token of the
    batch is one block, capacity ``max(1, int(B * S * capacity_factor /
    E))``; with it (a mesh whose ``model`` axis divides E), the mesh's
    blocks at ``ep_capacity``."""
    if _ep_model(cfg, splan):
        n_data, n_model = _ep_blocks(splan, x)
        cap = ep_capacity(cfg, splan, x)
    else:
        B, S = x.shape[:2]
        n_data = n_model = 1
        cap = max(1, int(B * S * cfg.capacity_factor / cfg.num_experts))
    out = moe_dispatch_blocks(p, x, n_data, n_model, cap)[0]
    if cfg.shared_expert:
        out = out + _shared_expert(cfg, p, x)
    return out


def _moe_decode_ep(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   splan) -> torch.Tensor:
    """The reference's EP decode: every model position takes all tokens
    (replicated over ``model``), routes them, runs its E/n local experts on
    every token with the tokens routed elsewhere masked to 0, at the
    operands' dtype, and the positions' outputs are summed in model order
    (the ``psum``).  Tokens split over the data axes (``decode_hidden``'s
    batch entry) must divide them evenly."""
    B, S, D = x.shape
    n_data, n = splan.block_counts()
    if splan.decode_hidden[0] is not None and B % n_data:
        raise ValueError(f"EP decode splits a batch of {B} over {n_data} "
                         f"data blocks; they must divide it evenly")
    E = cfg.num_experts
    El = E // n
    t = x.reshape(B * S, D)
    logits = t.float() @ p["router"]
    gate = torch.softmax(logits, dim=-1).amax(dim=-1)
    eidx = logits.argmax(dim=-1)
    locals_ = torch.arange(El, device=x.device)
    out = None
    for m in range(n):
        wi, wg, wo = (p[k][m * El:(m + 1) * El] for k in ("wi", "wg", "wo"))
        onehot = ((eidx - m * El)[:, None] == locals_).to(t.dtype)  # [T, El]
        # the reference's "td,edf->tef" as [El, T, F] products over the
        # weights in place
        h = torch.matmul(t, wi)
        g = torch.matmul(t, wg)
        y = torch.matmul(F.silu(g) * h, wo)                  # [El, T, D]
        y = (y * onehot.T[..., None]).sum(dim=0)             # [T, D]
        y = y * gate[:, None].to(y.dtype)
        out = y if out is None else out + y
    # the psum over model: every position's [tokens on its data block, D]
    local = B * S // (n_data if splan.decode_hidden[0] is not None else 1)
    record_collective("all-reduce", local * D * out.element_size(),
                      group=n, members=n_data * n)
    return out.reshape(B, S, D)


def moe_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
               splan=None) -> torch.Tensor:
    """Decode-path MoE, plus the shared expert.  By default
    ``argmax(logits)`` routing and a per-token gather of the ``[T, D, F]``
    expert weights (no capacity, each token runs its own expert); with
    ``cfg.moe_decode_ep`` on a mesh whose ``model`` axis divides E, the
    EP-local masked products summed over the model positions
    (``_moe_decode_ep``), which read each expert's weights in place."""
    B, S, D = x.shape
    if cfg.moe_decode_ep and _ep_model(cfg, splan):
        out = _moe_decode_ep(cfg, p, x, splan)
    else:
        tokens = x.reshape(B * S, D)
        logits, _, gate = _route(p, tokens)
        eidx = logits.argmax(dim=-1)
        wi, wg, wo = p["wi"][eidx], p["wg"][eidx], p["wo"][eidx]  # [T, D, F]
        h = torch.einsum("td,tdf->tf", tokens, wi)
        g = torch.einsum("td,tdf->tf", tokens, wg)
        y = torch.einsum("tf,tfd->td", F.silu(g) * h, wo)
        out = (y * gate[:, None].to(y.dtype)).reshape(B, S, D)
    if cfg.shared_expert:
        out = out + _shared_expert(cfg, p, x)
    return out
