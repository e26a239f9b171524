"""Mamba2 SSD (state-space duality) block: chunked scan and O(1) decode
(torch).

Mirrors ``repro/models/ssd.py``: within a chunk of length Q the recurrence
is a masked quadratic form; across chunks a ``[B, H, P, N]`` state is
carried by ``scanctl.scan``.  Decode carries ``{conv [B, W-1, C], state
[B, H, P, N]}``, the family's O(1) "KV cache".

Numerics follow the reference's jnp:
  * ``A_log``, ``D`` and ``dt_bias`` are f32 whatever the model dtype, and
    the state is f32;
  * each ``preferred_element_type=f32`` einsum contracts both operands in
    f32 (``_einsum_f32``), and where jnp promotes a mixed einsum (the f32
    state against ``B`` / ``C`` in the model dtype) the operands are cast
    to the promoted dtype explicitly;
  * ``M`` is cast to the model dtype before ``y_diag``, as the reference's
    ``M.astype(xdt.dtype)``;
  * softplus is jax's ``logaddexp(x, 0)`` (``_softplus``), so the pad
    positions' ``dt = -1e9`` give exactly 0;
  * the forward conv is the reference's sum over ``W`` shifted products in
    the same order.

``ssd_decode`` writes the new conv window and state into the cache tensors
it is given and returns them, as ``layers.attention_decode`` does with K/V
(``docs/torch_lm.md``).  The scan and the recurrent step run over whatever
heads their inputs hold (``_scan_heads``, ``_step_heads``): the whole
layer here, a position's heads over own shards (``models/positions.py``).  Under a mesh plan ``ssd_forward`` checks the
reference's head-axis constraints (``layers.shard``); the positions share
one device, so nothing else changes.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import scanctl
from repro_torch.dist.sharding import P as Pspec
from repro_torch.dist.sharding import _data_entry
from repro_torch.models.layers import _dense_init, _einsum_f32, shard

__all__ = ["init_ssd", "ssd_forward", "ssd_forward_with_cache",
           "init_ssd_cache", "ssd_decode"]

Params = dict[str, Any]


def init_ssd(cfg: ModelConfig, gen: torch.Generator, dtype, *,
             device=None) -> Params:
    """The reference's leaves, shapes and scales, drawn from ``gen``."""
    device = resolve_device(device)
    D, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, W = cfg.ssm_heads, cfg.conv_width
    conv_ch = di + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection -> [z(di), xBC(di + 2N), dt(H)]
        "in_proj": _dense_init(gen, (D, 2 * di + 2 * N + H), dtype, device),
        "conv_w": _dense_init(gen, (W, conv_ch), dtype, device,
                              scale=1.0 / W),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.zeros(H, **f32),
        "D": torch.ones(H, **f32),
        "dt_bias": torch.zeros(H, **f32),
        "norm": torch.ones(di, dtype=dtype, device=device),
        "out_proj": _dense_init(gen, (di, D), dtype, device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * N]
    dt = proj[..., di + di + 2 * N:]
    assert dt.shape[-1] == H
    return z, xBC, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), with no linear branch past a threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Mamba2's RMSNorm(y * silu(z)) output gate."""
    g = (y * F.silu(z)).float()
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + 1e-6)
    return (g * scale.float()).to(y.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., Q] -> [..., Q, Q] with out[i, j] = sum_{j < k <= i} x[k],
    -inf above the diagonal (the 1-SS mask of the SSD paper)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -math.inf)


def _promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The operands cast to their promoted dtype, as jnp promotes."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _scan_heads(cfg: ModelConfig, p: Params, xBC_raw: torch.Tensor,
                dt: torch.Tensor, *, S_true: int, Q: int, z=None,
                splan=None):
    """The conv, dt and the chunked scan over the heads that ``dt [B, S,
    h]`` holds (S a multiple of Q, padded past ``S_true``): ``xBC_raw [B,
    S, h * P + 2N]`` their x channels, then B and C; ``p``'s ``conv_w`` /
    ``conv_b`` those channels' and ``A_log`` / ``D`` / ``dt_bias`` those
    heads'.  Returns (y ``[B, S, h * P]`` before the gate, the final state
    ``[B, h, P, N]``).  ``splan`` (with ``z``) checks the reference's
    head-axis constraints."""
    B, S, _ = xBC_raw.shape
    N, P_ = cfg.ssm_state, cfg.ssm_headdim
    H = dt.shape[-1]
    di = H * P_
    nC = S // Q
    if S != S_true:  # pad positions: dt=0 => no state update, no output
        smask = (torch.arange(S, device=dt.device) < S_true)[None, :, None]
        dt = torch.where(smask, dt, -1e9)           # softplus(-1e9) == 0

    # causal depthwise conv over S (width W), SiLU
    W = cfg.conv_width
    pad = F.pad(xBC_raw, (0, 0, W - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(W))
    xBC = F.silu(conv + p["conv_b"])

    xs = xBC[..., :di].reshape(B, S, H, P_)
    B_ = xBC[..., di:di + N]                               # [B, S, N]
    C_ = xBC[..., di + N:]

    dt = _softplus(dt.float() + p["dt_bias"])              # [B, S, H]
    A = -torch.exp(p["A_log"])                             # [H]
    dA = dt * A                                            # [B, S, H]

    if splan is not None and splan.mesh is not None:
        da = _data_entry(splan.data_axes)
        model, mesh = splan.model_axis, splan.mesh
        xs = shard(xs, Pspec(da, None, model, None), mesh)
        shard(z, Pspec(da, None, model), mesh)
        B_ = shard(B_, Pspec(da, None, None), mesh)
        C_ = shard(C_, Pspec(da, None, None), mesh)
        dA = shard(dA, Pspec(da, None, model), mesh)

    def chunked(t, tail):
        t = t.reshape((B, nC, Q) + tail)
        return t.permute((1, 0, 2) + tuple(range(3, 3 + len(tail))))

    xs_c = chunked(xs * dt[..., None].to(xs.dtype), (H, P_))
    x_raw_c = chunked(xs, (H, P_))
    B_c = chunked(B_, (N,))
    C_c = chunked(C_, (N,))
    dA_c = chunked(dA, (H,))
    Dh = p["D"][None, None, :, None]

    def body(state, inp):
        xdt, xraw, Bj, Cj, dAj = inp                       # per chunk
        # within-chunk quadratic term
        L_ = torch.exp(_segsum(dAj.transpose(1, 2)))       # [B, H, Q, Q]
        scores = _einsum_f32("bqn,bsn->bqs", Cj, Bj)
        M = scores[:, None] * L_                           # [B, H, Q, Q]
        y_diag = _einsum_f32("bhqs,bshp->bqhp", M.to(xdt.dtype), xdt)
        # contribution of the carried state
        cum = torch.cumsum(dAj, dim=1)                     # [B, Q, H]
        y_off = torch.einsum("bqn,bhpn,bqh->bqhp", Cj.float(), state,
                             torch.exp(cum).to(Cj.dtype).float())
        # new chunk state
        decay = torch.exp(cum[:, -1:, :] - cum)            # [B, Q, H]
        new_state = torch.einsum("bsn,bsh,bshp->bhpn", Bj.float(),
                                 decay.to(Bj.dtype).float(), xdt.float())
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + new_state
        y = (y_diag + y_off).to(xraw.dtype) + xraw * Dh.to(xraw.dtype)
        return state, y

    state0 = torch.zeros((B, H, P_, N), dtype=torch.float32,
                         device=xBC_raw.device)
    final_state, ys = scanctl.scan(body, state0,
                                   (xs_c, x_raw_c, B_c, C_c, dA_c))
    return ys.permute(1, 0, 2, 3, 4).reshape(B, S, di), final_state


def ssd_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                chunk: int | None = None, return_cache: bool = False,
                splan=None):
    """Full-sequence SSD.  x [B, S, D] -> [B, S, D]; S is padded up to a
    multiple of the chunk, the pad positions masked by ``dt = -1e9``.
    ``return_cache`` also returns the decode cache (prefill).  ``splan``
    pins the head axis to the mesh's ``model`` axis, as the reference's
    constraints do."""
    S_true = x.shape[1]
    Q = min(chunk or cfg.ssm_chunk, S_true)
    S = -(-S_true // Q) * Q                       # pad S up to a Q multiple
    if S != S_true:
        x = F.pad(x, (0, 0, 0, S - S_true))

    proj = x @ p["in_proj"]
    z, xBC_raw, dt = _split_proj(cfg, proj)
    y, final_state = _scan_heads(cfg, p, xBC_raw, dt, S_true=S_true, Q=Q,
                                 z=z, splan=splan)
    out = _gated_rmsnorm(y, z, p["norm"]) @ p["out_proj"]
    out = out[:, :S_true]
    if not return_cache:
        return out
    W = cfg.conv_width
    conv_cache = (xBC_raw[:, S_true - (W - 1):S_true, :] if W > 1
                  else xBC_raw[:, :0, :])
    return out, {"conv": conv_cache, "state": final_state}


def ssd_forward_with_cache(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                           chunk: int | None = None, splan=None):
    return ssd_forward(cfg, p, x, chunk=chunk, return_cache=True,
                       splan=splan)


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, *,
                   device=None) -> dict:
    """Zero ``{conv [batch, W-1, C] (dtype), state [batch, H, P, N] f32}``."""
    device = resolve_device(device)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }


def _step_heads(cfg: ModelConfig, p: Params, hist: torch.Tensor,
                dt: torch.Tensor, state: torch.Tensor, dtype):
    """One recurrent step over the heads that ``dt [B, h]`` holds:
    ``hist [B, W, h * P + 2N]`` the conv window of their x channels and B
    and C, the new column last; ``p`` as ``_scan_heads``'; ``state [B, h,
    P, N]`` f32.  Returns (y ``[B, h * P]`` in ``dtype`` before the gate,
    the new state)."""
    B = hist.shape[0]
    N, P_ = cfg.ssm_state, cfg.ssm_headdim
    H = dt.shape[-1]
    di = H * P_
    conv = torch.einsum("bwc,wc->bc", *_promoted(hist, p["conv_w"]))
    xBC_a = F.silu(conv + p["conv_b"])

    xt = xBC_a[:, :di].reshape(B, H, P_)
    Bt = xBC_a[:, di:di + N]
    Ct = xBC_a[:, di + N:]
    dt = _softplus(dt.float() + p["dt_bias"])                      # [B, H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                         # [B, H]

    state = state * dA[:, :, None, None] + \
        torch.einsum("bhp,bn,bh->bhpn", xt.float(), Bt.float(), dt)
    y = torch.einsum("bhpn,bn->bhp", state, Ct.float()).to(dtype)
    y = y + xt * p["D"][None, :, None].to(xt.dtype)
    return y.reshape(B, di), state


def ssd_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step.  x [B, 1, D].  The new conv window and
    state are written into ``cache``'s own tensors (the window cast to the
    cache's dtype), which are returned."""
    proj = x[:, 0] @ p["in_proj"]
    z, xBC, dt = _split_proj(cfg, proj)
    hist = torch.cat(_promoted(cache["conv"], xBC[:, None]), dim=1)
    y, state = _step_heads(cfg, p, hist, dt, cache["state"], x.dtype)
    out = _gated_rmsnorm(y, z, p["norm"]) @ p["out_proj"]
    cache["conv"].copy_(hist[:, 1:])
    cache["state"].copy_(state)
    return out[:, None], {"conv": cache["conv"], "state": cache["state"]}
