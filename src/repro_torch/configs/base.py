"""Model / shape configuration schema for the assigned architecture pool.

One ``ModelConfig`` fully determines an architecture; one ``ShapeConfig``
determines an input-shape cell; the dry-run grid is their cross product.
``reduced()`` shrinks any config to a CPU-smoke-test size without changing
its family-specific structure (same block pattern, same norm/MoE/SSM
choices) — the smoke tests exercise STRUCTURE, the dry-run exercises SCALE.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | moe | audio | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # ---- attention ----
    qkv_bias: bool = False
    qk_norm: bool = False
    pos_type: str = "rope"           # rope | nope | irope
    rope_theta: float = 10_000.0
    attn_window: int = 0             # >0: chunked-local attention window
    global_every: int = 0            # iRoPE: every Nth layer global (NoPE)
    causal: bool = True
    # ---- mlp ----
    mlp_type: str = "swiglu"         # swiglu | sq_relu | gelu
    # ---- norm ----
    norm_type: str = "rmsnorm"       # rmsnorm | nonparam_ln | ln
    # ---- embeddings ----
    tie_embeddings: bool = False
    # ---- MoE ----
    num_experts: int = 0             # 0 = dense
    top_k: int = 1
    shared_expert: bool = False
    moe_every: int = 1               # 1 = every layer MoE; 2 = alternating
    capacity_factor: float = 1.25
    # ---- SSM (mamba2 / hybrid) ----
    ssm_layers: bool = False         # True: backbone layers are Mamba2 blocks
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # ---- hybrid (zamba2) ----
    shared_attn_every: int = 0       # >0: shared attn block every N layers
    shared_attn_lora_rank: int = 0
    # ---- enc-dec (seamless) ----
    encoder_layers: int = 0          # >0: encoder-decoder model
    dec_len_ratio: int = 4           # encoder length / decoder length
    # ---- modality frontend stub ----
    frontend: str = "none"           # none | audio_frames | vq_tokens
    # ---- numerics / schedule ----
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # full | dots (save dot outputs) | none
    logit_chunk: int = 1024          # chunked cross-entropy block
    moe_decode_ep: bool = False      # EP psum decode-MoE (hillclimb knob)
    attn_kv_chunk: int = 1024        # blockwise-attention KV chunk length
    source: str = ""                 # provenance note

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab padded so the 'model' axis (16) divides it."""
        return -(-self.vocab_size // 256) * 256

    @property
    def block_period(self) -> int:
        """Layer-pattern period for scan-over-blocks."""
        p = 1
        if self.global_every:
            p = _lcm(p, self.global_every)
        if self.moe_every > 1:
            p = _lcm(p, self.moe_every)
        if self.shared_attn_every:
            p = _lcm(p, self.shared_attn_every)
        return p

    @property
    def num_blocks(self) -> int:
        assert self.num_layers % self.block_period == 0, (
            f"{self.name}: layers {self.num_layers} not divisible by "
            f"period {self.block_period}")
        return self.num_layers // self.block_period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS = 6·N·D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top_k experts)."""
        return _param_count(self, active_only=True)


def _lcm(a: int, b: int) -> int:
    from math import gcd
    return a * b // gcd(a, b)


def _param_count(cfg: ModelConfig, *, active_only: bool) -> int:
    D, Fh = cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    total = cfg.vocab_padded * D * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        p = D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D
        if cfg.qkv_bias:
            p += (H + 2 * KV) * dh
        return p

    def mlp_params(ff):
        mats = 3 if cfg.mlp_type == "swiglu" else 2
        return mats * D * ff

    def ssm_params():
        di = cfg.d_inner
        nh = cfg.ssm_heads
        # in_proj -> [z, x, B, C, dt], conv over (x,B,C), out_proj
        proj_in = D * (2 * di + 2 * cfg.ssm_state + nh)
        conv = cfg.conv_width * (di + 2 * cfg.ssm_state)
        return proj_in + conv + di * D + 2 * nh

    n_layers = cfg.num_layers
    # hybrid (zamba2): the per-layer MLP belongs to the SHARED block, not to
    # each Mamba layer.
    layer_has_mlp = Fh > 0 and not (cfg.ssm_layers and cfg.shared_attn_every)
    for i in range(n_layers):
        is_moe = (cfg.num_experts > 0 and (i % cfg.moe_every) == 0)
        if cfg.ssm_layers:
            total += ssm_params()
        else:
            total += attn_params()
        if is_moe:
            e = cfg.top_k if active_only else cfg.num_experts
            total += e * mlp_params(Fh) + D * cfg.num_experts  # + router
            if cfg.shared_expert:
                total += mlp_params(Fh)
        elif layer_has_mlp:
            total += mlp_params(Fh)
    if cfg.shared_attn_every:
        n_slots = n_layers // cfg.shared_attn_every
        shared_d = 2 * cfg.d_model   # zamba2 concatenates embeds
        p = (shared_d * (H * dh) + 2 * shared_d * (KV * dh) + (H * dh) * D)
        p += 2 * shared_d * Fh       # the shared block's (gelu) MLP
        total += p + n_slots * cfg.shared_attn_lora_rank * 2 * shared_d
    if cfg.encoder_layers:
        for _ in range(cfg.encoder_layers):
            total += attn_params() + mlp_params(Fh)
        # decoder cross-attention
        total += n_layers * attn_params()
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM arch pairs with these four cells.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, layers: int | None = None,
            d_model: int = 64, vocab: int = 512) -> ModelConfig:
    """Shrink to smoke-test size, preserving the structural pattern."""
    period = cfg.block_period
    n_layers = layers or max(period, 2 if period == 1 else period)
    n_layers = -(-n_layers // period) * period
    head_dim = 16
    n_heads = max(2, d_model // head_dim)
    n_kv = max(1, min(cfg.num_kv_heads, n_heads) //
               max(1, cfg.num_heads // max(n_heads, 1)) or 1)
    n_kv = max(1, n_heads // max(1, cfg.num_heads // max(1, cfg.num_kv_heads)))
    while n_heads % n_kv:
        n_kv -= 1
    return dataclasses.replace(
        cfg,
        num_layers=n_layers,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else d_model * 4,
        vocab_size=vocab,
        num_experts=min(cfg.num_experts, 4),
        encoder_layers=0 if cfg.encoder_layers == 0 else 2,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_layers else cfg.ssm_headdim,
        ssm_chunk=32,
        shared_attn_lora_rank=min(cfg.shared_attn_lora_rank, 4),
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else 0,
        logit_chunk=64,
        remat=False,
    )
