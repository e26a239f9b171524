"""Llama-4-Scout-17B-16E: MoE (16 experts, top-1, + shared expert) with
iRoPE: 3 of every 4 layers use chunked-local RoPE attention (window 8192),
every 4th layer is global NoPE [hf:meta-llama/Llama-4-Scout-17B-16E]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    top_k=1,
    shared_expert=True,
    moe_every=1,            # every layer MoE
    attn_window=8192,
    global_every=4,         # every 4th layer: global attention, NoPE
    pos_type="irope",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    qk_norm=True,
    moe_decode_ep=True,   # §Perf: EP-local+psum decode beats weight gathers 6.5x
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
