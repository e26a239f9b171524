"""Llama-4-Maverick-400B-A17B: MoE with 128 experts top-1 + shared expert,
ALTERNATING dense/MoE layers, iRoPE like Scout
[hf:meta-llama/Llama-4-Maverick-17B-128E]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    top_k=1,
    shared_expert=True,
    moe_every=2,            # alternating dense / MoE
    attn_window=8192,
    global_every=4,
    pos_type="irope",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    qk_norm=True,
    moe_decode_ep=True,   # §Perf: EP-local+psum decode beats weight gathers 6.5x
    source="hf:meta-llama/Llama-4-Maverick-17B-128E",
)
