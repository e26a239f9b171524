"""Qwen2-7B: dense GQA transformer with QKV BIAS [arXiv:2407.10671]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-7B",
)
