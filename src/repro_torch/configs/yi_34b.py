"""Yi-34B: llama-architecture dense transformer with GQA [arXiv:2403.04652]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf:01-ai/Yi-34B",
)
