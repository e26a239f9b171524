"""OLMo-1B: dense transformer with NON-PARAMETRIC LayerNorm (no scale/bias),
tied embeddings, SwiGLU [arXiv:2402.00838]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,      # MHA (kv == heads)
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    mlp_type="swiglu",
    norm_type="nonparam_ln",
    tie_embeddings=True,
    pos_type="rope",
    source="arXiv:2402.00838; hf:allenai/OLMo-1B",
)
