"""Chameleon-34B: early-fusion VLM; decoder-only backbone over a mixed
VQ-image + text token vocabulary with QK-norm [arXiv:2405.09818].

The image tokenizer (VQ-VAE) is a STUB per the assignment: ``input_specs()``
feeds already-quantized token ids drawn from the unified 65536 vocab."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    frontend="vq_tokens",
    source="arXiv:2405.09818; hf:facebook/chameleon-30b",
)
