"""Minitron-4B: width/depth-pruned Nemotron; squared-ReLU (non-gated) MLP
[arXiv:2407.14679]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="sq_relu",
    norm_type="ln",
    pos_type="rope",
    source="arXiv:2407.14679; hf:nvidia/Minitron-4B-Base",
)
