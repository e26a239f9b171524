"""Zamba2-2.7B: hybrid Mamba2 backbone + ONE SHARED attention block invoked
every 6 layers with per-invocation LoRA deltas [arXiv:2411.15242].

The shared block attends over the concat(hidden, initial-embedding) stream
(2*d_model input), the Zamba trick that lets one attention block serve the
whole depth.  54 Mamba2 layers, 9 shared-attention call sites."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_layers=True,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    shared_attn_every=6,
    shared_attn_lora_rank=128,
    mlp_type="gelu",
    norm_type="rmsnorm",
    pos_type="rope",
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)
