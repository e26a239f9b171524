"""Mamba2-2.7B: attention-free SSM stack using the SSD (state-space duality)
chunked algorithm [arXiv:2405.21060].

d_ff=0: Mamba2 blocks have no separate MLP; the block IS the mixer
(in_proj -> conv -> SSD -> gated out_proj with expand factor 2).
vocab 50280 pads to 50432 for the model-axis sharding (DESIGN.md Sec. 5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_layers=True,
    ssm_state=128,
    ssm_headdim=64,       # 80 heads = 2*2560 / 64
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    norm_type="rmsnorm",
    pos_type="nope",      # SSM needs no positional encoding
    source="arXiv:2405.21060; hf:state-spaces/mamba2-2.7b",
)
