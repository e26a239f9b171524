"""SeamlessM4T-large-v2: encoder-decoder multimodal translator
[arXiv:2308.11596].  The speech frontend is a STUB per the assignment:
``input_specs()`` feeds precomputed frame embeddings to the encoder; the
text decoder is a standard causal transformer with cross-attention.
Decoder length = encoder length / 4 (speech-to-text ratio, DESIGN.md §4).
vocab 256206 pads to 256256."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    dec_len_ratio=4,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_type="gelu",
    norm_type="ln",
    pos_type="rope",
    frontend="audio_frames",
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
)
