"""llava-next-34b [vlm] — anyres tiling patch stub [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=20480, vocab_size=64000,
    head_dim=128, frontend="patches", frontend_len=2880)
