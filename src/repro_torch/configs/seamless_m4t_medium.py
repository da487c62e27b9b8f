"""seamless-m4t-medium [audio] — enc-dec, frame-embedding stub [arXiv:2308.11596; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    encoder_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, act="gelu", norm="layernorm",
    frontend="frames", frontend_len=1536)
