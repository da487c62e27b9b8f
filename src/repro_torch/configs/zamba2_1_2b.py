"""zamba2-1.2b [hybrid] — Mamba2 trunk + shared attn blocks [arXiv:2411.15242; hf].

The two shared attention invocations use a bounded (sliding-window) KV at
long_500k; trunk layers are Mamba2-style (diagonal selective SSM, state 64).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_version=2, attn_every=19, sliding_window=4096)
