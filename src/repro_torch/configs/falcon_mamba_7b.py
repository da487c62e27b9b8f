"""falcon-mamba-7b [ssm] — mamba1, attention-free [arXiv:2410.05355; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", num_layers=64, d_model=4096,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_version=1)
