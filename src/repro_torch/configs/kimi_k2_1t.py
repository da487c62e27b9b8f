"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384e top-8 [arXiv:2501.kimi2; unverified].

Adafactor (factored second moment) keeps optimizer state feasible at 1T
params — see EXPERIMENTS.md memory note.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
    num_heads=64, num_kv_heads=8, d_ff=2048, vocab_size=163840,
    head_dim=128, num_experts=384, num_experts_per_tok=8,
    use_adafactor=True)
