"""yi-6b [dense] — llama-architecture GQA decoder.

[arXiv:2403.04652]: 32 layers, d_model 4096, 32 heads (GQA kv=4,
head_dim 128), d_ff 11008, vocab 64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=("global",),
    rope_theta=5_000_000.0,
    long_context_ok=False,
    source="arXiv:2403.04652",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512,
    )
