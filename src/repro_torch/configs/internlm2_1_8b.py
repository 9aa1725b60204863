"""internlm2-1.8b [dense] — GQA decoder.

[arXiv:2403.17297]: 24 layers, d_model 2048, 16 heads (GQA kv=8,
head_dim 128), d_ff 8192, vocab 92544.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    block_pattern=("global",),
    rope_theta=1_000_000.0,
    long_context_ok=False,
    source="arXiv:2403.17297",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512,
    )
