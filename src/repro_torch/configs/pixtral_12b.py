"""pixtral-12b [vlm] — Pixtral-ViT frontend (stubbed) + Mistral-Nemo decoder.

[hf:mistralai/Pixtral-12B-2409]: 40 layers, d_model 5120, 32 heads (GQA kv=8,
head_dim 128), d_ff 14336, vocab 131072. Vision tower supplies patch
embeddings (stub per assignment carve-out).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    block_pattern=("global",),
    frontend="vision",
    frontend_dim=1024,
    frontend_len=256,
    rope_theta=1_000_000.0,
    long_context_ok=False,  # pure full attention -> skip long_500k
    source="hf:mistralai/Pixtral-12B-2409",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, frontend_dim=128, frontend_len=16,
    )
