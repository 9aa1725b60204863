"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060]: 24 layers, d_model 768, ssm_state 128, expand 2
(d_inner 1536, headdim 64 -> 24 ssd heads), vocab 50280, tied embeddings.
No attention, no separate FFN (the Mamba block is the whole layer). O(1)
decode state -> long-context eligible.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,            # d_inner // headdim (informational for ssd)
    num_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, chunk=128, d_conv=4),
    tie_embeddings=True,
    long_context_ok=True,
    source="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
        vocab_size=512,
        ssm=SSMConfig(d_state=32, expand=2, headdim=64, chunk=32, d_conv=4),
    )
