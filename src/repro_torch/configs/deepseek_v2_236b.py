"""deepseek-v2-236b — MLA + fine-grained MoE, the paper's big sibling.

[arXiv:2405.04434]: 60 layers, d_model 5120, 128 heads, MLA with
kv_lora_rank 512 / q_lora_rank 1536 (a compressed q projection) /
rope_head_dim 64 / nope 128 / v 128; MoE: 2 shared + 160 routed experts,
top-6, expert d_ff 1536; first layer dense (d_ff 12288); vocab 102400.
DeepSeek-V2-Lite, the paper's backbone, is this family at reduced scale.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: kv heads == heads after the up-projection
    head_dim=128,
    d_ff=1536,          # == the routed experts' d_ff
    vocab_size=102400,
    block_pattern=("mla",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        num_shared=2,
        d_ff_expert=1536,
        first_dense_layers=1,
        d_ff_dense=12288,
    ),
    rope_theta=10_000.0,
    long_context_ok=False,  # full (latent) attention
    source="arXiv:2405.04434",
)


def reduced() -> ModelConfig:
    """The small config the CPU tests run (the reference's)."""
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=128, vocab_size=512,
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=64, rope_head_dim=16,
                      nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_ff_expert=128,
                      first_dense_layers=1, d_ff_dense=256),
    )
