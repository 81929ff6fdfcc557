"""Grok-1 314B. [hf:xai-org/grok-1]

8-expert top-2 MoE in every layer, GQA kv=8, global attention only. The
same numbers as ``repro.configs.grok_1_314b``.
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("grok-1-314b")
def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family=Family.MOE,
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32_768,
        vocab=131_072,
        n_experts=8,
        top_k=2,
        moe_every=1,
        source="hf:xai-org/grok-1",
    )
