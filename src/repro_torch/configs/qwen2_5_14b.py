"""Qwen2.5-14B. [hf:Qwen/Qwen2.5-0.5B family card, 14B numbers]

Dense GQA decoder with QKV bias (the Qwen2.5 signature), rope theta 1e6.
The same numbers as ``repro.configs.qwen2_5_14b``.
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("qwen2.5-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family=Family.DENSE,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=13_824,
        vocab=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen2.5-0.5B",
    )
