"""Granite-3.0 2B base. [hf:ibm-granite/granite-3.0-2b-base]

Dense GQA decoder; the same numbers as ``repro.configs.granite_3_2b``.
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("granite-3-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family=Family.DENSE,
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=49_155,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
