"""DeepSeek-LLM 7B. [arXiv:2401.02954]

Llama-architecture dense decoder, MHA-like (kv = heads = 32). The same
numbers as ``repro.configs.deepseek_7b``.
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("deepseek-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family=Family.DENSE,
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11_008,
        vocab=102_400,
        source="arXiv:2401.02954",
    )
