"""Mistral-Large-Instruct-2407 (123B). [hf:mistralai/Mistral-Large-Instruct-2407]

88-layer dense GQA decoder, the deepest registered model (about 246 GB in
bf16: the roofline and ``--sim`` read it; the port serves it only
``.reduced()``). The same numbers as ``repro.configs.mistral_large_123b``.
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("mistral-large-123b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family=Family.DENSE,
        n_layers=88,
        d_model=12_288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        vocab=32_768,
        rope_theta=1_000_000.0,
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )
