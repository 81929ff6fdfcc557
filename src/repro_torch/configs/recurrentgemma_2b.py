"""RecurrentGemma-2B (Griffin). [arXiv:2402.19427]

RG-LRU recurrent blocks mixed 2:1 with local sliding-window attention
(window 2048): pattern (R, R, A), 26 layers = 8 full periods + (R, R).
The same numbers as ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.configs.base import BlockKind, Family, ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family=Family.HYBRID,
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256_000,
        pattern=(BlockKind.RGLRU, BlockKind.RGLRU, BlockKind.LOCAL_ATTN),
        window=2048,
        source="arXiv:2402.19427",
    )
