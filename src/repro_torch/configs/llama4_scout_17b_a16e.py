"""Llama-4 Scout 17B-active / 16 experts. [hf:meta-llama/Llama-4-Scout-17B-16E]

MoE (16 experts, top-1) in every layer; chunked local attention ("iRoPE",
chunk 8192) in 3 of every 4 layers with a global-attention layer every
4th. The same numbers as ``repro.configs.llama4_scout_17b_a16e``.
"""
from repro_torch.configs.base import BlockKind, Family, ModelConfig, register


@register("llama4-scout-17b-a16e")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family=Family.MOE,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202_048,
        n_experts=16,
        top_k=1,
        moe_every=1,
        # period ordered global-first so the 3-layer smoke variant still
        # exercises both attention kinds
        pattern=(BlockKind.ATTN, BlockKind.CHUNKED_ATTN,
                 BlockKind.CHUNKED_ATTN, BlockKind.CHUNKED_ATTN),
        chunk=8192,
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
