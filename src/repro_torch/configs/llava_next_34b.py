"""LLaVA-NeXT 34B. [hf:llava-hf/llava-v1.6-mistral-7b-hf, 34B numbers]

Dense LM backbone (Yi-34B class) behind a vision prefix of ``n_patches``
patch embeddings (a stub: the vision tower is not modelled; callers pass
``batch["patches"]``). The same numbers as
``repro.configs.llava_next_34b``; the port's model takes the prefix in
``prefill``, and its engine serves the backbone text-only, as the
reference's does.
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("llava-next-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family=Family.VLM,
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20_480,
        vocab=64_000,
        n_patches=2880,  # anyres: base 576 + 4 tiles x 576
        rope_theta=5_000_000.0,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
