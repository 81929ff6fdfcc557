"""Whisper-tiny. [arXiv:2212.04356]

Encoder-decoder transformer backbone (4+4 layers, d=384, 6 heads) over
1500 encoder frames. The same numbers as ``repro.configs.whisper_tiny``;
the port's engine does not serve the encoder-decoder family yet
(``--sim`` and the roofline read the config).
"""
from repro_torch.configs.base import Family, ModelConfig, register


@register("whisper-tiny")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family=Family.AUDIO,
        n_layers=4,
        n_encoder_layers=4,
        n_frames=1500,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51_865,
        qkv_bias=True,
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )
