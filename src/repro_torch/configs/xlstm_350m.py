"""xLSTM-350M. [arXiv:2405.04517]

xLSTM[7:1]: one sLSTM block per 8, rest mLSTM; 24 = 3 x 8 periods.
d_ff = 0: projections live inside the blocks. The same numbers as
``repro.configs.xlstm_350m``; the port serves it through its engine (the
mLSTM and sLSTM blocks of ``repro_torch.models.blocks``).
"""
from repro_torch.configs.base import BlockKind, Family, ModelConfig, register


@register("xlstm-350m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family=Family.SSM,
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50_304,
        # sLSTM first so the 3-layer smoke variant covers both block kinds
        pattern=(BlockKind.SLSTM,) + (BlockKind.MLSTM,) * 7,
        tie_embeddings=False,
        source="arXiv:2405.04517",
    )
