"""Architecture configs of the port: the reference's eleven, one module
each, with the reference's numbers. The engine serves the attention
decoders (dense or MoE FFN) and RG-LRU hybrids among them; the xLSTM,
encoder-decoder and vision-prefix families are registered for ``--sim``
and the roofline, and the model raises for them."""
import importlib

_MODULES = [
    "llama4_scout_17b_a16e",
    "recurrentgemma_2b",
    "qwen2_5_14b",
    "grok_1_314b",
    "whisper_tiny",
    "deepseek_7b",
    "xlstm_350m",
    "mistral_large_123b",
    "llava_next_34b",
    "granite_3_2b",
    "tinyyolo_v2",
]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


from repro_torch.configs.base import (  # noqa: E402,F401
    SHAPES, BlockKind, Family, InputShape, ModelConfig, get_config,
    list_archs, register,
)
