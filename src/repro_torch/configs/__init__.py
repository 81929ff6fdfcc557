"""Architecture configs of the port. Only the archs whose serving path is
ported are registered (granite-3-2b, recurrentgemma-2b, and the MoE archs
llama4-scout-17b-a16e and grok-1-314b)."""
import importlib

_MODULES = ["granite_3_2b", "recurrentgemma_2b", "llama4_scout_17b_a16e",
            "grok_1_314b"]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


from repro_torch.configs.base import (  # noqa: E402,F401
    BlockKind, Family, ModelConfig, get_config, register,
)
