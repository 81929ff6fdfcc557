"""Architecture configs of the port. Only the archs whose serving path is
ported are registered (granite-3-2b and recurrentgemma-2b)."""
import importlib

_MODULES = ["granite_3_2b", "recurrentgemma_2b"]

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
