"""Model configuration: a JAX-free copy of ``repro.configs.base``.

The port imports nothing of ``repro`` (whose ``configs.base`` imports JAX),
so it keeps its own copy of :class:`ModelConfig`, :class:`Family`,
:class:`BlockKind`, the registry and ``.reduced()``. Field names, defaults
and the derived properties the port reads are identical, so a config built
here describes the same model as its ``repro`` namesake. The derived
sizes (``n_params``, ``n_active_params``) and the input shapes
(:class:`InputShape`, ``SHAPES``) are the reference's, field for field,
and so are ``input_specs``' inputs (tensors, made in the caller's
fake-tensor mode by the dry run, where the reference makes shape structs).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    HYBRID = "hybrid"   # recurrent + local-attention mix (recurrentgemma)
    SSM = "ssm"         # xLSTM
    AUDIO = "audio"     # enc-dec backbone, conv frontend stubbed
    VLM = "vlm"         # dense LM backbone, vision frontend stubbed


class BlockKind(str, enum.Enum):
    """Per-layer block type; the layer stack is ``pattern`` repeated."""

    ATTN = "attn"             # global causal attention + MLP
    LOCAL_ATTN = "local"      # sliding-window attention + MLP
    CHUNKED_ATTN = "chunked"  # chunked ("iRoPE"-style) attention + MLP
    RGLRU = "rglru"           # RG-LRU recurrent block + MLP
    MLSTM = "mlstm"           # xLSTM mLSTM block (self-contained)
    SLSTM = "slstm"           # xLSTM sLSTM block (self-contained)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # citation for the source of the numbers above
    source: str = ""
    head_dim: Optional[int] = None
    # the layer stack is ``pattern`` tiled to n_layers
    pattern: Tuple[BlockKind, ...] = (BlockKind.ATTN,)
    # --- attention ----------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0            # sliding window size for LOCAL_ATTN blocks
    chunk: int = 0             # chunk size for CHUNKED_ATTN blocks
    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 0
    # --- enc-dec (audio) -------------------------------------------------
    n_encoder_layers: int = 0
    n_frames: int = 0
    # --- vlm ---------------------------------------------------------
    n_patches: int = 0
    # --- norm / misc ---------------------------------------------------
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple (granite's 49155 -> 49408);
        pad ids are never produced by the tokenizer."""
        if self.vocab % 256 == 0 or self.vocab <= 1024:
            return self.vocab
        return -(-self.vocab // 256) * 256

    @property
    def layer_pattern(self) -> Tuple[BlockKind, ...]:
        """Full per-layer block list of length n_layers."""
        reps = -(-self.n_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def is_moe_layer(self, i: int) -> bool:
        return bool(self.moe_every) and (i % self.moe_every == 0)

    @property
    def n_moe_layers(self) -> int:
        return sum(self.is_moe_layer(i) for i in range(self.n_layers))

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f = self.d_model, self.d_ff
        hd = self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp = 3 * d * f  # gate/up/down
        total = 0
        for i, kind in enumerate(self.layer_pattern):
            if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.CHUNKED_ATTN):
                ff = self.n_experts * mlp + d * self.n_experts if self.is_moe_layer(i) else mlp
                total += attn + ff
            elif kind == BlockKind.RGLRU:
                # conv1d + lru gates + in/out proj + MLP
                total += 2 * d * d + 3 * d * d + mlp
            elif kind == BlockKind.MLSTM:
                total += 2 * d * 2 * d + 4 * d * d  # up/down proj + qkv/gates
            elif kind == BlockKind.SLSTM:
                total += 4 * d * d + 2 * d * int(1.34 * d)
        if self.is_encdec:
            total += self.n_encoder_layers * (2 * attn + mlp)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    @property
    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if self.family != Family.MOE or not self.n_experts:
            return self.n_params
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f
        inactive = self.n_moe_layers * (self.n_experts - self.top_k) * mlp
        return self.n_params - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant with the same rules as ``repro``'s: <=2 layers
        per pattern period, d_model<=256, <=4 heads, <=4 experts, top-k
        <=2, chunk <=64, float32."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        n_layers = min(len(self.pattern), 3)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, n_layers) if len(self.pattern) == 1 else n_layers,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv),
            head_dim=d // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_frames=min(self.n_frames, 16) if self.n_frames else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            window=min(self.window, 64) if self.window else 0,
            chunk=min(self.chunk, 64) if self.chunk else 0,
            dtype="float32",
        )


# ----------------------------------------------------------------------
# Input shapes (the reference's assigned shapes; the roofline reads them)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        from repro_torch import configs
        configs.load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    from repro_torch import configs
    configs.load_all()
    return sorted(_REGISTRY)


# ----------------------------------------------------------------------
# input_specs: the model's inputs at an input shape
# ----------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: InputShape, device=None) -> Dict[str, "object"]:
    """The reference's inputs (``repro.configs.base.input_specs``) as
    uninitialised tensors on ``device`` (made inside the caller's fake-tensor
    mode, they hold no storage): train -> tokens, labels (B, S) int32;
    prefill -> tokens; decode -> tokens (B, 1) and pos (B,) int32 (the
    cache is the caller's); frames (B, n_frames, d) for AUDIO; patches (B,
    n_patches, d) for VLM other than at decode, in the config's dtype."""
    import torch        # the configs themselves import no torch
    B, S = shape.global_batch, shape.seq_len
    i32, wdt = torch.int32, getattr(torch, cfg.dtype)
    specs = {}
    if shape.kind == "train":
        specs["tokens"] = torch.empty((B, S), dtype=i32, device=device)
        specs["labels"] = torch.empty((B, S), dtype=i32, device=device)
    elif shape.kind == "prefill":
        specs["tokens"] = torch.empty((B, S), dtype=i32, device=device)
    else:
        specs["tokens"] = torch.empty((B, 1), dtype=i32, device=device)
        specs["pos"] = torch.empty((B,), dtype=i32, device=device)
    if cfg.family == Family.AUDIO:
        specs["frames"] = torch.empty((B, cfg.n_frames, cfg.d_model), dtype=wdt,
                                      device=device)
    if cfg.family == Family.VLM and shape.kind != "decode":
        specs["patches"] = torch.empty((B, cfg.n_patches, cfg.d_model), dtype=wdt,
                                       device=device)
    return specs
