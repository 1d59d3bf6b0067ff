"""Model configuration: the reference's ``ModelConfig`` and its registry.

The port carries the two dense configurations its generator serves
(``paper-cftrag``, ``qwen2-0.5b``); the other families' configurations
come with their models (ROADMAP Queue 1 item 10), and :func:`get_arch`
raises ``KeyError`` for them until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

ARCH_REGISTRY: Dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # only "dense" is ported (item 10)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # None -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    # --- runtime ---
    dtype: str = "bfloat16"
    attn_impl: str = "blocked"  # reference | blocked | flash
    attn_chunk: int = 1024      # blocked-attention kv tile

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 128-multiple, as the reference pads its
        embedding; logits beyond ``vocab`` are masked to -1e30."""
        return -(-self.vocab // 128) * 128

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU tests (the reference's)."""
        return self.replace(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            head_dim=32,
            d_ff=256,
            vocab=512,
            dtype="float32",
        )


def register(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_arch(arch_id: str) -> ModelConfig:
    from . import _load_all
    _load_all()
    try:
        return ARCH_REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"{arch_id!r} is not ported to repro_torch: it carries "
            f"{sorted(ARCH_REGISTRY)}; the other families come with their "
            f"models (ROADMAP Queue 1 item 10)") from None
