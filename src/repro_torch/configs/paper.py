"""The paper's own generator setting: a small dense LM at RAG-serving
shapes (qwen2-0.5b-class widths, a 64,000-token vocabulary)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="paper-cftrag",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=64000,
    qkv_bias=True,
    tie_embeddings=True,
))
