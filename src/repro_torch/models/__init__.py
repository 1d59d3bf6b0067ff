"""The generator LM of the port: dense decoder, attention, layers."""
from . import attention, layers, lm, transformer
from .convert import params_from_jax

__all__ = ["attention", "layers", "lm", "transformer", "params_from_jax"]
