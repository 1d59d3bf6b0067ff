"""PyTorch/CUDA port of the CFT-RAG reproduction.

Mirrors ``repro``'s layout (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``data``, ``training``, ``launch``) and imports
only torch, numpy and the standard library.  Retrieval, generation and
training run on an NVIDIA Hopper card through hand-written CUDA kernels
(``kernels/csrc``); every entry point defaults to the card and takes
``device="cpu"`` (or CPU parameters) for the plain torch path.
"""
from . import configs, core, data, kernels, models, serving, training

__all__ = ["configs", "core", "data", "kernels", "models", "serving",
           "training"]
