"""PyTorch/CUDA port of the CFT-RAG reproduction.

Mirrors ``repro``'s layout (``core``, ``kernels``, ``serving``, ``data``)
and imports only torch, numpy and the standard library.  The retrieval
path runs on an NVIDIA Hopper card through hand-written CUDA kernels
(``kernels/csrc``); every entry point defaults to the card and takes
``device="cpu"`` for the plain torch path.
"""
from . import core, data, kernels, serving

__all__ = ["core", "data", "kernels", "serving"]
