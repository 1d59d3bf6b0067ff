"""Parameters of the reference, converted to the port's layout.

The reference keeps its parameters as a nested dict of arrays in exactly
the port's layout (dense weights ``(d_in, d_out)``, layers stacked on a
leading axis), so conversion is a checked copy: every leaf's path and
shape must match :func:`repro_torch.models.transformer.param_shapes`.
The parity tests pass ``jax.tree.map(np.asarray, params)``; this module
itself takes numpy arrays only.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import DTYPES, Params
from .transformer import param_shapes


def params_from_jax(cfg: ModelConfig, tree: Any, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's params (nested dict of numpy arrays, bf16 as
    ``ml_dtypes.bfloat16``) as torch tensors of ``dtype`` (default: the
    config's) on ``device``.  Raises on a missing, extra or misshapen
    leaf."""
    dtype = DTYPES[cfg.dtype] if dtype is None else dtype
    return _convert(tree, param_shapes(cfg), "params", torch.device(device),
                    dtype)


def _convert(tree, shapes, path: str, device, dtype):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path}: keys {got}, want {sorted(shapes)}")
        return {k: _convert(tree[k], shapes[k], f"{path}.{k}", device, dtype)
                for k in shapes}
    a = np.asarray(tree)
    if a.shape != tuple(shapes):
        raise ValueError(f"{path}: shape {a.shape}, want {tuple(shapes)}")
    # bf16 -> f32 is exact; numpy has no bf16 that torch can read directly
    return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                     dtype=dtype)
