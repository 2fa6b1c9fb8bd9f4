"""Parameter bridge between the JAX package's trees and the port.

The JAX package keeps parameters as nested dicts of arrays.  Passed in as
numpy arrays (``np.asarray`` of each leaf), :func:`params_from_jax` turns
such a tree into the port's tree of tensors with the same layout, byte for
byte, so both sides compute with identical weights.  bfloat16 leaves travel
as their 16-bit patterns: numpy has no bfloat16 of its own and
``torch.bfloat16`` has no ``.numpy()``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import tree_map


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of ``t``; a bfloat16 tensor comes back as its uint16 bit
    patterns (``.view(ml_dtypes.bfloat16)`` on the caller's side restores
    the type)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays (the JAX package's parameter tree) ->
    the same tree of tensors on ``device``."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def params_to_numpy(tree):
    return tree_map(to_numpy, tree)
