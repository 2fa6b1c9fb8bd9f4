"""Offload copy (the paper's copy-engine stand-in) on Hopper: the ctypes
launcher of ``csrc/offload_copy.cu``.

Replaces the TPU kernel ``src/repro/kernels/offload_copy.py``
(``offload_copy_pallas``).  The CUDA source states the kernel's design and
its bound on the card; :mod:`repro_torch.kernels.ops` is the wrapper that
applies the offload policy, counts launches and picks this or the plain
version by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_DEPTH = 8       # the deepest ring the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("offload_copy")
    fn = lib.repro_offload_copy
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ring_depth(shape, depth: int, block_rows: int = 256) -> int:
    """The TPU kernel's slab contract, on any device: ``shape`` is 2-D
    ``(R, C)`` with ``R`` a multiple of ``min(block_rows, R)``.  Returns
    ``depth`` clamped to ``[1, R / block_rows]``, as the TPU kernel clamps
    it."""
    if len(shape) != 2:
        raise ValueError(f"offload_copy takes a 2-D (R, C) slab, got shape "
                         f"{tuple(shape)}")
    rows, cols = shape
    if rows <= 0 or cols <= 0:
        raise ValueError(f"empty slab {tuple(shape)}")
    block_rows = min(block_rows, rows)
    if block_rows <= 0 or rows % block_rows:
        raise ValueError(f"rows {rows} are not a multiple of block_rows "
                         f"{block_rows}")
    return max(1, min(depth, rows // block_rows))


def check_inputs(x, out_dtype, depth: int, block_rows: int) -> int:
    """Raise on anything the kernel does not take; returns the ring's depth
    after the clamp."""
    depth = ring_depth(x.shape, depth, block_rows)
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth}: the kernel takes 1..{MAX_DEPTH}")
    for name, dt in (("x", x.dtype), ("out", out_dtype)):
        if dt not in _DTYPES:
            raise TypeError(f"{name} dtype {dt}: need one of "
                            f"{tuple(_DTYPES)}")
    n = x.numel()
    for dt in (x.dtype, out_dtype):
        if n * dt.itemsize % 16:
            raise ValueError(f"{n} elements of {dt} are not a multiple of 16 "
                             "bytes (the bulk copies' unit)")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x is not 16-byte aligned")
    if x.device.type != "cuda":
        raise ValueError(f"x on {x.device}: the kernel needs a CUDA tensor")
    return depth


def offload_copy_cuda(x, scale: float = 1.0, out_dtype=None, depth: int = 2,
                      block_rows: int = 256, inject: bool = False):
    """Launch the kernel on the current stream: ``y = (x * scale)`` cast to
    ``out_dtype`` (default x's), through a ring of ``depth`` copies in
    flight per CTA.  Returns ``(y, sum of x * scale as a 0-d fp32 tensor)``
    with ``inject``, else ``(y, None)``."""
    out_dtype = out_dtype or x.dtype
    depth = check_inputs(x, out_dtype, depth, block_rows)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    ctas = _sm_count(x.device.index if x.device.index is not None
                     else torch.cuda.current_device())
    # partials of each CTA, the total, and the ticket (zero bits = 0)
    scratch = torch.zeros(ctas + 2, dtype=torch.float32,
                          device=x.device) if inject else None
    fn = _lib().repro_offload_copy
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), float(scale), x.numel(),
                 _DTYPES[x.dtype], _DTYPES[out_dtype], depth, ctas,
                 int(inject), scratch.data_ptr() if inject else None,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"offload copy kernel launch failed: CUDA error "
                           f"{err}")
    return y, (scratch[ctas] if inject else None)
