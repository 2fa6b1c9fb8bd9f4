"""Mamba2 SSD chunk scan on Hopper: the ctypes launcher of
``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_scan_pallas``).  The CUDA source states the kernel's design and its
bound on the card; :mod:`repro_torch.kernels.ops` is the wrapper that
counts launches and picks this or the plain version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_STATE = 64      # N the kernel takes (a multiple of 4 up to this)
MAX_CHUNK = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_inputs(xh, bm, cm, dt, da, d_skip, chunk: int) -> None:
    """Raise on anything the kernel does not take."""
    if xh.dim() != 4 or bm.dim() != 4 or cm.dim() != 4 or dt.dim() != 3 \
            or da.dim() != 3 or d_skip.dim() != 1:
        raise ValueError("need xh (B,S,H,P), bm/cm (B,S,G,N), dt/da (B,S,H) "
                         "and d_skip (H,)")
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    if cm.shape != bm.shape or bm.shape[:2] != (b, s) or \
            dt.shape != (b, s, h) or da.shape != (b, s, h) or \
            d_skip.shape != (h,):
        raise ValueError(
            f"shape mismatch: xh {tuple(xh.shape)}, bm {tuple(bm.shape)}, "
            f"cm {tuple(cm.shape)}, dt {tuple(dt.shape)}, "
            f"da {tuple(da.shape)}, d_skip {tuple(d_skip.shape)}")
    if h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    if n % 4 or n > MAX_STATE:
        raise ValueError(f"state width {n}: need a multiple of 4 up to "
                         f"{MAX_STATE}")
    if p % 16:
        raise ValueError(f"head width {p} is not a multiple of 16")
    if not 0 < min(chunk, s) <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: need 1..{MAX_CHUNK}")
    if xh.dtype not in _DTYPES:
        raise TypeError(f"xh dtype {xh.dtype}: need one of {tuple(_DTYPES)}")
    named = (("xh", xh), ("bm", bm), ("cm", cm), ("dt", dt), ("da", da),
             ("d_skip", d_skip))
    for name, t in named[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: need torch.float32")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device.type != "cuda" or t.device != xh.device:
            raise ValueError(f"{name} on {t.device}: the kernel needs all "
                             "inputs on one CUDA device")


def ssd_scan_cuda(xh, bm, cm, dt, da, d_skip, chunk: int = 256):
    """Launch the kernel on the current stream; returns
    (y (B,S,H,P) fp32, h_final (B,H,N,P) fp32)."""
    check_inputs(xh, bm, cm, dt, da, d_skip, chunk)
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    y = torch.empty(xh.shape, dtype=torch.float32, device=xh.device)
    h_final = torch.empty((b, h, n, p), dtype=torch.float32,
                          device=xh.device)
    fn = _lib().repro_ssd_scan_fwd
    with torch.cuda.device(xh.device):
        err = fn(xh.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(),
                 da.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                 h_final.data_ptr(), b, s, h, g, n, p, chunk,
                 _DTYPES[xh.dtype],
                 torch.cuda.current_stream(xh.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd scan kernel launch failed: CUDA error {err}")
    return y, h_final
