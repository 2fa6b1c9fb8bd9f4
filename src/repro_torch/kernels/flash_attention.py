"""GQA flash attention forward on Hopper: the ctypes launcher of
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_pallas``).  The CUDA source states the kernel's design
and its bound on the card; :mod:`repro_torch.kernels.ops` is the wrapper
that counts launches and picks this or the plain version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(q, k, v) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B,S,H,hd) and (B,T,K,hd)")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"query heads {h} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        f"{tuple(_DTYPES)} for all three")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} on {t.device}: the kernel needs all "
                             "inputs on one CUDA device")


def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream; returns o (B,S,H,hd)."""
    check_inputs(q, k, v)
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    fn = _lib().repro_flash_attention_fwd
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, s, t, h, kh, hd, _DTYPES[q.dtype], int(causal),
                 1.0 / float(hd) ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    return o
