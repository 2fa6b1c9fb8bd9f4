"""GQA flash attention forward on Hopper: the ctypes launchers of
``csrc/flash_attention_wgmma.cu`` (tensor cores) and
``csrc/flash_attention.cu`` (CUDA cores).

Both replace the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_pallas``).  Which one serves a call is fixed by
``(dtype, head_dim)`` (:func:`variant`): the tensor-core kernel takes bf16
at hd 64, 80 and 128; the CUDA-core kernel takes fp32 at every hd (whose
2e-5 gate TF32 cannot meet) and bf16 at hd 16 and 32.  It is a choice by
shape, not a fallback.  The CUDA sources state each kernel's design and
its bound on the card; :mod:`repro_torch.kernels.ops` is the wrapper that
counts launches and picks the kernel or the plain version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 80, 128)
WGMMA_HEAD_DIMS = (64, 80, 128)
VARIANTS = ("wgmma", "simt")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what a negative return of the tensor-core launcher means
_WGMMA_ERRORS = {-1: "the driver's cuTensorMapEncodeTiled is not reachable",
                 -2: "a TMA tensor map was refused"}


def variant(dtype, head_dim: int) -> str:
    """The kernel that serves ``(dtype, head_dim)``: ``"wgmma"`` (tensor
    cores) for bf16 at hd 64, 80 and 128, else ``"simt"`` (CUDA cores)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _fn(kind: str):
    """The C entry of ``kind``'s library, its argument types set."""
    if kind == "wgmma":
        fn = build.load("flash_attention_wgmma").repro_flash_attention_wgmma_fwd
        ints = 7          # B, S, T, H, K, hd, causal
    else:
        fn = build.load("flash_attention").repro_flash_attention_fwd
        ints = 8          # ... and the dtype
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (TMA needs "
                             "16-byte aligned bases)")


def flash_attention_cuda(q, k, v, causal: bool = True,
                         kind: str | None = None) -> torch.Tensor:
    """Launch a kernel on the current stream; returns o (B,S,H,hd).

    ``kind`` is :func:`variant`'s choice unless named; ``"simt"`` takes
    every ``(dtype, hd)``, ``"wgmma"`` only its own."""
    hd = q.shape[-1]
    kind = kind or variant(q.dtype, hd)
    if kind not in VARIANTS:
        raise ValueError(f"kernel {kind!r}: one of {VARIANTS}")
    if kind == "wgmma" and variant(q.dtype, hd) != "wgmma":
        raise ValueError(f"the tensor-core kernel takes bf16 at hd "
                         f"{WGMMA_HEAD_DIMS}, not {q.dtype} at hd {hd}")
    check_inputs(q, k, v)
    b, s, h, _ = q.shape
    t, kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, s, t, h, kh, hd]
    if kind == "simt":
        args.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = _fn(kind)(*args, int(causal), 1.0 / float(hd) ** 0.5,
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention ({kind}) kernel launch failed: "
                           + _WGMMA_ERRORS.get(err, f"CUDA error {err}"))
    return o
