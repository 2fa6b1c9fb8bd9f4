#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. the card's name and power limit, from ``nvidia-smi``;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, all at once (timed);
3. kernels: each kernel's wrapper on tensors on the card against its plain
   PyTorch version at the main paths' shapes and a few edge cases, with
   kernel / plain / library timings (CUDA events) and the bound: flash
   attention (K2) at hd 128 and 80, the SSD chunk scan (K3).  K2 has two
   kernels, fixed by (dtype, hd): the tensor-core one (bf16 at hd 64, 80,
   128: ragged, S != T, MHA and GQA cases) and the CUDA-core one (fp32,
   bf16 at hd 16, 32); at the three timed shapes the CUDA-core kernel is
   also gated and timed on the same bf16 inputs;
4. offload: the offload copy (K1) on fp32 slabs of 1, 16, 64 and 256 MiB
   (and bf16 ones at 256 MiB) at ring depths 1, 2 and 4 with the fused sum
   on and off, held bit for bit against its plain version, its sum against
   the fp64 sum, two launches against each other, bad inputs raising; its
   times per size and depth beside the bound, the plain version and the
   library calls; then the offload path itself
   (``repro_torch.launch.offload_modes`` at the 256 MiB slab: calibration,
   the tier-1 engine in each mode, the size threshold, K1 over mode x
   injection), with every kernel's launch count set to 0 just before and
   read just after;
5. reference: each served model at smoke width on the card equals the same
   model on the CPU (the path the CPU tests hold against JAX);
6. serve: full-width granite-8b (36 layers, d_model 4096), then full-width
   zamba2-2.7b (54 Mamba2 layers + a shared attention block applied 9
   times, d_model 2560), bf16, seeded random weights made on the card,
   through the port's dispatcher and transfer engine: 8 pipelined
   1024-token requests, then one sync 4096-token request, with every
   kernel's launch count (and K2's count per kernel) set to 0 just before
   each run and read just after: every prefill attention goes through the
   tensor-core K2.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``nvidia-smi`` name and power limit; before that one JSON line of kernels.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 without tensor
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# fp32: max |kernel - plain|, the bound of tests/test_kernels.py.
# bf16: the kernel reads bf16 inputs but computes scores and the softmax in
# fp32, so its yardstick is the plain version on the fp32 upcasts of the
# same inputs, and the error is taken row by row, relative to the row's RMS:
# a late causal row's values are ~sqrt(e/S) (0.05 at S=1024), too small for
# an absolute bound to see a fault confined to late rows.
FP32_TOL = 2e-5
BF16_ROW_TOL = 0.05
TILE = 64   # the kernel's K/V tile

# SSD scan: max over y and h_final of |kernel - plain| / (1 + |plain|), so
# the gate is allclose at rtol = atol = 1e-4, the bound of
# tests/test_kernels.py.  Every product is fp32 and a bf16 x is upcast on
# load, so bf16 x is held to the same bound against the plain version on
# the fp32 upcast of the same x.
SSD_TOL = 1e-4

# offload copy (K1): y is one fp32 multiply by the fp32 scale and a
# round-to-nearest-even cast in the kernel and in the plain version, so it
# is held bit for bit (max abs 0).  The sum is added in another order: its
# error is |s - s64| / sum |x * scale|, s64 the fp64 sum of the same fp32
# products; a sum that loses one 256-row block must read above the limit.
OFFLOAD_SUM_TOL = 1e-5
OFFLOAD_SCALE = 0.1                # not exact in binary
OFFLOAD_COLS = 1024
OFFLOAD_ROWS = (256, 4096, 16384, 65536)   # fp32 1, 16, 64, 256 MiB
OFFLOAD_PAIRS = (("float32", "bfloat16"), ("float32", "float32"),
                 ("bfloat16", "float32"), ("bfloat16", "bfloat16"))
OFFLOAD_DEPTHS = (1, 2, 4)
OFFLOAD_PATH_LAUNCHES = 6          # 3 modes x inject off / on
COLD_BYTES = 128 << 20             # inputs cycled past the 50 MB L2

# the served models: (name, layers, d_model, launches per prefill batch)
SERVED = (
    ("granite-8b", 36, 4096,
     {"flash_attention": 36, "ssd_scan": 0, "offload_copy": 0}),
    ("zamba2-2.7b", 54, 2560,
     {"flash_attention": 9, "ssd_scan": 54, "offload_copy": 0}),
)
KERNELS = ("flash_attention", "ssd_scan", "offload_copy")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches issued back to
    back (CUDA events, after a warm-up): the launches are queued behind a
    sleep kernel, so host time between them is not counted."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 4e5))     # ~0.2 ms a launch to queue
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, s, t, h, kh, hd, causal, dtype):
    """Least time for the work these inputs need: each input read once,
    the output written once; 4*hd FLOPs per visible (query, key) pair."""
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    flops = 4 * b * h * hd * pairs
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * (2 * b * s * h * hd + 2 * b * t * kh * hd)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def row_rel_err(got, want) -> float:
    """max over rows (b, s, h) of max|got - want| / RMS(want) over hd."""
    want = want.float()
    dev = (got.float() - want).abs().amax(-1)
    return (dev / want.pow(2).mean(-1).sqrt()).max().item()


def skipped_tile_err(q, k, v, want, causal=True) -> float:
    """The row error of a planted fault, for the bf16 gate to be set below:
    the last 64 query rows (all, if fewer) skip the 64 keys in the middle
    of the key sequence (plain fp32 on the same inputs, rounded to q's
    dtype)."""
    import torch

    b, s, h, hd = q.shape
    kh, t = k.shape[2], k.shape[1]
    lo, tile = max(s - TILE, 0), (t // TILE) // 2 * TILE
    qg = q[:, lo:].float().reshape(b, s - lo, kh, h // kh, hd)
    scores = torch.einsum("bskge,btke->bkgst", qg, k.float()) / hd ** 0.5
    qpos = torch.arange(lo, s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    hidden = (kpos >= tile) & (kpos < tile + TILE)
    if causal:
        hidden = hidden | (kpos > qpos)
    w = torch.softmax(scores.masked_fill(hidden, -1e30), dim=-1)
    o = torch.einsum("bkgst,btke->bskge", w, v.float()).reshape(
        b, s - lo, h, hd)
    return row_rel_err(o.to(q.dtype), want[:, lo:])


def flash_phase():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (WGMMA_HEAD_DIMS,
                                                     flash_attention_cuda,
                                                     variant)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (dtype, B, S, T, H, K, hd, causal, timed)
        ("bfloat16", 8, 1024, 1024, 32, 8, 128, True, True),   # granite
        ("bfloat16", 1, 4096, 4096, 32, 8, 128, True, True),   # sync request
        ("bfloat16", 8, 1024, 1024, 32, 32, 80, True, True),   # zamba2
        ("float32", 2, 256, 256, 4, 4, 80, True, False),
        ("bfloat16", 2, 192, 192, 8, 2, 64, True, False),
        ("float32", 2, 256, 256, 4, 2, 16, True, False),
        ("float32", 2, 256, 256, 8, 2, 64, True, False),
        ("float32", 2, 128, 128, 4, 4, 32, True, False),
        ("float32", 2, 64, 200, 8, 1, 32, False, False),       # S != T
        ("float32", 1, 100, 100, 4, 4, 128, True, False),      # ragged S, T
    ]
    # the tensor-core kernel's edges: ragged S = T (causal only at S == T),
    # S < T and S > T, MHA (H = K) and GQA (H = 4K), at each of its hd;
    # the last has more q tiles than the card has SMs, so a block walks
    # several (ragged) items
    for hd in WGMMA_HEAD_DIMS:
        cases += [("bfloat16", 2, 200, 200, 8, 8, hd, True, False),
                  ("bfloat16", 2, 200, 200, 8, 2, hd, True, False),
                  ("bfloat16", 2, 64, 200, 8, 2, hd, False, False),
                  ("bfloat16", 2, 256, 64, 8, 8, hd, False, False),
                  ("bfloat16", 2, 1000, 1000, 16, 4, hd, True, False)]
    results = []
    for dtype, b, s, t, h, kh, hd, causal, timed in cases:
        dt = getattr(torch, dtype)
        q = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, t, kh, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, t, kh, hd, generator=gen, device="cuda").to(dt)
        kind = variant(dt, hd)
        before = dict(ops.flash_attention.VARIANTS)
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(ops.flash_attention.VARIANTS[kind] == before[kind] + 1,
              f"{dtype} hd {hd} did not go through the {kind} kernel")
        row = {"dtype": dtype, "shape": [b, s, t, h, kh, hd],
               "causal": causal, "variant": kind}
        if dtype == "float32":
            plain = ref.flash_attention(q, k, v, causal=causal)
            err = (out - plain).abs().max().item()
            row.update(max_abs_err=err, tol=FP32_TOL)
            ok = err <= FP32_TOL
            gate = f"max|kernel-plain| = {err!r} (tol {FP32_TOL})"
        else:
            plain = ref.flash_attention(q.float(), k.float(), v.float(),
                                        causal=causal)
            err = row_rel_err(out, plain)
            fault = skipped_tile_err(q, k, v, plain, causal)
            row.update(max_abs_err=(out.float() - plain).abs().max().item(),
                       row_rel_err=err, fault_row_rel_err=fault,
                       tol=BF16_ROW_TOL)
            check(fault > BF16_ROW_TOL,
                  f"the bf16 gate would pass a skipped K/V tile: {row}")
            ok = err <= BF16_ROW_TOL
            gate = (f"row error vs plain on fp32 upcasts = {err!r} (tol "
                    f"{BF16_ROW_TOL}; a skipped K/V tile reads {fault!r}), "
                    f"max abs {row['max_abs_err']!r}")
        print(f"kernels: flash_attention ({kind}) {dtype} B={b} S={s} T={t} "
              f"H={h} K={kh} hd={hd} causal={causal}: {gate}")
        check(ok and out.isfinite().all().item(),
              f"flash_attention disagrees with its plain version: {row}")
        if timed:
            # the CUDA-core kernel on the same inputs, gated the same way
            old = flash_attention_cuda(q, k, v, causal, kind="simt")
            torch.cuda.synchronize()
            row["simt_row_rel_err"] = row_rel_err(old, plain)
            check(row["simt_row_rel_err"] <= BF16_ROW_TOL
                  and old.isfinite().all().item(),
                  f"the CUDA-core flash kernel disagrees: {row}")
            del old
        del plain
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)

            fns = {"ms": lambda: ops.flash_attention(q, k, v, causal=causal),
                   "simt_ms": lambda: flash_attention_cuda(
                       q, k, v, causal, kind="simt"),
                   "plain_ms": lambda: ref.flash_attention(q, k, v,
                                                           causal=causal),
                   "library_ms": library}
            lib_err = (library().transpose(1, 2).float()
                       - out.float()).abs().max().item()
            # in turns: kernel, CUDA-core kernel, plain, library, then
            # again in reverse
            times = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times[key].append(time_ms(fns[key],
                                              20 if key == "ms" else 5))
            row.update({key: min(v) for key, v in times.items()})
            row["library_vs_kernel_max_abs"] = lib_err
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, t, h, kh, hd, causal, dtype)
            print(f"kernels: flash_attention {dtype} B={b} S={s} H={h} "
                  f"K={kh} hd={hd}: tensor-core kernel {row['ms']!r} ms, "
                  f"CUDA-core kernel {row['simt_ms']!r} ms (row error "
                  f"{row['simt_row_rel_err']!r}), plain {row['plain_ms']!r} "
                  f"ms, sdpa {row['library_ms']!r} ms, bound "
                  f"{row['bound_ms']!r} ms ({row['bound_by']})")
        results.append(row)
        del q, k, v, out
    torch.cuda.empty_cache()
    return results


def ssd_bound(b, s, h, p, g, n, q, x_dtype):
    """Least time for the scan's work on these inputs: x, B, C, dt, da and
    D read once, y and h_final written once; the operations are the fewer
    of two forms of the same function, all fp32.  Chunked, per (b, h,
    chunk of L tokens): L(L+1)P (masked M dtx) + 2LNP (B^T dtx) + 2LNP
    (C h, none in the first chunk, whose carried state is zero), and per
    (b, group, chunk) L(L+1)N for C B^T.  Recurrent, per (b, h, token):
    NP (decay h) + 2NP (h += B (dt x)) + 2NP (C h) + 3P (dt x, D x), less
    the first token's decay of a zero state."""
    xb = 2 if x_dtype == "bfloat16" else 4
    nbytes = (b * s * h * p * (xb + 4) + 4 * b * h * n * p
              + 8 * b * s * g * n + 8 * b * s * h + 4 * h)
    lens = [min(q, s - c0) for c0 in range(0, s, q)]
    chunked = sum(b * h * (L * (L + 1) * p + (4 if c else 2) * L * n * p)
                  + b * g * L * (L + 1) * n for c, L in enumerate(lens))
    recurrent = b * h * (s * (5 * n * p + 3 * p) - n * p)
    flops = min(chunked, recurrent)
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scaled_err(got, want) -> float:
    """max |got - want| / (1 + |want|): at most tol iff allclose(rtol=atol=
    tol)."""
    return ((got - want).abs() / (1 + want.abs())).max().item()


def ssd_phase():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (x dtype, B, S, H, P, G, N, chunk, timed)
        ("float32", 8, 1024, 80, 64, 1, 64, 256, True),    # zamba2 prefill
        ("bfloat16", 8, 1024, 80, 64, 1, 64, 256, True),   # ... as served
        ("bfloat16", 1, 4096, 80, 64, 1, 64, 256, True),   # sync request
        ("float32", 2, 1000, 80, 64, 1, 64, 256, False),   # ragged S
        ("float32", 2, 192, 8, 16, 2, 16, 64, False),      # G = 2
        ("float32", 2, 100, 8, 32, 4, 32, 32, False),      # G = 4, ragged
    ]
    results = []
    for dtype, b, s, h, p, g, n, chunk, timed in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        # dt and A spread as in Mamba2 (dt ~ 0.05, A ~ -1): the state
        # carried from one chunk matters well into the next
        dt = F.softplus(randn(b, s, h) - 3.0)
        da = -torch.exp(0.5 * randn(h)) * dt
        xh = randn(b, s, h, p).to(getattr(torch, dtype))
        args = (xh, 0.5 * randn(b, s, g, n), 0.5 * randn(b, s, g, n), dt, da,
                torch.linspace(0.5, 1.5, h, device="cuda"))
        y, hf = ops.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        plain_args = (xh.float(),) + args[1:]
        wy, wh = ref.ssd_scan(*plain_args, chunk=chunk)
        err = max(scaled_err(y, wy), scaled_err(hf, wh))
        # planted fault: the state carried into the last chunk zeroed
        c_last = (s - 1) // min(chunk, s) * min(chunk, s)
        fy, fh = ref.ssd_scan(*(a[:, c_last:] for a in plain_args[:5]),
                              plain_args[5], chunk=chunk)
        fault = max(scaled_err(fy, wy[:, c_last:]), scaled_err(fh, wh))
        row = {"dtype": dtype, "shape": [b, s, h, p, g, n, chunk],
               "max_abs_err": max((y - wy).abs().max().item(),
                                  (hf - wh).abs().max().item()),
               "scaled_err": err, "fault_scaled_err": fault, "tol": SSD_TOL}
        print(f"kernels: ssd_scan x {dtype} B={b} S={s} H={h} P={p} G={g} "
              f"N={n} chunk={chunk}: "
              f"max|kernel-plain|/(1+|plain|) over y and h_final = {err!r} "
              f"(tol {SSD_TOL}; the last chunk's carried state zeroed reads "
              f"{fault!r}), max abs {row['max_abs_err']!r}")
        check(fault > SSD_TOL,
              f"the ssd gate would pass a dropped carried state: {row}")
        check(err <= SSD_TOL and y.isfinite().all().item()
              and hf.isfinite().all().item(),
              f"ssd_scan disagrees with its plain version: {row}")
        del wy, wh, fy, fh
        if timed:
            fns = {"ms": (lambda: ops.ssd_scan(*args, chunk=chunk), 20),
                   "plain_ms": (lambda: ref.ssd_scan(*args, chunk=chunk), 3)}
            # in turns: kernel, plain, then again in reverse
            times = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times[key].append(time_ms(*fns[key]))
            row.update({key: min(v) for key, v in times.items()})
            row["library_ms"] = None    # no one PyTorch call computes it
            row["bound_ms"], row["bound_by"] = ssd_bound(
                b, s, h, p, g, n, min(chunk, s), dtype)
            print(f"kernels: ssd_scan x {dtype} B={b} S={s}: kernel "
                  f"{row['ms']!r} ms, plain {row['plain_ms']!r} ms, bound "
                  f"{row['bound_ms']!r} ms ({row['bound_by']}), no library "
                  "call")
        results.append(row)
        del args, plain_args, xh, y, hf
    torch.cuda.empty_cache()
    return results


def offload_bound(n: int, in_dtype: str, out_dtype: str, inject: bool):
    """Least time for y = cast(x * scale) over n elements (+ the sum): x
    read once, y (and the sum) written once; n multiplies (+ n adds) at
    the fp32 rate.  Returns (ms, bound_by, bytes)."""
    size = {"float32": 4, "bfloat16": 2}
    nbytes = n * (size[in_dtype] + size[out_dtype]) + (4 if inject else 0)
    flops = n * (2 if inject else 1)
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def offload_phase(card: str) -> dict:
    """K1 against its plain version and timed, then the offload path.
    Returns the kernels-line fields of the main shape, the checks'
    summary and the path's launches."""
    import itertools

    import torch

    from repro_torch.core.policy import OffloadPolicy
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.offload_copy import offload_copy_cuda
    from repro_torch.launch import offload_modes

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    def gbps(nbytes, ms):
        return nbytes / ms / 1e6

    gen = torch.Generator(device="cuda").manual_seed(2)
    scale = OFFLOAD_SCALE
    rows_out, worst_sum, least_fault, main = [], 0.0, float("inf"), None
    for rows in OFFLOAD_ROWS:
        is_main = rows == OFFLOAD_ROWS[-1]
        x32 = torch.randn(rows, OFFLOAD_COLS, generator=gen,
                          device="cuda") + 0.5      # N(0.5, 1)
        slabs = {"float32": x32, "bfloat16": x32.to(torch.bfloat16)}
        for in_dt, out_dt in OFFLOAD_PAIRS if is_main else OFFLOAD_PAIRS[:2]:
            x, out = slabs[in_dt], getattr(torch, out_dt)
            n = x.numel()
            want, _ = ref.offload_copy(x, scale=scale, out_dtype=out)
            v = (x.float() * scale).double()
            s64, mag = v.sum().item(), v.abs().sum().item()
            mid = rows // 2 // 256 * 256
            fault = abs(v[mid:mid + 256].sum().item()) / mag
            del v
            check(fault > OFFLOAD_SUM_TOL,
                  f"the sum gate would pass a lost 256-row block: {fault!r}")
            least_fault = min(least_fault, fault)
            # timed on inputs cycled past the L2, so each launch reads cold
            copies = [x] + [x.clone() for _ in range(
                -(-COLD_BYTES // (n * x.element_size())) - 1)]
            cyc = itertools.cycle(copies)
            iters = 20 if rows >= 16384 else 50
            ybuf = torch.empty(x.shape, dtype=out, device="cuda")
            base = {}
            for inject in (False, True):
                def plain():
                    return ref.offload_copy(next(cyc), scale=scale,
                                            out_dtype=out, inject=inject)

                def library():
                    xi = next(cyc)
                    torch.mul(xi, scale, out=ybuf)
                    if inject:
                        xi.sum(dtype=torch.float32)

                base[inject] = {"plain_ms": time_ms(plain, iters),
                                "library_ms": time_ms(library, iters)}
            memcpy_ms = (time_ms(lambda: ybuf.copy_(next(cyc)), iters)
                         if in_dt == out_dt == "float32" else None)
            for depth in OFFLOAD_DEPTHS:
                for inject in (False, True):
                    y, s = offload_copy_cuda(x, scale, out, depth, 256,
                                             inject)
                    y2, s2 = offload_copy_cuda(x, scale, out, depth, 256,
                                               inject)
                    torch.cuda.synchronize()
                    equal = torch.equal(bits(y), bits(want))
                    same = torch.equal(bits(y2), bits(y)) and (
                        not inject or torch.equal(bits(s2), bits(s)))
                    err = (y.float() - want.float()).abs().max().item()
                    sum_err = (abs(s.item() - s64) / mag if inject
                               else None)
                    del y, y2
                    bound, bound_by, nbytes = offload_bound(n, in_dt, out_dt,
                                                            inject)
                    ms = time_ms(lambda: offload_copy_cuda(
                        next(cyc), scale, out, depth, 256, inject), iters)
                    row = {"rows": rows, "dtype": f"{in_dt}->{out_dt}",
                           "depth": depth, "inject": inject,
                           "bit_equal": equal, "deterministic": same,
                           "max_abs_err": err, "sum_rel_err": sum_err,
                           "fault_rel_err": fault if inject else None,
                           "ms": ms, "gbps": gbps(nbytes, ms),
                           "bound_ms": bound, "bound_by": bound_by,
                           **base[inject], "memcpy_ms": memcpy_ms}
                    print(f"offload: K1 {rows}x{OFFLOAD_COLS} {in_dt}->"
                          f"{out_dt} depth {depth} inject {inject}: bit-"
                          f"equal {equal}, max abs {err!r}, sum error "
                          f"{sum_err!r} (tol {OFFLOAD_SUM_TOL}; a lost "
                          f"block reads {fault!r}), repeat-equal {same}; "
                          f"kernel {ms!r} ms ({row['gbps']!r} GB/s), bound "
                          f"{bound!r} ms ({gbps(nbytes, bound)!r} GB/s), "
                          f"plain {row['plain_ms']!r} ms, library "
                          f"{row['library_ms']!r} ms, memcpy {memcpy_ms!r} "
                          f"ms ({card})")
                    check(equal and err == 0 and same and (
                        not inject or sum_err <= OFFLOAD_SUM_TOL),
                        f"offload_copy disagrees with its plain version: "
                        f"{row}")
                    if inject:
                        worst_sum = max(worst_sum, sum_err)
                    if is_main and (in_dt, out_dt, depth, inject) == (
                            "float32", "bfloat16", 2, False):
                        main = row
                    rows_out.append(row)
            del copies, cyc, want, ybuf
        del x32, slabs
        torch.cuda.empty_cache()

    # bad inputs raise, and the wrapper does not fall back
    bad = {"misaligned": torch.zeros(4 * 1024 + 1, device="cuda")[1:].view(
               4, 1024),
           "ragged": torch.zeros(300, 1024, device="cuda"),
           "not 16-byte": torch.zeros(1, 3, device="cuda")}
    for name, t in bad.items():
        for fn in (lambda: offload_copy_cuda(t, block_rows=256),
                   lambda: ops.offload_copy(t, policy=OffloadPolicy(
                       offload_threshold_bytes=1))):
            try:
                fn()
            except ValueError:
                continue
            raise SmokeFailure(f"a {name} input did not raise ValueError")
    print(f"offload: {', '.join(bad)} inputs raise ValueError")

    # the path: the port of examples/offload_modes.py at the 256 MiB slab
    for name in KERNELS:
        getattr(ops, name).LAUNCHES = 0
    ops.offload_copy.INLINE = 0
    res = offload_modes.run(device="cuda", rows=OFFLOAD_ROWS[-1],
                            cols=OFFLOAD_COLS)
    torch.cuda.synchronize()
    counted = {name: getattr(ops, name).LAUNCHES for name in KERNELS}
    inline = ops.offload_copy.INLINE
    th = res["threshold"]
    print(f"offload: path launches {counted}, inline {inline}; calibrated "
          f"{res['calibration']}; tier-1 ms per 16 MB transfer "
          f"{ {r['mode']: r['ms_per_transfer'] for r in res['engine']} }; "
          f"threshold {th} ({card})")
    check(counted == {**dict.fromkeys(KERNELS, 0),
                      "offload_copy": OFFLOAD_PATH_LAUNCHES},
          f"the offload path launched {counted}, not "
          f"{OFFLOAD_PATH_LAUNCHES} offload copies and nothing else")
    check(inline == th["kernel_inline"] == 1 and th["kernel_inline_ok"]
          and (th["inline"], th["offloaded"]) == (1, 1),
          f"the threshold step: {th}, INLINE rose by {inline}")
    check(len(res["kernel"]) == OFFLOAD_PATH_LAUNCHES
          and all(r["allclose"] for r in res["kernel"]),
          f"an offload path row disagrees: {res['kernel']}")
    check(all(r["offloaded"] == (0 if r["mode"] == "sync" else 8)
              and r["submitted"] == 8 for r in res["engine"]),
          f"tier-1 engine counters: {res['engine']}")
    torch.cuda.empty_cache()
    checks = [{"configs": len(rows_out),
               "bit_equal_all": all(r["bit_equal"] for r in rows_out),
               "deterministic_all": all(r["deterministic"]
                                        for r in rows_out),
               "max_sum_rel_err": worst_sum, "sum_tol": OFFLOAD_SUM_TOL,
               "min_fault_rel_err": least_fault,
               "bad_inputs_raised": sorted(bad)},
              *({k: r[k] for k in ("rows", "dtype", "depth", "inject",
                                   "ms", "gbps")} for r in rows_out
                if r["rows"] == OFFLOAD_ROWS[-1]
                and r["dtype"].startswith("float32"))]
    return {"main": {**main, "shape": [OFFLOAD_ROWS[-1], OFFLOAD_COLS]},
            "checks": checks, "launches": counted["offload_copy"]}


def reference_phase(arch: str, prompt_len: int):
    """``arch`` at smoke width in fp32 served on the card and on the CPU
    with the same weights: equal greedy tokens, close prefill logits."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import BatchedServer, ServeConfig

    cfg = get_smoke_config(arch)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(0)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
    scfg = ServeConfig(max_len=prompt_len + 8, max_batch=4, max_new_tokens=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
               for _ in range(4)]
    toks = {}
    for name, model, params in (("cpu", cpu_model, cpu_params),
                                ("cuda", gpu_model, gpu_params)):
        srv = BatchedServer(model, params, scfg, device=name)
        batch = srv._pack(prompts)
        toks[name] = srv.generate_batch(batch)
        srv.close()
    with torch.inference_mode():
        lc, _ = cpu_model.prefill(cpu_params, {"tokens": torch.from_numpy(
            batch["tokens"])})
        lg, _ = gpu_model.prefill(gpu_params, {"tokens": torch.from_numpy(
            batch["tokens"]).cuda()})
    err = (lg.cpu() - lc).abs().max().item()
    print(f"reference: smoke {arch} fp32, {prompt_len}-token prompts, card "
          f"vs CPU: prefill logits max|diff| = {err!r}, greedy tokens equal "
          f"= {bool((toks['cpu'] == toks['cuda']).all())}")
    check(err <= 1e-4, f"card prefill logits differ from the CPU's by {err}")
    check((toks["cpu"] == toks["cuda"]).all(),
          "card and CPU greedy tokens differ")


def serve_phase(arch: str, layers: int, d_model: int, per_batch: dict,
                card: str) -> dict:
    """Full-width ``arch`` through the serve entry points; returns each
    kernel's launches counted over the driven requests."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod

    common = ["--arch", arch, "--max-batch", "8", "--new-tokens", "16",
              "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = serve_mod.build_server(serve_mod.parse_args(
        common + ["--prompt-len", "4096"]))
    torch.cuda.synchronize()
    cfg = server.model.cfg
    n_params = cfg.param_count()
    print(f"serve: built {arch} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype}, {n_params} parameters) on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    check(cfg.num_layers == layers and cfg.d_model == d_model,
          "not the full-width config")
    runs = [("pipelined", 8, 1024), ("sync", 1, 4096)]
    launches = dict.fromkeys(KERNELS, 0)
    try:
        for mode, n, plen in runs:
            args = serve_mod.parse_args(common + [
                "--requests", str(n), "--prompt-len", str(plen),
                "--mode", mode])
            batches0 = server.stats["batches"]
            for name in KERNELS:
                getattr(ops, name).LAUNCHES = 0
            kinds = ops.flash_attention.VARIANTS
            for kind in kinds:
                kinds[kind] = 0
            res = serve_mod.drive(server, args)
            counted = {name: getattr(ops, name).LAUNCHES for name in KERNELS}
            by_kind = dict(kinds)
            batches = server.stats["batches"] - batches0
            for o in res["outs"]:
                check(o.shape == (16,) and o.dtype == np.int32
                      and (o >= 0).all() and (o < cfg.vocab_size).all(),
                      f"bad reply {o!r}")
            check(len(res["outs"]) == n, "missing replies")
            check(batches >= 1, "no prefill batch")
            for name in KERNELS:
                check(counted[name] == per_batch[name] * batches,
                      f"{name} launches {counted[name]} != "
                      f"{per_batch[name]} x {batches} prefill batches")
                launches[name] += counted[name]
            # every prefill attention on the tensor-core kernel
            check(by_kind == {"wgmma": counted["flash_attention"], "simt": 0},
                  f"flash_attention kernels {by_kind}: not all tensor-core")
            dt = res["seconds"]
            print(f"serve: {arch} {mode} {n} x {plen}-token prompts, "
                  f"{res['tokens']} new tokens in {dt!r} s: "
                  f"{res['tokens'] / dt!r} tok/s, {dt / n * 1e3!r} ms/request"
                  f", {batches} prefill batch(es), launches {counted}, "
                  f"flash_attention by kernel {by_kind} ({card})")
        print(f"serve: {arch} server stats {server.stats}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({card})")

        # the same prompt twice, a batch of another size between: the same
        # tokens (state left by an earlier batch must not be read)
        rng = np.random.default_rng(5)
        p = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
        a = server.generate_batch(server._pack([p]))
        server.generate_batch(server._pack([
            rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
            for _ in range(3)]))
        b = server.generate_batch(server._pack([p]))
        check(a.shape == (1, 16) and (a == b).all(),
              "the same prompt served twice gave different tokens")
        with torch.inference_mode():
            logits, _ = server.model.prefill(server.params, {
                "tokens": torch.from_numpy(p[None]).cuda()})
        check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
              and logits.isfinite().all().item(), "non-finite logits")
        print(f"serve: {arch} deterministic replies, finite logits of shape "
              f"{tuple(logits.shape)}")
    finally:
        server.close()
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    print(f"build: {sorted(libs)} built in {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernels: float32 matmuls in full float32 "
          "(allow_tf32 = False for matmul and cudnn)")
    flash = flash_phase()
    ssd = ssd_phase()
    offload = offload_phase(card)
    reference_phase("granite-8b", 40)
    reference_phase("zamba2-2.7b", 37)     # ragged against the chunk of 8
    served = {}
    for arch, layers, d_model, per_batch in SERVED:
        served[arch] = serve_phase(arch, layers, d_model, per_batch, card)
        gc.collect()                       # free one model before the next
        torch.cuda.empty_cache()

    def entry(name, source, replaces, row, checks, launches, per_batch,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_per_batch": per_batch,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "dtype": row["dtype"],
                "shape": row["shape"], **extra, "checks": checks}

    def timed(rows, **want):
        return next(r for r in rows if "ms" in r and all(
            r[k] == v for k, v in want.items()))

    # K2 on the served path is the tensor-core kernel; the CUDA-core one
    # (fp32, bf16 at hd 16 and 32) is timed beside it on the same inputs
    fa_src = ("src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
              "src/repro/kernels/flash_attention.py:70")

    def fa_extra(row):
        return {"variant": "wgmma", "cuda_core_ms": row["simt_ms"],
                "cuda_core_source":
                    "src/repro_torch/kernels/csrc/flash_attention.cu"}

    granite = timed(flash, shape=[8, 1024, 1024, 32, 8, 128])
    zamba = timed(flash, shape=[8, 1024, 1024, 32, 32, 80])
    kernels = [
        entry("flash_attention", *fa_src, granite,
              [r for r in flash if r["shape"][5] != 80],
              served["granite-8b"]["flash_attention"], 36,
              **fa_extra(granite)),
        entry("flash_attention", *fa_src, zamba,
              [r for r in flash if r["shape"][5] == 80],
              served["zamba2-2.7b"]["flash_attention"], 9,
              **fa_extra(zamba)),
        entry("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:67",
              timed(ssd, dtype="bfloat16", shape=[8, 1024, 80, 64, 1, 64,
                                                  256]),
              ssd, served["zamba2-2.7b"]["ssd_scan"], 54),
        entry("offload_copy", "src/repro_torch/kernels/csrc/offload_copy.cu",
              "src/repro/kernels/offload_copy.py:93", offload["main"],
              offload["checks"], offload["launches"],
              OFFLOAD_PATH_LAUNCHES),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
