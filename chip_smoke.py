#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. the card's name and power limit, from ``nvidia-smi``;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (timed);
3. kernels: each kernel's wrapper on tensors on the card against its plain
   PyTorch version at the main path's shapes and a few edge cases, with
   kernel / plain / library timings (CUDA events) and the bound;
4. reference: the smoke-width model served on the card equals the same
   model served on the CPU (the path the CPU tests hold against JAX);
5. serve: full-width granite-8b (36 layers, d_model 4096, bf16, seeded
   random weights made on the card) through the port's dispatcher and
   transfer engine — 8 pipelined 1024-token requests, then one sync
   4096-token request — with every kernel's launch count read around it.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``nvidia-smi`` name and power limit; before that one JSON line of kernels.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

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

ARCH = "granite-8b"
LAYERS = 36


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
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after a warm-up)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def skipped_tile_err(q, k, v, want) -> float:
    """The row error of a planted fault, for the bf16 gate to be set below:
    the last 64 query rows skip the K/V tile in the middle of the sequence
    (plain fp32 on the same inputs, causal, rounded to q's dtype)."""
    import torch

    b, s, h, hd = q.shape
    kh = k.shape[2]
    lo, tile = s - TILE, (s // TILE) // 2 * TILE
    qg = q[:, lo:].float().reshape(b, TILE, kh, h // kh, hd)
    scores = torch.einsum("bskge,btke->bkgst", qg, k.float()) / hd ** 0.5
    qpos = torch.arange(lo, s, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    hidden = (kpos > qpos) | ((kpos >= tile) & (kpos < tile + TILE))
    w = torch.softmax(scores.masked_fill(hidden, -1e30), dim=-1)
    o = torch.einsum("bkgst,btke->bskge", w, v.float()).reshape(b, TILE, h, hd)
    return row_rel_err(o.to(q.dtype), want[:, lo:])


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernels: float32 matmuls in full float32 "
          "(allow_tf32 = False for matmul and cudnn)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (dtype, B, S, T, H, K, hd, causal, timed)
        ("bfloat16", 8, 1024, 1024, 32, 8, 128, True, True),   # main path
        ("bfloat16", 1, 4096, 4096, 32, 8, 128, True, True),   # sync request
        ("bfloat16", 2, 192, 192, 8, 2, 64, True, False),
        ("float32", 2, 256, 256, 4, 2, 16, True, False),
        ("float32", 2, 256, 256, 8, 2, 64, True, False),
        ("float32", 2, 128, 128, 4, 4, 32, True, False),
        ("float32", 2, 64, 200, 8, 1, 32, False, False),       # S != T
        ("float32", 1, 100, 100, 4, 4, 128, True, False),      # ragged S, T
    ]
    results = []
    for dtype, b, s, t, h, kh, hd, causal, timed in cases:
        dt = getattr(torch, dtype)
        q = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, t, kh, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, t, kh, hd, generator=gen, device="cuda").to(dt)
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        row = {"dtype": dtype, "shape": [b, s, t, h, kh, hd],
               "causal": causal}
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
            fault = skipped_tile_err(q, k, v, plain)
            row.update(max_abs_err=(out.float() - plain).abs().max().item(),
                       row_rel_err=err, fault_row_rel_err=fault,
                       tol=BF16_ROW_TOL)
            check(fault > BF16_ROW_TOL,
                  f"the bf16 gate would pass a skipped K/V tile: {row}")
            ok = err <= BF16_ROW_TOL
            gate = (f"row error vs plain on fp32 upcasts = {err!r} (tol "
                    f"{BF16_ROW_TOL}; a skipped K/V tile reads {fault!r}), "
                    f"max abs {row['max_abs_err']!r}")
        print(f"kernels: flash_attention {dtype} B={b} S={s} T={t} H={h} "
              f"K={kh} hd={hd} causal={causal}: {gate}")
        check(ok and out.isfinite().all().item(),
              f"flash_attention disagrees with its plain version: {row}")
        del plain
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)

            fns = {"ms": lambda: ops.flash_attention(q, k, v, causal=causal),
                   "plain_ms": lambda: ref.flash_attention(q, k, v,
                                                           causal=causal),
                   "library_ms": library}
            lib_err = (library().transpose(1, 2).float()
                       - out.float()).abs().max().item()
            # in turns: kernel, plain, library, then again in reverse
            times = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times[key].append(time_ms(fns[key],
                                              20 if key == "ms" else 5))
            row.update({key: min(v) for key, v in times.items()})
            row["library_vs_kernel_max_abs"] = lib_err
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, t, h, kh, hd, causal, dtype)
            print(f"kernels: flash_attention {dtype} B={b} S={s}: kernel "
                  f"{row['ms']!r} ms, plain {row['plain_ms']!r} ms, "
                  f"sdpa {row['library_ms']!r} ms, bound {row['bound_ms']!r}"
                  f" ms ({row['bound_by']})")
        results.append(row)
        del q, k, v, out
    torch.cuda.empty_cache()
    return results


def reference_phase():
    """Smoke-width granite-8b in fp32 served on the card and on the CPU
    with the same weights: equal greedy tokens, close prefill logits."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import BatchedServer, ServeConfig

    cfg = get_smoke_config(ARCH)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(0)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
    scfg = ServeConfig(max_len=48, max_batch=4, max_new_tokens=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
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
    print(f"reference: smoke {ARCH} fp32 card vs CPU: prefill logits "
          f"max|diff| = {err!r}, greedy tokens equal = "
          f"{bool((toks['cpu'] == toks['cuda']).all())}")
    check(err <= 1e-4, f"card prefill logits differ from the CPU's by {err}")
    check((toks["cpu"] == toks["cuda"]).all(),
          "card and CPU greedy tokens differ")


def serve_phase(card: str) -> int:
    """Full-width granite-8b through the serve entry points; returns the
    flash kernel's launches counted over the driven requests."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod

    common = ["--arch", ARCH, "--max-batch", "8", "--new-tokens", "16",
                  "--device", "cuda"]
    t0 = time.perf_counter()
    server = serve_mod.build_server(serve_mod.parse_args(
        common + ["--prompt-len", "4096"]))
    torch.cuda.synchronize()
    cfg = server.model.cfg
    n_params = cfg.param_count()
    print(f"serve: built {ARCH} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype}, {n_params} parameters) on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    check(cfg.num_layers == LAYERS and cfg.d_model == 4096,
          "not the full-width config")
    runs = [("pipelined", 8, 1024), ("sync", 1, 4096)]
    launches = 0
    try:
        for mode, n, plen in runs:
            args = serve_mod.parse_args(common + [
                "--requests", str(n), "--prompt-len", str(plen),
                "--mode", mode])
            batches0 = server.stats["batches"]
            ops.flash_attention.LAUNCHES = 0
            res = serve_mod.drive(server, args)
            n_launch = ops.flash_attention.LAUNCHES
            batches = server.stats["batches"] - batches0
            launches += n_launch
            for o in res["outs"]:
                check(o.shape == (16,) and o.dtype == np.int32
                      and (o >= 0).all() and (o < cfg.vocab_size).all(),
                      f"bad reply {o!r}")
            check(len(res["outs"]) == n, "missing replies")
            check(batches >= 1 and n_launch == LAYERS * batches,
                  f"flash launches {n_launch} != {LAYERS} x {batches} "
                  "prefill batches")
            dt = res["seconds"]
            print(f"serve: {mode} {n} x {plen}-token prompts, "
                  f"{res['tokens']} new tokens in {dt!r} s: "
                  f"{res['tokens'] / dt!r} tok/s, {dt / n * 1e3!r} ms/request"
                  f", {batches} prefill batch(es), flash launches {n_launch}"
                  f" ({card})")
        print(f"serve: server stats {server.stats}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # same prompt twice -> same tokens
        p = np.random.default_rng(5).integers(0, cfg.vocab_size, 512).astype(
            np.int32)
        a = server.generate_batch(server._pack([p]))
        b = server.generate_batch(server._pack([p]))
        check(a.shape == (1, 16) and (a == b).all(),
              "the same prompt served twice gave different tokens")
        with torch.inference_mode():
            logits, _ = server.model.prefill(server.params, {
                "tokens": torch.from_numpy(p[None]).cuda()})
        check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
              and logits.isfinite().all().item(), "non-finite logits")
        print("serve: deterministic replies, finite logits of shape "
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

    checks = kernel_phase()
    reference_phase()
    launches = serve_phase(card)

    main_row = checks[0]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:70",
        "launches": launches,
        "launches_per_batch": LAYERS,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "checks": checks,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
