"""The ROCKET core in isolation: calibrate the latency model, then drive the
tier-1 transfer engine and the tier-3 offload-copy kernel through the
paper's configuration space (mode x device x injection).

Port of ``examples/offload_modes.py``, with ``--device`` (default ``cuda``)
and ``--rows``/``--cols`` for the tier-3 slab (default 65536 x 1024 fp32,
256 MiB, the largest message of the paper's payload sweep).  On the card:

  PYTHONPATH=src python -m repro_torch.launch.offload_modes

On the host, at a small slab:

  PYTHONPATH=src python -m repro_torch.launch.offload_modes --device cpu \\
      --rows 1024 --cols 256

The four steps are the example's: (1) calibrate ``L = L_fixed + a * MB``
from host-to-device copies; (2) the tier-1 engine in each mode over
16 MB x 8 transfers; (3) the size threshold: a 256 B and a 4 MB payload
through the engine, and the 256 B one through ``ops.offload_copy`` too,
which keeps it inline; (4) ``ops.offload_copy`` over mode x injection
against the plain version.  As in the reference, ``ops.offload_copy``
ignores ``policy.pipeline_depth``, so the pipelined row runs at depth 2,
the same as async.  ``run`` returns every row as a dict.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import AsyncTransferEngine
from repro_torch.core.latency import calibrate
from repro_torch.core.policy import ExecutionMode, OffloadPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

SCALE = 2.0
SEED = 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--cols", type=int, default=1024)
    return ap.parse_args(argv)


def _transfer_fn(dev: torch.device):
    """One complete host-to-``dev`` copy of a numpy buffer."""
    if dev.type == "cuda":
        def put(buf):
            torch.from_numpy(buf).to(dev)
            torch.cuda.synchronize(dev)
    else:
        def put(buf):
            torch.from_numpy(buf).clone()
    return put


def run(device="cuda", rows: int = 65536, cols: int = 1024) -> dict:
    dev = resolve_device(device)
    out = {"device": str(dev), "shape": [rows, cols]}

    # 1. per-node calibration (the paper's deployment-time profiling script)
    model = calibrate(_transfer_fn(dev),
                      sizes_bytes=(1 << 18, 1 << 20, 1 << 22), repeats=5)
    out["calibration"] = {
        "l_fixed_us": model.l_fixed_us,
        "alpha_us_per_mb": model.alpha_us_per_mb,
        "bandwidth_gbps": model.bandwidth_gbps(), "rel_std": model.rel_std}
    print(f"calibrated: L = {model.l_fixed_us:.1f}us "
          f"+ {model.alpha_us_per_mb:.2f}us/MB "
          f"(implied bw {model.bandwidth_gbps():.0f} GB/s, "
          f"rel std {model.rel_std:.0%})")

    # 2. tier-1: engine modes over a 16MB message stream
    buf = np.ones((4 << 20,), np.float32)
    print("\ntier-1 engine (16MB x 8 transfers):")
    out["engine"] = []
    for mode in ExecutionMode:
        pol = OffloadPolicy(mode=mode, offload_threshold_bytes=1,
                            pipeline_depth=3)
        with AsyncTransferEngine(pol, latency=model, device=dev) as eng:
            t0 = time.perf_counter()
            jobs = [eng.submit(buf) for _ in range(8)]
            for j in jobs:
                j.get()
            ms = (time.perf_counter() - t0) / 8 * 1e3
        s = eng.stats
        out["engine"].append({
            "mode": mode.value, "ms_per_transfer": ms,
            "submitted": s.submitted, "bytes_moved": s.bytes_moved,
            "inline": s.inline, "offloaded": s.offloaded, "polls": s.polls})
        print(f"  {mode.value:10s} {ms:7.2f} ms/transfer  "
              f"offloaded={s.offloaded} polls={s.polls}")

    # 3. the size threshold (offload control): small stays inline, at tier 1
    # and at tier 3 alike
    pol = OffloadPolicy(mode=ExecutionMode.ASYNC,
                        offload_threshold_bytes=1 << 20)
    with AsyncTransferEngine(pol, latency=model, device=dev) as eng:
        eng.submit(np.ones(64, np.float32)).get()       # 256B  -> inline
        eng.submit(np.ones(1 << 20, np.float32)).get()  # 4MB   -> offload
    inline0 = ops.offload_copy.INLINE
    small = torch.ones(1, 64, device=dev)
    y, _ = ops.offload_copy(small, scale=SCALE, policy=pol)
    out["threshold"] = {"inline": eng.stats.inline,
                        "offloaded": eng.stats.offloaded,
                        "kernel_inline": ops.offload_copy.INLINE - inline0,
                        "kernel_inline_ok": bool(torch.equal(y, small * SCALE))}
    print(f"\nthreshold: inline={eng.stats.inline} "
          f"offloaded={eng.stats.offloaded} (paper Table III 'Data Size'); "
          f"tier 3 kept the 256B copy inline: "
          f"{out['threshold']['kernel_inline'] == 1}")

    # 4. tier-3: the offload-copy kernel (its plain version on the CPU)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(rows, cols, generator=gen, device=dev)
    print(f"\ntier-3 offload_copy kernel (mode x injection), "
          f"x {tuple(x.shape)} fp32:")
    out["kernel"] = []
    for mode in ("sync", "async", "pipelined"):
        for inject in (False, True):
            pol = OffloadPolicy(mode=ExecutionMode(mode),
                                offload_threshold_bytes=1,
                                cache_injection=inject)
            y, total = ops.offload_copy(x, scale=SCALE, policy=pol,
                                        inject=inject)
            yr, tr = ref.offload_copy(x, scale=SCALE, inject=inject)
            row = {"mode": mode, "inject": inject,
                   "depth": ops.mode_depth(mode),
                   "allclose": bool(torch.allclose(y, yr, atol=1e-5)),
                   "max_abs_err": (y - yr).abs().max().item()}
            if inject:
                row["fused_sum"] = total.item()
                row["plain_sum"] = tr.item()
            out["kernel"].append(row)
            extra = f" fused_sum={row['fused_sum']:.1f}" if inject else ""
            print(f"  mode={mode:10s} inject={str(inject):5s} "
                  f"allclose={row['allclose']}{extra}")
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.device, args.rows, args.cols)


if __name__ == "__main__":
    main()
