"""Where a served batch spends its time on the card.

Builds the server as :mod:`repro_torch.launch.serve` does, serves one warm
batch, times it once with the profiler off, then serves it under
``torch.profiler`` and prints: the host-clock prefill and decode times,
the device-busy share of the profiled batch's wall time (sum of kernel
times over wall time), and the kernels and the PyTorch operators that take
the most device time.  Needs a CUDA device.  It takes the flags of
:mod:`repro_torch.launch.serve`; the batch holds ``--requests`` prompts
(at most ``--max-batch``) and goes straight to ``generate_batch``, without
the dispatcher, so ``--mode`` does not apply.  The pipelined batch that
``chip_smoke.py`` serves:

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch granite-8b \
      --requests 8 --max-batch 8 --prompt-len 1024 --new-tokens 16
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve


TOP = 12


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def main(argv=None) -> dict:
    args = serve.parse_args(argv)
    if not (args.device.startswith("cuda") and torch.cuda.is_available()):
        raise RuntimeError("profile_serve needs a CUDA device")
    if args.requests > args.max_batch:
        raise ValueError(f"--requests {args.requests} does not fit in one "
                         f"batch of --max-batch {args.max_batch}")
    server = serve.build_server(args)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, server.model.cfg.vocab_size, args.prompt_len)
               .astype(np.int32) for _ in range(args.requests)]
    batch = server._pack(prompts)
    try:
        server.generate_batch(batch)                       # warm-up
        t0 = time.perf_counter()
        server.generate_batch(batch)
        plain_wall = time.perf_counter() - t0              # profiler off
        s0 = dict(server.stats)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.generate_batch(batch)
            wall = time.perf_counter() - t0
    finally:
        server.close()
    avgs = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                     key=_device_us, reverse=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                 key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in kernels)

    def rows(events):
        return [{"name": e.key[:90], "calls": e.count,
                 "device_ms": _device_us(e) / 1e3} for e in events[:TOP]]
    out = {
        "arch": args.arch, "batch": args.requests,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "unprofiled_wall_s": plain_wall,
        "wall_s": wall,
        "prefill_s": server.stats["prefill_s"] - s0["prefill_s"],
        "decode_s": server.stats["decode_s"] - s0["decode_s"],
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "card": torch.cuda.get_device_name(0),
        "top_kernels": rows(kernels),
        "top_ops": rows(ops),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
