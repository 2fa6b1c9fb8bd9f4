"""Where a served batch spends its time on the card.

Builds the server as :mod:`repro_torch.launch.serve` does, serves one warm
batch, times it once with the profiler off, then serves it under
``torch.profiler`` and prints: the host-clock prefill and decode times of
both passes, the device-busy share of the profiled batch's wall time (sum
of kernel times over wall time), the kernels and the PyTorch operators
that take the most device time, and each hand-written kernel's device
time and its share of the prefill.  The trace is split into prefill and
decode by the server's ``PREFILL_RANGE``: the kernels that start inside
it are the prefill's, the rest the decode's.  The decode's host-bound
share is the share of its unprofiled host time in which the card runs no
decode kernel (the profiler slows the host, not the kernels).
Needs a CUDA device.  It takes the flags of :mod:`repro_torch.launch.serve`;
the batch holds ``--requests`` prompts (at most ``--max-batch``) and goes
straight to ``generate_batch``, without the dispatcher, so ``--mode`` does
not apply.  The pipelined batches that ``chip_smoke.py`` serves:

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch granite-8b \
      --requests 8 --max-batch 8 --prompt-len 1024 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch zamba2-2.7b \
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
from repro_torch.serve.engine import PREFILL_RANGE


TOP = 12
# the port's hand-written kernels, by the names of their CUDA functions
# ("flash_fwd" also matches the tensor-core "flash_fwd_wgmma")
PORT_KERNELS = {"flash_attention": "flash_fwd", "ssd_scan": "ssd_fwd"}


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
        s0 = dict(server.stats)
        t0 = time.perf_counter()
        server.generate_batch(batch)
        plain_wall = time.perf_counter() - t0              # profiler off
        s1 = dict(server.stats)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.generate_batch(batch)
            wall = time.perf_counter() - t0
    finally:
        server.close()
    events = prof.events()
    ranges = [e for e in events if e.name == PREFILL_RANGE
              and e.device_type == DeviceType.CPU]
    if len(ranges) != 1:
        raise RuntimeError(f"{len(ranges)} {PREFILL_RANGE} ranges in the "
                           "trace of one batch")
    span = ranges[0].time_range

    def in_prefill(e) -> bool:
        return span.start <= e.time_range.start <= span.end

    # device events, without the profiler's device copy of the range itself
    launched = [e for e in events if e.device_type == DeviceType.CUDA
                and e.name != PREFILL_RANGE]
    busy_us = sum(_device_us(e) for e in launched)
    prefill_busy_us = sum(_device_us(e) for e in launched if in_prefill(e))
    decode_busy_s = (busy_us - prefill_busy_us) / 1e6
    avgs = [e for e in prof.key_averages() if _device_us(e) > 0
            and e.key != PREFILL_RANGE]
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                     key=_device_us, reverse=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                 key=_device_us, reverse=True)
    prefill_s = s1["prefill_s"] - s0["prefill_s"]
    decode_s = s1["decode_s"] - s0["decode_s"]
    port = {}
    for name, fn in PORT_KERNELS.items():
        hits = [e for e in launched if fn in e.name]
        # the port's kernels run in the prefill only: one outside the range
        # means the trace's device and host clocks are not aligned
        if not all(in_prefill(e) for e in hits):
            raise RuntimeError(f"{fn} launches fall outside {PREFILL_RANGE}")
        us = sum(_device_us(e) for e in hits)
        port[name] = {"calls": len(hits), "device_ms": us / 1e3,
                      "share_of_prefill": us / 1e6 / prefill_s}

    def rows(events):
        return [{"name": e.key[:90], "calls": e.count,
                 "device_ms": _device_us(e) / 1e3} for e in events[:TOP]]
    out = {
        "arch": args.arch, "batch": args.requests,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "unprofiled_wall_s": plain_wall,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "profiled_wall_s": wall,
        "profiled_prefill_s": server.stats["prefill_s"] - s1["prefill_s"],
        "profiled_decode_s": server.stats["decode_s"] - s1["decode_s"],
        "device_busy_s": busy_us / 1e6,
        "device_busy_share_of_profiled_wall": busy_us / 1e6 / wall,
        "prefill_device_busy_s": prefill_busy_us / 1e6,
        "decode_device_busy_s": decode_busy_s,
        "decode_host_bound_share": 1.0 - decode_busy_s / decode_s,
        "port_kernels": port,
        "card": torch.cuda.get_device_name(0),
        "top_kernels": rows(kernels),
        "top_ops": rows(ops),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
