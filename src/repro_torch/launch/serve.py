"""Serving CLI: batched generation server with the ROCKET dispatcher.

Port of ``src/repro/launch/serve.py``, with the same flags plus
``--device`` (default ``cuda``).  Weights and prompts come from seed 0.
The dense (granite-8b) and hybrid (zamba2-2.7b) families are served.  Full
width on one card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --requests 8 --prompt-len 1024 --new-tokens 16 --max-batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --requests 8 --prompt-len 1024 --new-tokens 16 --max-batch 8

CPU-scale example:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --smoke --device cpu --requests 16 --mode pipelined
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import ExecutionMode, OffloadPolicy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchedServer, ServeConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--mode", default="pipelined",
                    choices=["sync", "async", "pipelined"])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_server(args: argparse.Namespace) -> BatchedServer:
    """The model (random weights from seed 0, made on the device) behind
    a :class:`BatchedServer` sized for ``--prompt-len`` + ``--new-tokens``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    scfg = ServeConfig(max_len=args.prompt_len + args.new_tokens,
                       max_batch=args.max_batch, max_new_tokens=args.new_tokens)
    policy = OffloadPolicy(mode=ExecutionMode(args.mode),
                           max_batch=args.max_batch,
                           offload_threshold_bytes=1 << 12)
    return BatchedServer(model, params, scfg, policy, device=args.device)


def drive(server: BatchedServer, args: argparse.Namespace) -> dict:
    """Send ``--requests`` random prompts through the dispatcher in
    ``--mode``; returns the replies, the wall time and the counters."""
    vocab = server.model.cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    with server.make_dispatcher() as dispatcher:
        t0 = time.perf_counter()
        if args.mode == "sync":
            outs = [dispatcher.request("generate", p, mode="sync")
                    for p in prompts]
        else:
            jids = [dispatcher.request("generate", p, mode=args.mode)
                    for p in prompts]
            outs = [dispatcher.query(j) for j in jids]
        dt = time.perf_counter() - t0
    return {"outs": outs, "seconds": dt,
            "tokens": sum(o.size for o in outs),
            "batches": dispatcher.stats.batches,
            "mean_batch": dispatcher.stats.mean_batch,
            "query_polls": dispatcher.stats.query_polls}


def main(argv=None) -> dict:
    args = parse_args(argv)
    server = build_server(args)
    try:
        res = drive(server, args)
        dt, n_tok = res["seconds"], res["tokens"]
        print(f"{args.requests} requests, {n_tok} tokens in {dt:.2f}s "
              f"({n_tok / dt:.1f} tok/s, {dt / args.requests * 1e3:.1f} "
              f"ms/req) on {server.device}")
        print(f"server stats: {server.stats}")
        print(f"dispatcher: batches={res['batches']} "
              f"mean_batch={res['mean_batch']:.2f} "
              f"query_polls={res['query_polls']}")
        res["server"] = dict(server.stats)
        return res
    finally:
        server.close()


if __name__ == "__main__":
    main()
