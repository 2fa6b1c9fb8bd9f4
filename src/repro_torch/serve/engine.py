"""Serving runtime: batched prefill/decode over a preallocated KV cache.

Port of ``src/repro/serve/engine.py`` (``serve_over_ipc`` and the
snapshot/restore pair come with the shared-memory fabric).

ROCKET integration, as in the JAX package:
- the :class:`~repro_torch.core.dispatcher.RequestDispatcher` front-end
  batches requests (pipelined mode) before they reach the device — the
  paper's application-level request batching;
- host→device prompt transfer goes through the tier-1
  :class:`~repro_torch.core.engine.AsyncTransferEngine`;
- the KV cache is one persistent device buffer: where the JAX server
  donates it through ``jit``, this server allocates it once and every
  prefill and decode step writes into it in place.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.dispatcher import RequestDispatcher
from repro_torch.core.engine import AsyncTransferEngine
from repro_torch.core.policy import OffloadPolicy
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelAPI
from repro_torch.obs import trace as _trace

# the profiler range around a batch's prefill; launch/profile_serve.py splits
# a batch's device time into prefill and decode by it
PREFILL_RANGE = "serve.prefill"


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    max_batch: int = 8
    max_new_tokens: int = 32


class BatchedServer:
    """Batch-synchronous generation server over a fixed slot count."""

    def __init__(self, model: ModelAPI, params, scfg: ServeConfig,
                 policy: OffloadPolicy = OffloadPolicy(), device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model built for {model.device}, server asked "
                             f"for {self.device}")
        self.model = model
        self.params = params
        self.scfg = scfg
        self.policy = policy
        self.engine = AsyncTransferEngine(policy, device=self.device)
        self._cache = model.init_cache(scfg.max_batch, scfg.max_len)
        # one batch at a time owns the cache (two dispatchers, or a direct
        # caller beside one, would otherwise interleave writes into it)
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "tokens_out": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cache_for(self, b: int) -> dict:
        if self._cache["k"].shape[1] < b:       # grow once for a wider batch
            self._cache = None                  # free the old one first
            self._cache = self.model.init_cache(b, self.scfg.max_len)
        return self._cache

    # -- core batched generation ------------------------------------------------
    def generate_batch(self, batch: dict, new_tokens: Optional[int] = None
                       ) -> np.ndarray:
        n_new = new_tokens or self.scfg.max_new_tokens
        b, s = batch["tokens"].shape
        if s + n_new - 1 > self.scfg.max_len:
            raise ValueError(f"prompt {s} + {n_new} new tokens exceeds "
                             f"max_len {self.scfg.max_len}")
        tt0 = _trace.now() if _trace.TRACE.enabled else 0
        with self._lock, torch.inference_mode():
            t0 = time.perf_counter()
            with record_function(PREFILL_RANGE):
                dev_batch = self.engine.submit(batch).get()
                logits, cache = self.model.prefill(self.params, dev_batch,
                                                   cache=self._cache_for(b))
                self._sync()
            self.stats["prefill_s"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            tok = logits[:, -1, :].argmax(-1).to(torch.int32)[:, None]
            outs = [tok]
            for _ in range(n_new - 1):
                logits, cache = self.model.decode_step(self.params, cache, tok)
                tok = logits[:, -1, :].argmax(-1).to(torch.int32)[:, None]
                outs.append(tok)
            result = torch.cat(outs, dim=1).cpu().numpy()
            self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["batches"] += 1
        self.stats["tokens_out"] += result.size
        if tt0:
            _trace.emit(_trace.SERVE_BATCH, tt0, arg=result.shape[0])
        return result

    # -- request-level API (dispatcher integration) ------------------------------
    def make_dispatcher(self) -> RequestDispatcher:
        d = RequestDispatcher(self.policy)

        def single(data: np.ndarray) -> np.ndarray:
            self.stats["requests"] += 1
            return self.generate_batch(self._pack([data]))[0]

        def batched(datas: list[np.ndarray]) -> list[np.ndarray]:
            self.stats["requests"] += len(datas)
            out = self.generate_batch(self._pack(datas))
            return [out[i] for i in range(len(datas))]

        def batched_slab(slab: np.ndarray, shapes) -> list[np.ndarray]:
            # single-copy datapath: the dispatcher's batch-formation gather
            # already left-aligned + zero-padded every prompt into ``slab``
            # — exactly what _pack would build — so wrap it without another
            # per-row packing copy
            self.stats["requests"] += len(shapes)
            out = self.generate_batch(self._wrap(slab))
            return [out[i] for i in range(len(shapes))]

        d.register_handler("generate", single, batch_fn=batched,
                           slab_fn=batched_slab)
        return d

    def _pack(self, prompts: list[np.ndarray]) -> dict:
        """Left-align prompts into a fixed (B, S) slab (persistent shape)."""
        s = max(int(p.shape[-1]) for p in prompts)
        toks = np.zeros((len(prompts), s), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : p.shape[-1]] = p
        return self._wrap(toks)

    def _wrap(self, toks: np.ndarray) -> dict:
        """Model-input dict around an already-packed (B, S) token slab."""
        return {"tokens": np.ascontiguousarray(toks.astype(np.int32,
                                                           copy=False))}

    def close(self):
        self.engine.close()
