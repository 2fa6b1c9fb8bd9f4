"""Size-aware transfer-latency model  L = L_fixed + α · size_MB  (§IV-C).

The paper calibrates (L_fixed, α) per machine with a helper script and uses
``sleep(0.95·L)`` to defer completion checks before passive waiting.  We do
the same for tier-1 (host→device) transfers, and reuse the same model
*structurally* for tier-3: the DMA pipeline depth of a kernel is chosen so
that one block's compute covers one block's predicted copy latency.

Copied from ``src/repro/core/latency.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, asdict
from typing import Callable, Optional, Sequence

import numpy as np

MB = float(1 << 20)


@dataclass(frozen=True)
class LatencyModel:
    l_fixed_us: float = 73.6          # paper's measured constants as priors
    alpha_us_per_mb: float = 33.4
    rel_std: float = 0.0              # calibration dispersion (<2% in paper)

    def predict_us(self, nbytes: int) -> float:
        return self.l_fixed_us + self.alpha_us_per_mb * (nbytes / MB)

    def defer_seconds(self, nbytes: int, fraction: float = 0.95) -> float:
        return fraction * self.predict_us(nbytes) * 1e-6

    # -- roofline helpers (tier 2/3: structural use of the same model) ------
    def bandwidth_gbps(self) -> float:
        """Asymptotic bandwidth implied by α."""
        if self.alpha_us_per_mb <= 0:
            return float("inf")
        return (MB / (self.alpha_us_per_mb * 1e-6)) / 1e9

    def pipeline_depth_for(self, block_bytes: int, compute_us_per_block: float,
                           max_depth: int = 8) -> int:
        """Buffers needed so compute hides the predicted copy latency."""
        if compute_us_per_block <= 0:
            return max_depth
        need = int(np.ceil(self.predict_us(block_bytes) / compute_us_per_block)) + 1
        return int(np.clip(need, 2, max_depth))


class ServiceTimeModel:
    """Online service-time predictor for SLO admission (load shedding).

    Layers a per-op EWMA of *observed* handler service time over the
    structural transfer model: ``predict_s(op, nbytes)`` returns the max
    of the transfer-latency prediction and the op's observed EWMA, so the
    dispatcher can ask "will this request make its deadline if I run it
    now?" before spending a batch slot on it.  Before the first
    observation the transfer model alone answers (microseconds — the
    model never sheds a request it knows nothing about), and every
    completed batch tightens the estimate (`observe` with the per-request
    share of the batch's wall time).
    """

    def __init__(self, latency: Optional[LatencyModel] = None,
                 ewma: float = 0.2):
        self.latency = latency or LatencyModel()
        self.ewma = ewma
        self._per_op: dict = {}

    def observe(self, op: str, seconds: float) -> None:
        """Feed one request's observed service time (batch share)."""
        prev = self._per_op.get(op)
        self._per_op[op] = (seconds if prev is None
                            else (1 - self.ewma) * prev + self.ewma * seconds)

    def predict_s(self, op: str, nbytes: int = 0) -> float:
        """Predicted service seconds for one request of ``op``."""
        floor = self.latency.predict_us(nbytes) * 1e-6
        return max(floor, self._per_op.get(op, 0.0))

    def snapshot(self) -> dict:
        """Per-op EWMA milliseconds (introspection/metrics)."""
        return {f"{op}_ms": s * 1e3 for op, s in sorted(self._per_op.items())}


def calibrate(transfer_fn: Callable[[np.ndarray], None],
              sizes_bytes: Sequence[int] = (1 << 16, 1 << 18, 1 << 20,
                                            1 << 22, 1 << 23),
              repeats: int = 20) -> LatencyModel:
    """The paper's per-node recalibration helper: measure, fit, check std-dev.

    ``transfer_fn`` performs (and completes) one transfer of the given buffer.
    """
    xs, ys, rels = [], [], []
    for size in sizes_bytes:
        buf = np.ones(size, np.uint8)
        transfer_fn(buf)                                   # warm-up / first-touch
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            transfer_fn(buf)
            ts.append((time.perf_counter() - t0) * 1e6)
        ts = np.asarray(ts)
        med = float(np.median(ts))
        xs.append(size / MB)
        ys.append(med)
        rels.append(float(np.std(ts) / max(med, 1e-9)))
    a, b = np.polyfit(np.asarray(xs), np.asarray(ys), 1)
    return LatencyModel(l_fixed_us=max(float(b), 0.0),
                        alpha_us_per_mb=max(float(a), 0.0),
                        rel_std=float(np.mean(rels)))


# ---------------------------------------------------------------------------
# persistence (per-node cache, like the paper's deployment-time profiling)
# ---------------------------------------------------------------------------

def save(model: LatencyModel, path: str) -> None:
    with open(path, "w") as f:
        json.dump(asdict(model), f)


def load(path: str) -> Optional[LatencyModel]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return LatencyModel(**json.load(f))
