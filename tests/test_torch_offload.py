"""The offload copy in the port: the plain PyTorch version and the wrapper
``ops.offload_copy`` on CPU tensors against the JAX package's plain version
(``ref.offload_copy``) and its Pallas kernel (interpret mode); the wrapper's
policy dispatch (threshold, ``Device.INLINE``, mode to depth, injection)
against the JAX package's; the launcher's input checks; and the port of
``examples/offload_modes.py`` on the CPU against the JAX engine under the
same policies.  The kernel itself is held against the plain version on the
card by ``test_torch_cuda.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import AsyncTransferEngine as JaxEngine
from repro.core.policy import Device as JaxDevice
from repro.core.policy import ExecutionMode as JaxMode
from repro.core.policy import OffloadPolicy as JaxPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.offload_copy import offload_copy_pallas
from repro_torch.core.policy import Device, ExecutionMode, OffloadPolicy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.offload_copy import MAX_DEPTH, check_inputs
from repro_torch.launch import offload_modes

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)

PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "float32"), ("bfloat16", "bfloat16")]
MODES = ["sync", "async", "pipelined"]
_INT = {2: np.int16, 4: np.int32}


def sum_ok(got, want) -> bool:
    """The bound of tests/test_kernels.py: the sums differ only in the
    order of addition."""
    return abs(float(got) - float(want)) <= abs(float(want)) * 1e-2 + 1e-2


@functools.lru_cache(maxsize=None)
def _slab(dtype: str, shape=(512, 256), seed: int = 0):
    """The same seeded slab in both packages, as (torch, jax)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(dtype))


def bits(a) -> np.ndarray:
    """The raw bits of a torch or JAX array, as integers."""
    if isinstance(a, torch.Tensor):
        return a.view(getattr(torch, f"int{8 * a.element_size()}")).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_both_packages_get_the_same_slab(in_dtype):
    xt, xj = _slab(in_dtype)
    np.testing.assert_array_equal(bits(xt), bits(xj))


@pytest.mark.parametrize("scale", [1.5, 0.1])
@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("in_dtype,out_dtype", PAIRS)
def test_offload_copy_matches_jax(in_dtype, out_dtype, depth, inject, scale):
    """y bit-equal to the JAX plain version and to the Pallas kernel at
    every ring depth; the sum within tests/test_kernels.py's bound."""
    xt, xj = _slab(in_dtype)
    yr, sr = jref.offload_copy(xj, scale=scale, out_dtype=out_dtype,
                               inject=inject)
    yp, sp = offload_copy_pallas(xj, scale=scale, out_dtype=out_dtype,
                                 depth=depth, block_rows=128, inject=inject,
                                 interpret=True)
    out = getattr(torch, out_dtype)
    pol = OffloadPolicy(mode=ExecutionMode.PIPELINED,
                        offload_threshold_bytes=1, cache_injection=False)
    got = [ref.offload_copy(xt, scale=scale, out_dtype=out, inject=inject),
           ops.offload_copy(xt, scale=scale, out_dtype=out, depth=depth,
                            block_rows=128, inject=inject, policy=pol)]
    np.testing.assert_array_equal(bits(yp), bits(yr))
    for y, s in got:
        assert y.dtype == out and y.shape == xt.shape
        np.testing.assert_array_equal(bits(y), bits(yr))
        if inject:
            assert s.dtype == torch.float32 and s.dim() == 0
            assert sum_ok(s, sr) and sum_ok(s, sp), (float(s), float(sr),
                                                     float(sp))
        else:
            assert s is None


@pytest.mark.parametrize("mode,depth,want", [
    # src/repro/kernels/ops.py:36-37: {sync: 1, async: 2,
    # pipelined: max(depth, 2)}
    ("sync", 1, 1), ("sync", 4, 1), ("async", 1, 2), ("async", 4, 2),
    ("pipelined", 1, 2), ("pipelined", 2, 2), ("pipelined", 3, 3),
    ("pipelined", 8, 8)])
def test_mode_depth_matches_the_reference_table(mode, depth, want):
    assert ops.mode_depth(mode, depth) == want
    assert ops.mode_depth(ExecutionMode(mode), depth) == want


def test_pipelined_depth_ignores_the_policy_pipeline_depth(monkeypatch):
    """The reference's quirk, kept: the ring's depth comes from the call's
    ``depth`` (default 2), never from ``policy.pipeline_depth``."""
    seen = []
    monkeypatch.setattr(ops, "ring_depth",
                        lambda shape, d, br: seen.append(d) or d)
    xt, _ = _slab("float32")
    for mode in MODES:
        ops.offload_copy(xt, policy=OffloadPolicy(
            mode=ExecutionMode(mode), offload_threshold_bytes=1,
            pipeline_depth=8))
    assert seen == [1, 2, 2]


@pytest.mark.parametrize("threshold,device,inline", [
    (1 << 20, "offload", True),     # 512 KB below the threshold
    (1, "offload", False),
    (1, "inline", True)])           # Device.INLINE: never offloaded
def test_threshold_and_inline_device_dispatch(threshold, device, inline):
    xt, xj = _slab("float32")
    pol = OffloadPolicy(mode=ExecutionMode.ASYNC, device=Device(device),
                        offload_threshold_bytes=threshold)
    jpol = JaxPolicy(mode=JaxMode.ASYNC, device=JaxDevice(device),
                     offload_threshold_bytes=threshold)
    assert jpol.should_offload(xt.numel() * 4) == (not inline)
    inline0, launches0 = ops.offload_copy.INLINE, ops.offload_copy.LAUNCHES
    y, s = ops.offload_copy(xt, scale=1.5, policy=pol)
    assert ops.offload_copy.INLINE - inline0 == int(inline)
    assert ops.offload_copy.LAUNCHES == launches0     # CPU: no kernel
    jy, js = jops.offload_copy(xj, scale=1.5, policy=jpol)
    np.testing.assert_array_equal(bits(y), bits(jy))
    assert (s is None) == (js is None)      # async injects by default
    if s is not None:
        assert sum_ok(s, js)


def test_the_inline_branch_takes_any_shape():
    """Below the threshold nothing of the kernel's contract applies, as in
    the reference (a ragged or 1-D payload stays inline)."""
    pol = OffloadPolicy(offload_threshold_bytes=1 << 20)
    for shape in ((300, 128), (64,)):
        x = torch.ones(shape)
        y, _ = ops.offload_copy(x, scale=2.0, policy=pol)
        assert torch.equal(y, 2 * x)


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("cache", [None, True, False])
@pytest.mark.parametrize("mode", MODES)
def test_injection_follows_the_policy(mode, cache, inject):
    """``inject or policy.injection_enabled()``, on both branches, against
    the JAX policy's answer."""
    want = inject or JaxPolicy(mode=JaxMode(mode),
                               cache_injection=cache).injection_enabled()
    xt, _ = _slab("float32")
    for threshold in (1, 1 << 30):
        _, s = ops.offload_copy(xt, inject=inject, policy=OffloadPolicy(
            mode=ExecutionMode(mode), cache_injection=cache,
            offload_threshold_bytes=threshold))
        assert (s is not None) == want


@pytest.mark.parametrize("shape,block_rows", [
    ((300, 128), 256), ((384, 128), 256), ((96, 128), 64), ((4096,), 256)])
def test_slab_contract_violations_raise(shape, block_rows):
    """R not a multiple of block_rows (or not a 2-D slab) raises above the
    threshold, as the TPU kernel's assertion does."""
    with pytest.raises(AssertionError):
        offload_copy_pallas(jnp.zeros(shape), block_rows=block_rows,
                            interpret=True)
    with pytest.raises(ValueError):
        ops.offload_copy(torch.zeros(shape), block_rows=block_rows,
                         policy=OffloadPolicy(offload_threshold_bytes=1))


def _misaligned():
    return torch.zeros(4 * 128 + 1)[1:].view(4, 128)


@pytest.mark.parametrize("make,kw,err,match", [
    (lambda: torch.zeros(4, 128, 2), {}, ValueError, "2-D"),
    (lambda: torch.zeros(300, 128), {}, ValueError, "multiple of block_rows"),
    (lambda: torch.zeros(4096, 128), {"block_rows": 1, "depth": 16},
     ValueError, "depth"),
    (lambda: torch.zeros(4, 128, dtype=torch.float16), {}, TypeError,
     "dtype"),
    (lambda: torch.zeros(4, 128), {"out_dtype": torch.int32}, TypeError,
     "dtype"),
    (lambda: torch.zeros(1, 3), {}, ValueError, "16 bytes"),
    (lambda: torch.zeros(128, 8).t(), {}, ValueError, "contiguous"),
    (_misaligned, {}, ValueError, "aligned"),
    (lambda: torch.zeros(4, 128), {}, ValueError, "CUDA"),
])
def test_kernel_launcher_validates_inputs(make, kw, err, match):
    x = make()
    kw = {"depth": 2, "block_rows": 256, **kw}
    with pytest.raises(err, match=match):
        check_inputs(x, kw.get("out_dtype", x.dtype), kw["depth"],
                     kw["block_rows"])


def test_the_kernel_takes_the_deepest_ring_it_is_built_for():
    x = torch.zeros(4096, 128)
    with pytest.raises(ValueError, match="CUDA"):       # past every shape check
        check_inputs(x, x.dtype, MAX_DEPTH, 1)


def test_a_deep_pipelined_ring_is_clamped_to_the_kernel():
    """``pipelined`` at depth 16 on a slab of 4,096 rows (16 blocks of 256):
    y and the sum equal the JAX package's, and the ring the wrapper hands
    the kernel is clamped at the deepest it is built for, so the launcher
    takes it (every check up to the device passes)."""
    xt, xj = _slab("float32", (4096, 256), seed=4)
    pol = OffloadPolicy(mode=ExecutionMode.PIPELINED,
                        offload_threshold_bytes=1)
    jpol = JaxPolicy(mode=JaxMode.PIPELINED, offload_threshold_bytes=1)
    y, s = ops.offload_copy(xt, scale=0.1, depth=16, inject=True, policy=pol)
    jy, js = jops.offload_copy(xj, scale=0.1, depth=16, inject=True,
                               policy=jpol)
    np.testing.assert_array_equal(bits(y), bits(jy))
    assert sum_ok(s, js)
    ring = ops.kernel_depth(xt.shape, pol.mode, 16, 256)
    assert ring == MAX_DEPTH
    with pytest.raises(ValueError, match="CUDA"):
        check_inputs(xt, xt.dtype, ring, 256)


def _jax_engine_stats(policy, payloads):
    with JaxEngine(policy) as eng:
        for j in [eng.submit(p) for p in payloads]:
            j.get()
    return {f: getattr(eng.stats, f)
            for f in ("submitted", "bytes_moved", "inline", "offloaded")}


def test_offload_modes_twin_on_cpu():
    """The port of examples/offload_modes.py at a small slab: every kernel
    row agrees with the plain version, the pipelined row runs at the async
    depth, the threshold keeps the small payload inline at both tiers, and
    the engine's counters equal the JAX engine's under the same policies."""
    launches0 = ops.offload_copy.LAUNCHES
    res = offload_modes.run(device="cpu", rows=512, cols=256)
    assert ops.offload_copy.LAUNCHES == launches0
    assert res["calibration"]["l_fixed_us"] >= 0
    rows = res["kernel"]
    assert [(r["mode"], r["inject"]) for r in rows] == [
        (m, i) for m in MODES for i in (False, True)]
    assert all(r["allclose"] and r["max_abs_err"] == 0 for r in rows)
    assert [r["depth"] for r in rows] == [1, 1, 2, 2, 2, 2]
    for r in rows:
        assert ("fused_sum" in r) == r["inject"]
        if r["inject"]:
            assert sum_ok(r["fused_sum"], r["plain_sum"])
    buf = np.ones((4 << 20,), np.float32)
    for row in res["engine"]:
        want = _jax_engine_stats(JaxPolicy(
            mode=JaxMode(row["mode"]), offload_threshold_bytes=1,
            pipeline_depth=3), [buf] * 8)
        assert {f: row[f] for f in want} == want, row["mode"]
    want = _jax_engine_stats(JaxPolicy(
        mode=JaxMode.ASYNC, offload_threshold_bytes=1 << 20),
        [np.ones(64, np.float32), np.ones(1 << 20, np.float32)])
    th = res["threshold"]
    assert (th["inline"], th["offloaded"]) == (want["inline"],
                                               want["offloaded"]) == (1, 1)
    assert th["kernel_inline"] == 1 and th["kernel_inline_ok"]
