"""The SSD chunk scan in the port: the plain PyTorch version, through the
wrapper on CPU tensors, against the JAX package's literal recurrence
(``ref.ssd_scan``), its chunked form (``ssm.ssd_chunked``) and its Pallas
kernel (interpret mode); the wrapper's device dispatch and input checks.
The kernel itself is held against the plain version on the card by
``test_torch_cuda.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan_cuda

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)

# the bounds of tests/test_kernels.py: fp32 sums in another order; bf16 x
# against the JAX functions on the same bf16 x
FP32_TOL = 1e-4
BF16_TOL = 5e-2


def _inputs(seed, b=2, s=32, nh=4, p=16, g=2, n=8):
    """The distribution of tests/test_kernels.py::_ssd_inputs, from numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, nh, p)).astype(np.float32)
    bm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((b, s, nh))).astype(np.float32)
    da = (-np.exp(rng.standard_normal(nh)) * dt).astype(np.float32)
    dsk = np.linspace(0.5, 1.5, nh).astype(np.float32)
    return xh, bm, cm, dt, da, dsk


def _port(args, chunk, xh_dtype=torch.float32):
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].to(xh_dtype)
    y, hf = ops.ssd_scan(*t, chunk=chunk)
    assert y.dtype == hf.dtype == torch.float32
    return y.numpy(), hf.numpy()


def _chunked(args, chunk, xh=None):
    cfg = dataclasses.replace(jax_smoke("zamba2-2.7b"), ssm_chunk=chunk)
    j = [jnp.asarray(a) for a in args]
    if xh is not None:
        j[0] = xh
    return jssm.ssd_chunked(*j, cfg)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_plain_scan_matches_jax_fp32(chunk, g):
    args = _inputs(chunk + g, g=g)
    y, hf = _port(args, chunk)
    j = [jnp.asarray(a) for a in args]
    for name, (wy, wh) in (
            ("ref", jref.ssd_scan(*j)),
            ("ssd_chunked", _chunked(args, chunk)),
            ("pallas", ssd_scan_pallas(*j, chunk=chunk, interpret=True))):
        np.testing.assert_allclose(y, np.asarray(wy), rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=f"y vs {name}")
        np.testing.assert_allclose(hf, np.asarray(wh), rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=f"h_final vs {name}")


def test_plain_scan_matches_jax_bf16_x():
    args = _inputs(1)
    xj = jnp.asarray(args[0]).astype(jnp.bfloat16)
    # the same bf16 values on both sides
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    t = [xt] + [torch.from_numpy(a) for a in args[1:]]
    y, hf = (r.numpy() for r in ops.ssd_scan(*t, chunk=16))
    j = [xj] + [jnp.asarray(a) for a in args[1:]]
    for name, (wy, wh) in (
            ("ref", jref.ssd_scan(*j)),
            ("ssd_chunked", _chunked(args, 16, xh=xj)),
            ("pallas", ssd_scan_pallas(*j, chunk=16, interpret=True))):
        np.testing.assert_allclose(y, np.asarray(wy), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=f"y vs {name}")
        np.testing.assert_allclose(hf, np.asarray(wh), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=f"h_final vs {name}")


@pytest.mark.parametrize("s,chunk,g", [(37, 8, 2), (5, 16, 1), (70, 32, 4)])
def test_plain_scan_ragged_s_matches_ssd_chunked(s, chunk, g):
    """S not a multiple of the chunk: identity-step padding, so h_final is
    the state after the last real token (the Pallas kernel takes no ragged
    S)."""
    args = _inputs(s, s=s, g=g)
    y, hf = _port(args, chunk)
    wy, wh = _chunked(args, chunk)
    assert y.shape == np.asarray(wy).shape
    np.testing.assert_allclose(y, np.asarray(wy), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(hf, np.asarray(wh), rtol=FP32_TOL,
                               atol=FP32_TOL)


@pytest.mark.parametrize("s,chunk", [(32, 8), (37, 16)])
def test_port_recurrence_matches_chunked_and_jax(s, chunk):
    """The port's second yardstick, the literal recurrence, against its
    JAX original and against the chunked plain version."""
    args = _inputs(7, s=s)
    t = [torch.from_numpy(a) for a in args]
    y, hf = ref.ssd_scan_recurrent(*t)
    wy, wh = jref.ssd_scan(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=FP32_TOL,
                               atol=FP32_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), rtol=FP32_TOL,
                               atol=FP32_TOL)
    cy, ch = ref.ssd_scan(*t, chunk=chunk)
    torch.testing.assert_close(cy, y, rtol=FP32_TOL, atol=FP32_TOL)
    torch.testing.assert_close(ch, hf, rtol=FP32_TOL, atol=FP32_TOL)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    t = [torch.from_numpy(a) for a in _inputs(9)]
    before = ops.ssd_scan.LAUNCHES
    y, hf = ops.ssd_scan(*t, chunk=8)
    assert ops.ssd_scan.LAUNCHES == before
    wy, wh = ref.ssd_scan(*t, chunk=8)
    torch.testing.assert_close(y, wy, rtol=0, atol=0)
    torch.testing.assert_close(hf, wh, rtol=0, atol=0)


def test_kernel_launcher_refuses_non_cuda_tensors():
    """No fallback: the CUDA launcher raises on a tensor that is not on a
    CUDA device instead of computing anything."""
    t = [torch.from_numpy(a) for a in _inputs(10)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*t)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(*[a.to("meta") for a in t])


@pytest.mark.parametrize("bad,err", [
    ("state", "state width"), ("head", "multiple of 16"),
    ("groups", "multiple of groups"), ("dtype", "float32"),
    ("contig", "contiguous"), ("shape", "mismatch"), ("chunk", "chunk")])
def test_kernel_launcher_validates_inputs(bad, err):
    kw = {"state": dict(n=6), "head": dict(p=24), "groups": dict(nh=6, g=4)}
    t = [torch.from_numpy(a) for a in _inputs(11, **kw.get(bad, {}))]
    chunk = 256
    if bad == "dtype":
        t[1] = t[1].double()
    elif bad == "contig":
        t[0] = t[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        t[3] = t[3][:, 1:]
    elif bad == "chunk":
        chunk = 0
    with pytest.raises((ValueError, TypeError), match=err):
        ssd_scan_cuda(*t, chunk=chunk)
