"""Flash attention in the port: the plain PyTorch version against the JAX
package's reference and its Pallas kernel (interpret mode), the wrapper's
device dispatch and input checks.  The kernel itself is held against the plain
version on the card by ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention_cuda,
                                                 variant)

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)

# the bounds of tests/test_kernels.py: fp32 sums in another order, bf16
# rounds P and the output to 8 mantissa bits
FP32_TOL = 2e-5
BF16_TOL = 0.1

SHAPES = [   # (s, t, h, kh, hd, causal) of tests/test_kernels.py
    (128, 128, 4, 4, 32, True),
    (128, 128, 4, 2, 64, True),
    (64, 128, 8, 1, 32, False),
    (256, 256, 2, 2, 128, True),
    (128, 128, 4, 4, 80, True),     # zamba2's shared block: hd 2560/32
]


def _qkv(seed, b, s, t, h, kh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), np.float32),
            rng.standard_normal((b, t, kh, hd), np.float32),
            rng.standard_normal((b, t, kh, hd), np.float32))


@pytest.mark.parametrize("s,t,h,kh,hd,causal", SHAPES)
def test_plain_flash_matches_jax_fp32(s, t, h, kh, hd, causal):
    q, k, v = _qkv(0, 2, s, t, h, kh, hd)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal).numpy()
    want_ref = np.asarray(jref.flash_attention(q, k, v, causal=causal))
    want_pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=FP32_TOL, atol=FP32_TOL)


def test_plain_flash_matches_jax_bf16():
    q, k, v = _qkv(1, 1, 128, 128, 4, 2, 32)
    qj, kj, vj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    # the same bf16 values on both sides
    qt, kt, vt = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (qj, kj, vj))
    got = ops.flash_attention(qt, kt, vt, causal=True).float().numpy()
    want_ref = np.asarray(jref.flash_attention(qj, kj, vj, causal=True),
                          np.float32)
    want_pallas = np.asarray(flash_attention_pallas(
        qj, kj, vj, causal=True, block_q=64, block_k=64, interpret=True),
        np.float32)
    np.testing.assert_allclose(got, want_ref, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=BF16_TOL, atol=BF16_TOL)


def test_causal_mask_is_top_left():
    """S < T causal: query i sees keys 0..i (the Pallas kernel's mask), not
    the bottom-right alignment of the JAX ref; checked against an explicit
    per-row softmax."""
    q, k, v = _qkv(2, 1, 4, 8, 2, 1, 16)
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True).numpy()
    for i in range(4):
        sc = np.einsum("he,te->ht", q[0, i], k[0, : i + 1, 0]) / 4.0
        w = np.exp(sc - sc.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        np.testing.assert_allclose(got[0, i], w @ v[0, : i + 1, 0],
                                   rtol=FP32_TOL, atol=FP32_TOL)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 64, 64, 4, 2, 16))
    before = ops.flash_attention.LAUNCHES
    out = ops.flash_attention(q, k, v)
    assert ops.flash_attention.LAUNCHES == before
    torch.testing.assert_close(out, ref.flash_attention(q, k, v),
                               rtol=0, atol=0)


def test_kernel_launcher_refuses_non_cuda_tensors():
    """No fallback: the CUDA launcher raises on a tensor that is not on a
    CUDA device instead of computing anything."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 64, 64, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*meta)


@pytest.mark.parametrize("bad,err", [
    ("head_dim", "head_dim"), ("dtype", "dtypes"), ("contig", "contiguous"),
    ("groups", "multiple")])
def test_kernel_launcher_validates_inputs(bad, err):
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 64, 64, 4, 2, 32))
    if bad == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "dtype":
        q = q.double()
    elif bad == "contig":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        q = q[:, :, :3]
    with pytest.raises((ValueError, TypeError), match=err):
        flash_attention_cuda(q.contiguous() if bad != "contig" else q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_the_kernel_is_fixed_by_dtype_and_head_dim(dtype, hd):
    """Tensor cores for bf16 at hd 64, 80, 128; CUDA cores for fp32 (whose
    2e-5 gate TF32 cannot meet) and bf16 at hd 16, 32."""
    want = ("wgmma" if dtype == "bfloat16" and hd in (64, 80, 128)
            else "simt")
    assert variant(getattr(torch, dtype), hd) == want


def test_the_tensor_core_kernel_refuses_other_shapes():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 64, 64, 4, 2, 128))
    with pytest.raises(ValueError, match="tensor-core"):
        flash_attention_cuda(q, k, v, kind="wgmma")          # fp32
    with pytest.raises(ValueError, match="one of"):
        flash_attention_cuda(q, k, v, kind="tensor")


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_cpu_bf16_tensors_take_the_plain_path_and_launch_nothing(hd):
    """bf16 at the tensor-core kernel's head dims, on the CPU: the plain
    version, within the bf16 bound of the JAX reference, and no launch
    of either kernel."""
    q, k, v = _qkv(7, 1, 96, 96, 4, 2, hd)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    launches, variants = (ops.flash_attention.LAUNCHES,
                          dict(ops.flash_attention.VARIANTS))
    out = ops.flash_attention(qt, kt, vt, causal=True)
    assert ops.flash_attention.LAUNCHES == launches
    assert ops.flash_attention.VARIANTS == variants
    torch.testing.assert_close(out, ref.flash_attention(qt, kt, vt),
                               rtol=0, atol=0)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jref.flash_attention(qj, kj, vj, causal=True),
                      np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
