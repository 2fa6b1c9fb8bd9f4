"""The port's dense model against the JAX package on identical weights:
attention (prefill and decode), prefill logits and KV cache, decode steps,
at the fp32 smoke widths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import transformer as jtr
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr
from repro_torch.models.registry import build_model

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)

# fp32 throughout; sums run in another order than XLA's, over a few layers
TOL = 1e-4


def _jax_params(arch, seed=0):
    model = jax_build(jax_smoke(arch))
    tree = model.init(jax.random.key(seed))
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("s", [64, 3072])
def test_prefill_attention_matches_attend_and_blockwise(s):
    """At S=64 the JAX model runs ``attend``, at S=3072 ``attend_blockwise``
    (S*S above BLOCKWISE_THRESHOLD); the port's prefill attention is the
    same function in both cases."""
    cfg = get_smoke_config("granite-8b")
    jcfg = jax_smoke("granite-8b")
    rng = np.random.default_rng(s)
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    q = rng.standard_normal((1, s, h, hd), np.float32)
    k = rng.standard_normal((1, s, kh, hd), np.float32)
    v = rng.standard_normal((1, s, kh, hd), np.float32)
    got = attn.prefill_attention(_t(q), _t(k), _t(v), cfg).numpy()
    if jattn._use_blockwise(s, s):
        want = jattn.attend_blockwise(q, k, v, jcfg, causal=True)
    else:
        want = jattn.attend(q, k, v, jcfg, jattn.causal_mask(s))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_decode_attend_matches_jax():
    jcfg = jax_smoke("granite-8b")
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, 1, 4, 16), np.float32)
    k = rng.standard_normal((3, 20, 2, 16), np.float32)
    v = rng.standard_normal((3, 20, 2, 16), np.float32)
    index = np.array([0, 7, 19], np.int32)
    got = attn.attend(_t(q), _t(k), _t(v),
                      attn.decode_mask(_t(index).long(), 20)).numpy()
    want = jattn.attend(q, k, v, jcfg, jattn.decode_mask(index, 20))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-32b", "nemotron-4-15b"])
def test_prefill_and_decode_match_jax(arch):
    """Last-token prefill logits, the K/V cache, and three decode steps:
    swiglu + rmsnorm, qk_norm, and squared_relu + layernorm."""
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke(arch)
    tree = _jax_params(arch)
    params = params_from_jax(tree)
    b, s, max_len = 2, 12, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)

    jlogits, jcache = jtr.lm_prefill(tree, {"tokens": tokens}, jcfg,
                                     max_len=max_len)
    logits, cache = tr.lm_prefill(params, {"tokens": _t(tokens)}, cfg,
                                  max_len=max_len)
    assert logits.shape == (b, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]),
                                   rtol=TOL, atol=TOL)

    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = jtr.lm_decode_step(tree, jcache, tok, jcfg)
        logits, cache = tr.lm_decode_step(params, cache, _t(tok), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {step}")
    np.testing.assert_array_equal(cache["index"].numpy(),
                                  np.asarray(jcache["index"]))


def test_long_prefill_matches_jax_blockwise_model():
    """S=3072: the JAX model takes ``attend_blockwise`` in every layer."""
    arch = "granite-8b"
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke(arch)
    s = 3072
    assert jattn._use_blockwise(s, s)
    tree = _jax_params(arch, seed=3)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: jtr.lm_prefill(p, {"tokens": t}, jcfg))(
        tree, tokens)
    logits, _ = tr.lm_prefill(params_from_jax(tree), {"tokens": _t(tokens)},
                              cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)


def test_build_model_init_shapes_match_jax_tree():
    """The port's seeded init builds the JAX package's tree, leaf for leaf,
    in param_dtype; param_count agrees with the JAX analytic count."""
    for arch in ("granite-8b", "qwen3-32b"):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  param_dtype="bfloat16")
        params = build_model(cfg, device="cpu").init(0)
        jtree = jax.eval_shape(jax_build(jax_smoke(arch)).init,
                               jax.random.key(0))
        flat = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
        ported = dict(jax.tree_util.tree_flatten_with_path(params)[0])
        assert set(flat) == set(ported)
        for path, leaf in flat.items():
            assert tuple(ported[path].shape) == leaf.shape, path
            assert ported[path].dtype == torch.bfloat16
        assert cfg.param_count() == jax_smoke(arch).param_count()


def test_build_model_refuses_unported_families_and_missing_cuda():
    with pytest.raises(NotImplementedError):
        build_model(get_smoke_config("granite-moe-1b-a400m"), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("host has CUDA: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("granite-8b"))
