"""The port's hybrid model (zamba2: Mamba2 backbone + shared attention)
against the JAX package on identical weights, at the fp32 smoke widths:
the SSM block's prefill and decode, the model's prefill logits and every
cache field, decode steps, the served greedy tokens, and the init tree."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import OffloadPolicy as JaxPolicy
from repro.models import build_model as jax_build
from repro.models import hybrid as jhb
from repro.models import ssm as jssm
from repro.models.registry import count_params_analytic as jax_count
from repro.serve import BatchedServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import OffloadPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import hybrid as hb
from repro_torch.models import ssm
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchedServer, ServeConfig

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)

# fp32 throughout; sums run in another order than XLA's, over a few layers
TOL = 1e-4
ARCH = "zamba2-2.7b"
CACHE_FIELDS = ("conv", "ssm", "k", "v")


def _jax_params(seed=0):
    tree = jax_build(jax_smoke(ARCH)).init(jax.random.key(seed))
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg=msg)


@pytest.mark.parametrize("s", [2, 13])
def test_ssm_block_prefill_and_decode_match_jax(s):
    """One Mamba2 block: the output, the conv state (the pre-conv xbc,
    left-padded when S < W-1) and the final SSM state after prefill, then
    two decode steps with the states carried in place."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    lp = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.key(1), jcfg))
    # non-trivial decay, skip and dt bias, as a trained model has
    rng = np.random.default_rng(s)
    for key in ("A_log", "D", "dt_bias"):
        lp[key] = rng.standard_normal(lp[key].shape).astype(np.float32)
    params = params_from_jax(lp)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)

    jout, (jconv, jstate) = jssm.ssm_block_prefill(lp, x, jcfg)
    out, (conv, state) = ssm.ssm_block_prefill(params, _t(x), cfg)
    _close(out, jout, "out")
    _close(conv, jconv, "conv_state")
    _close(state, jstate, "ssm_state")

    conv, state = conv.clone(), state.clone()
    for step in range(2):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jconv, jstate = jssm.ssm_block_decode(lp, xt, jcfg, jconv,
                                                    jstate)
        out = ssm.ssm_block_decode(params, _t(xt), cfg, conv, state)
        _close(out, jout, f"decode out, step {step}")
        _close(conv, jconv, f"conv_state, step {step}")
        _close(state, jstate, f"ssm_state, step {step}")


@pytest.mark.parametrize("s", [12, 16])
def test_prefill_and_decode_match_jax(s):
    """Last-token logits and every cache field after prefill (S=12 is
    ragged against the smoke chunk of 8), then 4 decode steps."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    tree = _jax_params()
    params = params_from_jax(tree)
    b, max_len = 2, 24
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)

    jlogits, jcache = jhb.hybrid_lm_prefill(tree, {"tokens": tokens}, jcfg,
                                            max_len=max_len)
    logits, cache = hb.hybrid_lm_prefill(params, {"tokens": _t(tokens)}, cfg,
                                         max_len=max_len)
    assert logits.shape == (b, 1, cfg.vocab_size)
    _close(logits, jlogits, "prefill logits")
    for key in CACHE_FIELDS:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close(cache[key], jcache[key], key)
    np.testing.assert_array_equal(cache["index"].numpy(),
                                  np.asarray(jcache["index"]))

    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = jhb.hybrid_lm_decode_step(tree, jcache, tok, jcfg)
        logits, cache = hb.hybrid_lm_decode_step(params, cache, _t(tok), cfg)
        _close(logits, jlogits, f"decode logits, step {step}")
        for key in CACHE_FIELDS:
            _close(cache[key], jcache[key], f"{key}, step {step}")
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(jcache["index"]))


def _serve_pipelined(server, prompts):
    with server.make_dispatcher() as d:
        jids = [d.request("generate", p, mode="pipelined") for p in prompts]
        return [d.query(j) for j in jids]


def test_greedy_tokens_equal_jax_server():
    jmodel = jax_build(jax_smoke(ARCH))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    jsrv = JaxServer(jmodel, tree, JaxServeConfig(max_len=32, max_new_tokens=5),
                     JaxPolicy(max_batch=4))
    model = build_model(get_smoke_config(ARCH), device="cpu")
    srv = BatchedServer(model, params_from_jax(tree),
                        ServeConfig(max_len=32, max_new_tokens=5),
                        OffloadPolicy(max_batch=4), device="cpu")
    vocab = model.cfg.vocab_size
    # equal lengths: a shorter row would run its SSM state on through the
    # pad tokens in both packages
    prompts = [(np.arange(1, 11, dtype=np.int32) * (i + 3)) % vocab
               for i in range(5)]
    try:
        want = _serve_pipelined(jsrv, prompts)
        got = _serve_pipelined(srv, prompts)
    finally:
        jsrv.close()
        srv.close()
    assert all(o.shape == (5,) for o in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert srv.stats["requests"] == jsrv.stats["requests"] == 5


def test_prefill_overwrites_state_left_by_an_earlier_batch():
    """The SSM and conv state are set outright by each prefill: a prompt
    served, then a wider batch of other prompts, then the first prompt
    again, gives the same tokens, with the cache written in place."""
    model = build_model(get_smoke_config(ARCH), device="cpu")
    srv = BatchedServer(model, model.init(0),
                        ServeConfig(max_len=24, max_batch=3, max_new_tokens=5),
                        device="cpu")
    rng = np.random.default_rng(4)
    p = rng.integers(0, model.cfg.vocab_size, 11).astype(np.int32)
    state = srv._cache["ssm"]
    a = srv.generate_batch(srv._pack([p]))
    srv.generate_batch(srv._pack([
        rng.integers(0, model.cfg.vocab_size, 11).astype(np.int32)
        for _ in range(3)]))
    b = srv.generate_batch(srv._pack([p]))
    np.testing.assert_array_equal(a, b)
    assert srv._cache["ssm"] is state
    srv.close()


def test_launch_serve_main_runs_on_cpu(capsys):
    res = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--requests", "5", "--prompt-len", "9",
                             "--new-tokens", "3"])
    assert len(res["outs"]) == 5 and all(o.shape == (3,) for o in res["outs"])
    assert res["server"]["requests"] == 5
    assert "tok/s" in capsys.readouterr().out


def test_init_tree_matches_jax_tree():
    """The port's seeded init builds the JAX package's tree, leaf for leaf:
    bf16 in param_dtype, A_log, D and dt_bias in float32."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke(ARCH), param_dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(0)
    jtree = jax.eval_shape(jax_build(jcfg).init, jax.random.key(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    ported = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(flat) == set(ported)
    for path, leaf in flat.items():
        assert tuple(ported[path].shape) == leaf.shape, path
        assert str(ported[path].dtype) == f"torch.{leaf.dtype.name}", path
    assert params["ssm_blocks"]["ssm"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_matches_jax(smoke):
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    jcfg = jax_smoke(ARCH) if smoke else jax_config(ARCH)
    assert cfg.param_count() == jax_count(jcfg)
    if not smoke:
        assert cfg.param_count() == 2_340_750_240


def test_cache_layout_matches_jax():
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    cache = hb.hybrid_init_cache(cfg, 3, 20, "cpu")
    jcache = jhb.hybrid_init_cache(jcfg, 3, 20)
    assert set(cache) == set(jcache)
    for key in CACHE_FIELDS:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        assert str(cache[key].dtype) == f"torch.{jcache[key].dtype}", key
        assert cache[key].is_contiguous()
    assert not any(cache[key].any() for key in cache)
