"""The port's serving path against the JAX package's: the same weights and
prompts through ``BatchedServer.make_dispatcher`` in pipelined mode give
the same greedy tokens; the port's CLI runs on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import OffloadPolicy as JaxPolicy
from repro.models import build_model as jax_build
from repro.serve import BatchedServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import OffloadPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchedServer, ServeConfig

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)

ARCH = "granite-8b"


def _serve_pipelined(server, prompts):
    with server.make_dispatcher() as d:
        jids = [d.request("generate", p, mode="pipelined") for p in prompts]
        return [d.query(j) for j in jids]


def test_greedy_tokens_equal_jax_server():
    jmodel = jax_build(jax_smoke(ARCH))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    jsrv = JaxServer(jmodel, tree, JaxServeConfig(max_len=32, max_new_tokens=4),
                     JaxPolicy(max_batch=4))
    model = build_model(get_smoke_config(ARCH), device="cpu")
    srv = BatchedServer(model, params_from_jax(tree),
                        ServeConfig(max_len=32, max_new_tokens=4),
                        OffloadPolicy(max_batch=4), device="cpu")
    vocab = model.cfg.vocab_size
    # equal lengths: a mixed-length batch continues shorter prompts from a
    # pad token in both packages (left-aligned slab, last-column logits)
    prompts = [(np.arange(1, 7, dtype=np.int32) * (i + 3)) % vocab
               for i in range(5)]
    try:
        want = _serve_pipelined(jsrv, prompts)
        got = _serve_pipelined(srv, prompts)
    finally:
        jsrv.close()
        srv.close()
    assert all(o.shape == (4,) for o in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert srv.stats["requests"] == jsrv.stats["requests"] == 5
    assert srv.stats["tokens_out"] == jsrv.stats["tokens_out"]


def test_server_is_deterministic_and_reuses_its_cache():
    model = build_model(get_smoke_config(ARCH), device="cpu")
    srv = BatchedServer(model, model.init(0),
                        ServeConfig(max_len=24, max_batch=2, max_new_tokens=5),
                        device="cpu")
    p = np.arange(3, 13, dtype=np.int32)
    cache = srv._cache["k"]
    a = srv.generate_batch(srv._pack([p]))
    srv.generate_batch(srv._pack([p[::-1].copy(), p]))   # dirty the cache
    b = srv.generate_batch(srv._pack([p]))
    np.testing.assert_array_equal(a, b)
    assert srv._cache["k"] is cache                      # written in place
    with pytest.raises(ValueError, match="max_len"):
        srv.generate_batch(srv._pack([np.zeros(21, np.int32)]))
    srv.close()


def test_launch_serve_main_runs_on_cpu(capsys):
    res = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--requests", "6", "--prompt-len", "8",
                             "--new-tokens", "3"])
    assert len(res["outs"]) == 6 and all(o.shape == (3,) for o in res["outs"])
    assert res["server"]["requests"] == 6
    assert "tok/s" in capsys.readouterr().out


def test_server_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("host has CUDA: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", ARCH, "--smoke"])
