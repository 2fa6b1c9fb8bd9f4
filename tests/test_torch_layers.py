"""The port's MLP against the JAX package's on the same numpy-seeded
inputs and weights, for every MLP type the configs name."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)

# fp32 on both sides: one up (or gate and up) projection, the activation
# and the down projection, summed in another order than XLA's
TOL = 1e-5


def _weights(mlp_type, d, f, seed):
    rng = np.random.default_rng(seed)
    names = ("wg", "wu", "wd") if mlp_type == "swiglu" else ("wi", "wd")
    return {n: (rng.standard_normal((f, d) if n == "wd" else (d, f))
                / np.sqrt(d if n != "wd" else f)).astype(np.float32)
            for n in names}


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_apply_mlp_matches_jax(mlp_type):
    cfg = dataclasses.replace(get_smoke_config("granite-8b"),
                              mlp_type=mlp_type)
    jcfg = dataclasses.replace(jax_smoke("granite-8b"), mlp_type=mlp_type)
    d, f = cfg.d_model, cfg.d_ff
    w = _weights(mlp_type, d, f, seed=11)
    x = np.random.default_rng(12).standard_normal((2, 5, d)).astype(np.float32)
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in w.items()},
                           torch.from_numpy(x), cfg)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_apply_mlp_refuses_an_unknown_type():
    cfg = dataclasses.replace(get_smoke_config("granite-8b"),
                              mlp_type="relu")
    w = _weights("gelu", cfg.d_model, cfg.d_ff, seed=13)
    with pytest.raises(ValueError, match="mlp_type"):
        layers.apply_mlp({k: torch.from_numpy(v) for k, v in w.items()},
                         torch.zeros(1, cfg.d_model), cfg)
