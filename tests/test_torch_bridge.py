"""The parameter bridge: JAX trees cross into the port bit for bit,
bfloat16 leaves included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.bridge import params_from_jax, params_to_numpy, to_tensor

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)


def test_round_trip_is_bit_exact_with_bf16_leaves():
    cfg = dataclasses.replace(jax_smoke("granite-8b"), param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_build(cfg).init(jax.random.key(0)))
    tree["extra_f32"] = np.linspace(-1, 1, 7, dtype=np.float32)
    params = params_from_jax(tree)
    assert params["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert params["extra_f32"].dtype == torch.float32
    back = params_to_numpy(params)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in flat:
        want_bits = leaf.view(np.uint16) if leaf.dtype.name == "bfloat16" \
            else leaf.view(np.uint8)
        got_bits = got[path].view(np.uint16) if leaf.dtype.name == "bfloat16" \
            else got[path].view(np.uint8)
        assert got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got_bits, want_bits, err_msg=str(path))


def test_bf16_values_survive_as_numbers():
    x = np.asarray(jnp.array([1.5, -2.25, 3e-3, 65280.0], jnp.bfloat16))
    t = to_tensor(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


def test_hybrid_tree_round_trip_is_bit_exact():
    """The nested hybrid tree (``ssm_blocks`` stacked (groups, per, ...),
    the shared block, a tied embedding) in bf16, with its float32 leaves
    (A_log, D, dt_bias) kept float32."""
    cfg = dataclasses.replace(jax_smoke("zamba2-2.7b"), param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_build(cfg).init(jax.random.key(1)))
    params = params_from_jax(tree)
    assert params["ssm_blocks"]["ssm"]["in_proj"].dtype == torch.bfloat16
    assert params["ssm_blocks"]["ssm"]["A_log"].dtype == torch.float32
    assert "lm_head" not in params["embed"]
    back = dict(jax.tree_util.tree_flatten_with_path(params_to_numpy(params))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        assert back[path].shape == leaf.shape, path
        np.testing.assert_array_equal(back[path].view(np.uint8),
                                      leaf.view(np.uint8), err_msg=str(path))
