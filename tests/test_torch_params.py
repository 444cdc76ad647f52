"""Weights: the port's random_params has the JAX pytree's exact structure,
and params_from_numpy carries any such tree across leaf for leaf."""

import jax
import numpy as np
import pytest
import torch

from test_torch_common import jax_config, shared_fields

from speechcatcher_tpu.models.asr_model import ASRModel as JaxModel
from speechcatcher_tpu_torch.config import flagship_config, tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import (
    params_checksum,
    params_from_numpy,
    random_params,
)


@pytest.mark.parametrize("input_layer,encoder_type", [
    ("conv2d", "transformer"), ("conv2d6", "transformer"),
    ("conv2d8", "transformer"), ("linear", "transformer"),
    ("conv2d", "conformer"), ("linear", "conformer"),
])
def test_random_params_has_jax_structure(input_layer, encoder_type):
    cfg = tiny_config(input_layer=input_layer, encoder_type=encoder_type,
                      conformer_kernel_size=7)
    ref = JaxModel.random_init(jax_config(cfg), seed=0).params
    ours = random_params(cfg, seed=0)
    assert (jax.tree.structure(ours) == jax.tree.structure(ref))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.dtype(b.dtype)


def test_random_params_is_seeded():
    cfg = tiny_config()
    assert params_checksum(random_params(cfg, 1)) == params_checksum(
        random_params(cfg, 1))
    assert params_checksum(random_params(cfg, 1)) != params_checksum(
        random_params(cfg, 2))


def test_params_from_numpy_matches_jax_tree_leaf_for_leaf():
    cfg = tiny_config()
    tree = jax.tree.map(np.asarray,
                        JaxModel.random_init(jax_config(cfg), seed=3).params)
    ours = params_from_numpy(tree, "cpu")
    assert jax.tree.structure(ours) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(tree)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)


def test_model_layers_are_views_of_the_stack():
    cfg = tiny_config()
    tree = random_params(cfg, 4)
    model = ASRModel.from_numpy(cfg, tree, device="cpu")
    layers = model.params["encoder"]["layers"]
    assert len(layers) == cfg.encoder_layers
    np.testing.assert_array_equal(
        layers[1]["self_attn"]["linear_q"]["weight"].numpy(),
        tree["encoder"]["layers"]["self_attn"]["linear_q"]["weight"][1])


def test_flagship_config_matches_the_jax_flagship():
    from __graft_entry__ import _flagship_config

    assert shared_fields(flagship_config()) == shared_fields(
        _flagship_config())


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ASRModel.random_init(tiny_config(), seed=0)
