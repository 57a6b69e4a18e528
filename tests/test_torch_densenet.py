"""The port's DenseNet (thyroid_tpu_torch/models/cnn/densenet.py) against
the JAX package on the CPU in float32: a narrow DenseNet (growth 8, blocks
(1, 1), 16 initial features, 32²) on numpy-drawn, bumped weights with
running statistics from a JAX train-mode forward, its forward, one Trainer
step (CE, and with MixUp/CutMix on JAX's draws) and its bf16 forward; the
golden densenet121 logits from JAX's PRNGKey(0) init; the variable trees
of densenet121/161/169/201 and their YAMLs."""
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (flat_tree, global_rel, golden_input,
                                golden_variables, jax_cnn,
                                jax_mixup_cutmix_params, jax_step,
                                jax_train_stats, port_step, tree_shapes_equal)
from thyroid_tpu_torch.models.cnn import densenet as port_densenet
from thyroid_tpu_torch.models.from_jax import load_jax_variables, to_jax_variables
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training.configs import TRAINING_CNN

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
NARROW = {"name": "densenet121", "growth_rate": 8, "block_config": (1, 1),
          "num_init_features": 16, "img_size": 32, "in_channels": 1,
          "num_classes": 2, "dtype": "f32", "dropout_rate": 0.0}
TCFG = dict(TRAINING_CNN, scheduler_params=dict(TRAINING_CNN["scheduler_params"],
                                                warmup_steps=1))


@lru_cache(maxsize=None)
def golden():
    return golden_variables("densenet121")


@lru_cache(maxsize=None)
def small():
    model, variables = jax_cnn(NARROW)
    x = np.random.RandomState(1).randn(8, 32, 32, 1).astype(np.float32)
    return model, jax_train_stats(model, variables, jnp.asarray(x))


def _port(cfg, variables):
    model = ModelRegistry.create_model(cfg)
    load_jax_variables(model, variables)
    return model.eval()


@pytest.mark.unit
def test_forward_matches_jax():
    model, variables = small()
    x = np.random.RandomState(2).randn(3, 32, 32, 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(NARROW, variables)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(want[0] - want[1]).max() > 1e-2


@pytest.mark.unit
@pytest.mark.parametrize("mix", [False, True], ids=["ce", "mixup_cutmix"])
def test_train_step_matches_jax(mix, tmp_path, monkeypatch):
    """One Trainer step (cnn.yaml) from the same variables: the loss within
    1e-4, the gradients' global difference within 1e-3 of their norm and
    the updated running statistics within 1e-4 (test_torch_resnet.py's
    limits), against JAX's _train_step_impl loss (with MixUp/CutMix on
    JAX's own draws)."""
    model, variables = small()
    tcfg = dict(TCFG, mixup_alpha=0.8, cutmix_alpha=1.0) if mix else TCFG
    rs = np.random.RandomState(10)
    x = rs.randn(4, 32, 32, 1).astype(np.float32)
    y = (np.arange(4) % 2).astype(np.int32)
    w = np.array([1, 1, 1, 0.5], np.float32)
    _, mix_rng = jax.random.split(jax.random.PRNGKey(3))
    want, grads_want, stats_want = jax_step(model, variables, x, y, w,
                                            mix_rng=mix_rng if mix else None)
    mirror = jax_mixup_cutmix_params(mix_rng, x.shape, 0.8, 1.0) if mix else None
    got, grads, stats, _ = port_step(NARROW, tcfg, variables, x, y, w,
                                     monkeypatch, tmp_path, mirror)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (got, want)
    assert global_rel(grads, grads_want) < 1e-3
    stats, stats_want = flat_tree(stats), flat_tree(stats_want)
    assert set(stats) == set(stats_want)
    for k, v in stats_want.items():
        np.testing.assert_allclose(stats[k], v, atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.unit
def test_bf16_forward_and_round_trip():
    """The bf16 forward within 1e-2 of JAX's bf16 forward as written (the
    jitted program without excess precision); load/to_jax_variables exact
    inverses and strict; the capture forward gives the same logits and
    the (B, h, w, C) feature map after norm_final and ReLU."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    _, variables = small()
    model = _port(NARROW, variables)
    back = to_jax_variables(model)
    for col in ("params", "batch_stats"):
        got, want = flat_tree(back[col]), flat_tree(variables[col])
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), col
    params = {k: v for k, v in variables["params"].items() if k != "transition1"}
    with pytest.raises(KeyError, match="transition1"):
        load_jax_variables(model, {**variables, "params": params})
    x = np.random.RandomState(4).randn(2, 32, 32, 1).astype(np.float32)
    with torch.no_grad():
        logits, inter = model(torch.from_numpy(x), capture=True)
        assert torch.equal(logits, model(torch.from_numpy(x)))
    assert list(inter) == ["features"] and inter["features"].shape[0] == 2
    assert inter["features"].min() >= 0                      # after the ReLU
    cfg = dict(NARROW, dtype="bf16")
    jmodel = JaxRegistry.create_model(cfg)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)).lower(
        variables, jnp.asarray(x)).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2, rtol=0)


@pytest.mark.unit
def test_golden_logits():
    """The golden densenet121 logits from the port on JAX's initial
    variables, at tests/unit/test_golden_parity.py's tolerance."""
    rec = np.load(GOLDEN / "densenet121.npz")
    cfg, variables = golden()
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(golden_input(224))).numpy()
    np.testing.assert_allclose(got, rec["logits"], atol=2e-3, rtol=1e-3)


@pytest.mark.unit
@pytest.mark.parametrize("name", list(port_densenet.DENSENET_PARAMS))
def test_variable_tree_and_yaml(name):
    """densenet121/161/169/201 from the registry: names, shapes and
    collections against JAX's init (jax.eval_shape at 32²; densenet121's
    golden variables, which no input size shapes); the YAML's nested params
    (growth, blocks, initial features) are read."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    model = JaxRegistry.create_model({"name": name})
    shapes = golden()[1] if name == "densenet121" else jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 32, 32, 1)), train=False))
    tree_shapes_equal(to_jax_variables(ModelRegistry.create_model({"name": name})),
                      shapes)
    cfg = yaml.safe_load((ROOT / "configs" / "model" / "cnn" / f"{name}.yaml")
                         .read_text())
    built = ModelRegistry.create_model(cfg)
    p = cfg["params"]
    assert isinstance(built, port_densenet.DenseNet)
    assert built.conv0.kernel.shape[0] == p["num_init_features"]
    layers = [n for n in built.stages if n.startswith("denseblock")]
    assert len(layers) == sum(p["block_config"])
    assert built.denseblock1_layer1.Conv_1.kernel.shape[0] == p["growth_rate"]
