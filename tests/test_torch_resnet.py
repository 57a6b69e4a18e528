"""The port's ResNet (thyroid_tpu_torch/models/cnn/resnet.py) against the
JAX package on the CPU in float32: a narrow ResNet (width 8, one block a
stage, 32²) of either block kind on numpy-drawn, bumped weights with
running statistics from a JAX train-mode forward, its forward and one
Trainer step (with and without MixUp/CutMix on JAX's own draws); the
golden resnet18 and resnet50 logits from JAX's PRNGKey(0) init; the
variable tree of resnet18/34/50/101 by name and shape; the unwired
SpatialAttention and QualityEncoder."""
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (flat_tree, global_rel, golden_variables,
                                jax_cnn, jax_mixup_cutmix_params,
                                jax_train_stats)
from thyroid_tpu_torch.models.cnn import resnet as port_resnet
from thyroid_tpu_torch.models.from_jax import (jax_tree, load_jax_variables,
                                               to_jax_variables)
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training import engine as port_engine
from thyroid_tpu_torch.training import metrics as tmetrics
from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_CNN
from thyroid_tpu_torch.training.engine import Trainer

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
BLOCKS = ("basic", "bottleneck")


def narrow(block: str):
    return {"name": "resnet18" if block == "basic" else "resnet50",
            "block": block, "layers": (1, 1, 1, 1), "width": 8,
            "img_size": 32, "in_channels": 1, "num_classes": 2, "dtype": "f32",
            "dropout_rate": 0.0}


@lru_cache(maxsize=None)
def small(block: str):
    """(block, JAX narrow ResNet, its variables with running statistics),
    built once per block kind."""
    cfg = narrow(block)
    model, variables = jax_cnn(cfg)
    x = np.random.RandomState(1).randn(8, 32, 32, 1).astype(np.float32)
    return block, model, jax_train_stats(model, variables, jnp.asarray(x))


def _port(cfg, variables):
    """The port's model of `cfg` holding `variables` (the strict loader
    fills every tensor, so no initial draw is made), in eval mode."""
    model = ModelRegistry.create_model(cfg)
    load_jax_variables(model, variables)
    return model.eval()


@pytest.mark.unit
@pytest.mark.parametrize("block", BLOCKS)
def test_forward_matches_jax(block):
    block, model, variables = small(block)
    x = np.random.RandomState(2).randn(3, 32, 32, 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(narrow(block), variables)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(want[0] - want[1]).max() > 1e-2     # the input matters


TCFG = dict(TRAINING_CNN, scheduler_params=dict(TRAINING_CNN["scheduler_params"],
                                                warmup_steps=1))


def _batch(seed, n=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 32, 32, 1).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.int32)
    w = np.ones(n, np.float32)
    w[-1] = 0.5
    return x, y, w


@pytest.mark.unit
@pytest.mark.parametrize("block,mix", [("basic", False), ("bottleneck", False),
                                       ("bottleneck", True)],
                         ids=["basic-plain", "bottleneck-plain",
                              "bottleneck-mixup_cutmix"])
def test_train_step_matches_jax(block, mix, tmp_path, monkeypatch):
    """One training step's loss, gradients and updated running statistics
    as JAX's Trainer computes them (its _train_step_impl: MixUp/CutMix on
    the step key's second half, the train-mode forward with mutable
    batch_stats, CE or the mixed CE; one jitted value_and_grad here)
    against the port's train_step from the same variables (cnn.yaml,
    float32): the loss within 1e-4, the gradients' global difference
    within 1e-3 of their norm, the statistics within 1e-4. With
    mixup_alpha 0.8 and cutmix_alpha 1.0 the port's draw is replaced by
    JAX's mirror (permutation, λ, box, switch): the bottleneck net, whose
    blocks the root default's resnet50 runs."""
    from thyroid_tpu.ops.augment import mixup_cutmix
    from thyroid_tpu.training.losses import cross_entropy, mixed_cross_entropy

    block, model, variables = small(block)
    cfg = narrow(block)
    tcfg = dict(TCFG, mixup_alpha=0.8, cutmix_alpha=1.0) if mix else TCFG
    x, y, w = _batch(10)
    _, mix_rng = jax.random.split(jax.random.PRNGKey(3))

    def loss_fn(params, batch_stats, x, y, w):
        labels_b = lam = None
        if mix:
            x, _, labels_b, lam = mixup_cutmix(x, y, mix_rng, mixup_alpha=0.8,
                                               cutmix_alpha=1.0)
        logits, upd = model.apply({"params": params, "batch_stats": batch_stats},
                                  x, train=True, mutable=["batch_stats"])
        if mix:
            loss = mixed_cross_entropy(logits, y, labels_b, lam, 0.0, w)
        else:
            loss = cross_entropy(logits, y, 0.0, w)
        return loss, upd["batch_stats"]

    (want, stats_want), grads_want = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(w))
    if mix:
        mirror = jax_mixup_cutmix_params(mix_rng, x.shape, 0.8, 1.0)
        monkeypatch.setattr(port_engine, "draw_mixup_cutmix",
                            lambda *a, **k: mirror)
    grads = {}
    loss_and_grads = Trainer.loss_and_grads

    def keep(self, *args):
        out = loss_and_grads(self, *args)
        grads.update(out[2])
        return out

    monkeypatch.setattr(Trainer, "loss_and_grads", keep)
    pt = Trainer(ModelRegistry.create_model(cfg), cfg, tcfg, TRAINER_DEFAULT,
                 steps_per_epoch=2, output_dir=tmp_path, variables=variables,
                 device="cpu")
    tm, _ = pt.train_step(tmetrics.zero_metric_state(), torch.from_numpy(x),
                          torch.from_numpy(y).long(), torch.from_numpy(w))
    got = float(tm["loss_sum"]) / float(tm["w_sum"])
    assert abs(got - float(want)) <= 1e-4 * max(1.0, abs(float(want))), \
        (got, float(want))
    assert global_rel(jax_tree(grads, pt.state.layout),
                       jax.tree.map(np.asarray, grads_want)) < 1e-3
    stats = flat_tree(jax_tree(pt.state.batch_stats, pt.state.layout))
    for k, v in flat_tree(stats_want).items():
        np.testing.assert_allclose(stats[k], np.asarray(v), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    # the metrics count the original labels, mixed or not
    assert float(tm["w_sum"]) == float(w.sum())


@pytest.mark.unit
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_golden_logits(name):
    """The golden fixture's logits from the port on JAX's initial variables,
    at tests/unit/test_golden_parity.py's tolerance."""
    rec = np.load(GOLDEN / f"{name}.npz")
    cfg, variables = golden_variables(name)
    rs = np.random.RandomState(12345)
    x = (rs.rand(2, 224, 224, 1).astype(np.float32) * 2 - 1)
    with torch.no_grad():
        got = _port(cfg, jax.tree.map(np.asarray, variables))(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, rec["logits"], atol=2e-3, rtol=1e-3)


@pytest.mark.unit
@pytest.mark.parametrize("name", list(port_resnet.RESNET_PARAMS))
def test_variable_tree_and_yaml(name):
    """resnet18/34/50/101 from the registry and from configs/model/cnn/*:
    names, shapes and collections against JAX's init (jax.eval_shape);
    the YAML's nested params (block, layers, width, dropout) are read."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    model = JaxRegistry.create_model({"name": name})
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 1)),
        train=False))
    port = to_jax_variables(ModelRegistry.create_model({"name": name}))
    assert set(port) == {"params", "batch_stats"}
    for col in port:
        want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    shapes[col])[0]}
        got = {k: tuple(v.shape) for k, v in flat_tree(port[col]).items()}
        assert got == want, col
    cfg = yaml.safe_load((ROOT / "configs" / "model" / "cnn" / f"{name}.yaml")
                         .read_text())
    built = ModelRegistry.create_model(cfg)
    assert isinstance(built, port_resnet.ResNet)
    assert built.dropout_rate == cfg["params"]["dropout_rate"]
    assert len(built.blocks) == sum(cfg["params"]["layers"])


@pytest.mark.unit
@pytest.mark.parametrize("block", BLOCKS)
def test_round_trip_strict_and_capture(block):
    """load_jax_variables and to_jax_variables are exact inverses, strict
    on a missing downsample; the capture forward gives the same logits
    and the last block's output ("features"); for the
    bottleneck net (resnet50's blocks) the bf16 forward within 1e-2 of
    JAX's bf16 forward as written (bf16 moves these logits by 6e-2 from
    float32, and XLA's default jitted program, which keeps some
    intermediates in float32, by as much from the one as written)."""
    block, _, variables = small(block)
    model = _port(narrow(block), variables)
    back = to_jax_variables(model)
    for col in ("params", "batch_stats"):
        got, want = flat_tree(back[col]), flat_tree(variables[col])
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), col
    params = dict(variables["params"])
    params["layer2_0"] = {k: v for k, v in params["layer2_0"].items()
                          if k != "downsample"}
    with pytest.raises(KeyError, match="downsample"):
        load_jax_variables(model, {**variables, "params": params})
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 32, 32, 1)
                         .astype(np.float32))
    with torch.no_grad():
        logits, inter = model(x, capture=True)
        assert torch.equal(logits, model(x))
    assert list(inter) == ["features"] and inter["features"].shape[0] == 2
    if block != "bottleneck":
        return
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg = dict(narrow(block), dtype="bf16")
    jmodel = JaxRegistry.create_model(cfg)
    # jitted without excess precision: every bf16 result is rounded where
    # the program writes it, bit-equal to the eager forward in one compile
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)).lower(
        variables, jnp.asarray(x.numpy())).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                variables, jnp.asarray(x.numpy()))
    with torch.no_grad():
        got = _port(cfg, variables)(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2, rtol=0)


@pytest.mark.unit
def test_spatial_attention_and_quality_encoder():
    from thyroid_tpu.models.cnn import resnet as jax_resnet

    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 5, 8).astype(np.float32)
    q = rs.rand(3, 3).astype(np.float32)
    for jmod, pmod, inp in (
            (jax_resnet.SpatialAttention(), port_resnet.SpatialAttention(8), x),
            (jax_resnet.QualityEncoder(hidden_dim=16),
             port_resnet.QualityEncoder(3, 16), q)):
        variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(inp))
        want = jmod.apply(variables, jnp.asarray(inp))
        load_jax_variables(pmod, jax.tree.map(np.asarray, variables))
        with torch.no_grad():
            got = pmod(torch.from_numpy(inp))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)
