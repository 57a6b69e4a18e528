"""The port's efficientnet training (BatchNorm statistics through the train
step, checkpoints and Trainer.fit) against the JAX package on the CPU, on
the narrow efficientnet of tests/torch_parity.py with numpy-drawn,
bumped weights and running statistics from a JAX train-mode forward."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (SMALL_EFFNET, assert_trees_close, flat_tree,
                                jax_cnn, jax_train_stats)
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.data.pipeline import DevicePipeline
from thyroid_tpu_torch.models.from_jax import jax_tree, to_jax_variables
from thyroid_tpu_torch.models.layers import dropout
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.ops import depthwise_pallas
from thyroid_tpu_torch.training import checkpoint as tckpt
from thyroid_tpu_torch.training import metrics as tmetrics
from thyroid_tpu_torch.training.configs import (MODEL_EFFICIENTNET_B0,
                                                TRAINER_DEFAULT, TRAINING_CNN)
from thyroid_tpu_torch.training.engine import Trainer

ROOT = Path(__file__).resolve().parents[1]
# configs/training/cnn.yaml with one warm-up step (so the updates are not
# all but zero) and an EMA, float32
TCFG = dict(TRAINING_CNN, ema_decay=0.999,
            scheduler_params=dict(TRAINING_CNN["scheduler_params"],
                                  warmup_steps=1))
TRCFG = dict(TRAINER_DEFAULT, gradient_clip_val=1.0)


def _batch(seed, n=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 32, 32, 1).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.int32)
    w = np.ones(n, np.float32)
    w[-1] = 0.5
    return x, y, w


@pytest.fixture(scope="module")
def small():
    """(JAX narrow efficientnet, its variables with running statistics)."""
    model, variables = jax_cnn(SMALL_EFFNET)
    return model, jax_train_stats(model, variables, jnp.asarray(_batch(1, 8)[0]))


@pytest.mark.unit
def test_config_literals_match_yaml():
    for lit, rel in ((TRAINING_CNN, "configs/training/cnn.yaml"),
                     (MODEL_EFFICIENTNET_B0,
                      "configs/model/cnn/efficientnet_b0.yaml")):
        assert lit == yaml.safe_load((ROOT / rel).read_text()), rel
    model = ModelRegistry.create_model(MODEL_EFFICIENTNET_B0)
    assert model.dropout_rate == 0.2 and model.img_size == 224


def _stats(trainer):
    return jax_tree(trainer.state.batch_stats, trainer.state.layout)


def _zero_grad_biases(model):
    """The project BatchNorm's bias of every MBConv. Every path from it
    reaches a train-mode BatchNorm through a 1×1 convolution (the next
    block's expand conv or the head conv, across residual adds), which
    removes a per-channel constant: its gradient is zero up to rounding,
    and Adam turns that rounding, which differs between the frameworks,
    into updates of up to about lr."""
    return {f"{n}.{getattr(model, n).bns[-1]}.bias" for n in model.blocks}


@pytest.mark.unit
def test_three_step_trajectory_matches_jax(small, tmp_path, monkeypatch):
    """The same three batches through JAX Trainer._train_step and the
    port's train_step from identical variables (cnn.yaml: AdamW lr 1e-4, wd
    1e-5; one warm-up step, EMA 0.999, clip 1.0, float32). After each step:
    the loss within 1e-5; the parameters and their EMA within atol 5e-6,
    rtol 1e-5 (an Adam update moves an element by about ±lr whatever its
    gradient, so an element whose gradient is near zero, as BatchNorm makes
    some, moves by a share of lr that rounding decides), and the biases of
    _zero_grad_biases within 3·lr per update;
    the running statistics within 1e-5 (the batch statistics' float32 sums
    in another order). The JAX Trainer starts from these variables: its
    create_and_init is replaced (flax's unjitted init takes half a minute)
    and its create_train_state jitted (one compile, not one per leaf)."""
    import thyroid_tpu.training.engine as jax_engine
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry
    from thyroid_tpu.training.metrics import zero_metric_state

    _, variables = small
    jv = jax.tree.map(jnp.asarray, variables)
    monkeypatch.setattr(jax_engine, "create_and_init", lambda cfg, rng: (None, jv))
    make_state = jax_engine.create_train_state
    monkeypatch.setattr(jax_engine, "create_train_state",
                        lambda model, v, tx, ema: jax.jit(
                            lambda v: make_state(model, v, tx, ema))(v))
    jt = jax_engine.Trainer(JaxRegistry.create_model(SMALL_EFFNET), SMALL_EFFNET,
                            TCFG, TRCFG, steps_per_epoch=3,
                            output_dir=tmp_path / "jax")
    state = jt.state
    pt = Trainer(ModelRegistry.create_model(SMALL_EFFNET), SMALL_EFFNET, TCFG,
                 TRCFG, steps_per_epoch=3, output_dir=tmp_path / "port",
                 variables=variables, device="cpu")
    loose = _zero_grad_biases(pt.model)
    for step in range(3):
        x, y, w = _batch(10 + step)
        state, jm, _ = jt._train_step(
            state, zero_metric_state(), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(w), jax.random.PRNGKey(step), jnp.float32(0.0))
        tm, _ = pt.train_step(tmetrics.zero_metric_state(), torch.from_numpy(x),
                              torch.from_numpy(y).long(), torch.from_numpy(w))
        want = float(jm["loss_sum"]) / float(jm["w_sum"])
        got = float(tm["loss_sum"]) / float(tm["w_sum"])
        assert abs(got - want) < 1e-5, (step, got, want)
        layout = pt.state.layout
        for mine, ref in ((pt.state.params, state.params),
                          (pt.state.ema_params, state.ema_params)):
            tight = {n: t for n, t in mine.items() if n not in loose}
            assert_trees_close(jax_tree(tight, layout), _without(ref, loose),
                               atol=5e-6, rtol=1e-5)
            got_b = flat_tree(jax_tree({n: mine[n] for n in loose}, layout))
            ref_b = flat_tree(ref)
            for n, v in got_b.items():
                np.testing.assert_allclose(v, ref_b[n], atol=3e-4 * step + 1e-6,
                                           rtol=0, err_msg=n)
        assert_trees_close(_stats(pt), state.batch_stats, atol=1e-5, rtol=1e-5)
    new, old = flat_tree(_stats(pt)), flat_tree(variables["batch_stats"])
    assert max(np.abs(new[k] - old[k]).max() for k in old) > 1e-2
    new, old = flat_tree(jax_tree(pt.state.params, pt.state.layout)), \
        flat_tree(variables["params"])
    assert max(np.abs(new[k] - old[k]).max() for k in old) > 1e-4


def _without(tree, names):
    """A nested tree without the leaves at the dotted `names`."""
    flat = {k: v for k, v in flat_tree(tree).items() if k not in names}
    out = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@pytest.mark.unit
def test_bf16_step_loss_matches_jax(small, tmp_path):
    """One bf16 train step's loss against JAX's bf16 training forward on the
    same variables and a batch of 8 at 64², within 2e-2: bf16 rounds at
    other places in the two frameworks, and JAX's own two depthwise paths
    (library conv, dw_shift_conv) differ by 1e-2 in bf16 on this batch. At
    32² and batch 4 the last stages' BatchNorm sees 4 values per channel
    and amplifies the roundings beyond that. The step moves the
    statistics."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry
    from thyroid_tpu.training.losses import cross_entropy

    _, variables = small
    rs = np.random.RandomState(20)
    x = rs.randn(8, 64, 64, 1).astype(np.float32)
    y, w = (np.arange(8) % 2).astype(np.int32), np.ones(8, np.float32)
    bf16 = dict(SMALL_EFFNET, dtype="bf16")
    jmodel = JaxRegistry.create_model(bf16)
    logits, _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    want = float(cross_entropy(logits, jnp.asarray(y), 0.0, jnp.asarray(w)))
    pt = Trainer(ModelRegistry.create_model(bf16), bf16, TCFG, TRCFG,
                 steps_per_epoch=1, output_dir=tmp_path, variables=variables,
                 device="cpu")
    before = {k: v.clone() for k, v in pt.state.batch_stats.items()}
    tm, _ = pt.train_step(tmetrics.zero_metric_state(), torch.from_numpy(x),
                          torch.from_numpy(y).long(), torch.from_numpy(w))
    got = float(tm["loss_sum"]) / float(tm["w_sum"])
    assert abs(got - want) < 2e-2, (got, want)
    assert all(not torch.equal(before[k], v) for k, v in pt.state.batch_stats.items())


@pytest.mark.unit
def test_fit_with_dw_pallas_and_checkpoints(small, tmp_path, monkeypatch):
    """Trainer.fit with dw_pallas_conv on the CPU for two epochs: each eval
    forward runs the plain depthwise once per stride-1 block (4 in the
    narrow net) and the train steps never; the best checkpoint restores
    parameters and statistics (test reproduces its epoch's val metrics);
    save_state/resume_from restore params, batch_stats, optimizer state,
    EMA and step exactly."""
    _, variables = small
    calls = []
    plain = depthwise_pallas.depthwise_conv2d_plain
    monkeypatch.setattr(depthwise_pallas, "depthwise_conv2d_plain",
                        lambda x, w: calls.append(x.shape) or plain(x, w))
    rs = np.random.RandomState(3)
    imgs = (rs.rand(12, 48, 48, 1) * 65535).astype(np.float32)
    labels = (np.arange(12) % 2).astype(np.int64)
    train = DevicePipeline(imgs, labels, batch_size=4, img_size=32,
                           train=True, device="cpu")
    val = DevicePipeline(imgs[:6], labels[:6], batch_size=4, img_size=32,
                         device="cpu")
    cfg = dict(SMALL_EFFNET, dw_pallas_conv=True, drop_path_rate=0.2,
               dropout_rate=0.2)
    tcfg = dict(TCFG, epochs=2)
    trainer = Trainer(ModelRegistry.create_model(cfg), cfg, tcfg, TRCFG,
                      steps_per_epoch=train.steps_per_epoch(),
                      output_dir=tmp_path / "run", variables=variables,
                      device="cpu")
    fit = trainer.fit(train, val)
    assert trainer.state.step == 6 and len(calls) == 4 * 2 * 2
    assert all(np.isfinite(v) for v in fit.history[-1].values())
    stats = flat_tree(_stats(trainer))
    assert max(np.abs(stats[k] - v).max()
               for k, v in flat_tree(variables["batch_stats"]).items()) > 1e-2

    best_epoch = json.loads((fit.best_checkpoint / "metadata.json")
                            .read_text())["epoch"]
    ckpt, _ = tckpt.load_checkpoint(fit.best_checkpoint)
    assert set(ckpt) == {"params", "batch_stats"}
    test = trainer.test(val, checkpoint=fit.best_checkpoint)
    for k, v in fit.history[best_epoch].items():
        if k.startswith("val_"):
            assert test["test_" + k[4:]] == pytest.approx(v, abs=1e-6), k
    assert_trees_close(to_jax_variables(trainer.model)["batch_stats"],
                       ckpt["batch_stats"], atol=0, rtol=0)

    saved = trainer.save_state(tmp_path / "state.ckpt")
    other = Trainer(ModelRegistry.create_model(cfg), cfg, dict(tcfg, seed=7),
                    dict(TRCFG, seed=7), steps_per_epoch=3,
                    output_dir=tmp_path / "other", device="cpu")
    other.resume_from(saved)
    assert other.state.step == trainer.state.step == other._global_step
    for n, b in trainer.state.batch_stats.items():
        assert torch.equal(other.state.batch_stats[n], b), n
    for n, p in trainer.state.params.items():
        assert torch.equal(other.state.params[n], p), n
        assert torch.equal(other.state.ema_params[n], trainer.state.ema_params[n])
        assert torch.equal(other.state.opt_state.mu[n], trainer.state.opt_state.mu[n])
    assert depthwise_pallas.depthwise_conv2d_pallas.launches == 0


@pytest.mark.unit
def test_stochastic_depth_and_dropout():
    """DropPath only on residual blocks, at drop_path_rate · block / blocks
    (JAX's rate, not Swin's linspace); flax Dropout semantics: keep with
    probability 1 − rate, scaled by 1/keep, identity at eval and rate 0."""
    model = ModelRegistry.create_model(
        {"name": "efficientnet_b0", "drop_path_rate": 0.32})
    rates = {n: getattr(model, n).drop_path.rate for n in model.blocks
             if getattr(model, n).drop_path is not None}
    total = len(model.blocks)
    assert total == 16
    want = {n: 0.32 * i / total for i, n in enumerate(model.blocks)
            if getattr(model, n).residual}
    assert rates == pytest.approx(want) and len(rates) == 9
    x = torch.ones(20000)
    assert dropout(x, 0.2, False, None) is x and dropout(x, 0.0, True, None) is x
    y = dropout(x, 0.2, True, torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.8))}
    assert abs(float((y > 0).float().mean()) - 0.8) < 0.02
    with pytest.raises(ValueError):
        dropout(x, 0.2, True, None)
