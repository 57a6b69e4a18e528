"""Swin training with `train_token_kernels` in the port (norm1 + QKV through
fused_ln_matmul, norm2 + MLP through fused_ln_mlp, both under autograd)
against the JAX package's opt-in path, on the CPU, in float32, on the
bumped small-Swin weights of tests/torch_parity.py. The JAX side is
`create_model(dict(SMALL_F32, use_pallas_attention=True))
.clone(train_token_kernels=True)`, its Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (SMALL_F32, SMALL_SWIN, assert_trees_close,
                                flat_tree, jax_swin, small_batch)
from thyroid_tpu_torch.models.from_jax import (jax_layout, jax_tree,
                                               load_jax_params)
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.models.vit.swin import (SwinBlock, SwinTransformer,
                                               swin_arguments)
from thyroid_tpu_torch.training import losses as tlosses
from thyroid_tpu_torch.training import metrics as tmetrics
from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
from thyroid_tpu_torch.training.engine import Trainer

# the JAX layout of the small Swin's parameters (jax_tree's second argument)
LAYOUT = jax_layout(ModelRegistry.create_model(SMALL_SWIN))


def _jax_model(flag: bool):
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    model = JaxRegistry.create_model(dict(SMALL_F32, use_pallas_attention=True))
    return model.clone(train_token_kernels=True) if flag else model


def _port_model(config, flag: bool, params=None) -> SwinTransformer:
    model = SwinTransformer(**swin_arguments(config), train_token_kernels=flag)
    model.init_weights(torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_params(model, params)
    return model


def _port_loss_grads(model, x, y, w):
    logits = model(torch.from_numpy(x), train=True)
    loss = tlosses.cross_entropy(logits, torch.from_numpy(y), 0.1,
                                 torch.from_numpy(w))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.item(), jax_tree(dict(zip(names, grads)), LAYOUT)


@pytest.fixture(scope="module")
def params():
    return jax_swin(SMALL_SWIN)[1]


def _blocks(model):
    return [m for m in model.modules() if isinstance(m, SwinBlock)]


@pytest.mark.unit
def test_build_swins_drop_train_token_kernels():
    """Neither package's build_swin reads the key: a config that sets it
    builds the default model; the flag takes effect only on the module."""
    cfg = dict(SMALL_SWIN, train_token_kernels=True)
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    assert JaxRegistry.create_model(cfg).train_token_kernels is False
    assert _jax_model(True).train_token_kernels is True
    port = ModelRegistry.create_model(cfg)
    assert port.train_token_kernels is False
    assert not any(b.train_token_kernels for b in _blocks(port))
    flagged = SwinTransformer(**swin_arguments(cfg), train_token_kernels=True)
    assert len(_blocks(flagged)) == 4
    assert all(b.train_token_kernels for b in _blocks(flagged))


@pytest.mark.unit
def test_flag_keeps_the_parameter_tree(params):
    """The flag changes no parameter: JAX's training init gives the same
    tree with it on and off, the port's modules the same names and shapes,
    and the JAX tree loads strictly into the flagged port model."""
    x = jnp.zeros((1, 64, 64, 1))

    def tree(model):
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            x, train=True))["params"]
        return {k: v.shape for k, v in flat_tree(shapes).items()}

    assert tree(_jax_model(True)) == tree(_jax_model(False))
    on, off = _port_model(SMALL_F32, True), _port_model(SMALL_F32, False)
    assert [(n, p.shape) for n, p in on.named_parameters()] == \
        [(n, p.shape) for n, p in off.named_parameters()]
    load_jax_params(on, params)
    assert set(flat_tree(jax_tree(dict(on.named_parameters()),
                                  LAYOUT))) == \
        set(flat_tree(params))


@pytest.mark.unit
def test_small_swin_token_train_grads_match_jax(params):
    """Loss within 1e-5 and parameter gradients within atol 5e-5, rtol
    5e-4 (the JAX package's bound for its fused-vs-XLA training
    gradients) of JAX's flagged model; with the flag off, the port's own
    gradients agree with the flagged ones as closely."""
    from thyroid_tpu.training.losses import cross_entropy

    jmodel = _jax_model(True)
    x, y, w = small_batch(6)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return cross_entropy(logits, jnp.asarray(y), 0.1, jnp.asarray(w))

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    got_loss, got = _port_loss_grads(_port_model(SMALL_F32, True, params), x, y, w)
    assert abs(got_loss - float(want_loss)) < 1e-5
    assert_trees_close(got, want, atol=5e-5, rtol=5e-4)
    assert max(np.abs(v).max() for v in flat_tree(want).values()) > 1e-3

    off_loss, off = _port_loss_grads(_port_model(SMALL_F32, False, params), x, y, w)
    assert abs(off_loss - got_loss) < 1e-5
    assert_trees_close(got, off, atol=5e-5, rtol=5e-4)


@pytest.mark.unit
def test_bf16_token_train_step(params):
    """The flagged model in bf16 on the CPU: finite gradients in float32
    for every parameter, and a loss within 3e-2 of the float32 loss (the
    bound chip_smoke.py holds the card's bf16 step to)."""
    x, y, w = small_batch(7)
    f32_loss, _ = _port_loss_grads(_port_model(SMALL_F32, True, params), x, y, w)
    bf16 = _port_model(dict(SMALL_F32, dtype="bf16"), True, params)
    loss, grads = _port_loss_grads(bf16, x, y, w)
    assert abs(loss - f32_loss) < 3e-2
    flat = flat_tree(grads)
    assert len(flat) == sum(1 for _ in bf16.parameters())
    assert all(v.dtype == np.float32 and np.isfinite(v).all()
               for v in flat.values())


@pytest.mark.unit
def test_three_step_token_trajectory_matches_jax(params, tmp_path):
    """The same three batches through JAX Trainer._train_step on the
    flagged JAX model and the port's train_step on the flagged port model,
    from identical weights (configs/training/vit.yaml with warmup_steps 1,
    ema_decay 0.999, clip 1.0, float32): loss per step within 1e-5, params
    and EMA within atol 1e-6, rtol 1e-5, as the unflagged trajectory test."""
    from thyroid_tpu.training.engine import Trainer as JaxTrainer
    from thyroid_tpu.training.metrics import zero_metric_state

    mcfg = dict(SMALL_F32, use_pallas_attention=True)
    tcfg = dict(TRAINING_VIT, ema_decay=0.999,
                scheduler_params=dict(TRAINING_VIT["scheduler_params"],
                                      warmup_steps=1))
    trcfg = dict(TRAINER_DEFAULT, gradient_clip_val=1.0)
    jt = JaxTrainer(_jax_model(True), mcfg, tcfg, trcfg, steps_per_epoch=3,
                    output_dir=tmp_path / "jax")
    jp = jax.tree.map(jnp.asarray, params)
    state = jt.state.replace(params=jp, ema_params=jax.tree.map(jnp.array, jp),
                             opt_state=jt.state.tx.init(jp))
    pt = Trainer(_port_model(SMALL_F32, True), SMALL_F32, tcfg, trcfg,
                 steps_per_epoch=3, output_dir=tmp_path / "port",
                 params=params, device="cpu")
    assert all(b.train_token_kernels for b in _blocks(pt.model))
    for step in range(3):
        x, y, w = small_batch(20 + step)
        state, jm, _ = jt._train_step(
            state, zero_metric_state(), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(w), jax.random.PRNGKey(step), jnp.float32(0.0))
        tm, _ = pt.train_step(tmetrics.zero_metric_state(), torch.from_numpy(x),
                              torch.from_numpy(y), torch.from_numpy(w))
        want = float(jm["loss_sum"]) / float(jm["w_sum"])
        got = float(tm["loss_sum"]) / float(tm["w_sum"])
        assert abs(got - want) < 1e-5, (step, got, want)
    assert pt.state.step == 3 and int(state.step) == 3
    assert_trees_close(jax_tree(pt.state.params, LAYOUT), state.params,
                       atol=1e-6, rtol=1e-5)
    assert_trees_close(jax_tree(pt.state.ema_params, LAYOUT),
                       state.ema_params,
                       atol=1e-6, rtol=1e-5)
    new, old = flat_tree(jax_tree(pt.state.params, LAYOUT)), flat_tree(params)
    assert max(np.abs(new[k] - old[k]).max() for k in old) > 1e-4
