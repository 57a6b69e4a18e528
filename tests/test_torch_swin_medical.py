"""The port's Swin with the medical adaptations (contrast-adaptive and
quality-guided WindowAttention, quality-aware PatchMerging, window padding,
ape, dropout, the uncertainty head) against the JAX package on the CPU, on
numpy-seeded inputs and bumped weights: WindowAttention branch by branch,
the narrow medical model's logits and uncertainty, one float32 train step
against the JAX Trainer's, and swin_medical.yaml's parameter tree."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (MEDICAL_SWIN, assert_trees_close, jax_swin,
                                perturb)
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import (jax_layout, jax_tree,
                                               load_jax_params, to_jax_params)
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.models.vit import swin as tswin
from thyroid_tpu_torch.training import metrics as tmetrics
from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
from thyroid_tpu_torch.training.engine import Trainer

ROOT = Path(__file__).resolve().parents[1]
# the JAX model as the port's math is: JAX's fused-path math
JAX_MEDICAL = dict(MEDICAL_SWIN, use_pallas_attention=True)


@pytest.fixture(scope="module")
def medical():
    """(JAX narrow medical model (float32), bumped params)."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    _, params = jax_swin(MEDICAL_SWIN)
    return JaxRegistry.create_model(dict(JAX_MEDICAL, dtype="f32")), params


def _x(seed, n=3):
    return np.random.RandomState(seed).randn(n, 40, 40, 1).astype(np.float32)


def _attn_params(module, seed, *args, **kw):
    """Bumped numpy params of a JAX WindowAttention: its tree from an
    eval_shape'd init, kernels N(0, 0.2²) (wider than the model's 0.02, so
    that the gates and the softmax see more than their biases), contrast
    scales 1 + N(0, 0.5²), zero biases."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    rs = np.random.RandomState(seed)

    def draw(tree):
        return {k: draw(v) if hasattr(v, "items") else
                (np.zeros(v.shape, np.float32) if k == "bias" else
                 (1 + 0.5 * rs.randn(*v.shape)).astype(np.float32)
                 if k == "contrast_scale" else
                 (0.2 * rs.randn(*v.shape)).astype(np.float32))
                for k, v in tree.items()}

    return perturb(draw(shapes["params"]))


CASES = {
    # name: (WindowAttention options, spatial, shifted)
    "spatial_ln_kernel": (dict(ln_kernel=True), True, True),
    "spatial_quality_guided": (dict(quality_guided=True), True, True),
    "windows_contrast_quality_mask": (
        dict(contrast_adaptive=True, quality_guided=True), False, True),
}


@pytest.mark.unit
@pytest.mark.parametrize("case", list(CASES))
def test_window_attention_matches_jax(case):
    """The port's WindowAttention against JAX's WindowAttention.apply on
    one branch each (serving, float32, 8x8 maps of width 32, 2 heads,
    window 4, shift 2): the spatial LN+QKV+W-MSA kernel path, the spatial
    path with the quality gate (kernels 2 + 5, gate, projection), and the
    windows path with contrast scaling, the gate and the shift mask. 2e-5:
    the JAX LN-kernel test's bound."""
    from thyroid_tpu.models.vit.swin import WindowAttention as JaxAttention

    opts, spatial, shifted = CASES[case]
    dim, heads, ws = 32, 2, 4
    rs = np.random.RandomState(11)
    x = rs.randn(2, 8, 8, dim).astype(np.float32)
    g = (1 + 0.1 * rs.randn(dim)).astype(np.float32)
    b = (0.1 * rs.randn(dim)).astype(np.float32)
    mask = tswin.shift_attention_mask(8, 8, ws, 2 if shifted else 0)
    jmod = JaxAttention(dim, ws, heads, use_pallas=True, **opts)
    if spatial:
        jargs = (jnp.asarray(x),)
        jkw = dict(mask=jnp.asarray(mask), spatial=True,
                   ln=(jnp.asarray(g), jnp.asarray(b)), fuse_residual=True)
        targs = (torch.from_numpy(x), torch.from_numpy(mask))
        tkw = dict(spatial=True, ln=(torch.from_numpy(g), torch.from_numpy(b)),
                   fuse_residual=True)
    else:
        win = tswin.window_partition(torch.from_numpy(x), ws)
        jargs = (jnp.asarray(win.numpy()),)
        jkw = dict(mask=jnp.asarray(mask))
        targs = (win, torch.from_numpy(mask))
        tkw = {}
    params = _attn_params(jmod, 3, *jargs, **jkw)
    want = np.asarray(jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **jkw))(
        params, *jargs))
    tmod = tswin.WindowAttention(dim, ws, heads, **opts)
    load_jax_params(tmod, params)
    with torch.inference_mode():
        got = tmod(*targs, **tkw).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-5
    assert np.abs(want).max() > 1e-2       # the comparison is not vacuous


def _jax_out(model, params, x, train=False, **kw):
    """JAX's forward in one jitted program (op by op, JAX's CPU takes
    several times longer)."""
    return jax.jit(lambda p, x: model.apply(
        {"params": p}, x, train=train, rngs={"dropout": jax.random.PRNGKey(0)},
        **kw))(params, jnp.asarray(x))


@pytest.mark.unit
def test_medical_model_matches_jax(medical):
    """The narrow medical model (padding in both stages, contrast, quality
    gates, quality-aware merge, ape, uncertainty head) in float32: logits
    and return_uncertainty's output within 1e-5 of JAX's serving forward
    (use_pallas_attention: the fused MLP and merge kernels in interpret
    mode, the windows attention in XLA)."""
    jmodel, params = medical
    x = _x(5)
    want, want_u = (np.asarray(a) for a in _jax_out(
        jmodel, params, x, return_uncertainty=True))
    model = create_and_init(dict(MEDICAL_SWIN, dtype="f32"), device="cpu")
    load_jax_params(model, params)
    with torch.inference_mode():
        got, got_u = model(torch.from_numpy(x), return_uncertainty=True)
        logits = model(torch.from_numpy(x))
    assert torch.equal(logits, got)
    assert np.abs(got.numpy() - want).max() < 1e-5, (got, want)
    assert np.abs(got_u.numpy() - want_u).max() < 1e-5
    assert np.ptp(want[:, 0]) > 1e-3 and np.ptp(want_u[:, 0]) > 1e-4


@pytest.mark.unit
def test_medical_model_bf16_matches_jax():
    """bf16 medical model against JAX's bf16 serving forward: within 2e-2
    on logits of size about 0.3 (bf16 rounds at different places in the two
    frameworks; a bf16 ulp near 1 is 2^-8)."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    _, params = jax_swin(MEDICAL_SWIN)
    jmodel = JaxRegistry.create_model(dict(JAX_MEDICAL, dtype="bf16"))
    x = _x(6)
    want = np.asarray(_jax_out(jmodel, params, x))
    model = create_and_init(dict(MEDICAL_SWIN, dtype="bf16"), device="cpu")
    load_jax_params(model, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 2e-2, (got, want)


def _medical_trainers(params, tmp_path, monkeypatch):
    import thyroid_tpu.training.engine as jax_engine
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    mcfg = dict(MEDICAL_SWIN, dtype="f32", drop_path_rate=0.0, drop_rate=0.0)
    # vit.yaml with no warm-up and a weight decay of 0.05 at lr 1e-3, so
    # that the decay alone visibly moves the uncertainty head's kernels
    tcfg = dict(TRAINING_VIT, scheduler_params=dict(
        TRAINING_VIT["scheduler_params"], warmup_steps=0, warmup_epochs=0),
        optimizer_params=dict(TRAINING_VIT["optimizer_params"], lr=1e-3,
                              weight_decay=0.05))
    jp = jax.tree.map(jnp.asarray, params)
    monkeypatch.setattr(jax_engine, "create_and_init",
                        lambda cfg, rng: (None, {"params": jp}))
    jcfg = dict(mcfg, use_pallas_attention=True)
    jt = jax_engine.Trainer(JaxRegistry.create_model(jcfg), jcfg, tcfg,
                            TRAINER_DEFAULT, steps_per_epoch=3,
                            output_dir=tmp_path / "jax")
    pt = Trainer(ModelRegistry.create_model(mcfg), mcfg, tcfg, TRAINER_DEFAULT,
                 steps_per_epoch=3, output_dir=tmp_path / "port",
                 params=params, device="cpu")
    return jt, pt


@pytest.mark.unit
def test_medical_train_step_matches_jax(medical, tmp_path, monkeypatch):
    """One float32 train step (configs/training/vit.yaml with no warm-up,
    lr 1e-3 and weight decay 0.05; drop path and dropout 0) from the same
    weights: the loss within 1e-5,
    the gradients within atol 5e-5, rtol 5e-4 (the bound of the small-Swin
    gradient test), the uncertainty head's gradients zero; then the updated
    parameters, the uncertainty head's included (its kernels moved only by
    the decoupled weight decay), within atol 1e-5, rtol 1e-5 (an Adam
    update moves an element by about ±lr whatever its gradient)."""
    from thyroid_tpu.training.losses import cross_entropy
    from thyroid_tpu.training.metrics import zero_metric_state

    jmodel, params = medical
    jt, pt = _medical_trainers(params, tmp_path, monkeypatch)
    rs = np.random.RandomState(9)
    x = _x(9, 4)
    y = (np.arange(4) % 2).astype(np.int32)
    w = rs.rand(4).astype(np.float32)

    def loss(p):
        return cross_entropy(_jax_out(jt.model, p, x, train=True),
                             jnp.asarray(y), 0.1, jnp.asarray(w))

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    got_loss, _, grads, _ = pt.loss_and_grads(
        torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(w))
    assert abs(float(got_loss) - float(want_loss)) < 1e-5
    layout = pt.state.layout
    assert_trees_close(jax_tree(grads, layout), want, atol=5e-5, rtol=5e-4)
    for n in ("uncertainty_1.kernel", "uncertainty_2.bias"):
        assert not grads[n].any()
    assert np.abs(want["uncertainty_1"]["kernel"]).max() == 0

    state, jm, _ = jt._train_step(
        jt.state, zero_metric_state(), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(w), jax.random.PRNGKey(0), jnp.float32(0.0))
    tm, _ = pt.train_step(tmetrics.zero_metric_state(), torch.from_numpy(x),
                          torch.from_numpy(y).long(), torch.from_numpy(w))
    assert abs(float(tm["loss_sum"]) / float(tm["w_sum"])
               - float(jm["loss_sum"]) / float(jm["w_sum"])) < 1e-5
    new = jax_tree(pt.state.params, layout)
    assert_trees_close(new, state.params, atol=1e-5, rtol=1e-5)
    decayed = params["uncertainty_1"]["kernel"] * (1 - 1e-3 * 0.05)
    np.testing.assert_allclose(new["uncertainty_1"]["kernel"].numpy(), decayed,
                               rtol=1e-6, atol=0)
    assert not np.array_equal(decayed, params["uncertainty_1"]["kernel"])


@pytest.mark.unit
def test_swin_medical_yaml_tree_matches_jax():
    """configs/model/vit/swin_medical.yaml (full depth, 256², padding in
    every stage, dropout 0.05) builds in both packages with the same
    parameter names and shapes (JAX's init traced with eval_shape, not
    run)."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg = yaml.safe_load((ROOT / "configs/model/vit/swin_medical.yaml").read_text())
    jmodel = JaxRegistry.create_model(cfg)
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 1)), train=False))
    model = ModelRegistry.create_model(cfg)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out.update(shapes(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = tuple(v.shape)
        return out

    got = shapes(to_jax_params(model))
    assert got == shapes(want["params"])
    blocks = [getattr(getattr(model, f"stage_{s}"), f"block_{i}")
              for s, d in enumerate((2, 2, 18, 2)) for i in range(d)]
    assert all(b.padded for b in blocks)
    assert {b.attn.proj_drop_rate for b in blocks} == {0.05}
    assert model.drop_rate == 0.05 and len(jax_layout(model)) == len(got)
