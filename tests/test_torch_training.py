"""The port's training path (thyroid_tpu_torch.training, DropPath, the Swin
training forward, DevicePipeline) against the JAX package on the CPU, in
float32, on numpy-seeded inputs and the bumped small-Swin weights of
tests/torch_parity.py."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (SMALL_F32, SMALL_SWIN, assert_trees_close,
                                flat_tree, jax_swin, small_batch)
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.data.pipeline import DevicePipeline
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import (jax_layout, jax_tree,
                                               load_jax_params)
from thyroid_tpu_torch.models.layers import DropPath
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.ops.augment import train_augment
from thyroid_tpu_torch.training import checkpoint as tckpt
from thyroid_tpu_torch.training import losses as tlosses
from thyroid_tpu_torch.training import metrics as tmetrics
from thyroid_tpu_torch.training import schedules as tsched
from thyroid_tpu_torch.training.configs import (TRAINER_DEFAULT, TRAINING_VIT,
                                                VIT_OPTIMIZER_PARAMS)
from thyroid_tpu_torch.training.engine import Trainer

ROOT = Path(__file__).resolve().parents[1]
# the JAX layout of the small Swin's parameters (jax_tree's second argument)
LAYOUT = jax_layout(ModelRegistry.create_model(SMALL_SWIN))


def _np(tree):
    """A JAX-named tree of torch tensors as numpy, for the JAX functions."""
    return {k: _np(v) if hasattr(v, "items") else v.numpy()
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def small():
    """(JAX small Swin with the Pallas training path, bumped params)."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    _, params = jax_swin(SMALL_SWIN)
    model = JaxRegistry.create_model(dict(SMALL_F32, use_pallas_attention=True))
    return model, params


@pytest.mark.unit
def test_config_literals_match_yaml():
    for lit, rel in ((TRAINING_VIT, "configs/training/vit.yaml"),
                     (TRAINER_DEFAULT, "configs/trainer/default.yaml")):
        assert lit == yaml.safe_load((ROOT / rel).read_text()), rel
    assert VIT_OPTIMIZER_PARAMS == json.loads(
        (ROOT / "configs/vit_optimizer_params.json").read_text())


@pytest.mark.unit
def test_small_swin_train_grads_match_jax(small):
    """Parameter gradients of the training forward (CE with label
    smoothing and weights) against JAX's use_pallas_attention path in
    interpret mode; atol 5e-5, rtol 5e-4, the JAX package's own bound for
    its fused-vs-XLA training gradients."""
    from thyroid_tpu.training.losses import cross_entropy

    jmodel, params = small
    x, y, w = small_batch(5)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return cross_entropy(logits, jnp.asarray(y), 0.1, jnp.asarray(w))

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    model = create_and_init(SMALL_F32, device="cpu")
    load_jax_params(model, params)
    logits = model(torch.from_numpy(x), train=True)
    got_loss = tlosses.cross_entropy(logits, torch.from_numpy(y), 0.1,
                                     torch.from_numpy(w))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(got_loss, list(model.parameters()))
    assert abs(got_loss.item() - float(want_loss)) < 1e-5
    assert_trees_close(jax_tree(dict(zip(names, grads)), LAYOUT), want,
                        atol=5e-5, rtol=5e-4)
    assert max(np.abs(v).max() for v in flat_tree(want).values()) > 1e-3


@pytest.mark.unit
@pytest.mark.parametrize("kind,extra", [
    ("cosine", {"warmup_epochs": 2, "eta_min": 1e-6}),
    ("cosine", {"warmup_steps": 7}),
    ("step", {"warmup_steps": 3, "step_size": 1, "gamma": 0.5}),
    ("constant", {"warmup_epochs": 1}),
])
def test_schedule_matches_optax(kind, extra):
    """60 update counts of each schedule against the JAX package's optax
    schedule, within 1e-7."""
    from thyroid_tpu.training.schedules import build_schedule

    kw = dict(base_lr=1e-3, steps_per_epoch=6, epochs=10, kind=kind, **extra)
    want = build_schedule(**kw)
    got = tsched.build_schedule(**kw)
    for count in range(60):
        assert abs(got(count) - float(want(count))) < 1e-7, count
    if "warmup_epochs" in extra or "warmup_steps" in extra:
        assert got(0) == 0.0


def _param_tree(seed):
    """A small-Swin-shaped tree of random float32 leaves (port names)."""
    model = create_and_init(SMALL_SWIN, device="cpu")
    rs = np.random.RandomState(seed)
    return {n: torch.from_numpy(rs.randn(*p.shape).astype(np.float32) * 0.1)
            for n, p in model.named_parameters()}


@pytest.mark.unit
def test_layer_decay_mask_matches_jax():
    from thyroid_tpu.training.schedules import layer_decay_mask

    params = _param_tree(0)
    want = flat_tree(layer_decay_mask(_np(jax_tree(params, LAYOUT)), 0.9, 2))
    got = tsched.layer_decay_mask(params, 0.9, 2)
    assert {k.replace("patch_embed.weight", "patch_embed.kernel"): v
            for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    # the quirk: a block index inside its stage wins over the stage index
    assert got["stage_1.block_0.attn.qkv.kernel"] == 0.9
    assert got["stage_0.downsample.norm.scale"] == 0.9
    assert got["norm.scale"] == 1.0
    assert got["patch_embed.weight"] == pytest.approx(0.81)


@pytest.mark.unit
@pytest.mark.parametrize("grad_scale", [10.0, 1e-3], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax(grad_scale):
    """Two updates of clip_by_global_norm(1) → adamw (mask ndim > 1) →
    layer decay 0.9, with a warmup-then-cosine schedule (the first update
    reads lr at count 0), against the JAX package's optax chain, 1e-6."""
    import optax

    from thyroid_tpu.training.schedules import build_optimizer, build_schedule

    params = _param_tree(1)
    grads = [{n: g * grad_scale for n, g in _param_tree(s).items()}
             for s in (2, 3)]
    kw = dict(base_lr=1e-2, steps_per_epoch=1, epochs=10, warmup_steps=1)
    okw = dict(weight_decay=0.05, gradient_clip_val=1.0, layer_decay=0.9,
               num_layers=2)
    jp = _np(jax_tree(params, LAYOUT))
    tx = build_optimizer(jp, build_schedule(**kw), **okw)
    ostate = tx.init(jp)
    update = jax.jit(tx.update)
    port = tsched.build_optimizer(params, tsched.build_schedule(**kw), **okw)
    pstate = port.init(params)
    tp = {n: p.clone() for n, p in params.items()}
    for g in grads:
        upd, ostate = update(_np(jax_tree(g, LAYOUT)), ostate, jp)
        jp = optax.apply_updates(jp, upd)
        tsched.apply_updates(tp, port.update(g, pstate, tp))
    assert pstate.count == 2
    assert_trees_close(jax_tree(tp, LAYOUT), jp, atol=1e-6, rtol=0)
    moved = max(float((tp[n] - p).abs().max()) for n, p in params.items())
    assert moved > 1e-3


@pytest.mark.unit
def test_cross_entropy_matches_jax():
    from thyroid_tpu.training.losses import cross_entropy

    rs = np.random.RandomState(4)
    logits = rs.randn(9, 2).astype(np.float32) * 3
    labels = rs.randint(0, 2, 9).astype(np.int32)
    weights = rs.rand(9).astype(np.float32)
    for ls, w in ((0.0, None), (0.1, None), (0.1, weights),
                  (0.0, np.zeros(9, np.float32))):
        want = cross_entropy(jnp.asarray(logits), jnp.asarray(labels), ls,
                             None if w is None else jnp.asarray(w))
        got = tlosses.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels), ls,
                                    None if w is None else torch.from_numpy(w))
        assert abs(float(got) - float(want)) < 1e-6, (ls, w)


@pytest.mark.unit
def test_metric_state_and_auroc_match_jax():
    """Two batches through update_metric_state, then finalize, against the
    JAX package: confusion counts, weighted loss, and AUROC with tied
    scores and weight-0 padding rows."""
    from thyroid_tpu.training import metrics as jm

    rs = np.random.RandomState(5)
    batches = []
    for _ in range(2):
        p1 = np.round(rs.rand(8), 1).astype(np.float32)     # ties
        probs = np.stack([1 - p1, p1], axis=1)
        labels = rs.randint(0, 2, 8).astype(np.int32)
        w = np.ones(8, np.float32)
        w[-2:] = 0.0
        batches.append((probs, labels, w, np.float32(rs.rand())))
    js, ts = jm.zero_metric_state(), tmetrics.zero_metric_state()
    jsc, tsc = [], []
    for probs, labels, w, loss in batches:
        js, s1 = jm.update_metric_state(js, jnp.asarray(probs),
                                        jnp.asarray(labels), jnp.asarray(w),
                                        loss=jnp.asarray(loss))
        jsc.append(s1)
        ts, t1 = tmetrics.update_metric_state(
            ts, torch.from_numpy(probs), torch.from_numpy(labels),
            torch.from_numpy(w), loss=torch.tensor(loss))
        tsc.append(t1)
    labels = [b[1] for b in batches]
    wts = [b[2] for b in batches]
    want = jm.finalize_metric_state(js, jsc, [jnp.asarray(x) for x in labels],
                                    [jnp.asarray(x) for x in wts], prefix="val_")
    got = tmetrics.finalize_metric_state(
        ts, tsc, [torch.from_numpy(x) for x in labels],
        [torch.from_numpy(x) for x in wts], prefix="val_")
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    sc = np.array([0.1, 0.4, 0.4, 0.8, 0.4])
    lb = np.array([0, 1, 0, 1, 1])
    assert tmetrics.auroc(sc, lb) == jm.auroc(sc, lb)
    assert np.isnan(tmetrics.auroc(sc, np.zeros(5)))


@pytest.mark.unit
def test_three_step_trajectory_matches_jax(small, tmp_path, monkeypatch):
    """The same three batches through JAX Trainer._train_step and the
    port's train_step from identical weights: configs/training/vit.yaml
    (label smoothing 0.1, AdamW lr 1e-4, wd 1e-5, layer decay 0.9) with
    warmup_steps 1, ema_decay 0.999, clip 1.0, float32. Loss per step
    within 1e-5. Params and EMA within atol 1e-6, rtol 1e-5: the gradients
    agree to float32 summation order, and an Adam update divides each by
    its own root mean square, so an element whose gradient is much larger
    than eps moves by nearly ±lr whatever its size; at lr 1e-4 that keeps
    the difference of the parameters near 1e-8."""
    import thyroid_tpu.training.engine as jax_engine
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry
    from thyroid_tpu.training.metrics import zero_metric_state

    _, params = small
    mcfg = dict(SMALL_F32, use_pallas_attention=True)
    tcfg = dict(TRAINING_VIT, ema_decay=0.999,
                scheduler_params=dict(TRAINING_VIT["scheduler_params"],
                                      warmup_steps=1))
    trcfg = dict(TRAINER_DEFAULT, gradient_clip_val=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    # the state is rebuilt on these weights below: skip JAX's unjitted init
    monkeypatch.setattr(jax_engine, "create_and_init",
                        lambda cfg, rng: (None, {"params": jp}))
    jt = jax_engine.Trainer(JaxRegistry.create_model(mcfg), mcfg, tcfg, trcfg,
                            steps_per_epoch=3, output_dir=tmp_path / "jax")
    state = jt.state.replace(params=jp, ema_params=jax.tree.map(jnp.array, jp),
                             opt_state=jt.state.tx.init(jp))
    pt = Trainer(ModelRegistry.create_model(SMALL_F32), SMALL_F32, tcfg, trcfg,
                 steps_per_epoch=3, output_dir=tmp_path / "port",
                 params=params, device="cpu")
    for step in range(3):
        x, y, w = small_batch(10 + step)
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
    moved = max(np.abs(new[k] - old[k]).max() for k in old)
    assert moved > 1e-4          # two updates at lr 1e-4 moved the weights


def _frames(n, seed=0, side=64):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, side, side, 1) * 65535).astype(np.float32), \
        (np.arange(n) % 2).astype(np.int64)


@pytest.mark.unit
def test_fit_test_and_checkpoint_round_trip(tmp_path):
    """fit for two epochs on a dozen 64² frames, then test(checkpoint=best):
    history keys are the JAX engine's, the best checkpoint reproduces its
    epoch's val metrics, and save_state/resume_from restore params,
    optimizer state, EMA and step exactly."""
    from thyroid_tpu.training.metrics import finalize_metric_state, zero_metric_state

    imgs, labels = _frames(12)
    train = DevicePipeline(imgs, labels, batch_size=4, img_size=64,
                           train=True, device="cpu")
    val = DevicePipeline(imgs[:6], labels[:6], batch_size=4, img_size=64,
                         device="cpu")
    cfg = dict(SMALL_SWIN, drop_path_rate=0.1)
    tcfg = dict(TRAINING_VIT, epochs=2, ema_decay=0.99)
    trainer = Trainer(ModelRegistry.create_model(cfg), cfg, tcfg,
                      TRAINER_DEFAULT, steps_per_epoch=train.steps_per_epoch(),
                      output_dir=tmp_path / "run", device="cpu")
    assert next(trainer.model.parameters()).dtype == torch.float32
    assert trainer.model.dtype == torch.bfloat16      # precision bf16
    fit = trainer.fit(train, val)
    assert len(fit.history) == 2 and trainer.state.step == 6

    keys = list(finalize_metric_state(
        zero_metric_state(), [jnp.ones(2)], [jnp.arange(2)],
        [jnp.ones(2)]))
    want = {f"{p}{k}" for p in ("train_", "val_") for k in keys + ["loss"]} | {
        "epoch", "lr", "time_s"}
    got = set(fit.history[0])
    assert want <= got and got - want <= {"ms_per_step", "steps_per_sec"}
    assert all(np.isfinite(v) for v in fit.history[-1].values())
    assert json.loads((tmp_path / "run/history.json").read_text())[0]["epoch"] == 0
    ckdir = tmp_path / "run/checkpoints"
    assert (ckdir / "swin_tiny-best.ckpt/metadata.json").exists()
    assert (ckdir / "swin_tiny-latest.ckpt/state.pt").exists()

    best_epoch = json.loads((fit.best_checkpoint / "metadata.json")
                            .read_text())["epoch"]
    test = trainer.test(val, checkpoint=fit.best_checkpoint)
    for k, v in fit.history[best_epoch].items():
        if k.startswith("val_"):
            assert test["test_" + k[4:]] == pytest.approx(v, abs=1e-6), k

    saved = trainer.save_state(tmp_path / "state.ckpt")
    other = Trainer(ModelRegistry.create_model(cfg), cfg,
                    dict(tcfg, seed=7), dict(TRAINER_DEFAULT, seed=7),
                    steps_per_epoch=3, output_dir=tmp_path / "other",
                    device="cpu")
    other.resume_from(saved)
    assert other.state.step == trainer.state.step == other._global_step
    for n, p in trainer.state.params.items():
        assert torch.equal(other.state.params[n], p), n
        assert torch.equal(other.state.ema_params[n], trainer.state.ema_params[n])
        assert torch.equal(other.state.opt_state.mu[n], trainer.state.opt_state.mu[n])
        assert torch.equal(other.state.opt_state.nu[n], trainer.state.opt_state.nu[n])
    assert other.state.opt_state.count == trainer.state.opt_state.count
    variables, meta = tckpt.load_checkpoint(fit.best_checkpoint)
    assert meta["monitor"] == "val_acc"
    assert variables["params"]["patch_embed"]["kernel"].shape == (4, 4, 1, 32)


@pytest.mark.unit
def test_device_pipeline_batches():
    """Train: one seeded permutation per epoch, the last batch wrapped to
    the start of the epoch's order, weight 1. Eval: sequential, the last
    batch padded with its last row at weight 0. Images are the standardized
    prepared cache rows."""
    imgs, labels = _frames(10, seed=3)
    kw = dict(batch_size=4, img_size=32, mean=(0.5,), std=(0.25,), device="cpu")
    train = DevicePipeline(imgs, labels, train=True, **kw)
    ev = DevicePipeline(imgs, labels, **kw)
    assert train.steps_per_epoch() == 3
    g = torch.Generator().manual_seed(0)
    order = torch.randperm(10, generator=torch.Generator().manual_seed(0))
    batches = list(train.epoch(g))
    idx = torch.cat([b.label for b in batches])
    assert torch.equal(idx, train.labels[order[torch.arange(12) % 10]])
    assert all(b.weight.eq(1).all() for b in batches)
    x = batches[0].image
    assert torch.allclose(x, (train.cache[order[:4]] - 0.5) / 0.25)
    e = list(ev.epoch())
    assert torch.equal(torch.cat([b.weight for b in e]),
                       torch.tensor([1.0] * 10 + [0.0] * 2))
    assert torch.equal(e[-1].image[-1], e[-1].image[1])
    rgb = DevicePipeline(imgs, labels, out_channels=3, **kw)
    assert next(rgb.epoch()).image.shape == (4, 32, 32, 3)
    with pytest.raises(ValueError):
        next(train.epoch())
    # an augmented training pipeline augments after the gather, before
    # standardize, from the augmentation generator; evaluation never
    aug = DevicePipeline(imgs, labels, augmentation_level="light", train=True,
                         **kw)
    with pytest.raises(ValueError, match="Generator"):
        next(aug.epoch(torch.Generator().manual_seed(0)))
    x = next(aug.epoch(torch.Generator().manual_seed(0),
                       torch.Generator().manual_seed(1))).image
    want = train_augment(aug.cache[order[:4]], torch.Generator().manual_seed(1),
                         "light")
    assert torch.equal(x, (want - 0.5) / 0.25)
    assert not torch.equal(x, batches[0].image)
    held = DevicePipeline(imgs, labels, augmentation_level="light", **kw)
    assert torch.equal(next(held.epoch()).image, e[0].image)


@pytest.mark.unit
def test_drop_path():
    """Per-sample keep with probability 1 − rate, scaled by 1/keep, from
    the given generator; identity at eval and at rate 0."""
    x = torch.ones(4000, 3, 2)
    dp = DropPath(0.25)
    assert dp(x) is x and DropPath(0.0)(x, True) is x
    y = dp(x, True, torch.Generator().manual_seed(0))
    per = y[:, 0, 0]
    assert set(per.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.75))}
    assert torch.equal(y, per[:, None, None].expand_as(y))
    assert abs(float((per > 0).float().mean()) - 0.75) < 0.03
    assert torch.equal(y, dp(x, True, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError):
        dp(x, True)


@pytest.mark.unit
def test_swin_training_options():
    """build_swin reads drop_path_rate (SWIN_PARAMS default 0.2 for
    swin_tiny), rising linearly over the blocks, and the dropout rates:
    drop_rate reaches the embedding, the MLP and the attention's
    projection, attn_drop_rate the attention probabilities."""
    model = ModelRegistry.create_model(SMALL_SWIN)
    rates = [getattr(getattr(model, f"stage_{s}"), f"block_{b}").drop_path.rate
             for s in range(2) for b in range(2)]
    assert rates == pytest.approx(list(np.linspace(0, 0.2, 4)))
    model = create_and_init(dict(SMALL_SWIN, drop_rate=0.1, attn_drop_rate=0.2),
                            device="cpu")
    blocks = [getattr(getattr(model, f"stage_{s}"), f"block_{b}")
              for s in range(2) for b in range(2)]
    assert model.drop_rate == 0.1
    assert {b.drop_rate for b in blocks} == {b.attn.proj_drop_rate
                                             for b in blocks} == {0.1}
    assert {b.attn.attn_drop_rate for b in blocks} == {0.2}
    # the training forward draws them (the windows path: attention dropout
    # takes the block off the fused kernels); the serving forward does not
    x = torch.from_numpy(small_batch(3)[0][:2])
    outs = [model(x, train=True, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert all(bool(torch.isfinite(o).all()) for o in outs)


@pytest.mark.unit
def test_trainer_refuses_unported_modes(tmp_path):
    """A mesh that is not a process mesh raises a TypeError naming the
    mesh (training on a mesh runs in tests/test_torch_parallel.py).
    Distillation (a teacher_fn), SGD, gradient accumulation and clipping by
    value, once refused here, build and step (tests/test_torch_distill.py
    and tests/test_torch_optim_extra.py hold them to JAX); loss mode
    "distillation" without a teacher raises a ValueError."""
    kw = dict(steps_per_epoch=2, output_dir=tmp_path, device="cpu")
    model = ModelRegistry.create_model(SMALL_SWIN)
    with pytest.raises(TypeError, match="mesh"):
        Trainer(model, SMALL_SWIN, TRAINING_VIT, TRAINER_DEFAULT, **kw,
                mesh=object())
    with pytest.raises(ValueError, match="teacher"):
        Trainer(model, SMALL_SWIN, TRAINING_VIT, TRAINER_DEFAULT, **kw,
                loss_mode="distillation")
    # the "deit" loss mode is ported (tests/test_torch_vit.py holds it to JAX)
    assert Trainer(model, SMALL_SWIN, TRAINING_VIT, TRAINER_DEFAULT, **kw,
                   loss_mode="deit").loss_mode == "deit"
    x, y, w = small_batch(5)
    x, y, w = torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(w)

    def step(trainer, alpha=None):
        before = {n: p.detach().clone() for n, p in trainer.state.params.items()}
        keys = trainer._aux_keys
        ms, _ = trainer.train_step(tmetrics.zero_metric_state(keys), x, y, w,
                                   alpha)
        assert bool(torch.isfinite(ms["loss_sum"])) and float(ms["w_sum"]) == w.sum()
        return ms, any(not torch.equal(before[n], p)
                       for n, p in trainer.state.params.items())

    # distillation: a teacher_fn selects the mode; the teacher sees the
    # batch, MixUp/CutMix is skipped, the three terms are summed
    seen = []
    teacher = Trainer(ModelRegistry.create_model(SMALL_F32), SMALL_F32,
                      dict(TRAINING_VIT, mixup_alpha=0.2), TRAINER_DEFAULT,
                      **kw, teacher_fn=lambda im: seen.append(im) or
                      torch.zeros(len(im), 2),
                      distillation_config={"alpha": 0.5})
    assert teacher.loss_mode == "distillation"
    ms, _ = step(teacher, torch.tensor(0.5))
    assert len(seen) == 1 and torch.equal(seen[0], x)
    assert {"aux_class_loss", "aux_distillation_loss",
            "aux_teacher_agreement"} <= set(ms)
    # SGD, clipping by value: the first step updates (no warmup)
    no_warmup = dict(TRAINING_VIT, scheduler_params={"name": "cosine"})
    for training, trcfg in (
            (dict(no_warmup, optimizer_params={"name": "sgd", "lr": 1e-2}), {}),
            (no_warmup, {"gradient_clip_algorithm": "value",
                         "gradient_clip_val": 1e-3})):
        trainer = Trainer(ModelRegistry.create_model(SMALL_F32), SMALL_F32,
                          training, dict(TRAINER_DEFAULT, **trcfg), **kw)
        assert step(trainer)[1] and trainer.state.opt_state.count == 1
    # accumulation over 2 mini-steps: the parameters move on the second
    acc = Trainer(ModelRegistry.create_model(SMALL_F32), SMALL_F32, no_warmup,
                  dict(TRAINER_DEFAULT, accumulate_grad_batches=2), **kw)
    assert [step(acc)[1] for _ in range(2)] == [False, True]
    assert acc.state.step == 2 and acc.state.opt_state.count == 1
    # MixUp/CutMix is ported: the step mixes the batch (its loss is the
    # mixed CE, test_torch_resnet.py holds it to JAX) and counts the
    # original labels
    mixed = Trainer(ModelRegistry.create_model(SMALL_F32), SMALL_F32,
                    dict(TRAINING_VIT, mixup_alpha=0.2, mixup_prob=0.0),
                    TRAINER_DEFAULT, **kw)
    assert (mixed.mixup_alpha, mixed.cutmix_alpha, mixed.mixup_prob) == (0.2, 0.0, 1.0)
    step(mixed)
    # attention-map logging is ported (tests/test_torch_analysis.py); it
    # needs matplotlib, which a Trainer asked to log checks at construction
    logging_on = Trainer(model, SMALL_SWIN, TRAINING_VIT,
                         dict(TRAINER_DEFAULT, log_attention_every_n_epochs=1),
                         **kw)
    assert logging_on.cfg.log_attention_every_n_epochs == 1
