"""Distillation in the port (thyroid_tpu_torch.training.losses,
training/checkpoint.py's teachers, the Trainer's "distillation" loss mode,
the distillation presets through the k-fold CLI) against the JAX package
on the CPU in float32, on numpy-seeded inputs: the losses and α schedule
for tuple and plain students; a single teacher and a weighted ensemble of
narrow ResNet and EfficientNet members carried across with
load_jax_variables against JAX's jitted make_teacher_fn and
make_ensemble_teacher_fn; teachers built from port checkpoints; two
distillation train steps of a narrow DeiT (depth 2, width 48, 32², patch
8) with a narrow ResNet teacher against JAX's Trainer._train_step; the
three distillation presets, cut to 2 folds of one epoch on 16 frames."""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (SMALL_EFFNET, assert_trees_close, flat_tree,
                                jax_cnn, jax_params, one_torch_thread)  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import batch_stats, jax_layout, jax_tree
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training import checkpoint as tckpt
from thyroid_tpu_torch.training import losses as tlosses
from thyroid_tpu_torch.training import metrics as tmetrics
from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
from thyroid_tpu_torch.training.engine import Trainer

# float32 on one CPU: the same formulas, summed in other orders
LOSS_ATOL = 2e-6
# teacher logits (a few BatchNorm'd convolutions deep) and parameters
# after two AdamW steps at lr 1e-4 (an Adam update moves an element by
# about ±lr whatever its gradient's size)
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5

NARROW_RESNET = {"name": "resnet18", "img_size": 32, "width": 8,
                 "layers": [1, 1, 1, 1], "in_channels": 1, "num_classes": 2,
                 "dtype": "f32"}
NARROW_DEIT = {"name": "deit_tiny", "img_size": 32, "patch_size": 8,
               "embed_dim": 48, "depth": 2, "num_heads": 3, "in_channels": 1,
               "num_classes": 2, "dtype": "f32", "drop_path_rate": 0.0,
               "token_kernels": False}


def _logits(seed: int, n: int = 12):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 2) * 3).astype(np.float32)


@pytest.mark.unit
@pytest.mark.parametrize("student", ["tuple", "plain"])
@pytest.mark.parametrize("temperature", [1.0, 4.0])
@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_distillation_loss_matches_jax(kind, alpha, temperature, student):
    """distillation_loss and its three terms against JAX's, without and
    with label smoothing 0.1 and sample weights, within LOSS_ATOL; α a
    float32 scalar as the steps pass it."""
    from thyroid_tpu.training import losses as jl

    cls, dist, teacher = _logits(1), _logits(2), _logits(3)
    labels = np.random.RandomState(4).randint(0, 2, 12).astype(np.int64)
    weights = np.random.RandomState(5).rand(12).astype(np.float32)
    out_j = (jnp.asarray(cls), jnp.asarray(dist)) if student == "tuple" \
        else jnp.asarray(cls)
    out_p = (torch.from_numpy(cls), torch.from_numpy(dist)) \
        if student == "tuple" else torch.from_numpy(cls)
    for ls, w in ((0.0, None), (0.1, weights)):
        want, want_aux = jl.distillation_loss(
            out_j, jnp.asarray(teacher), jnp.asarray(labels),
            alpha=jnp.float32(alpha), temperature=temperature,
            distillation_type=kind, label_smoothing=ls,
            weights=None if w is None else jnp.asarray(w))
        got, got_aux = tlosses.distillation_loss(
            out_p, torch.from_numpy(teacher), torch.from_numpy(labels),
            alpha=torch.tensor(alpha), temperature=temperature,
            distillation_type=kind, label_smoothing=ls,
            weights=None if w is None else torch.from_numpy(w))
        assert abs(float(got) - float(want)) < LOSS_ATOL, (ls, float(got), float(want))
        assert set(got_aux) == set(want_aux)
        for k in want_aux:
            assert abs(float(got_aux[k]) - float(want_aux[k])) < LOSS_ATOL, k
    soft = (jl.soft_distillation(jnp.asarray(dist), jnp.asarray(teacher),
                                 temperature),
            tlosses.soft_distillation(torch.from_numpy(dist),
                                      torch.from_numpy(teacher), temperature))
    hard = (jl.hard_distillation(jnp.asarray(dist), jnp.asarray(teacher)),
            tlosses.hard_distillation(torch.from_numpy(dist),
                                      torch.from_numpy(teacher)))
    for want, got in (soft, hard):
        assert abs(float(got) - float(want)) < LOSS_ATOL


SCHEDULES = [None, [], [[0, 0.3], [20, 0.5], [40, 0.7]], [[5, 0.1], [10, 0.9]]]


@pytest.mark.unit
@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=["none", "empty", "preset", "late-start"])
def test_progressive_alpha_matches_jax(schedule):
    """α(epoch) against JAX's at the schedule's edges; an empty schedule
    gives the default (deit_small_distill_ensemble sets progressive and no
    schedule: α stays 0.7)."""
    from thyroid_tpu.training.losses import progressive_alpha

    for epoch in (0, 4, 5, 9, 10, 19, 20, 39, 40, 99):
        for default in (0.7, 0.25):
            assert tlosses.progressive_alpha(epoch, schedule, default) == \
                progressive_alpha(epoch, schedule, default)
    assert tlosses.progressive_alpha(0, [], 0.7) == 0.7


# ------------------------------------------------------------------ teachers

def _spread_stats(variables, seed: int):
    """`variables` with running means N(0, 0.1²) and variances in
    [0.5, 1.5], so the eval forward reads non-trivial statistics."""
    rs = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                ((rs.randn(*v.shape) * 0.1).astype(np.float32) if k == "mean"
                 else (0.5 + rs.rand(*v.shape)).astype(np.float32))
                for k, v in tree.items()}

    return {"params": variables["params"],
            "batch_stats": walk(variables["batch_stats"])}


@pytest.fixture(scope="module")
def members():
    """[(config, JAX module, numpy variables)]: a narrow ResNet and
    tests/torch_parity.py's narrow EfficientNet."""
    out = []
    for i, cfg in enumerate((NARROW_RESNET, SMALL_EFFNET)):
        module, variables = jax_cnn(cfg, seed=i)
        out.append((cfg, module, _spread_stats(variables, 10 + i)))
    return out


def _images(seed: int, n: int = 4):
    return np.random.RandomState(seed).randn(n, 32, 32, 1).astype(np.float32)


def _port_module(cfg, variables=None):
    module = ModelRegistry.create_model(cfg)
    if variables is not None:
        from thyroid_tpu_torch.models.from_jax import load_jax_variables
        load_jax_variables(module, variables)
    return module


WEIGHTS = {"equal": None, "normalised": [0.4, 0.6], "unnormalised": [2.0, 3.0]}


@pytest.fixture(scope="module")
def jax_teachers(members):
    """JAX's teachers on _images(20): the ResNet member's make_teacher_fn
    and make_ensemble_teacher_fn of both members at weights 2 and 3."""
    from thyroid_tpu.training.checkpoint import (make_ensemble_teacher_fn,
                                                 make_teacher_fn)

    x = jnp.asarray(_images(20))
    _, module, variables = members[0]
    ens = make_ensemble_teacher_fn([(m, v) for _, m, v in members],
                                   WEIGHTS["unnormalised"])
    return (np.asarray(make_teacher_fn(module, variables)(x)),
            np.asarray(ens(x)))


@pytest.mark.unit
def test_single_teacher_matches_jax(members, jax_teachers):
    """make_teacher_fn: the port module filled from the JAX variables, in
    eval mode with frozen parameters, against JAX's make_teacher_fn."""
    cfg, _, variables = members[0]
    teacher = tckpt.make_teacher_fn(_port_module(cfg), variables)
    got = teacher(torch.from_numpy(_images(20)))
    np.testing.assert_allclose(got.numpy(), jax_teachers[0],
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    (m,) = teacher.members
    assert not m.training and not any(p.requires_grad for p in m.parameters())
    assert not got.requires_grad


@pytest.mark.unit
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_ensemble_teacher_matches_jax(members, jax_teachers, weights):
    """make_ensemble_teacher_fn over (module, variables) pairs, the weights
    normalised to sum 1: at weights 2 and 3 against JAX's ensemble; at
    each weighting, the weighted average of the port members' own logits
    (bit-equal: the same products summed in member order)."""
    w = WEIGHTS[weights]
    x = torch.from_numpy(_images(20))
    teacher = tckpt.make_ensemble_teacher_fn(
        [(_port_module(c), v) for c, _, v in members], w)
    got = teacher(x)
    total = sum(w) if w else 1.0
    norm = [v / total for v in w] if w else [0.5, 0.5]
    assert teacher.weights == pytest.approx(norm)
    logits = [m(x, train=False) for m in teacher.members]
    assert torch.equal(got, logits[0] * teacher.weights[0]
                       + logits[1] * teacher.weights[1])
    if weights == "unnormalised":
        np.testing.assert_allclose(got.numpy(), jax_teachers[1],
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def _save(module, path):
    state = SimpleNamespace(params=dict(module.named_parameters()),
                            batch_stats=batch_stats(module),
                            layout=jax_layout(module), step=0)
    return tckpt.save_checkpoint(path, state)


@pytest.mark.unit
def test_create_teacher_from_port_checkpoints(members, jax_teachers, tmp_path,
                                              monkeypatch):
    """create_teacher_from_config from port checkpoints: a single teacher
    with its model config equal to make_teacher_fn's bits; an ensemble
    with teacher_models and weights against JAX's ensemble; without model
    configs, each file's own name picks one; no checkpoint raises;
    get_best_checkpoint."""
    paths = [_save(_port_module(c, v), tmp_path / f"member{i}" / "m-best.ckpt")
             for i, (c, _, v) in enumerate(members)]
    x = torch.from_numpy(_images(20))
    cfg, _, variables = members[0]
    single = tckpt.create_teacher_from_config(
        {"teacher_checkpoint": str(paths[0]), "teacher_model": cfg},
        device="cpu")
    assert torch.equal(single(x), tckpt.make_teacher_fn(
        _port_module(cfg), variables)(x))
    ens = tckpt.create_teacher_from_config(
        {"teacher_checkpoints": [str(p) for p in paths],
         "teacher_models": [c for c, _, _ in members],
         "teacher_weights": WEIGHTS["unnormalised"]}, device="cpu")
    np.testing.assert_allclose(ens(x).numpy(), jax_teachers[1],
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    # without model configs each file's name picks one
    # (_infer_model_config_from_path, held to JAX's below; the presets'
    # full-size teachers load this way on the card, chip_smoke.py phase 26)
    named = []
    monkeypatch.setattr(tckpt, "_infer_model_config_from_path",
                        lambda path: named.append(str(path)) or cfg)
    for dcfg in ({"teacher_checkpoint": str(paths[0])},
                 {"teacher_checkpoints": [str(paths[0])]}):
        teacher = tckpt.create_teacher_from_config(dcfg, device="cpu")
        assert torch.equal(teacher(x), single(x))
    assert named == [str(paths[0])] * 2
    with pytest.raises(ValueError, match="no teacher checkpoint"):
        tckpt.create_teacher_from_config({"alpha": 0.5})
    best = _save(_port_module(cfg, variables), tmp_path / "resnet18-best.ckpt")
    assert tckpt.get_best_checkpoint(tmp_path, "resnet18") == best
    assert tckpt.get_best_checkpoint(tmp_path, "resnet50") is None


def _registered():
    from thyroid_tpu_torch.models import cnn, ensemble, vit  # noqa: F401

    return sorted({n for names in ModelRegistry.list_models().values()
                   for n in names})


@pytest.mark.unit
@pytest.mark.parametrize("name", _registered())
def test_infer_teacher_config_matches_jax(name):
    """`<name>-best.ckpt`: the port's inferred config is JAX's (the first
    CNN, then ViT, name in sorted order that the file name contains), or
    both raise."""
    import thyroid_tpu.models  # noqa: F401  (register the JAX families)
    from thyroid_tpu.training.checkpoint import _infer_model_config_from_path

    path = f"checkpoints/{name}-best.ckpt"
    try:
        want = _infer_model_config_from_path(path)
    except ValueError:
        with pytest.raises(ValueError):
            tckpt._infer_model_config_from_path(path)
        return
    assert tckpt._infer_model_config_from_path(path) == want


# --------------------------------------------------------- the train step

@pytest.mark.unit
def test_distillation_steps_match_jax(members, tmp_path, monkeypatch):
    """Two distillation steps (soft, T 4, α 0.3, label smoothing 0.1,
    sample weights) of the narrow DeiT with the narrow ResNet teacher:
    the port's Trainer.train_step against JAX's Trainer._train_step from
    the same weights, configs/training/vit.yaml without warmup, float32.
    Each step's loss, class_loss, distillation_loss, teacher_agreement
    and class-head accuracy within LOSS_ATOL; parameters after both within
    PARAM_ATOL / PARAM_RTOL; the teacher unchanged."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry
    from thyroid_tpu.training import engine as jax_engine
    from thyroid_tpu.training.checkpoint import make_teacher_fn
    from thyroid_tpu.training.metrics import zero_metric_state

    tcfg_, tmodule, tvars = members[0]
    dcfg = {"enabled": True, "temperature": 4.0, "alpha": 0.3,
            "distillation_type": "soft"}
    tcfg = dict(TRAINING_VIT, scheduler_params={"name": "cosine",
                                                "eta_min": 1e-6,
                                                "warmup_epochs": 0})
    _, params = jax_params(NARROW_DEIT, seed=3)
    jp = jax.tree.map(jnp.asarray, params)
    # the JAX Trainer starts from these weights (flax's unjitted init of
    # its own would take seconds)
    monkeypatch.setattr(jax_engine, "create_and_init",
                        lambda cfg, rng: (None, {"params": jp}))
    jt = jax_engine.Trainer(JaxRegistry.create_model(NARROW_DEIT), NARROW_DEIT,
                            tcfg, TRAINER_DEFAULT, steps_per_epoch=2,
                            output_dir=tmp_path / "jax",
                            teacher_fn=make_teacher_fn(tmodule, tvars),
                            distillation_config=dcfg)
    state = jt.state
    port_teacher = tckpt.make_teacher_fn(_port_module(tcfg_), tvars)
    before = {n: t.clone() for n, t in port_teacher.members[0].state_dict().items()}
    pt = Trainer(ModelRegistry.create_model(NARROW_DEIT), NARROW_DEIT, tcfg,
                 TRAINER_DEFAULT, steps_per_epoch=2,
                 output_dir=tmp_path / "port", params=params, device="cpu",
                 teacher_fn=port_teacher, distillation_config=dcfg)
    assert pt.loss_mode == jt.loss_mode == "distillation"
    assert pt._alpha_for_epoch(0) == jt._alpha_for_epoch(0) == 0.3
    keys = ("class_loss", "distillation_loss", "teacher_agreement")
    for step in range(2):
        rs = np.random.RandomState(50 + step)
        x = rs.randn(6, 32, 32, 1).astype(np.float32)
        y = (np.arange(6) % 2).astype(np.int64)
        w = rs.rand(6).astype(np.float32)
        state, jm, _ = jt._train_step(
            state, zero_metric_state(keys), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(w), jax.random.PRNGKey(step), jnp.float32(0.3))
        tm, _ = pt.train_step(tmetrics.zero_metric_state(keys),
                              torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w), pt._alpha_tensor(0))
        for k in ("loss_sum", "w_sum", "tp", "fp", "tn", "fn",
                  *(f"aux_{a}" for a in keys)):
            assert abs(float(tm[k]) - float(jm[k])) < LOSS_ATOL, (step, k)
    assert_trees_close(jax_tree(pt.state.params, pt.state.layout),
                       state.params, atol=PARAM_ATOL, rtol=PARAM_RTOL)
    after = port_teacher.members[0].state_dict()
    assert all(torch.equal(before[n], after[n]) for n in before)


@pytest.mark.unit
def test_distillation_mode_needs_a_teacher(tmp_path):
    with pytest.raises(ValueError, match="teacher_fn"):
        Trainer(ModelRegistry.create_model(NARROW_DEIT), NARROW_DEIT,
                TRAINING_VIT, TRAINER_DEFAULT, steps_per_epoch=2,
                output_dir=tmp_path, device="cpu", loss_mode="distillation")


# ------------------------------------------------------------ the presets

@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """16 synthetic frames of 64²."""
    from thyroid_tpu_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(root / "synthetic", n_images=16, size=64)
    return root


NARROW_TEACHERS = {
    "resnet50": {"name": "resnet50", "width": 8, "layers": [1, 1, 1, 1]},
    "efficientnet_b0": {"name": "efficientnet_b0", "width_mult": 0.25,
                        "depth_mult": 0.3},
    "densenet121": {"name": "densenet121", "growth_rate": 4,
                    "block_config": [1, 1, 1, 1], "num_init_features": 8},
    "densenet169": {"name": "densenet169", "growth_rate": 4,
                    "block_config": [1, 1, 1, 1], "num_init_features": 8},
}


def _flow(cfg) -> str:
    """A config mapping as a YAML flow mapping, for an override."""
    return "{" + ", ".join(f"{k}: {v}" for k, v in cfg.items()) + "}"


# preset: (its teachers, the overrides that point it at their checkpoints)
PRESETS = {
    "deit_tiny_distill_resnet50": (
        ["resnet50"],
        lambda ck: [f"experiment.distillation.teacher_checkpoint={ck['resnet50']}",
                    "+experiment.distillation.teacher_model.width=8",
                    "+experiment.distillation.teacher_model.layers=[1,1,1,1]"]),
    "densenet169_distill_deit_tiny_kfold": (
        ["densenet169"],
        lambda ck: [f"experiment.distillation.teacher_checkpoint={ck['densenet169']}",
                    "+experiment.distillation.teacher_model.growth_rate=4",
                    "+experiment.distillation.teacher_model.block_config=[1,1,1,1]",
                    "+experiment.distillation.teacher_model.num_init_features=8"]),
    "deit_small_distill_ensemble": (
        ["resnet50", "efficientnet_b0", "densenet121"],
        lambda ck: [
            "experiment.distillation.teacher_checkpoints=["
            + ",".join(str(ck[n]) for n in ("resnet50", "efficientnet_b0",
                                             "densenet121")) + "]",
            "+experiment.distillation.teacher_models=["
            + ",".join(_flow(NARROW_TEACHERS[n]) for n in
                       ("resnet50", "efficientnet_b0", "densenet121")) + "]"]),
}


@pytest.mark.unit
@pytest.mark.parametrize("preset", list(PRESETS))
def test_distillation_preset_runs(preset, tiny_corpus, tmp_path, monkeypatch):
    """launch_experiment of each distillation preset, its student cut to
    32², patch 8, width 48, depth 2 and its teachers narrow (port
    checkpoints in tmp_path), 2 folds of one epoch on 16 frames without
    quality preprocessing: both folds succeed, the Trainer takes the "distillation" loss mode with
    the preset's α at epoch 0, the history carries the three terms, the
    summary the distillation fields, and the teachers' weights stay."""
    from thyroid_tpu_torch.experiment import kfold_experiment
    from thyroid_tpu_torch.experiment import launch_experiment

    names, point = PRESETS[preset]
    ck = {n: _save(create_and_init(NARROW_TEACHERS[n], seed=i, device="cpu"),
                   tmp_path / "ck" / f"{n}-best.ckpt")
          for i, n in enumerate(names)}
    teachers, modes = [], set()
    make = kfold_experiment.create_teacher_from_config
    monkeypatch.setattr(kfold_experiment, "create_teacher_from_config",
                        lambda *a, **k: teachers.append(make(*a, **k)) or teachers[-1])
    fit = Trainer.fit
    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **k: (
        modes.add((self.loss_mode, self._alpha_for_epoch(0))), fit(self, *a, **k))[1])
    summary = launch_experiment(
        [f"experiment={preset}", "dataset=synthetic_tiny",
         f"dataset.data_path={tiny_corpus / 'synthetic'}",
         f"dataset.split_dir={tiny_corpus / 'splits'}",
         f"kfold.split_dir={tiny_corpus / 'splits'}", f"output_dir={tmp_path / 'out'}",
         "experiment.kfold.num_folds=2", "trainer.max_epochs=1",
         "training.epochs=1", "training.batch_size=4",
         "dataset.synthetic_size=16", "dataset.quality_preprocessing=false",
         "experiment.student_model.img_size=32",
         "experiment.student_model.params.patch_size=8",
         "experiment.student_model.params.embed_dim=48",
         "experiment.student_model.params.depth=2",
         "+experiment.student_model.dtype=f32", *point(ck)], device="cpu")
    rows = summary["raw_fold_results"]
    assert summary["num_successful_folds"] == 2, rows
    alpha = 0.7 if preset == "deit_small_distill_ensemble" else 0.3
    assert modes == {("distillation", alpha)}
    assert summary["family"] == "distilled_vit"
    assert summary["student_model_name"] == ("deit_small" if "small" in preset
                                             else "deit_tiny")
    assert summary["teacher_model_name"] == (
        "cnn_ensemble" if "ensemble" in preset else names[0])
    assert isinstance(summary["student_param_count"], int)
    for path in (tmp_path / "out").rglob("history.json"):
        row = json.loads(path.read_text())[0]
        assert {"train_class_loss", "train_distillation_loss",
                "train_teacher_agreement"} <= set(row)
    assert len(teachers) == 2 and len(teachers[0].members) == len(names)
    for teacher in teachers:
        for m, n in zip(teacher.members, names):
            live = flat_tree(jax_tree(dict(m.named_parameters()), jax_layout(m)))
            saved = flat_tree(tckpt.load_checkpoint(ck[n])[0]["params"])
            assert live.keys() == saved.keys()
            assert all(np.array_equal(live[k], saved[k]) for k in saved)
