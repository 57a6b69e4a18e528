"""The port's stacked k-fold trainer (thyroid_tpu_torch/training/stacked.py)
on the CPU: with JAX's tests/unit/test_stacked.py configuration (resnet18
at 32², 24 frames a fold, batch 8, float32; width 16) stacked fold f is equal to a
sequential port Trainer on fold f, epoch by epoch; each fold keeps its own
best state for the test pass and the export; reset and the shape checks;
the selection logic (per-fold best epoch, early stopping on the mean
monitored metric, the result rows) against JAX's StackedKFoldTrainer.fit
with both sides' train_epoch / eval_epoch replaced by one scripted metric
sequence; `kfold.stacked` through the k-fold CLI, and its fall-back to the
sequential sweep when the folds' shapes differ."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.data.pipeline import DevicePipeline
from thyroid_tpu_torch.data.synthetic import generate_corpus_arrays
from thyroid_tpu_torch.models import cnn  # noqa: F401  (register ResNet)
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training.checkpoint import load_checkpoint
from thyroid_tpu_torch.training.engine import Trainer
from thyroid_tpu_torch.training.stacked import (StackedKFoldTrainer,
                                                StackedShapeError)

# JAX's test_stacked.py configuration (resnet18 at 32², 24 frames a fold,
# batch 8, float32) with the width cut to 16, monitoring the validation
# loss so that the folds' best epochs can differ; NARROW for the
# bookkeeping tests
MCFG = {"name": "resnet18", "img_size": 32, "in_channels": 1,
        "num_classes": 2, "width": 16}
NARROW = dict(MCFG, width=8, layers=[1, 1, 1, 1])
TCFG = {"epochs": 2, "batch_size": 8, "optimizer_params": {"lr": 1e-3},
        "scheduler_params": None, "monitor_metric": "val_loss",
        "monitor_mode": "min", "early_stopping_patience": 50}
TRAINER_CFG = {"max_epochs": 2, "enable_checkpointing": False,
               "deterministic": True, "precision": "f32"}


def _fold_data(seed):
    imgs, labels = generate_corpus_arrays(n_images=24, size=64)
    order = np.random.RandomState(seed).permutation(24)
    return imgs[order], labels[order]


def _pipe(imgs, labels, train):
    return DevicePipeline(imgs, labels, batch_size=8, img_size=32,
                          train=train, augmentation_level="none", device="cpu")


def _folds(seeds=(1, 2), n_train=16):
    folds = []
    for s in seeds:
        imgs, labels = _fold_data(s)
        folds.append({"train": _pipe(imgs[:n_train], labels[:n_train], True),
                      "val": _pipe(imgs[n_train:], labels[n_train:], False),
                      "test": _pipe(imgs[n_train - 4:], labels[n_train - 4:],
                                    False)})
    return folds


def _stacked(folds, tmp, cfg=MCFG, **kw):
    return StackedKFoldTrainer(cfg, TCFG, TRAINER_CFG,
                               [f["train"] for f in folds],
                               [f["val"] for f in folds],
                               [f["test"] for f in folds],
                               output_dir=tmp, device="cpu", **kw)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """(folds, the fitted stacked trainer, its rows, each fold's
    sequential history)."""
    tmp = tmp_path_factory.mktemp("stacked")
    folds = _folds()
    sequential = []
    for f, fd in enumerate(folds):
        tr = Trainer(ModelRegistry.create_model(MCFG), MCFG, TCFG, TRAINER_CFG,
                     steps_per_epoch=fd["train"].steps_per_epoch(),
                     output_dir=tmp / f"seq{f}", device="cpu")
        sequential.append(tr.fit(fd["train"], fd["val"]).history)
    st = _stacked(folds, tmp / "st")
    return folds, st, st.fit(), sequential


@pytest.mark.unit
def test_stacked_equals_sequential(fitted):
    """Every train_* and val_* number of every epoch of stacked fold f
    equals the sequential Trainer's on fold f (the same steps in the same
    order: the folds share the seed); best_epoch is the sequential
    history's first minimum of val_loss."""
    _, _, rows, sequential = fitted
    assert len(rows) == 2
    for row, seq in zip(rows, sequential):
        assert row["epochs_trained"] == len(seq) == 2 and row["stacked"] is True
        for got, want in zip(row["history"], seq):
            keys = {k for k in want if k.startswith(("train_", "val_"))}
            assert keys and keys <= set(got)
            assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        losses = [h["val_loss"] for h in seq]
        assert row["best_epoch"] == losses.index(min(losses))
        assert row["best_val_metric"] == min(losses)


@pytest.mark.unit
def test_per_fold_best_states(fitted):
    """After fit each fold holds its own best epoch's state: evaluating it
    again gives that epoch's val_loss exactly, and the rows' test_*
    metrics are those states' on the test splits."""
    folds, st, rows, _ = fitted
    again = st.eval_epoch([f["val"] for f in folds], "val_")
    test = st.eval_epoch([f["test"] for f in folds], "test_")
    for row, v, t in zip(rows, again, test):
        assert v["val_loss"] == row["best_val_metric"]
        assert {k: row[k] for k in t} == t


@pytest.mark.unit
def test_export_fold_checkpoints(fitted, tmp_path):
    """export_fold_checkpoints writes the sequential layout, with the
    fold, stacked_export and the model config in the metadata, and the
    per-fold best parameters."""
    _, st, _, _ = fitted
    paths = st.export_fold_checkpoints(tmp_path / "ckpts", "resnet18", MCFG,
                                       extra_metadata={"folds": 2})
    for f, p in enumerate(paths, start=1):
        assert p == (tmp_path / "ckpts" / "resnet18" / f"fold_{f}"
                     / "checkpoints" / "resnet18-best.ckpt")
        variables, meta = load_checkpoint(p)
        assert meta["fold"] == f and meta["stacked_export"] is True
        assert meta["model_config"]["name"] == "resnet18" and meta["folds"] == 2
        model = ModelRegistry.create_model(MCFG)
        from thyroid_tpu_torch.models.from_jax import load_jax_variables
        load_jax_variables(model, variables)
        live = st.trainers[f - 1].state.params
        assert all(torch.equal(t, live[n]) for n, t in model.named_parameters())


@pytest.mark.unit
def test_reset_and_shape_checks(tmp_path):
    """reset swaps in same-geometry data and restarts every fold from the
    initial state; other geometries raise StackedShapeError, as unequal
    folds do at construction; a mesh that is not a process mesh raises a
    TypeError naming the mesh (the stacked trainer on a (slice, data)
    mesh runs in tests/test_torch_parallel.py)."""
    folds = _folds()
    st = _stacked(folds, tmp_path, NARROW)
    init = {n: p.detach().clone() for n, p in st.trainers[0].state.params.items()}
    st.train_epoch(0)
    assert not all(torch.equal(init[n], p) for n, p in st.trainers[0].state.params.items())
    fresh = _folds(seeds=(7, 8))
    st.reset([f["train"] for f in fresh], [f["val"] for f in fresh])
    assert st.train_pipelines[0] is fresh[0]["train"] and st.test_pipelines is None
    for t in st.trainers:
        assert all(torch.equal(init[n], p) for n, p in t.state.params.items())
        assert t.state.step == 0
    bad = _pipe(*_fold_data(3), True)                # 24 frames, not 16
    with pytest.raises(StackedShapeError):
        st.reset([bad, bad], [f["val"] for f in fresh])
    with pytest.raises(StackedShapeError):
        StackedKFoldTrainer(NARROW, TCFG, TRAINER_CFG, [folds[0]["train"], bad],
                            [f["val"] for f in folds], device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        _stacked(folds, tmp_path, NARROW, mesh=object())


# ------------------------------------------------ selection against JAX

NAN = float("nan")
# scenario: (monitor, mode, patience, val[epoch][fold]; 4 epochs, 3 folds)
SCENARIOS = {
    "max-early-stop": ("val_acc", "max", 2,
                       [[0.5, 0.6, 0.4], [0.7, 0.6, 0.3], [0.6, 0.5, 0.5],
                        [0.4, 0.9, 0.2]]),
    "min-nan": ("val_loss", "min", None,
                [[0.9, 0.8, 0.7], [NAN, 0.5, 0.7], [0.4, 0.6, 0.2],
                 [0.5, 0.5, 0.1]]),
    "fold-never-finite": ("val_acc", "max", 0,
                          [[0.5, NAN, 0.4], [0.6, NAN, 0.3], [0.6, NAN, 0.5],
                           [0.5, NAN, 0.1]]),
}


def _script(values, monitor):
    """(train_epoch, eval_epoch) bodies shared by both sides: each returns
    per-fold dicts from the scenario's table."""
    seen = {"epoch": 0}

    def train(epoch):
        seen["epoch"] = epoch
        return [{"train_loss": 1.0 / (epoch + 1) + 0.1 * f} for f in range(3)]

    def evaluate(prefix):
        if prefix == "test_":
            return [{"test_acc": 0.25 * (f + 1)} for f in range(3)]
        row = values[seen["epoch"]]
        return [{monitor: row[f], "val_other": float(f)} for f in range(3)]

    return train, evaluate


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.unit
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_selection_matches_jax(scenario, tmp_path, monkeypatch):
    """Both sides' fit on one scripted metric sequence: the same rows
    (best epoch per fold, best_val_metric, the best epoch's val_*, test_*,
    epochs_trained after early stopping on the mean, stacked, history
    without its wall times)."""
    import jax.numpy as jnp

    from thyroid_tpu.training import engine as jax_engine
    from thyroid_tpu.training.stacked import \
        StackedKFoldTrainer as JaxStacked

    monitor, mode, patience, values = SCENARIOS[scenario]
    tcfg = dict(TCFG, epochs=4, monitor_metric=monitor, monitor_mode=mode,
                early_stopping_patience=patience)
    trcfg = dict(TRAINER_CFG, max_epochs=4)
    # the JAX side's states are a stand-in tree (flax's unjitted init of
    # the model is not needed: the script replaces every step)
    monkeypatch.setattr(jax_engine, "create_and_init", lambda cfg, rng: (
        None, {"params": {"w": jnp.zeros((3,), jnp.float32)}}))
    jpipe = SimpleNamespace(cache=jnp.zeros((4, 8, 8, 1)), labels=jnp.zeros((4,)),
                            steps_per_epoch=lambda: 1)
    ppipe = SimpleNamespace(cache=torch.zeros(4, 8, 8, 1), labels=torch.zeros(4),
                            steps_per_epoch=lambda: 1)
    jst = JaxStacked(NARROW, tcfg, trcfg, [jpipe] * 3, [jpipe] * 3, [jpipe] * 3,
                     output_dir=tmp_path / "jax")
    pst = StackedKFoldTrainer(NARROW, tcfg, trcfg, [ppipe] * 3, [ppipe] * 3,
                              [ppipe] * 3, output_dir=tmp_path / "port",
                              device="cpu")
    train, evaluate = _script(values, monitor)
    jst.train_epoch = lambda epoch, rng: train(epoch)
    jst.eval_epoch = lambda caches, labels, pipe0, prefix="val_": evaluate(prefix)
    want = jst.fit()
    train, evaluate = _script(values, monitor)
    pst.train_epoch = train
    pst.eval_epoch = lambda pipes, prefix="val_", limit_fraction=None: evaluate(prefix)
    got = pst.fit()
    for g, w in zip(got, want):
        for row in (*g["history"], *w["history"]):
            row.pop("time_s")
        assert g.keys() == w.keys()
        assert all(_same(g[k], w[k]) for k in w if k != "history"), (g, w)
        assert len(g["history"]) == len(w["history"])
        for hg, hw in zip(g["history"], w["history"]):
            assert hg.keys() == hw.keys()
            assert all(_same(hg[k], hw[k]) for k in hw)


# -------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """16 synthetic frames of 64²."""
    from thyroid_tpu_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(root / "synthetic", n_images=16, size=64)
    return root


@pytest.mark.unit
@pytest.mark.parametrize("folds", [2, 3], ids=["stacked", "fallback"])
def test_stacked_kfold_cli(folds, tiny_corpus, tmp_path, monkeypatch):
    """test_resnet18_kfold_quick with `+kfold.stacked=true`, its resnet18
    cut to width 8 at 32², on 16 frames: at 2 folds (equal splits) every
    row comes from the stacked trainer; at 3 folds (5/6/5 training
    frames) StackedShapeError sends the sweep down the sequential path
    once, and every fold still succeeds."""
    from thyroid_tpu_torch.experiment import KFoldExperiment, launch_experiment

    stacked, sequential = [], []
    run_stacked, run_fold = KFoldExperiment.run_stacked, KFoldExperiment.run_fold
    monkeypatch.setattr(KFoldExperiment, "run_stacked", lambda self, f: (
        stacked.append(list(f)), run_stacked(self, f))[1])
    monkeypatch.setattr(KFoldExperiment, "run_fold", lambda self, f: (
        sequential.append(f), run_fold(self, f))[1])
    summary = launch_experiment(
        ["experiment=test_resnet18_kfold_quick", "+kfold.stacked=true",
         "dataset=synthetic_tiny", f"dataset.data_path={tiny_corpus / 'synthetic'}",
         f"dataset.split_dir={tmp_path / 'splits'}",
         f"kfold.split_dir={tmp_path / 'splits'}", f"output_dir={tmp_path / 'out'}",
         f"experiment.kfold.num_folds={folds}", "training.batch_size=4",
         "dataset.synthetic_size=16", "dataset.quality_preprocessing=false",
         "+experiment.model.img_size=32", "+experiment.model.params.width=8",
         "+experiment.model.params.layers=[1,1,1,1]", "+experiment.model.dtype=f32"],
        device="cpu")
    rows = summary["raw_fold_results"]
    assert summary["num_successful_folds"] == folds, rows
    assert stacked == [list(range(1, folds + 1))]
    if folds == 2:
        assert sequential == [] and all(r["stacked"] is True for r in rows)
        assert [r["fold"] for r in rows] == [1, 2]
        assert all(r["best_epoch"] == 0 and "history" not in r for r in rows)
    else:
        assert sequential == [1, 2, 3] and not any("stacked" in r for r in rows)
