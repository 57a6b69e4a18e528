"""The port's k-fold experiment path (thyroid_tpu_torch.data.pipeline.
create_data_loaders, experiment/) against the JAX package on the CPU.

- create_data_loaders: the same labels as JAX, prepared caches within
  1e-5 (the bound tests/test_torch_preprocess.py holds prepare_images to);
- a 2-fold, 1-epoch KFoldExperiment of a narrow efficientnet_b0 at 32²
  (quality preprocessing on, 16 frames of 64²) on device="cpu": both folds
  succeed, its fold files equal JAX's, and its summary equals the one
  JAX's aggregate_results + log_results write from the same fold rows;
- a failed fold is recorded and the sweep goes on; each unported option
  raises before any fold runs; without a card nothing falls back to the
  CPU; checkpoint metadata from a ConfigNode equals a plain dict's.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import SMALL_EFFNET, one_torch_thread  # noqa: F401
from thyroid_tpu.config import compose as jax_compose
from thyroid_tpu.data.corpus import generate_kfold_splits as jax_kfold_splits
from thyroid_tpu.data.pipeline import create_data_loaders as jax_loaders
from thyroid_tpu.experiment.kfold_experiment import \
    KFoldExperiment as JaxKFoldExperiment
from thyroid_tpu_torch.config import ConfigNode, compose
from thyroid_tpu_torch.data.corpus import generate_kfold_splits
from thyroid_tpu_torch.data.pipeline import (IMAGENET_MEAN, IMAGENET_STD,
                                             DevicePipeline,
                                             create_data_loaders)
from thyroid_tpu_torch.data.synthetic import generate_corpus
from thyroid_tpu_torch.experiment import (ExperimentManager, KFoldExperiment,
                                          launch_experiment)
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training.engine import Trainer

ROOT = Path(__file__).resolve().parents[1]
PREPARE_TOL = 1e-5
# the narrow efficientnet of tests/torch_parity.py, as config overrides
NARROW = ["model.img_size=32", "+model.width_mult=0.25",
          "+model.depth_mult=0.3", "+model.dtype=f32"]


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """16 synthetic frames of 64² and their 2 fold files."""
    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(root / "synthetic", n_images=16, size=64)
    labels = np.asarray([0] * 8 + [1] * 8)
    generate_kfold_splits(labels, 2, root / "splits")
    return root


def _dataset_config(root: Path, **over):
    cfg = {"data_path": str(root / "synthetic"),
           "split_file": str(root / "splits" / "split_fold_1.json"),
           "batch_size": 4, "img_size": 32, "mean": [0.5], "std": [0.5],
           "quality_preprocessing": False, "apply_augmentations": False,
           "augmentation_level": "medium"}
    return {**cfg, **over}


@pytest.mark.unit
def test_create_data_loaders_match_jax(tiny_corpus):
    """Labels equal, caches within PREPARE_TOL, batches and steps alike;
    apply_augmentations false forces the level to none."""
    cfg = _dataset_config(tiny_corpus)
    got = create_data_loaders(cfg, model_config={"in_channels": 1}, device="cpu")
    want = jax_loaders(cfg, model_config={"in_channels": 1})
    assert set(got) == set(want) == {"train", "val", "test"}
    for split in want:
        g, w = got[split], want[split]
        assert isinstance(g, DevicePipeline) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
        np.testing.assert_allclose(g.cache.numpy(), np.asarray(w.cache),
                                   atol=PREPARE_TOL)
        assert (g.steps_per_epoch(), g.train, g.mean, g.std) == \
            (w.steps_per_epoch(), w.train, w.mean, w.std)


@pytest.mark.unit
def test_create_data_loaders_channels_and_augmentation(tiny_corpus):
    """3-channel models get ImageNet statistics unless 3-channel ones are
    pinned; with apply_augmentations the train split (only) augments at
    the config's level, in the given mode, with JAX's ViT flags."""
    cfg = _dataset_config(tiny_corpus)
    rgb = create_data_loaders(cfg, ("val",), model_config={"in_channels": 3},
                              device="cpu")["val"]
    assert (rgb.mean, rgb.std, rgb.out_channels) == (IMAGENET_MEAN, IMAGENET_STD, 3)
    batch = next(rgb.epoch())
    assert batch.image.shape == (4, 32, 32, 3)
    pinned = dict(cfg, mean=[0.1, 0.2, 0.3], std=[0.4, 0.5, 0.6])
    kept = create_data_loaders(pinned, ("val",), model_config={"in_channels": 3},
                               device="cpu")["val"]
    assert kept.mean == (0.1, 0.2, 0.3) and kept.std == (0.4, 0.5, 0.6)
    aug_cfg = dict(cfg, apply_augmentations=True, randaugment_n=3)
    for mode in ("standard", "vit"):
        got = create_data_loaders(aug_cfg, ("train", "val"), augment_mode=mode,
                                  device="cpu")
        want = jax_loaders(aug_cfg, ("train", "val"), augment_mode=mode)
        for split in ("train", "val"):
            g, w = got[split], want[split]
            assert (g.augmentation_level, g.augment_mode, g.vit_aug_params) == \
                (w.augmentation_level, w.augment_mode, w.vit_aug_params)
        assert got["train"].augments() and not got["val"].augments()
    assert got["train"].vit_aug_params == {
        "use_randaugment": True, "use_patch_quality": True,
        "randaugment_n": 3, "randaugment_m": 9.0}
    batch = next(got["train"].epoch(torch.Generator().manual_seed(0),
                                    torch.Generator().manual_seed(0)))
    assert batch.image.shape == (4, 32, 32, 1)
    assert bool(torch.isfinite(batch.image).all())


def _overrides(root: Path, out: Path, *extra):
    return ["model=cnn/efficientnet_b0", "dataset=synthetic_tiny",
            "training=cnn", "augmentation=no_aug", "trainer.max_epochs=1",
            "kfold.num_folds=2", f"dataset.data_path={root / 'synthetic'}",
            f"dataset.split_dir={out / 'splits'}",
            f"kfold.split_dir={out / 'splits'}", f"output_dir={out / 'out'}",
            "dataset.synthetic_size=16", "training.batch_size=4", *NARROW,
            *extra]


@pytest.mark.unit
def test_kfold_experiment_runs_and_summarises_like_jax(tiny_corpus, tmp_path):
    summary = launch_experiment(_overrides(tiny_corpus, tmp_path), device="cpu")
    rows = summary["raw_fold_results"]
    assert summary["num_successful_folds"] == 2 and summary["total_folds"] == 2
    assert not any("error" in r for r in rows)
    assert all(np.isfinite(v) for k, v in summary.items() if k.startswith("avg_"))
    assert 0 <= summary["avg_test_acc"] <= 1
    # the fold files are JAX's
    jax_kfold_splits(np.asarray([0] * 8 + [1] * 8), 2, tmp_path / "jax_splits")
    for n in (1, 2):
        name = f"split_fold_{n}.json"
        assert (tmp_path / "splits" / name).read_text() == \
            (tmp_path / "jax_splits" / name).read_text()
    # JAX's aggregate_results + log_results on the same rows
    jcfg = jax_compose(overrides=_overrides(tiny_corpus, tmp_path / "jax"))
    jcfg["name"] = "efficientnet_b0"
    jexp = JaxKFoldExperiment(jcfg)
    jexp.output_dir = tmp_path / "jax_out"
    jexp.output_dir.mkdir()
    jexp.fold_results = [dict(r) for r in rows]
    jexp.aggregate_results()
    jexp.log_results()
    written = tmp_path / "out" / "efficientnet_b0" / "kfold_summary_efficientnet_b0.json"
    want = json.loads((jexp.output_dir / written.name).read_text())
    assert json.loads(written.read_text()) == want
    meta = json.loads((Path(rows[0]["best_checkpoint"]) / "metadata.json").read_text())
    assert meta["fold"] == 1 and meta["model_config"]["width_mult"] == 0.25


def _fake_row(fold):
    return {"fold": fold, "test_acc": 0.5 + fold / 10, "val_acc": float("nan"),
            "best_checkpoint": "x"}


@pytest.mark.unit
def test_failed_fold_is_recorded_and_sweep_goes_on(tiny_corpus, tmp_path,
                                                   monkeypatch):
    exp = ExperimentManager(compose(overrides=_overrides(tiny_corpus, tmp_path)),
                            device="cpu").build_experiment()
    calls = []

    def run_fold(fold):
        calls.append(fold)
        if fold == 1:
            raise RuntimeError("boom")
        return _fake_row(fold)

    monkeypatch.setattr(exp, "run_fold", run_fold)
    out = exp.run()
    assert calls == [1, 2]
    assert exp.fold_results[0] == {"error": "boom", "fold": 1}
    assert out["num_successful_folds"] == 1 and out["avg_test_acc"] == 0.7
    assert "avg_val_acc" not in out            # no finite value
    monkeypatch.setattr(exp, "run_fold", lambda fold: 1 / 0)
    exp.fold_results = []
    assert exp.run() == {"status": "All folds failed or no metrics",
                         "raw_fold_results": [
                             {"error": "division by zero", "fold": 1},
                             {"error": "division by zero", "fold": 2}]}


# option: (overrides, the folds it must run: both, or slice 1's of 2)
UNPORTED = {
    "distillation": (["+distillation.enabled=true"], [1, 2]),
    "stacked": (["+kfold.stacked=true"], [1, 2]),
    "slices": (["+kfold.num_slices=2", "+kfold.slice_index=1"], [2]),
    "ablation": (["+ablation.parameter_space=[]"], [1, 2]),
    "augmentation": (["augmentation=medium",
                      "dataset.apply_augmentations=true"], [1, 2]),
}


@pytest.mark.unit
@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_options_raise_before_any_fold(case, tiny_corpus, tmp_path,
                                                monkeypatch):
    """Every option once refused here is ported and reaches its folds:
    augmentation (test_augmented_kfold_runs runs them), distillation
    (tests/test_torch_distill.py), the stacked trainer, which takes both
    folds at once (tests/test_torch_stacked.py), an ablation node without
    a parameter space, which the manager leaves to the k-fold experiment
    as JAX's does (tests/test_torch_ablation.py), and k-fold over slices:
    slice 1 of 2 runs fold 2 alone (round robin) and writes its summary as
    kfold_summary_<prefix>_slice1.json with slice_index and num_slices
    (tests/test_torch_parallel.py merges both slices' files)."""
    extra, folds = UNPORTED[case]
    ran = []
    monkeypatch.setattr(KFoldExperiment, "run_fold",
                        lambda self, fold: ran.append(fold) or _fake_row(fold))
    monkeypatch.setattr(KFoldExperiment, "run_stacked", lambda self, folds: (
        ran.extend(folds), self.fold_results.extend(map(_fake_row, folds))))
    overrides = _overrides(tiny_corpus, tmp_path, *extra)
    summary = launch_experiment(overrides, device="cpu")
    assert ran == folds
    if case == "slices":
        (path,) = (tmp_path / "out").rglob("kfold_summary_*.json")
        assert path.name.endswith("_slice1.json")
        assert (summary["slice_index"], summary["num_slices"]) == (1, 2)
        assert [r["fold"] for r in json.loads(path.read_text())[
            "raw_fold_results"]] == [2]


# narrow models at 32² for the augmented experiments: the root default's
# resnet50 and the preset's resnet18 at width 8, one block a stage;
# swin_baseline's swin_tiny.yaml at embed 16, one block in each of two
# stages, window 4. A preset's model node replaces the root's model, and
# its kfold node merges over the root's, so their cuts name the
# experiment node (as in the JAX manager).
NARROW_RESNET = ["img_size=32", "params.width=8", "params.layers=[1,1,1,1]",
                 "dtype=f32"]
NARROW_SWIN = ["img_size=32", "params.embed_dim=16", "params.depths=[1,1]",
               "params.num_heads=[1,2]", "params.window_size=4", "dtype=f32"]
AUGMENTED = {
    # the root default composition: resnet50, dataset cars, level medium
    "root_default": ([], [f"model.{o}" for o in NARROW_RESNET[:3]]
                     + ["+model.dtype=f32"], "resnet50", "standard"),
    "test_resnet18_kfold_quick": (
        ["experiment=test_resnet18_kfold_quick"],
        [f"+experiment.model.{o}" for o in NARROW_RESNET], "resnet18",
        "standard"),
    "swin_baseline": (["experiment=swin_baseline",
                       "experiment.kfold.num_folds=2"],
                      [f"+experiment.model.{o}" for o in NARROW_SWIN],
                      "swin_tiny", "vit"),
}


@pytest.mark.unit
@pytest.mark.parametrize("preset", ["swin_baseline", "swin_large",
                                    "swin_medical_optimized",
                                    "swin_target_944"])
def test_swin_presets_build_with_augmentation(preset):
    """The four Swin presets, as written (level medium), build their
    k-fold experiment: nothing refuses them before a fold, and their
    training split will take the ViT augmentation."""
    exp = ExperimentManager(compose(overrides=[f"experiment={preset}"]),
                            device="cpu").build_experiment()
    assert isinstance(exp, KFoldExperiment)
    assert exp.dataset_config["augmentation_level"] == "medium"
    assert exp.dataset_config["apply_augmentations"] is True
    assert exp.model_config["architecture"] == "vit"


@pytest.mark.unit
@pytest.mark.parametrize("case", list(AUGMENTED))
def test_augmented_kfold_runs(case, tiny_corpus, tmp_path, monkeypatch):
    """The root default (no group override) and two presets at level
    medium, cut to 2 folds of one epoch on the tiny corpus on the CPU:
    both folds succeed with finite averages, and the train split augments
    in the mode the architecture picks (the ViT path: RandAugment and
    patch quality)."""
    from thyroid_tpu_torch.data import pipeline

    preset, narrow, name, mode = AUGMENTED[case]
    batches = []
    make_batch = pipeline.DevicePipeline.make_batch

    def spy(self, idx, generator=None):
        if self.augments():
            batches.append((self.augment_mode, self.augmentation_level))
        return make_batch(self, idx, generator)

    monkeypatch.setattr(pipeline.DevicePipeline, "make_batch", spy)
    overrides = [*preset, f"dataset.data_path={tiny_corpus / 'synthetic'}",
                 f"dataset.split_dir={tmp_path / 'splits'}",
                 f"kfold.split_dir={tmp_path / 'splits'}",
                 f"output_dir={tmp_path / 'out'}", "kfold.num_folds=2",
                 "trainer.max_epochs=1", "training.epochs=1",
                 "training.batch_size=4", *narrow]
    summary = launch_experiment(overrides, device="cpu")
    rows = summary["raw_fold_results"]
    assert summary["num_successful_folds"] == 2, rows
    assert not any("error" in r for r in rows)
    assert (tmp_path / "out" / name).is_dir()       # the model built
    assert all(np.isfinite(v) for k, v in summary.items() if k.startswith("avg_"))
    assert batches and set(batches) == {(mode, "medium")}


@pytest.mark.unit
def test_no_card_no_fallback(tiny_corpus, tmp_path, monkeypatch):
    """Without a card the default device raises; the CLI exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_experiment(_overrides(tiny_corpus, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_data_loaders(_dataset_config(tiny_corpus), ("val",))
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False; import runpy; "
         "runpy.run_module('thyroid_tpu_torch.experiment.manager', "
         "run_name='__main__')", *_overrides(tiny_corpus, tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.unit
def test_config_node_checkpoint_metadata_matches_dict(tmp_path):
    """Trainer.fit writes model_config.to_dict() for a ConfigNode: the
    same metadata.json model_config as from a plain dict."""
    rs = np.random.RandomState(2)
    imgs = (rs.rand(4, 40, 40, 1) * 65535).astype(np.float32)
    labels = np.asarray([0, 1, 0, 1])
    config = dict(SMALL_EFFNET, params={"note": (1, 2)})
    metas = []
    for name, mc in (("dict", config), ("node", ConfigNode(config))):
        pipe = DevicePipeline(imgs, labels, batch_size=4, img_size=32,
                              train=True, device="cpu")
        val = DevicePipeline(imgs, labels, batch_size=4, img_size=32, device="cpu")
        trainer = Trainer(ModelRegistry.create_model(config), mc,
                          {"epochs": 1}, {"max_epochs": 1, "precision": "f32"},
                          steps_per_epoch=1, output_dir=tmp_path / name,
                          device="cpu")
        fit = trainer.fit(pipe, val, extra_ckpt_metadata={"fold": 3})
        metas.append(json.loads((fit.best_checkpoint / "metadata.json").read_text()))
    assert metas[0]["model_config"] == metas[1]["model_config"]
    assert metas[1]["model_config"]["params"] == {"note": [1, 2]}
    assert metas[0]["fold"] == metas[1]["fold"] == 3
