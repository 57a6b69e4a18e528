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

from tests.torch_parity import SMALL_EFFNET
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
    pinned; an augmentation level other than none raises (Augmentation is
    not ported)."""
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
    with pytest.raises(NotImplementedError, match="Augmentation"):
        create_data_loaders(dict(cfg, apply_augmentations=True), ("train",),
                            device="cpu")


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


UNPORTED = {
    "distillation": (["+distillation.enabled=true"], "Other experiments"),
    "stacked": (["+kfold.stacked=true"], "Other experiments"),
    "slices": (["+kfold.num_slices=2"], "Parallelism"),
    "ablation": (["+ablation.parameter_space=[]"], "Other experiments"),
    "augmentation": (["augmentation=medium"], "Augmentation"),
}


@pytest.mark.unit
@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_options_raise_before_any_fold(case, tiny_corpus, tmp_path,
                                                monkeypatch):
    extra, item = UNPORTED[case]
    ran = []
    monkeypatch.setattr(KFoldExperiment, "run_fold",
                        lambda self, fold: ran.append(fold))
    with pytest.raises(NotImplementedError, match=item):
        launch_experiment(_overrides(tiny_corpus, tmp_path, *extra), device="cpu")
    assert ran == [] and not (tmp_path / "splits").exists()


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
