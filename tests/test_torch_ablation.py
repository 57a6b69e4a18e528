"""The port's ablation and all-models sweeps
(thyroid_tpu_torch/experiment/{ablation,all_models}_experiment.py) on the
CPU: their bookkeeping against the JAX package's own methods on the same
configs and rows (the manager's dispatch, `combinations`,
`_apply_overrides`, `summarize`, `_model_experiment_config`,
`_aggregate_model`, `_prune_checkpoints`), then one tiny run of each: the
ablation_augmentation preset's eight runs with its resnet50 cut to width
8 at 32², and an all-models sweep of two narrow model YAMLs, 2 folds of
one epoch on 16 frames, both with the quality stages left out of the
splits' preparation (the flags they ask for are checked)."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.config import compose
from thyroid_tpu_torch.experiment import (AblationExperiment,
                                          AllModelsFullKFoldExperiment,
                                          ExperimentManager, KFoldExperiment,
                                          launch_experiment)

ALL_MODELS = ("thyroid_tpu_torch.experiment.all_models_experiment."
              "AllModelsFullKFoldExperiment")


def _both(overrides):
    """(port experiment, JAX experiment) that each manager builds from the
    same overrides."""
    from thyroid_tpu.config import compose as jax_compose
    from thyroid_tpu.experiment.manager import ExperimentManager as JaxManager

    port = ExperimentManager(compose(overrides=overrides),
                             device="cpu").build_experiment()
    return port, JaxManager(jax_compose(overrides=overrides)).build_experiment()


DISPATCH = {
    "preset": ["experiment=ablation_augmentation"],
    "empty-space": ["+ablation.parameter_space=[]"],
    "not-primary": ["experiment=ablation_augmentation",
                    "experiment.ablation.is_primary_ablation_experiment=false"],
}


@pytest.mark.unit
@pytest.mark.parametrize("case", list(DISPATCH))
def test_manager_dispatch_matches_jax(case):
    """An ablation node with a parameter space builds the ablation sweep,
    an empty space or is_primary false the k-fold experiment, as in JAX."""
    port, jax_exp = _both(DISPATCH[case])
    assert type(port).__name__ == type(jax_exp).__name__
    assert isinstance(port, AblationExperiment if case == "preset"
                      else KFoldExperiment)


@pytest.mark.unit
def test_combinations_and_overrides_match_jax():
    """ablation_augmentation's 4 levels × quality off/on: the same eight
    combinations in order, and each run's config (a deep copy with the
    dotted-path overrides) equal to JAX's; the sweep's config untouched."""
    port, jax_exp = _both(DISPATCH["preset"])
    combos = port.combinations()
    assert combos == jax_exp.combinations() and len(combos) == 8
    assert combos[0] == {"dataset.augmentation_level": "none",
                         "dataset.quality_preprocessing": False}
    before = port.config.to_dict()
    for combo in combos:
        got = port._apply_overrides(combo).to_dict()
        assert got == jax_exp._apply_overrides(combo).to_dict()
        assert got["dataset"]["augmentation_level"] == \
            combo["dataset.augmentation_level"]
    assert port.config.to_dict() == before
    assert port.parameter_space == jax_exp.parameter_space


RUNS = [
    {"run": "a", "overrides": {"x": 1}, "test_acc": 0.6, "test_auc": 0.7},
    {"error": "boom", "run": 2, "overrides": {"x": 2}},
    {"run": "c", "overrides": {"x": 3}, "test_acc": 0.8},
    {"run": "d", "overrides": {"x": 4}, "test_acc": 0.8},
    {"run": "e", "overrides": {"x": 5}},
]


@pytest.mark.unit
@pytest.mark.parametrize("rows", [RUNS, RUNS[1:2], []],
                         ids=["mixed", "all-failed", "none"])
def test_summarize_matches_jax(rows):
    """summarize on the same rows: counts, the best run by test_acc (the
    first of a tie; a row without test_acc ranks last), every row kept."""
    port, jax_exp = _both(DISPATCH["preset"])
    port.run_results, jax_exp.run_results = list(rows), list(rows)
    port.summarize()
    jax_exp.summarize()
    assert port.summary == jax_exp.summary


FOLD_ROWS = {
    "mixed": {"raw_fold_results": [
        {"fold": 1, "test_acc": 0.5, "best_checkpoint": "fold_1/checkpoints/b"},
        {"error": "x", "fold": 2},
        {"fold": 3, "test_acc": 0.75, "best_checkpoint": "fold_3/checkpoints/b"},
        {"fold": 4, "test_acc": "n/a"}], "avg_test_auc": 0.6},
    "failed": {"status": "All folds failed or no metrics",
               "raw_fold_results": [{"error": "x", "fold": 1}]},
    "tied": {"raw_fold_results": [
        {"fold": 1, "test_acc": 0.7, "best_checkpoint": "fold_1/checkpoints/b"},
        {"fold": 2, "test_acc": 0.7, "best_checkpoint": "fold_2/checkpoints/b"}]},
}


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.mark.unit
@pytest.mark.parametrize("case", list(FOLD_ROWS))
def test_aggregate_and_prune_match_jax(case, tmp_path):
    """_aggregate_model and _prune_checkpoints on the same fold rows and
    fold directories: the same per-model summary, and the same files
    left (only the best fold's best checkpoint, as best_checkpoint/)."""
    from thyroid_tpu.experiment.all_models_experiment import \
        AllModelsFullKFoldExperiment as JaxAllModels

    results = FOLD_ROWS[case]
    assert AllModelsFullKFoldExperiment._aggregate_model("m", results) == \
        JaxAllModels._aggregate_model("m", results)
    trees = []
    for side, cls in (("port", AllModelsFullKFoldExperiment),
                      ("jax", JaxAllModels)):
        out = tmp_path / side
        for fold in range(1, 5):
            ck = out / f"fold_{fold}" / "checkpoints" / "b"
            ck.mkdir(parents=True)
            (ck / "state.pt").write_text(f"fold {fold}")
        rows = {"raw_fold_results": [
            {**r, "best_checkpoint": str(out / r["best_checkpoint"])}
            if "best_checkpoint" in r else r
            for r in results["raw_fold_results"]]}
        cls._prune_checkpoints(None, SimpleNamespace(output_dir=out, num_folds=4),
                               rows)
        trees.append(_tree(out))
    assert trees[0] == trees[1]
    if case != "failed":
        assert (tmp_path / "port" / "best_checkpoint" / "state.pt").read_text() \
            == ("fold 3" if case == "mixed" else "fold 1")


@pytest.mark.unit
def test_model_experiment_config_matches_jax(tmp_path):
    """Per model the composed config with that model's YAML, quality
    preprocessing forced on, the model's input size, one output tree and
    the model's name, as JAX builds it; model_names from the config when
    the class path reaches the sweep; list_model_configs' discovery."""
    from thyroid_tpu.config import compose as jax_compose
    from thyroid_tpu.config.loader import list_model_configs
    from thyroid_tpu.experiment.all_models_experiment import \
        AllModelsFullKFoldExperiment as JaxAllModels

    over = [f"output_dir={tmp_path}", "augmentation=no_aug"]
    port = AllModelsFullKFoldExperiment(compose(overrides=over), device="cpu")
    jax_exp = JaxAllModels(jax_compose(overrides=over))
    port.setup()
    jax_exp.setup()
    assert port.model_names == jax_exp.model_names == list_model_configs()
    for option in ("cnn/inception_v3", "vit/swin_medical"):
        got = port._model_experiment_config(option).to_dict()
        assert got == jax_exp._model_experiment_config(option).to_dict()
        assert got["dataset"]["quality_preprocessing"] is True
    via_cli = ExperimentManager(compose(overrides=[
        *over, f"+experiment_class_path={ALL_MODELS}",
        "+model_names=[cnn/resnet18,vit/deit_tiny]"]),
        device="cpu").build_experiment()
    assert isinstance(via_cli, AllModelsFullKFoldExperiment)
    assert via_cli.model_names == ["cnn/resnet18", "vit/deit_tiny"]


# --------------------------------------------------------------- tiny runs

@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """16 synthetic frames of 64²."""
    from thyroid_tpu_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(root / "synthetic", n_images=16, size=64)
    return root


def _no_quality_kernels(monkeypatch):
    """Within the test, DevicePipeline prepares its split without the
    quality stages (tests/test_torch_quality.py holds them, and
    chip_smoke.py phase 26 runs these sweeps with them on the card) and
    records the flag each split asked for."""
    from thyroid_tpu_torch.data import pipeline

    asked = []
    prepare = pipeline.prepare_images

    def record(raw, img_size, quality=False):
        asked.append(bool(quality))
        return prepare(raw, img_size, quality=False)

    monkeypatch.setattr(pipeline, "prepare_images", record)
    return asked


def _corpus(root: Path, out: Path):
    return ["dataset=synthetic_tiny", f"dataset.data_path={root / 'synthetic'}",
            f"dataset.split_dir={out / 'splits'}",
            f"kfold.split_dir={out / 'splits'}", f"output_dir={out / 'out'}",
            "trainer.max_epochs=1", "training.epochs=1", "training.batch_size=8",
            "dataset.synthetic_size=16"]


@pytest.mark.unit
def test_ablation_preset_runs(tiny_corpus, tmp_path, monkeypatch):
    """ablation_augmentation through the CLI, its resnet50 at width 8,
    one block a stage, 32²: eight runs, each with its level and quality
    flag in the dataset config it loads (the quality runs' three splits
    ask for the quality stages), none an "error" row;
    ablation_summary.json holds them and the best by test_acc."""
    from thyroid_tpu_torch.experiment import ablation_experiment

    asked = _no_quality_kernels(monkeypatch)
    seen = []
    loaders = ablation_experiment.create_data_loaders
    monkeypatch.setattr(ablation_experiment, "create_data_loaders",
                        lambda cfg, **kw: seen.append(
                            (cfg["augmentation_level"], cfg["quality_preprocessing"]))
                        or loaders(cfg, **kw))
    summary = launch_experiment(
        ["experiment=ablation_augmentation", *_corpus(tiny_corpus, tmp_path),
         "+experiment.model.img_size=32", "+experiment.model.params.width=8",
         "+experiment.model.params.layers=[1,1,1,1]", "+experiment.model.dtype=f32",
         "experiment.trainer.max_epochs=1", "experiment.training.epochs=1"],
        device="cpu")
    assert summary["num_runs"] == summary["num_successful"] == 8, summary
    assert seen == [(level, q) for level in ("none", "light", "medium", "heavy")
                    for q in (False, True)]
    assert asked == [q for _, q in seen for _ in range(3)]
    written = json.loads((tmp_path / "out" / "ablation_augmentation"
                          / "ablation_summary.json").read_text())
    assert len(written["all_runs"]) == 8
    best = max(summary["all_runs"], key=lambda r: r["test_acc"])
    assert written["best_run"]["run"] == best["run"]
    assert all(np.isfinite(r["test_loss"]) for r in summary["all_runs"])


TINY_MODELS = {
    "cnn/tiny_resnet": {"name": "resnet18", "architecture": "cnn",
                        "pretrained": False, "num_classes": 2, "in_channels": 1,
                        "img_size": 32, "dtype": "f32",
                        "params": {"width": 8, "layers": [1, 1, 1, 1]}},
    "vit/tiny_deit": {"name": "deit_tiny", "architecture": "vit",
                      "pretrained": False, "num_classes": 2, "in_channels": 1,
                      "img_size": 32, "dtype": "f32",
                      "params": {"patch_size": 8, "embed_dim": 48, "depth": 2,
                                 "num_heads": 3}},
}


@pytest.mark.unit
def test_all_models_sweep_runs(tiny_corpus, tmp_path, monkeypatch):
    """The sweep over two narrow model YAMLs in a config directory of
    their own, 2 folds of one epoch each with quality preprocessing
    forced on (every split asks for it): a summary per model with its
    best fold, only `{model}/best_checkpoint` left of the checkpoints,
    and all_models_summary.json."""
    asked = _no_quality_kernels(monkeypatch)
    cdir = tmp_path / "configs"
    for option, cfg in TINY_MODELS.items():
        path = cdir / "model" / f"{option}.yaml"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(yaml.safe_dump(cfg))
    over = [*_corpus(tiny_corpus, tmp_path), "kfold.num_folds=2",
            "dataset.quality_preprocessing=false", "training=cnn",
            "augmentation=no_aug"]
    exp = AllModelsFullKFoldExperiment(compose(overrides=over),
                                       config_dir=str(cdir), device="cpu")
    results = exp.execute()
    assert exp.model_names == ["cnn/tiny_resnet", "vit/tiny_deit"]
    assert asked == [True] * 12            # 2 models × 2 folds × 3 splits
    for name, model in (("tiny_resnet", "resnet18"), ("tiny_deit", "deit_tiny")):
        res = results[name]
        assert res["num_successful_folds"] == 2, res
        assert res["best_fold"] in (1, 2) and 0 <= res["avg_accuracy"] <= 1
        root = tmp_path / "out" / "all_models_kfold" / model
        assert (root / "best_checkpoint" / "state.pt").exists()
        assert not any(root.glob("fold_*"))
    summary = json.loads((tmp_path / "out" / "all_models_kfold"
                          / "all_models_summary.json").read_text())
    assert set(summary) == {"tiny_resnet", "tiny_deit"}
