"""Port config composition (thyroid_tpu_torch.config) against the JAX
package's on the repo's configs/: the composed trees, as `to_dict()`,
must be equal exactly, for the root default, group and path overrides,
`+a.b=v` and `~a.b`, and every configs/experiment preset through
ExperimentManager's merged tree."""
from pathlib import Path

import pytest

import thyroid_tpu.experiment.manager as jax_manager
from thyroid_tpu.config import ConfigNode as JaxNode
from thyroid_tpu.config import compose as jax_compose
from thyroid_tpu.config import list_model_configs as jax_list
from thyroid_tpu.config import load_model_config as jax_load
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch import config as tcfg
from thyroid_tpu_torch.config import (ConfigNode, compose, list_model_configs,
                                      load_model_config)
from thyroid_tpu_torch.experiment import manager as torch_manager

ROOT = Path(__file__).resolve().parents[1]
PRESETS = sorted(p.stem for p in (ROOT / "configs" / "experiment").glob("*.yaml"))
PATH = ["model=cnn/efficientnet_b0", "dataset=synthetic", "training=cnn",
        "augmentation=no_aug", "trainer.max_epochs=1", "kfold.num_folds=2",
        "dataset.data_path=/tmp/corpus", "dataset.split_dir=/tmp/splits",
        "kfold.split_dir=/tmp/splits", "output_dir=/tmp/out"]
OVERRIDES = {
    "root-default": [],
    "model": ["model=cnn/efficientnet_b0"],
    "dataset": ["dataset=synthetic_tiny"],
    "training": ["training=vit"],
    "augmentation": ["augmentation=no_aug"],
    "trainer-kfold": ["trainer=quick", "kfold=seven"],
    "experiment-path": PATH,
    "paths-typed": ["trainer.max_epochs=3", "dataset.mean=[0.4]",
                    "training.optimizer_params.lr=3e-4", "seed=null",
                    "kfold.shuffle=false", "output_dir='x y'"],
    "add": ["+model.width_mult=0.25", "+extra.deep.key={a: 1, b: [1, 2]}",
            "+student_model=vit/deit_tiny"],
    "delete": ["~dataset.mean", "~trainer", "~training.loss.name"],
    "mixed": ["model=vit/swin_tiny", "+model.dtype=bf16", "~model.params",
              "dataset=cars_quality", "dataset.batch_size=8"],
}


@pytest.mark.unit
@pytest.mark.parametrize("overrides", list(OVERRIDES.values()),
                         ids=list(OVERRIDES))
def test_compose_matches_jax(overrides):
    got, want = compose(overrides=overrides), jax_compose(overrides=overrides)
    assert isinstance(got, ConfigNode)
    assert got.to_dict() == want.to_dict()


@pytest.mark.unit
@pytest.mark.parametrize("bad,error", [("dataset", ValueError),
                                       ("model=cnn/none", FileNotFoundError)])
def test_compose_errors_match_jax(bad, error):
    with pytest.raises(error):
        jax_compose(overrides=[bad])
    with pytest.raises(error):
        compose(overrides=[bad])


@pytest.mark.unit
def test_model_configs_match_jax():
    assert list_model_configs() == jax_list()
    assert list_model_configs(families=("cnn", "vit", "ensemble")) == \
        jax_list(families=("cnn", "vit", "ensemble"))
    for name in ("efficientnet_b0", "vit/swin_tiny", "cnn/resnet18", "swin_medical"):
        assert load_model_config(name).to_dict() == jax_load(name).to_dict()
    with pytest.raises(FileNotFoundError):
        load_model_config("no_such_model")
    assert tcfg.DEFAULT_CONFIG_DIR == ROOT / "configs"


def _captured(cls_attr, module, monkeypatch):
    box = {}
    monkeypatch.setattr(module, cls_attr,
                        lambda cfg, **kw: box.setdefault("cfg", cfg))
    return box


@pytest.mark.unit
@pytest.mark.parametrize("preset", PRESETS)
def test_experiment_preset_tree_matches_jax(preset, monkeypatch):
    """The tree build_experiment hands its experiment; the experiment
    classes (k-fold and ablation) are stubbed on both sides, so that no
    experiment is built."""
    overrides = [f"experiment={preset}", "augmentation=no_aug"]
    want = _captured("KFoldExperiment", jax_manager, monkeypatch)
    monkeypatch.setattr(jax_manager, "AblationExperiment",
                        lambda cfg: want.setdefault("cfg", cfg))
    jax_manager.ExperimentManager(jax_compose(overrides=overrides)).build_experiment()
    got = _captured("KFoldExperiment", torch_manager, monkeypatch)
    monkeypatch.setattr(torch_manager, "AblationExperiment",
                        lambda cfg, **kw: got.setdefault("cfg", cfg))
    torch_manager.ExperimentManager(compose(overrides=overrides)).build_experiment()
    assert got["cfg"].to_dict() == want["cfg"].to_dict()


@pytest.mark.unit
def test_manager_without_experiment_node_matches_jax(monkeypatch):
    """No experiment node: the root config itself gets the name and the
    augmentation level, in place, on both sides."""
    want = _captured("KFoldExperiment", jax_manager, monkeypatch)
    jcfg = jax_compose(overrides=PATH)
    jax_manager.ExperimentManager(jcfg).build_experiment()
    got = _captured("KFoldExperiment", torch_manager, monkeypatch)
    cfg = compose(overrides=PATH)
    torch_manager.ExperimentManager(cfg).build_experiment()
    assert got["cfg"] is cfg
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.dataset.augmentation_level == "none"
    assert cfg.dataset.apply_augmentations is False
    assert cfg.name == "efficientnet_b0"


@pytest.mark.unit
def test_config_node_matches_jax():
    data = {"a": {"b": [1, {"c": 2}], "d": None}, "e": (3, 4)}
    got, want = ConfigNode(data), JaxNode(data)
    assert got.to_dict() == want.to_dict()
    assert got.a.b[1].c == 2 and got.select("a.b.1.c") == 2
    for path in ("a.b.-1.c", "a.b.5", "a.x", "e.1", "a.d"):
        assert got.select(path, "miss") == want.select(path, "miss"), path
    with pytest.raises(KeyError):
        got.select("a.x")
    for node in (got, want):
        node.update_path("a.f.g", 5)
        node.merge({"a": {"b": 7, "h": {"i": 1}}, "k": [{"l": 1}]})
        node.x = 1
        del node.e
    assert got.to_dict() == want.to_dict()
    assert isinstance(got.k[0], ConfigNode)
    assert got.to_json(sort_keys=True) == want.to_json(sort_keys=True)
    assert dict(got.flat_items()) == dict(want.flat_items())
    dup = got.copy()
    dup.a.h.i = 2
    assert got.a.h.i == 1 and dup.to_dict() != got.to_dict()
    with pytest.raises(AttributeError):
        got.missing


@pytest.mark.unit
def test_schemas_match_jax():
    """The port's pydantic models, loaded lazily, validate as JAX's."""
    from thyroid_tpu.config import schemas as jschemas

    ds = {"data_path": "d", "channels": 1, "mean": [0.1, 0.2, 0.3], "std": 0.5}
    assert tcfg.DatasetConfig(**ds).model_dump() == \
        jschemas.DatasetConfig(**ds).model_dump()
    assert tcfg.TrainerConfig(precision="16-mixed").precision == "bf16"
    for bad in ({"precision": "fp8"},):
        with pytest.raises(ValueError):
            tcfg.TrainerConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.TrainingConfig(monitor_mode="up")
    with pytest.raises(ValueError):
        tcfg.DatasetConfig(data_path="d", channels=3, mean=[0.5, 0.5])
    main = {"model": {"name": "swin_tiny", "architecture": "vit", "depth": 2}}
    assert tcfg.MainAppConfig(**main).model_dump() == \
        jschemas.MainAppConfig(**main).model_dump()
    with pytest.raises(AttributeError):
        tcfg.NoSuchSchema
