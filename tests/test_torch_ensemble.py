"""The port's CNN ensemble (thyroid_tpu_torch/models/ensemble/cnn_ensemble.py)
against the JAX package on the CPU in float32: narrow members named
resnet50, efficientnet_b0 and densenet121 (so the accuracy table weighs
them) on numpy-drawn, bumped variables, every method's combined
probabilities, the member probabilities at temperature 2, the ddof-1
uncertainty and the teacher logits; the registry shell of
configs/model/ensemble/cnn_top3.yaml and restore_ensemble on the port's
own checkpoints. Then the slice end to end: the k-fold CLI composition
for model=vit/deit_tiny training=vit, narrowed, through both folds on the
CPU."""
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import SMALL_EFFNET, jax_cnn, jax_train_stats
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.ensemble import (DEFAULT_MODEL_ACCURACIES,
                                               CNNEnsemble,
                                               build_ensemble_from_members)
from thyroid_tpu_torch.models.from_jax import batch_stats, jax_layout
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training.checkpoint import (restore_ensemble,
                                                   save_checkpoint)

ROOT = Path(__file__).resolve().parents[1]
MEMBERS = (
    {"name": "resnet50", "block": "bottleneck", "layers": (1, 1, 1, 1),
     "width": 8, "img_size": 32, "in_channels": 1, "num_classes": 2,
     "dtype": "f32", "dropout_rate": 0.0},
    SMALL_EFFNET,
    {"name": "densenet121", "growth_rate": 8, "block_config": (1, 1),
     "num_init_features": 16, "img_size": 32, "in_channels": 1,
     "num_classes": 2, "dtype": "f32", "dropout_rate": 0.0},
)
METHODS = ("weighted_average", "simple_average", "weighted_voting")
# the narrow efficientnet member's logits reach 150 and agree with JAX's
# within 7e-4 (5e-6 relative); over temperature 2 that moves a probability
# by at most a quarter of 3.5e-4 and a log-probability by 3.5e-4
PROB_ATOL, LOGP_ATOL = 1e-4, 1e-3


@lru_cache(maxsize=None)
def member_variables():
    x = jnp.asarray(np.random.RandomState(1).randn(8, 32, 32, 1)
                    .astype(np.float32))
    out = []
    for i, cfg in enumerate(MEMBERS):
        model, variables = jax_cnn(cfg, seed=i)
        out.append(jax_train_stats(model, variables, x))
    return out


@lru_cache(maxsize=None)
def jax_ensembles():
    """{method: (JAX's CNNEnsemble over the members, its outputs on the
    test's input)}, every method in one jitted program."""
    from thyroid_tpu.models.ensemble import \
        build_ensemble_from_members as jax_build

    variables = member_variables()
    ens = {m: jax_build(list(MEMBERS), variables, method=m, temperature=2.0)
           for m in METHODS}
    x = jnp.asarray(ensemble_input())
    outs = jax.jit(lambda x: {m: (e(x), e.member_probs(x),
                                  *e.predict_with_uncertainty(x), e.logits(x))
                              for m, e in ens.items()})(x)
    return {m: (ens[m], outs[m]) for m in METHODS}


def ensemble_input():
    return np.random.RandomState(2).randn(5, 32, 32, 1).astype(np.float32)


@pytest.mark.unit
@pytest.mark.parametrize("method", METHODS)
def test_methods_match_jax(method):
    """Combined probabilities, member probabilities (temperature 2: each a
    softmax of logits / T), the weighted mean with the members' ddof-1
    standard deviation, and log(clip(p, 1e-8, 1)) of each method against
    JAX's CNNEnsemble over the same members, within PROB_ATOL (LOGP_ATOL
    for the logs); the weights equal JAX's."""
    jens, want = jax_ensembles()[method]
    x = ensemble_input()
    ens = build_ensemble_from_members(list(MEMBERS), member_variables(),
                                      method=method, temperature=2.0,
                                      device="cpu")
    assert ens.member_names == ["resnet50", "efficientnet_b0", "densenet121"]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = (ens(xt), ens.member_probs(xt), *ens.predict_with_uncertainty(xt),
               ens.logits(xt))
    for name, g, w in zip(("combined", "members", "mean", "std", "logits"),
                          got, want):
        atol = LOGP_ATOL if name == "logits" else PROB_ATOL
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(ens.weights().numpy(), np.asarray(jens.weights()),
                               atol=1e-7)
    assert float(got[1].std()) > 1e-3          # the members disagree
    if method == "weighted_voting":
        assert set(np.unique(got[0].numpy().round(6))) <= {
            0.0, 1.0, *np.asarray(jens.weights()).round(6),
            *(1 - np.asarray(jens.weights())).round(6)}


@pytest.mark.unit
def test_registry_shell_and_restore(tmp_path):
    """cnn_top3.yaml through the registry: a CNNEnsemble of resnet50,
    efficientnet_b0 and densenet121 with the YAML's method, temperature
    and accuracies. restore_ensemble fills each member of an ensemble from
    a port checkpoint (torch.save, written by save_checkpoint from the
    narrow members with their seeded weights), after which each member's
    tensors and logits equal the source's; a wrong number of checkpoints
    raises."""
    cfg = yaml.safe_load((ROOT / "configs" / "model" / "ensemble" / "cnn_top3.yaml")
                         .read_text())
    shell = ModelRegistry.create_model(cfg)
    assert isinstance(shell, CNNEnsemble)
    assert shell.member_names == cfg["params"]["members"]
    assert [type(m).__name__ for m in shell.members] == \
        ["ResNet", "EfficientNet", "DenseNet"]
    assert shell.method == cfg["params"]["method"]
    assert shell.temperature == cfg["params"]["temperature"]
    assert shell.model_accuracies == cfg["params"]["model_accuracies"] \
        == DEFAULT_MODEL_ACCURACIES
    paths, sources = [], []
    for i, member in enumerate(MEMBERS):
        model = create_and_init(member, seed=10 + i, device="cpu")
        state = SimpleNamespace(params=dict(model.named_parameters()),
                                batch_stats=batch_stats(model),
                                layout=jax_layout(model), step=0)
        paths.append(save_checkpoint(tmp_path / f"{member['name']}.ckpt", state))
        sources.append(model)
    ens = CNNEnsemble([m["name"] for m in MEMBERS],
                      [ModelRegistry.create_model(m) for m in MEMBERS])
    with pytest.raises(ValueError, match="3 members but 2 checkpoints"):
        restore_ensemble(ens, paths[:2])
    assert restore_ensemble(ens, paths) is ens
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 32, 32, 1)
                         .astype(np.float32))
    with torch.no_grad():
        for member, source in zip(ens.members, sources):
            src = source.state_dict()
            assert all(torch.equal(t, src[k]) for k, t in member.state_dict().items())
            assert torch.equal(member(x), source(x))
        probs = ens(x)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """16 synthetic frames of 64²."""
    from thyroid_tpu_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(root / "synthetic", n_images=16, size=64)
    return root


# the composition's cut: deit_tiny at 32², patch 8, width 48, depth 2
# (inception_v3's CLI runs in chip_smoke.py phase 25: at full width its
# CPU folds cost minutes under the suite's parallel load)
ZOO_CLI = {
    "deit_tiny": (["model=vit/deit_tiny", "training=vit", "model.img_size=32",
                   "model.params.patch_size=8", "model.params.embed_dim=48",
                   "model.params.depth=2"], "deit"),
}


@pytest.mark.unit
@pytest.mark.parametrize("name", list(ZOO_CLI))
def test_zoo_kfold_cli(name, tiny_corpus, tmp_path, monkeypatch):
    """launch_experiment with the composition's model and training groups,
    cut to 2 folds of one epoch on 16 frames: both folds succeed with
    finite averages, the Trainer takes DeiT's "deit" loss mode on its
    training tuple, and its eval forwards take the serving path (the fused
    LN + QKV, whose plain version runs on the CPU)."""
    from thyroid_tpu_torch.experiment import launch_experiment
    from thyroid_tpu_torch.models import layers
    from thyroid_tpu_torch.training.engine import Trainer

    extra, mode = ZOO_CLI[name]
    seen = {"modes": set(), "tuples": 0, "fused": 0}
    step = Trainer.loss_and_grads

    def spy(self, images, *args):
        seen["modes"].add(self.loss_mode)
        seen["tuples"] += isinstance(self.model(images[:1], train=True,
                                                generator=self.dropout_generator),
                                     tuple)
        return step(self, images, *args)

    fused = layers.fused_ln_matmul
    monkeypatch.setattr(Trainer, "loss_and_grads", spy)
    monkeypatch.setattr(layers, "fused_ln_matmul", lambda *a, **k: (
        seen.__setitem__("fused", seen["fused"] + 1), fused(*a, **k))[1])
    summary = launch_experiment(
        [*extra, "dataset=synthetic_tiny",
         f"dataset.data_path={tiny_corpus / 'synthetic'}",
         f"dataset.split_dir={tmp_path / 'splits'}",
         f"kfold.split_dir={tmp_path / 'splits'}", f"output_dir={tmp_path / 'out'}",
         "kfold.num_folds=2", "trainer.max_epochs=1", "training.epochs=1",
         "training.batch_size=4", "dataset.synthetic_size=16",
         "+model.dtype=f32"], device="cpu")
    rows = summary["raw_fold_results"]
    assert summary["num_successful_folds"] == 2, rows
    assert not any("error" in r for r in rows)
    assert all(np.isfinite(v) for k, v in summary.items() if k.startswith("avg_"))
    assert seen["modes"] == {mode} and seen["tuples"] > 0
    assert seen["fused"] > 0
