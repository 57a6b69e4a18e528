"""The port's analysis (thyroid_tpu_torch/analysis, data/quality_report.py,
the Trainer's attention-map logging, MetricLogger.log_image) against the
JAX package on the CPU in float32, on the same numpy-drawn, bumped weights
and inputs: GradCAM (DeiT's head rule included), the attention maps in
JAX's order, the class-token heatmap, rollout, gradient patch importance,
Swin's stage maps, predict_probs with and without TTA, binary_report,
roc_curve_points, evaluate_ensemble_kfold's summary, analyze_split; then
the CLI's subcommands on tiny checkpoints of a 12-frame corpus (port
only). JAX's analysis functions run on jitted modules (JittedModule)."""
import json
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (SMALL_SWIN, JittedModule, jax_cnn, jax_params,
                                jax_swin, one_torch_thread)  # noqa: F401
from thyroid_tpu_torch.analysis import attention, cli, evaluation
from thyroid_tpu_torch.analysis.gradcam import gradcam
from thyroid_tpu_torch.data.imageio import PNG_SIGNATURE, decode_png
from thyroid_tpu_torch.data.pipeline import DevicePipeline
from thyroid_tpu_torch.data.quality_report import analyze_split
from thyroid_tpu_torch.models.base import ModelRegistry, create_and_init
from thyroid_tpu_torch.models.from_jax import (batch_stats, jax_layout,
                                               load_jax_variables)
from thyroid_tpu_torch.training.checkpoint import save_checkpoint
from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
from thyroid_tpu_torch.training.engine import Trainer
from thyroid_tpu_torch.utils.observe import MetricLogger

# heatmaps and maps in [0, 1] (max-normalised), confidences, probabilities:
# float32 sums of the same products in other orders
MAP_ATOL, CONF_ATOL, PROB_ATOL = 1e-4, 1e-5, 1e-5


def vit_config(family: str, **over):
    cfg = {"name": f"{family}_tiny", "img_size": 32, "patch_size": 8,
           "embed_dim": 48, "depth": 2, "num_heads": 3, "in_channels": 1,
           "num_classes": 2, "dtype": "f32", "drop_path_rate": 0.0}
    return dict(cfg, **over)


RESNET = {"name": "resnet18", "layers": (1, 1, 1, 1), "width": 8,
          "in_channels": 1, "num_classes": 2, "dtype": "f32",
          "dropout_rate": 0.0}
SWIN = dict(SMALL_SWIN, img_size=32, dtype="f32")
CONFIGS = {"vit": vit_config("vit"), "deit": vit_config("deit"),
           "swin": SWIN, "resnet": RESNET}


def port_model(config, variables):
    model = ModelRegistry.create_model(config)
    load_jax_variables(model, variables)
    return model.eval()


@pytest.fixture(scope="module")
def models():
    """{family: (config, jitted JAX module, JAX variables)}."""
    out = {}
    for name, cfg in CONFIGS.items():
        if name == "resnet":
            jmodel, variables = jax_cnn(cfg, seed=2)
        else:
            jmodel, params = (jax_swin(cfg, seed=1) if name == "swin"
                              else jax_params(cfg, seed=3))
            variables = {"params": params}
        out[name] = (cfg, JittedModule(jmodel), variables)
    return out


def image(seed: int, n: int = 1, side: int = 32) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, side, side, 1).astype(np.float32)


@pytest.mark.unit
@pytest.mark.parametrize("family", list(CONFIGS))
def test_gradcam_matches_jax(models, family):
    """The class, the heatmap and the confidence; DeiT has no pool_type,
    so its score is `head` over the mean of all tokens, as in JAX; the
    functional form (the Trainer's variables) equals the module's own."""
    from thyroid_tpu.analysis.gradcam import gradcam as jax_gradcam

    cfg, jmodel, variables = models[family]
    x = image(5)
    want_heat, want_cls, want_conf = jax_gradcam(jmodel, variables,
                                                 jnp.asarray(x))
    model = port_model(cfg, variables)
    heat, cls, conf = gradcam(model, None, torch.from_numpy(x))
    assert cls == want_cls and heat.shape == want_heat.shape
    assert np.abs(heat - want_heat).max() <= MAP_ATOL
    assert abs(conf - want_conf) <= CONF_ATOL
    assert hasattr(model, "pool_type") == (family == "vit")
    tensors = {**dict(model.named_parameters()), **batch_stats(model)}
    blank = ModelRegistry.create_model(cfg).eval()
    again = gradcam(blank, tensors, torch.from_numpy(x), 1 - cls)
    assert again[1] == 1 - cls
    np.testing.assert_array_equal(
        again[0], gradcam(model, None, torch.from_numpy(x), 1 - cls)[0])


@pytest.mark.unit
def test_attention_maps_rollout_and_patch_importance(models):
    """collect_attention_maps, the class-token heatmap of the last map and
    the rollout over all; gradient patch importance, also on the model
    built with token_kernels (the plain versions of kernels 2-3 on the
    CPU, differentiable as the kernels are with their backward kernels)."""
    from thyroid_tpu.analysis import attention as jatt

    cfg, jmodel, variables = models["vit"]
    x = image(6)
    want = jatt.collect_attention_maps(jmodel, variables, jnp.asarray(x))
    model = port_model(cfg, variables)
    got = attention.collect_attention_maps(model, None, torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-5
    for fn in (lambda m: attention.cls_attention_heatmap(m[-1]),
               lambda m: attention.cls_attention_heatmap(m[-1], has_cls=False),
               attention.attention_rollout):
        assert np.abs(fn(got) - fn(want)).max() <= MAP_ATOL
    want_imp = jatt.gradient_patch_importance(jmodel, variables,
                                              jnp.asarray(x), patch_size=8)
    for tk in (False, True):
        fused = port_model(dict(cfg, token_kernels=tk), variables)
        imp = attention.gradient_patch_importance(
            fused, None, torch.from_numpy(x), patch_size=8)
        assert imp.shape == (4, 4) and np.abs(imp - want_imp).max() <= MAP_ATOL


@pytest.mark.unit
def test_swin_stage_feature_maps(models):
    from thyroid_tpu.analysis import attention as jatt

    cfg, jmodel, variables = models["swin"]
    x = image(8)
    want = jatt.swin_stage_feature_maps(jmodel, variables, jnp.asarray(x))
    got = attention.swin_stage_feature_maps(port_model(cfg, variables), None,
                                            torch.from_numpy(x))
    assert [g.shape for g in got] == [w.shape for w in want] == [(8, 8), (4, 4)]
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= MAP_ATOL


def frames(seed: int, n: int, side: int = 48) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return (rs.rand(n, side, side, 1) * 40000 + 500).astype(np.uint16)


class JaxBatches:
    """The batches of a port pipeline, as JAX's pipeline yields them."""

    def __init__(self, pipeline):
        self.batches = [SimpleNamespace(image=jnp.asarray(b.image.numpy()),
                                        label=jnp.asarray(b.label.numpy()),
                                        weight=jnp.asarray(b.weight.numpy()))
                        for b in pipeline.epoch()]

    def epoch(self, key):
        return iter(self.batches)


@pytest.mark.unit
@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_predict_probs_matches_jax(models, tta):
    """Over an eval pipeline of 10 frames at batch 4 (two padding rows,
    dropped), JAX fed the same batches in the same order."""
    from thyroid_tpu.analysis.evaluation import predict_probs as jax_predict

    cfg, jmodel, variables = models["resnet"]
    pipe = DevicePipeline(frames(1, 10), np.arange(10) % 2, batch_size=4,
                          img_size=32, device="cpu")
    want = jax_predict(jmodel, variables, JaxBatches(pipe), tta=tta)
    got = evaluation.predict_probs(port_model(cfg, variables), None, pipe,
                                   tta=tta)
    assert got[0].shape == (10, 2)
    assert np.abs(got[0] - want[0]).max() <= PROB_ATOL
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.unit
def test_binary_report_and_roc_points():
    """On fixed arrays with ties and on one class: every count and ratio
    equal, the AUC within 1e-12 (NaN on one class)."""
    from thyroid_tpu.analysis.evaluation import binary_report, roc_curve_points

    rs = np.random.RandomState(9)
    p1 = np.round(rs.rand(64), 2)
    probs = np.stack([1 - p1, p1], axis=1)
    for labels in (rs.randint(0, 2, 64), np.ones(64, int)):
        got = evaluation.binary_report(probs, labels)
        want = binary_report(probs, labels)
        auc, want_auc = got.pop("auc"), want.pop("auc")
        assert got == want
        assert (np.isnan(auc) and np.isnan(want_auc)) or abs(auc - want_auc) <= 1e-12
        for g, w in zip(evaluation.roc_curve_points(p1, labels),
                        roc_curve_points(p1, labels)):
            np.testing.assert_array_equal(g, w)


def save_model(model, path, config=None):
    state = SimpleNamespace(params=dict(model.named_parameters()),
                            batch_stats=batch_stats(model),
                            layout=jax_layout(model), step=0)
    meta = {"model_config": config} if config is not None else None
    return save_checkpoint(path, state, meta)


@pytest.mark.unit
def test_ensemble_kfold_summary_matches_jax(tmp_path, monkeypatch):
    """Two narrow members over two folds: the port's summary (all three
    modes, each member's reports, the aggregates, the file) equals JAX's
    evaluate_ensemble_kfold fed the probabilities the port computed."""
    from thyroid_tpu.analysis import evaluation as jeval

    members = [RESNET, vit_config("deit")]
    specs = []
    for i, cfg in enumerate(members):
        ckpts = {fold: str(save_model(create_and_init(cfg, seed=10 * i + fold,
                                                      device="cpu"),
                                      tmp_path / f"{i}_{fold}"))
                 for fold in (1, 2)}
        specs.append({"model": cfg, "checkpoints": ckpts})
    pipes = {fold: DevicePipeline(frames(fold, 7), np.arange(7) % 2,
                                  batch_size=4, img_size=32, device="cpu")
             for fold in (1, 2)}
    seen = []
    predict = evaluation.predict_probs
    monkeypatch.setattr(evaluation, "predict_probs",
                        lambda *a, **k: seen.append(predict(*a, **k)) or seen[-1])
    got = evaluation.evaluate_ensemble_kfold(specs, pipes, weights=[2.0, 1.0],
                                             output_path=tmp_path / "e.json",
                                             device="cpu")
    replay = iter(seen)
    monkeypatch.setattr(jeval, "predict_probs", lambda *a, **k: next(replay))
    monkeypatch.setattr(jeval, "load_checkpoint", lambda path: ({}, {}))
    monkeypatch.setattr(jeval.ModelRegistry, "create_model", lambda cfg: None)
    want = jeval.evaluate_ensemble_kfold(specs, pipes, weights=[2.0, 1.0])
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert set(got["modes"]) == {"weighted_average", "simple_average",
                                 "weighted_voting"}
    assert set(got["members"]) == {"resnet18", "deit_tiny"}
    assert json.loads((tmp_path / "e.json").read_text()) == \
        json.loads(json.dumps(got))


def quality_frames() -> np.ndarray:
    """64² uint16 frames: dark, low-contrast, with hot-pixel artifacts,
    clean, and dark with artifacts."""
    rs = np.random.RandomState(11)
    f = np.empty((5, 64, 64, 1), np.float64)
    f[0] = rs.rand(64, 64, 1) * 200                      # mean < 150
    f[1] = 1000 + rs.rand(64, 64, 1) * 20                # std < 80
    f[2] = 800 + rs.rand(64, 64, 1) * 400
    f[2, :3, :3] = 65535                                 # max / mean > 30
    f[3] = rs.rand(64, 64, 1) * 30000
    f[4] = rs.rand(64, 64, 1) * 100
    f[4, 0, 0] = 9000
    return f.astype(np.uint16)


@pytest.mark.unit
def test_analyze_split_matches_jax():
    from thyroid_tpu.data.quality_report import analyze_split as jax_analyze

    x = quality_frames()
    got = analyze_split(x, device="cpu")
    want = jax_analyze(x)
    assert got["quality_issues"] == want["quality_issues"] == {
        "extreme_dark": [0, 4], "low_contrast": [1],
        "potential_artifacts": [2, 4]}
    assert got["num_images"] == want["num_images"] == 5
    for k in ("mean_intensity", "std_intensity", "min", "max"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    for k in ("mean", "std", "max"):
        np.testing.assert_allclose(got["per_image"][k], want["per_image"][k],
                                   rtol=1e-6)


@pytest.mark.unit
def test_trainer_attention_logging(models, tmp_path, monkeypatch):
    """The Trainer's maps (the first 4 validation images, the last captured
    map's class-token heatmap) against JAX's cls_attention_heatmap(
    collect_attention_maps(...)[-1]) on the same weights and images; one
    epoch of fit writes the figure; a Swin's window maps are skipped by
    JAX's shape rule; without matplotlib the Trainer refuses to log."""
    from thyroid_tpu.analysis import attention as jatt

    cfg, jmodel, variables = models["deit"]
    trainer_cfg = dict(TRAINER_DEFAULT, log_attention_every_n_epochs=1,
                       max_epochs=1, enable_checkpointing=False)
    served = dict(cfg, token_kernels=True)
    trainer = Trainer(ModelRegistry.create_model(served), served, TRAINING_VIT,
                      trainer_cfg, steps_per_epoch=1, device="cpu",
                      variables=variables, output_dir=tmp_path / "deit")
    val = DevicePipeline(frames(2, 6), np.arange(6) % 2, batch_size=6,
                         img_size=32, device="cpu")
    images, labels, heatmaps = trainer.attention_maps(val)
    assert images.shape == (4, 32, 32, 1) and list(labels) == [0, 1, 0, 1]
    maps = jatt.collect_attention_maps(jmodel, variables, jnp.asarray(images))
    for i, hm in enumerate(heatmaps):
        want = jatt.cls_attention_heatmap(maps[-1][i:i + 1], has_cls=True)
        assert hm.shape == (4, 4) and np.abs(hm - want).max() <= MAP_ATOL
    train = DevicePipeline(frames(3, 4), np.arange(4) % 2, batch_size=4,
                           img_size=32, train=True, device="cpu")
    trainer.fit(train, val)
    png = tmp_path / "deit" / "logs" / "images" / "attention_maps_00000.png"
    assert png.read_bytes().startswith(PNG_SIGNATURE)

    # JAX's skip rule: the last map is not one per image (4 windows of the
    # 64² Swin's last stage a frame; a CNN records none)
    for cfg, side in ((dict(SMALL_SWIN, dtype="f32"), 64), (RESNET, 32)):
        other = Trainer(ModelRegistry.create_model(cfg), cfg, TRAINING_VIT,
                        trainer_cfg, device="cpu", output_dir=tmp_path / "other")
        assert other.attention_maps(DevicePipeline(
            frames(2, 4), np.zeros(4), batch_size=4, img_size=side,
            device="cpu")) is None
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        Trainer(ModelRegistry.create_model(RESNET), RESNET, TRAINING_VIT,
                trainer_cfg, device="cpu", output_dir=tmp_path / "off")


@pytest.mark.unit
def test_log_image_writes_png(tmp_path):
    """An array is min-max scaled to uint8 and written as a PNG."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4) - 3.0
    path = MetricLogger(tmp_path).log_image("maps/a", arr, step=3)
    assert path == tmp_path / "images" / "maps_a_00003.png"
    want = ((arr - arr.min()) / (arr.max() - arr.min()) * 255).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(path.read_bytes()), want)


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 12-frame 64² corpus with a one-fold split file, checkpoints of
    narrow models (with their configs) in the sequential-training layout,
    and the dataset overrides that point the CLI at them."""
    from thyroid_tpu_torch.data.corpus import generate_splits
    from thyroid_tpu_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("analysis_cli")
    generate_corpus(root / "corpus", n_images=12, size=64)
    (root / "splits").mkdir()
    labels = np.arange(12) >= 6
    splits = {k: [int(i) for i in v]
              for k, v in generate_splits(labels.astype(int), 0.25, 0.25, 42).items()}
    (root / "splits" / "split_fold_1.json").write_text(json.dumps(splits))
    ckpts = {}
    for name, cfg in (("resnet18", RESNET), ("vit_tiny", vit_config("vit")),
                      ("swin_tiny", SWIN)):
        path = root / "ckpt" / name / "fold_1" / "checkpoints" / f"{name}-best.ckpt"
        ckpts[name] = save_model(create_and_init(cfg, seed=4, device="cpu"),
                                 path, cfg)
    overrides = [f"dataset.data_path={root / 'corpus'}", "dataset.synthetic=false",
                 f"dataset.split_dir={root / 'splits'}", "dataset.img_size=32",
                 "dataset.batch_size=4", "dataset.quality_preprocessing=false"]
    opts = ["--device", "cpu"] + [a for o in overrides for a in ("--override", o)]
    return SimpleNamespace(root=root, ckpts=ckpts, opts=opts)


@pytest.mark.unit
def test_cli_gradcam(corpus):
    out = corpus.root / "gradcam"
    rows = cli.main(["gradcam", "--model", "resnet18", "--checkpoint",
                     str(corpus.ckpts["resnet18"]), "--output-dir", str(out),
                     "--n-samples", "2", *corpus.opts])
    assert len(rows) == 2 and all(np.isfinite(r["heatmap"]).all() for r in rows)
    assert sorted(p.name for p in out.iterdir()) == \
        ["gradcam_resnet18_0.png", "gradcam_resnet18_1.png"]


@pytest.mark.unit
@pytest.mark.parametrize("name", ["vit_tiny", "swin_tiny"])
def test_cli_attention(corpus, name):
    """ViT: the last map's class-token heatmap, the rollout and patch
    importance; Swin (built without its kernels, so that autograd runs
    through it): the stage maps and patch importance."""
    out = corpus.root / f"attention_{name}"
    heatmaps = cli.main(["attention", "--model", name, "--checkpoint",
                         str(corpus.ckpts[name]), "--output-dir", str(out),
                         *corpus.opts])
    want = (["last-layer CLS attention", "attention rollout"] if name == "vit_tiny"
            else ["stage 0 activity", "stage 1 activity"])
    assert list(heatmaps) == want + ["gradient patch importance"]
    assert (out / f"attention_{name}.png").exists()


@pytest.mark.unit
def test_cli_confusion_roc(corpus):
    """--tta reports equal evaluate_checkpoint's; a checkpoint without a
    stored model config does not rebuild silently."""
    out = corpus.root / "roc"
    reports = cli.main(["confusion-roc", "--models",
                        f"resnet18={corpus.ckpts['resnet18']}",
                        f"vit_tiny={corpus.ckpts['vit_tiny']}", "--tta",
                        "--output-dir", str(out), *corpus.opts])
    assert (out / "confusion_roc.png").exists()
    assert json.loads((out / "reports.json").read_text()).keys() == reports.keys()
    pipe = cli._split_pipeline(cli.parser().parse_args(
        ["confusion-roc", "--models", "x", *corpus.opts]), "test")
    direct = evaluation.evaluate_checkpoint(corpus.ckpts["resnet18"],
                                            pipeline=pipe, tta=True, device="cpu")
    assert reports["resnet18"]["confusion_matrix"] == direct["confusion_matrix"]
    assert reports["resnet18"]["auc"] == direct["auc"]
    bare = save_model(create_and_init(RESNET, device="cpu"), corpus.root / "bare")
    with pytest.raises(ValueError, match="model_config"):
        evaluation.evaluate_checkpoint(bare, pipeline=pipe, device="cpu")


@pytest.mark.unit
def test_cli_ensemble_kfold(corpus):
    """The default layout, one fold, the summary file and the merged
    cnn_ensemble row with the normalised weights; --demo-corpus raises."""
    row = corpus.root / "all_models_summary.json"
    row.write_text(json.dumps({"resnet18": {"avg_accuracy": 0.5}}))
    summary = cli.main(["ensemble-kfold", "--members", "resnet18", "vit_tiny",
                        "--weights", "3", "1", "--folds", "1",
                        "--checkpoint-root", str(corpus.root / "ckpt"),
                        "--output", str(corpus.root / "ens.json"),
                        "--summary-row", str(row), *corpus.opts])
    assert summary["weights"] == [0.75, 0.25]
    assert set(summary["members"]) == {"resnet18", "vit_tiny"}
    zoo = json.loads(row.read_text())
    assert set(zoo) == {"resnet18", "cnn_ensemble"}
    assert zoo["cnn_ensemble"]["avg_accuracy"] == summary["mean_accuracy"]
    with pytest.raises(NotImplementedError, match="CLI"):
        cli.main(["ensemble-kfold", "--demo-corpus", *corpus.opts])


@pytest.mark.unit
def test_cli_quality_report(corpus):
    out = corpus.root / "quality.json"
    report = cli.main(["quality-report", "--data-path", str(corpus.root / "corpus"),
                       "--split-dir", str(corpus.root / "q_splits"),
                       "--output", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == report
    assert report["summary"]["total_images"] == 12
    assert set(report["dataset_stats"]) == {"train", "val", "test"}
