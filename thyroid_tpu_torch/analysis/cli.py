"""Command line of the analysis (counterpart of scripts/generate_gradcam.py,
generate_attention_maps.py, generate_confusion_roc.py,
run_ensemble_kfold_evaluation.py and data_quality_report.py), one
subcommand each, with those scripts' arguments:

    python -m thyroid_tpu_torch.analysis.cli gradcam --model resnet50 \\
        --checkpoint outputs/.../resnet50-best.ckpt [--device cpu]
    python -m thyroid_tpu_torch.analysis.cli attention ...
    python -m thyroid_tpu_torch.analysis.cli confusion-roc --models name=ckpt ...
    python -m thyroid_tpu_torch.analysis.cli ensemble-kfold --members ... \\
        --checkpoint-root outputs --folds 7 [--summary-row FILE]
    python -m thyroid_tpu_torch.analysis.cli quality-report --data-path ...

Beside the scripts' arguments: `--device` (the card unless "cpu" is given)
and, where a dataset config is composed, `--override KEY=VALUE` (repeatable,
e.g. `dataset.data_path=...`), applied after `dataset=`. The ensemble reads
the sequential-training layout
{root}/{model}/fold_{f}/checkpoints/{model}-best.ckpt. `gradcam` and
`attention` build the model without the serving kernels (`token_kernels`
and `use_pallas_attention` false, as the JAX scripts do), so that autograd
runs through the forward; `confusion-roc` and `ensemble-kfold` evaluate the
models as served. `--demo-corpus` raises: the zoo demo's corpus has no
port. `--batch` and `--img-size` size only that corpus, as in the scripts.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

DEMO_UNPORTED = ("--demo-corpus rebuilds scripts/run_zoo_kfold_demo.py's "
                 "corpus, which is not ported (ROADMAP Queue 1: CLI)")


def _no_demo(args) -> None:
    if args.demo_corpus:
        raise NotImplementedError(DEMO_UNPORTED)


def _dataset_config(args) -> Dict[str, Any]:
    from ..config import compose

    cfg = compose(overrides=[f"dataset={args.dataset}", *args.override])
    return cfg.dataset.to_dict()


def _split_pipeline(args, split: str, dataset_config=None):
    from ..data.pipeline import create_data_loaders

    dcfg = dataset_config if dataset_config is not None else _dataset_config(args)
    return create_data_loaders(dcfg, splits=(split,), device=args.device)[split]


def stored_config(checkpoint: str | Path, name: str) -> Dict[str, Any]:
    """The model config a checkpoint's metadata stores, else {"name":
    name}."""
    meta_path = Path(checkpoint) / "metadata.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return dict(meta.get("model_config") or {"name": name})


def _analysis_model(args):
    """The checkpoint's model built without the serving kernels."""
    from .evaluation import load_model

    mcfg = stored_config(args.checkpoint, args.model)
    mcfg["token_kernels"] = False
    mcfg["use_pallas_attention"] = False
    return load_model(args.checkpoint, mcfg, args.device)[0]


def cmd_gradcam(args) -> List[Dict[str, Any]]:
    from .evaluation import eval_batches
    from .gradcam import gradcam, gradcam_overlay

    _no_demo(args)
    pipe = _split_pipeline(args, args.split)
    model = _analysis_model(args)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    batch = next(iter(eval_batches(pipe)))
    rows = []
    for i in range(min(args.n_samples, batch.image.shape[0])):
        img = batch.image[i:i + 1]
        heat, cls, conf = gradcam(model, None, img)
        label = int(batch.label[i])
        gradcam_overlay(heat, img[0].cpu().numpy(),
                        out / f"gradcam_{args.model}_{i}.png",
                        title=f"true={label} pred={cls} conf={conf:.2f}")
        print(f"sample {i}: true={label} pred={cls} conf={conf:.3f}")
        rows.append({"label": label, "pred": cls, "confidence": conf,
                     "heatmap": heat})
    print("wrote figures to", out)
    return rows


def cmd_attention(args) -> Dict[str, np.ndarray]:
    from .attention import (attention_figure, attention_rollout,
                            cls_attention_heatmap, collect_attention_maps,
                            gradient_patch_importance, swin_stage_feature_maps)
    from .evaluation import eval_batches

    _no_demo(args)
    pipe = _split_pipeline(args, "test")
    model = _analysis_model(args)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    img = next(iter(eval_batches(pipe))).image[:1]
    heatmaps = {}
    if "swin" in args.model:
        for i, m in enumerate(swin_stage_feature_maps(model, None, img)):
            heatmaps[f"stage {i} activity"] = m
    else:
        maps = collect_attention_maps(model, None, img)
        if maps:
            heatmaps["last-layer CLS attention"] = cls_attention_heatmap(maps[-1])
            heatmaps["attention rollout"] = attention_rollout(maps)
    heatmaps["gradient patch importance"] = gradient_patch_importance(
        model, None, img)
    path = out / f"attention_{args.model}.png"
    attention_figure(img[0].cpu().numpy(), heatmaps, path)
    print("wrote", path)
    return heatmaps


def cmd_confusion_roc(args) -> Dict[str, Dict[str, Any]]:
    from .evaluation import (binary_report, confusion_roc_figure, load_model,
                             predict_probs, roc_curve_points)

    _no_demo(args)
    specs = []
    for spec in args.models:
        name, _, ckpt = spec.partition("=")
        specs.append((name, Path(ckpt)))
    pipe = _split_pipeline(args, "test")
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    reports, rocs = {}, {}
    for name, ckpt in specs:
        model, _ = load_model(ckpt, stored_config(ckpt, name), args.device)
        probs, labels, _ = predict_probs(model, None, pipe, tta=args.tta)
        rep = binary_report(probs, labels)
        rep["checkpoint"] = str(ckpt)
        rep["tta"] = bool(args.tta)
        reports[name] = rep
        rocs[name] = roc_curve_points(probs[:, 1], labels)
        print(name, {k: round(v, 4) for k, v in rep.items()
                     if isinstance(v, float)})
    confusion_roc_figure(reports, rocs, out / "confusion_roc.png")
    (out / "reports.json").write_text(json.dumps(reports, indent=2,
                                                 default=str))
    print("wrote", out)
    return reports


def member_checkpoints(root: Path, name: str, folds: int):
    """({fold: the best checkpoint of `name`}, the model config fold 1's
    metadata stores, else {"name": name}) in the sequential-training
    layout; a missing checkpoint exits."""
    ckpts = {}
    for fold in range(1, folds + 1):
        best = root / name / f"fold_{fold}" / "checkpoints" / f"{name}-best.ckpt"
        if not best.exists():
            raise SystemExit(f"missing checkpoint {best} — train {name} first")
        ckpts[fold] = str(best)
    return ckpts, stored_config(ckpts[1], name)


def cmd_ensemble_kfold(args) -> Dict[str, Any]:
    from .evaluation import evaluate_ensemble_kfold

    _no_demo(args)
    root = Path(args.checkpoint_root)
    member_specs = []
    for name in args.members:
        ckpts, model_cfg = member_checkpoints(root, name, args.folds)
        member_specs.append({"model": model_cfg, "checkpoints": ckpts})
    dataset_config = _dataset_config(args)
    fold_pipelines = {}
    for fold in range(1, args.folds + 1):
        dcfg = dict(dataset_config)
        dcfg["split_file"] = str(
            Path(dcfg["split_dir"]) / f"split_fold_{fold}.json")
        fold_pipelines[fold] = _split_pipeline(args, "test", dcfg)

    summary = evaluate_ensemble_kfold(member_specs, fold_pipelines,
                                      weights=args.weights,
                                      output_path=args.output,
                                      device=args.device)
    slim = {k: v for k, v in summary.items() if k not in ("folds",)}
    slim["modes"] = {m: {k: v for k, v in d.items() if k != "folds"}
                     for m, d in summary["modes"].items()}
    slim["members"] = {m: {k: v for k, v in d.items() if k != "folds"}
                       for m, d in summary["members"].items()}
    print(json.dumps(slim, indent=2))
    if args.summary_row:
        merge_summary_row(Path(args.summary_row), summary, args.members)
    return summary


def merge_summary_row(path: Path, summary: Dict[str, Any],
                      members: Sequence[str]) -> None:
    """Merge a "cnn_ensemble" row (the weighted-average mode) into an
    all_models_summary.json, beside the trained zoo models."""
    zoo = json.loads(path.read_text()) if path.exists() else {}
    accs = [f["accuracy"] for f in summary["folds"].values()]
    # a single-class test fold has a NaN AUC, which JSON cannot hold
    aucs = [f["auc"] for f in summary["folds"].values()
            if np.isfinite(f["auc"])]
    zoo["cnn_ensemble"] = {
        "avg_accuracy": float(np.mean(accs)),
        "std_accuracy": float(np.std(accs)),
        "avg_test_auc": float(np.mean(aucs)) if aucs else None,
        "num_successful_folds": len(accs),
        "hparams": {
            # the normalised weights applied, not the raw CLI values
            "members": list(members), "weights": summary["weights"],
            "mode": "weighted_average",
            "provenance": "ensemble k-fold evaluation of exported fold "
                          "checkpoints (not trained) — see "
                          "ensemble_eval.json for all modes",
        },
        "per_fold": [
            {"fold": k, "test_acc": f["accuracy"], "test_auc": f["auc"]}
            for k, f in summary["folds"].items()],
    }
    path.write_text(json.dumps(zoo, indent=2, default=str))
    print(f"merged cnn_ensemble row into {path}")


def cmd_quality_report(args) -> Dict[str, Any]:
    from ..data.quality_report import generate_quality_report

    cfg = {"data_path": args.data_path, "split_dir": args.split_dir,
           "val_split_ratio": 0.15, "test_split_ratio": 0.15,
           "random_seed": 42}
    report = generate_quality_report(cfg, args.output, device=args.device)
    print("summary:", report["summary"])
    return report


def _common(p: argparse.ArgumentParser, dataset: bool = True) -> None:
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    if dataset:
        p.add_argument("--dataset", default="synthetic")
        p.add_argument("--override", action="append", default=[],
                       metavar="KEY=VALUE",
                       help="a config override after dataset=, repeatable")
        p.add_argument("--demo-corpus", action="store_true",
                       help="not ported: the zoo demo's corpus")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m thyroid_tpu_torch.analysis.cli")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("gradcam", help="Grad-CAM figures of one checkpoint")
    g.add_argument("--model", required=True)
    g.add_argument("--checkpoint", required=True)
    g.add_argument("--split", default="test")
    g.add_argument("--batch", type=int, default=16)
    g.add_argument("--img-size", type=int, default=224)
    g.add_argument("--n-samples", type=int, default=4)
    g.add_argument("--output-dir", default="outputs/gradcam")
    _common(g)
    g.set_defaults(run=cmd_gradcam)

    a = sub.add_parser("attention", help="attention maps, rollout, patch "
                       "importance (Swin: stage activity maps)")
    a.add_argument("--model", required=True)
    a.add_argument("--checkpoint", required=True)
    a.add_argument("--batch", type=int, default=16)
    a.add_argument("--img-size", type=int, default=224)
    a.add_argument("--output-dir", default="outputs/attention")
    _common(a)
    a.set_defaults(run=cmd_attention)

    c = sub.add_parser("confusion-roc", help="confusion matrices and ROC "
                       "curves of best checkpoints")
    c.add_argument("--models", nargs="+", required=True,
                   help="name=checkpoint pairs, e.g. resnet50=outputs/.../best.ckpt")
    c.add_argument("--batch", type=int, default=64)
    c.add_argument("--img-size", type=int, default=224)
    c.add_argument("--tta", action="store_true")
    c.add_argument("--output-dir", default="outputs/confusion_roc")
    _common(c)
    c.set_defaults(run=cmd_confusion_roc)

    e = sub.add_parser("ensemble-kfold", help="k-fold weighted-probability "
                       "ensemble evaluation")
    e.add_argument("--members", nargs="+",
                   default=["densenet169", "vit_small", "vit_tiny"])
    e.add_argument("--weights", nargs="+", type=float, default=[0.5, 0.25, 0.25])
    e.add_argument("--checkpoint-root", default="outputs")
    e.add_argument("--folds", type=int, default=7)
    e.add_argument("--batch", type=int, default=64)
    e.add_argument("--img-size", type=int, default=224)
    e.add_argument("--output", default="outputs/ensemble_kfold_results.json")
    e.add_argument("--summary-row", default=None,
                   help="also merge a 'cnn_ensemble' row (weighted-average "
                        "mode) into this all_models_summary.json")
    _common(e)
    e.set_defaults(run=cmd_ensemble_kfold)

    q = sub.add_parser("quality-report", help="reports/quality_report.json")
    q.add_argument("--data-path", default="data/raw")
    q.add_argument("--split-dir", default="data/splits")
    q.add_argument("--output", default="reports/quality_report.json")
    _common(q, dataset=False)
    q.set_defaults(run=cmd_quality_report)
    return p


def main(argv: Optional[Sequence[str]] = None):
    """Run one subcommand; → what it computed."""
    args = parser().parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    main(sys.argv[1:])
