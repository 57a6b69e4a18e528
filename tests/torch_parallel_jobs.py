"""The multi-rank side of tests/test_torch_parallel.py: `mesh_ranks`, which
`thyroid_tpu_torch.parallel.spawn` runs in every rank of a 4-rank gloo
world on the CPU, and the runs it is held against, which the test makes
in one process with the same functions. Imports only torch, numpy and the
port (never JAX, never a test module), so that a rank starts quickly.

Every rank runs the same jobs in order, on the whole world ({"data": 4},
{"data": 2, "model": 2}, {"slice": 2, "data": 2}) or on its half (a
{"rep": 2, "data": 2} mesh, each half a {"data": 2} line running its own
job), and returns {job: result}; parameters come back from rank 0 and
rank 2 only.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from thyroid_tpu_torch.data.pipeline import DevicePipeline
from thyroid_tpu_torch.data.synthetic import generate_corpus_arrays
from thyroid_tpu_torch.models.from_jax import jax_tree
from thyroid_tpu_torch.models.layers import BatchNorm
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.training.checkpoint import make_teacher_fn
from thyroid_tpu_torch.training.engine import Trainer
from thyroid_tpu_torch.training.stacked import StackedKFoldTrainer

RESNET18 = {"name": "resnet18", "img_size": 32, "in_channels": 1,
            "num_classes": 2}
NARROW = {"name": "resnet18", "block": "basic", "layers": (1, 1, 1, 1),
          "width": 8, "img_size": 32, "in_channels": 1, "num_classes": 2,
          "dtype": "f32", "dropout_rate": 0.0}
STUDENT = {"name": "deit_tiny", "img_size": 32, "in_channels": 1,
           "num_classes": 2, "dtype": "f32",
           "params": {"patch_size": 16, "depth": 2, "drop_path_rate": 0.2}}
DISTILLATION = {"temperature": 4.0, "alpha": 0.5, "distillation_type": "soft"}
BATCH = 16
CLIP = 1e-3          # below every gradient norm here: the clip always acts
SGD_LR = 0.1         # the JAX comparison's step: update = -lr · gradient
# resnet18's runs take SGD with momentum, whose update is linear in the
# gradient (and cheaper at lr 0). AdamW's first update is ±lr wherever
# |g| ≫ its eps 1e-8, and lr·g/(|g| + eps) where a gradient cancels to
# ~1e-8, so a rounding of such an element's sum moves its update by up to
# ~0.7·lr (layer1_0/ConvBN_0/Conv_0/kernel here: 7e-4 after one step).


def corpus(n: int = 32, seed: int = 42):
    """JAX's data-parallel test corpus: n synthetic 64² frames, shuffled
    by RandomState(1)."""
    imgs, labels = generate_corpus_arrays(n_images=n, size=64, seed=seed)
    order = np.random.RandomState(1).permutation(n)
    return imgs[order], labels[order]


def pipelines(n_train: int = 32, n_val: Optional[int] = None, seed: int = 42,
              level: str = "none"):
    imgs, labels = corpus(n_train, seed)
    tr = DevicePipeline(imgs, labels, batch_size=BATCH, img_size=32, train=True,
                        augmentation_level=level, device="cpu")
    if n_val is not None:
        imgs, labels = imgs[:n_val], labels[:n_val]
    va = DevicePipeline(imgs, labels, batch_size=BATCH, img_size=32,
                        train=False, device="cpu")
    return tr, va


def trainer(out: Path, model=RESNET18, lr: float = 0.0, epochs: int = 1,
            mesh=None, optimizer: str = "adamw", trainer_extra: Optional[Dict[str, Any]] = None,
            training_extra: Optional[Dict[str, Any]] = None, **kw) -> Trainer:
    cfg = {"max_epochs": epochs, "enable_checkpointing": False,
           "precision": "f32", **(trainer_extra or {})}
    training = {"epochs": epochs, "batch_size": BATCH,
                "optimizer_params": {"name": optimizer, "lr": lr},
                "scheduler_params": None,
                "monitor_metric": "val_acc", "monitor_mode": "max",
                "early_stopping_patience": 50, **(training_extra or {})}
    return Trainer(ModelRegistry.create_model(model), model, training, cfg,
                   steps_per_epoch=2, output_dir=out, mesh=mesh,
                   device="cpu", **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy().copy()     # not the live tensor
    return out


def state_arrays(t: Trainer) -> Dict[str, np.ndarray]:
    """The parameters and running statistics by JAX path."""
    out = {}
    for col, named in (("params", t.state.params),
                       ("batch_stats", t.state.batch_stats)):
        out.update({f"{col}/{k}": v for k, v in
                    _flat(jax_tree(named, t.state.layout)).items()})
    return out


def moments(t: Trainer) -> Dict[str, np.ndarray]:
    sd = t.state.opt_state.state_dict()
    return {f"{slot}/{n}": v.numpy().copy() for slot in ("mu", "nu")
            for n, v in sd[slot].items()}


def fit_run(out: Path, mesh=None, local_stats: bool = False,
            arrays: bool = False, data: Optional[dict] = None,
            **kw) -> Dict[str, Any]:
    """Trainer.fit of `kw` on `data` (pipelines' arguments) → the last
    epoch's losses and accuracy [and the state]. With `local_stats` every
    BatchNorm normalises with its rank's statistics (what a data-parallel
    step without the global reduction computes)."""
    t = trainer(out, mesh=mesh, **kw)
    if local_stats:
        for m in t.model.modules():
            if isinstance(m, BatchNorm):
                m.group = None
    res = t.fit(*pipelines(**(data or {})))
    got = {k: float(res.history[-1][k]) for k in
           ("train_loss", "val_loss", "val_acc", "val_auc")}
    got["best"] = None if res.best_checkpoint is None else str(res.best_checkpoint)
    got["stopped"] = res.stopped_epoch
    if arrays:
        got["state"] = state_arrays(t)
        got["stats"] = {k: v for k, v in got["state"].items()
                        if k.startswith("batch_stats/")}
    return got


def fsdp_run(out: Path, mesh, resume: Path, save: Optional[Path] = None):
    """Two clipped AdamW steps of the narrow ResNet from the one-device
    checkpoint `resume`, on `mesh` (FSDP over "model" where it has one),
    [written to `save`] → loss, state and moments (whole: FSDP's blocks
    gathered)."""
    t = trainer(out, model=NARROW, lr=1e-3, mesh=mesh,
                trainer_extra={"model_axis": "model", "gradient_clip_val": CLIP})
    t.resume_from(resume)
    res = t.fit(*pipelines())
    sd = t.state.opt_state.state_dict()
    if t.sync is not None and t.sync.fsdp:
        sd = t.sync.full_state(sd, t.state.params)
    got = {"train_loss": float(res.history[-1]["train_loss"]),
           "state": state_arrays(t),
           "moments": {f"{slot}/{n}": v.numpy().copy() for slot in ("mu", "nu")
                       for n, v in sd[slot].items()},
           "blocks": {n: d for n, d in (t.sync.dims if t.sync else {}).items()
                      if d is not None}}
    if save is not None:
        t.save_state(save)
    return got


def distill_run(out: Path, mesh=None) -> Dict[str, Any]:
    """Two distillation steps of a narrow DeiT (DropPath on) under the
    seeded narrow ResNet as a frozen teacher."""
    teacher = ModelRegistry.create_model(NARROW)
    teacher.init_weights(torch.Generator().manual_seed(7))
    t = trainer(out, model=STUDENT, lr=1e-3, mesh=mesh,
                teacher_fn=make_teacher_fn(teacher),
                distillation_config=DISTILLATION)
    res = t.fit(*pipelines())
    return {k: float(res.history[-1][k]) for k in
            ("train_loss", "train_distillation_loss", "train_teacher_agreement",
             "val_loss", "val_acc")}


def draws_run(out: Path, mesh=None) -> Dict[str, Any]:
    """What every rank must draw as one process does: the medium
    augmentation, MixUp/CutMix, dropout, under gradient accumulation (two
    mini-steps to an update) and a checkpoint each epoch; the val split
    ends in a half-padded batch (24 frames at 16)."""
    model = dict(NARROW, dropout_rate=0.3)
    t = trainer(out, model=model, lr=1e-3, epochs=2, mesh=mesh,
                trainer_extra={"accumulate_grad_batches": 2,
                               "enable_checkpointing": True, "save_top_k": 1},
                training_extra={"mixup_alpha": 0.8, "cutmix_alpha": 1.0})
    res = t.fit(*pipelines(n_val=24, level="medium"))
    got = {k: float(res.history[-1][k]) for k in
           ("train_loss", "val_loss", "val_acc", "val_auc")}
    got["best"] = str(res.best_checkpoint)
    got["state"] = state_arrays(t)
    return got


def jax_batch():
    """The JAX comparison's batch: 16 seeded 32² frames."""
    rs = np.random.RandomState(10)
    x = rs.randn(BATCH, 32, 32, 1).astype(np.float32)
    y = (np.arange(BATCH) % 2).astype(np.int64)
    return x, y, np.ones(BATCH, np.float32)


def jax_step_run(out: Path, mesh=None) -> Dict[str, Any]:
    """One SGD step (no clip) of the seeded narrow ResNet on jax_batch →
    loss, state before and after."""
    t = trainer(out, model=NARROW, lr=SGD_LR, mesh=mesh, optimizer="sgd",
                trainer_extra={"gradient_clip_val": None})
    before = state_arrays(t)
    x, y, w = (torch.from_numpy(a) for a in jax_batch())
    if mesh is not None:
        x, y, w = (t.batch_sharding.take(a) for a in (x, y, w))
    from thyroid_tpu_torch.training.metrics import zero_metric_state

    mstate, score = t.train_step(zero_metric_state(), x, y, w)
    loss = t._finalize(mstate, [score], [y], [w], "train_")["train_loss"]
    return {"loss": loss, "before": before, "state": state_arrays(t)}


def stacked_data(n_folds: int = 2):
    """n folds of 32 training and 16 val/test frames, each its own corpus
    seed."""
    folds = []
    for f in range(n_folds):
        tr, va = pipelines(32, n_val=16, seed=100 + f)
        folds.append((tr, va))
    return folds


def stacked_run(out: Path, mesh=None) -> List[Dict[str, Any]]:
    """The stacked k-fold trainer, narrow ResNet, 2 folds, 2 epochs → each
    fold's row (no history)."""
    folds = stacked_data()
    st = StackedKFoldTrainer(
        NARROW, {"epochs": 2, "batch_size": BATCH, "optimizer_params": {"lr": 1e-3},
                 "scheduler_params": None, "monitor_metric": "val_acc",
                 "monitor_mode": "max", "early_stopping_patience": 50},
        {"max_epochs": 2, "precision": "f32"}, [f[0] for f in folds],
        [f[1] for f in folds], [f[1] for f in folds], output_dir=out,
        mesh=mesh, device="cpu")
    rows = st.fit()
    paths = st.export_fold_checkpoints(out / "export", "narrow")
    return [{**{k: v for k, v in r.items() if k != "history"},
             "exported": p.exists(), "folds": st.folds} for r, p in zip(rows, paths)]


def mesh_ranks(root: str) -> Dict[str, Any]:
    """Every multi-rank job (see the module docstring)."""
    from thyroid_tpu_torch.parallel import create_mesh

    root = Path(root)
    rank = torch.distributed.get_rank()
    world = create_mesh({"data": 4})
    halves = create_mesh({"rep": 2, "data": 2})
    half, pair = halves.index("rep"), halves.submesh(("data",))
    out: Dict[str, Any] = {"rank": rank}

    def keep(name, value):
        if rank not in (0, 2) and isinstance(value, dict):
            value = {k: v for k, v in value.items()
                     if k not in ("state", "before", "moments")}
        out[name] = value

    def run(name, fn, *args, **kw):
        keep(name, fn(root / f"{name}_{rank}", *args, **kw))

    run("dp4_lr0", fit_run, mesh=world, data={"n_train": 16},
        optimizer="sgd")
    if half == 0:
        run("dp2_lr0", fit_run, mesh=pair, data={"n_train": 16},
            optimizer="sgd")
        run("dp2_lr", fit_run, mesh=pair, lr=1e-3, arrays=True,
            optimizer="sgd")
    else:
        run("dp2_lr0_local", fit_run, mesh=pair, local_stats=True,
            data={"n_train": 16}, optimizer="sgd")
        run("distill", distill_run, mesh=pair)
        run("jax_step", jax_step_run, mesh=pair)
        run("draws", draws_run, mesh=pair)
    run("fsdp", fsdp_run, create_mesh({"data": 2, "model": 2}),
        root / "one.ckpt", save=root / "fsdp.ckpt")
    run("fsdp_replicated", fsdp_run, world, root / "one.ckpt")
    out["stacked"] = stacked_run(root / "stacked",
                                 create_mesh({"slice": 2, "data": 2}))
    return out


def launch_main(out: str, *overrides: str) -> None:
    """`torchrun ... tests/torch_parallel_jobs.py <out> <override>...`:
    launch_experiment on the CPU, one torch thread a rank → out/rank<R>.json,
    this rank's fold rows (wall time and checkpoint paths aside)."""
    import json
    import os

    from thyroid_tpu_torch.experiment import launch_experiment

    torch.set_num_threads(1)
    summary = launch_experiment(list(overrides), device="cpu")
    rows = [{k: v for k, v in r.items()
             if k not in ("train_time_s", "best_checkpoint")}
            for r in summary["raw_fold_results"]]
    Path(out, f"rank{os.environ['RANK']}.json").write_text(
        json.dumps(rows, sort_keys=True, default=str))


if __name__ == "__main__":
    import sys

    launch_main(*sys.argv[1:])
