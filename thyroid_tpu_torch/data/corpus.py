"""Corpus scanning and split generation (counterpart of
thyroid_tpu/data/corpus.py, the same functions and files).

- the scan of data_path/{normal,cancerous} for tif/tiff/png/jpg/jpeg, each
  extension's matches sorted, which fixes the index order the split files
  refer to;
- a stratified, seeded train/val/test split (test carved first, then val
  as a fraction of the rest);
- rotating k-fold files: test = fold i, val = fold (i+1) % k, train = the
  rest; at k = 2 the non-test fold is split 75/25 into train and val;
- split JSON {"train": [...], "val": [...], "test": [...]} of indices, and
  split_info.json with metadata.

The indices are scikit-learn's, drawn by data/stratify.py (numpy only), so
the files equal the JAX package's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .stratify import stratified_kfold_test_folds, train_test_split

CLASS_NAMES = ("normal", "cancerous")
SUPPORTED_FORMATS = ("*.tif", "*.tiff", "*.png", "*.jpg", "*.jpeg")


def scan_corpus(data_path: str | Path) -> Tuple[List[Path], np.ndarray, List[str]]:
    """Scan class dirs → (paths, labels, patient_ids) in the canonical order."""
    root = Path(data_path)
    paths: List[Path] = []
    labels: List[int] = []
    patient_ids: List[str] = []
    for class_idx, class_name in enumerate(CLASS_NAMES):
        class_dir = root / class_name
        if not class_dir.exists():
            continue
        class_images = [p for fmt in SUPPORTED_FORMATS for p in sorted(class_dir.glob(fmt))]
        for p in class_images:
            paths.append(p)
            labels.append(class_idx)
            stem = p.stem
            if "_" in stem and stem.split("_")[-1].isdigit():
                patient_ids.append(f"{class_name}_{stem.split('_')[-1]}")
            else:
                patient_ids.append(stem)
    return paths, np.asarray(labels, dtype=np.int32), patient_ids


def generate_splits(
    labels: np.ndarray,
    val_split_ratio: float = 0.15,
    test_split_ratio: float = 0.15,
    random_seed: int = 42,
) -> Dict[str, np.ndarray]:
    """Stratified train/val/test index split: test carved first, then val
    as a fraction of the remainder."""
    indices = np.arange(len(labels))
    if len(indices) == 0:
        return {k: np.array([], dtype=np.int64) for k in ("train", "val", "test")}
    test_ratio = test_split_ratio if test_split_ratio and 0 < test_split_ratio < 1 else 0.15
    val_ratio = val_split_ratio if 0 < val_split_ratio < 1 else 0.2
    stratify = labels if len(np.unique(labels)) > 1 else None
    train_val, test = train_test_split(
        indices, test_size=test_ratio, stratify=stratify, random_state=random_seed
    )
    stratify_tv = labels[train_val] if stratify is not None else None
    if stratify_tv is not None and len(np.unique(stratify_tv)) < 2:
        stratify_tv = None
    train, val = train_test_split(
        train_val, test_size=val_ratio, stratify=stratify_tv, random_state=random_seed
    )
    return {"train": train, "val": val, "test": test}


def rotating_fold_indices(
    labels: np.ndarray,
    k: int,
    seed: int = 42,
    stratified: bool = True,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """In-memory rotating folds → [(train, val, test)] per fold: test=fold i,
    val=fold (i+1)%k, train=rest.

    stratified=True chunks per class (StratifiedKFold's draws, as the
    split-file generator makes them); stratified=False is the plain
    permute-and-chunk that older exported artifacts recorded."""
    labels = np.asarray(labels)
    n = len(labels)
    if stratified and len(np.unique(labels)) > 1:
        chunks = stratified_kfold_test_folds(labels, k, seed)
    else:
        order = np.random.RandomState(seed).permutation(n)
        chunks = np.array_split(order, k)
    folds = []
    for i in range(k):
        test = chunks[i]
        val = chunks[(i + 1) % k]
        train = np.concatenate([chunks[j] for j in range(k)
                                if j not in (i, (i + 1) % k)])
        folds.append((train, val, test))
    return folds


def generate_kfold_splits(
    labels: np.ndarray,
    k: int,
    split_dir: str | Path,
    random_seed: int = 42,
    prefix: str = "split_fold_",
) -> List[Path]:
    """Rotating k-fold split files. Fold file i (1-based): test=fold i,
    val=fold (i+1)%k, train=the rest (k = 2: see below)."""
    split_dir = Path(split_dir)
    split_dir.mkdir(parents=True, exist_ok=True)
    if k == 1:
        # single-"fold" smoke runs: just a standard stratified split
        splits = generate_splits(labels, random_seed=random_seed)
        path = split_dir / f"{prefix}1.json"
        with open(path, "w") as f:
            json.dump({s: splits[s].tolist() for s in ("train", "val", "test")},
                      f, indent=2)
        return [path]
    fold_indices = stratified_kfold_test_folds(labels, k, random_seed)
    written = []
    for i in range(k):
        test_idx = fold_indices[i]
        if k >= 3:
            val_idx = fold_indices[(i + 1) % k]
            train_idx = np.concatenate(
                [fold_indices[j] for j in range(k) if j != i and j != (i + 1) % k]
            )
        else:
            # k=2 degenerates under the rotation (empty train); split the
            # non-test fold 75/25 into train/val instead. StratifiedKFold
            # emits ascending indices, class-ordered here, so shuffle
            # before slicing or the val split would be single-class.
            rng = np.random.RandomState(random_seed + i)
            other = rng.permutation(fold_indices[(i + 1) % k])
            n_val = max(1, len(other) // 4)
            val_idx = np.sort(other[:n_val])
            train_idx = np.sort(other[n_val:])
        path = split_dir / f"{prefix}{i + 1}.json"
        with open(path, "w") as f:
            json.dump(
                {
                    "train": train_idx.tolist(),
                    "val": val_idx.tolist(),
                    "test": test_idx.tolist(),
                },
                f,
                indent=2,
            )
        written.append(path)
    return written


def load_split_file(path: str | Path) -> Dict[str, np.ndarray]:
    with open(path) as f:
        data = json.load(f)
    return {k: np.asarray(v, dtype=np.int64) for k, v in data.items()
            if isinstance(v, list)}


def save_split_info(
    splits: Dict[str, np.ndarray],
    path: str | Path,
    total_images: int,
) -> None:
    """split_info.json: the splits and their ratios (the schema of
    data/splits/split_info.json)."""
    n = max(total_images, 1)
    payload = {k: np.asarray(v).tolist() for k, v in splits.items()}
    payload["metadata"] = {
        "total_images": total_images,
        "patient_level_split": False,
        "split_ratios": {k: len(v) / n for k, v in splits.items()},
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def resolve_split(
    labels: np.ndarray,
    split_dir: str | Path,
    split_file: str | Path | None = None,
    fold: int | None = None,
    prefix: str = "split_fold_",
    val_split_ratio: float = 0.15,
    test_split_ratio: float = 0.15,
    random_seed: int = 42,
) -> Dict[str, np.ndarray]:
    """Three resolution paths: explicit split_file → k-fold file by number
    → standard split (loaded from split_info.json, or generated and
    saved there)."""
    split_dir = Path(split_dir)
    if split_file is not None:
        return load_split_file(split_file)
    if fold is not None:
        return load_split_file(split_dir / f"{prefix}{fold}.json")
    info_path = split_dir / "split_info.json"
    if info_path.exists():
        return load_split_file(info_path)
    splits = generate_splits(labels, val_split_ratio, test_split_ratio, random_seed)
    save_split_info(splits, info_path, len(labels))
    return splits
