"""Deterministic synthetic CARS-thyroid-like frames (counterpart of
thyroid_tpu/data/synthetic.py, numpy only).

A copy of the JAX package's generator, kept here because the port imports
nothing of that package; `tests/test_torch_quality.py` holds the two
bit-equal. Frames are 512×512 single-channel uint16 by default, with the
corpus's quality mix: 5.8% extreme-dark (mean < 150), 9.1% low-contrast
(std < 80, mean > 150), 14.2% bright speckle artifacts (max/mean > 30),
the rest clean. `generate_corpus` writes a corpus of 16-bit PNGs through
the port's own PNG writer (data/imageio.py): its bytes are not cv2's, its
pixels are.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Tuple

import numpy as np

from .imageio import encode_png

QUALITY_MIX = {"extreme_dark": 0.058, "low_contrast": 0.091, "artifacts": 0.142}


def _texture(rng: np.random.Generator, size: int, label: int,
             difficulty: float = 0.0) -> np.ndarray:
    """Band-limited random texture in [0, 1]; cancerous tissue gets finer,
    higher-frequency structure and brighter foci. `difficulty` in [0, 1]
    pulls the two classes' distributions toward each other."""
    coarse = rng.random((size // 16, size // 16))
    fine = rng.random((size // 4, size // 4))
    coarse = np.kron(coarse, np.ones((16, 16)))
    fine = np.kron(fine, np.ones((4, 4)))
    noise = rng.random((size, size)) * 0.15
    d = float(np.clip(difficulty, 0.0, 1.0))
    if label == 0:  # normal: smooth follicular pattern
        w_fine = 0.2 + d * rng.uniform(0.0, 0.35)
        n_foci = int(round(d * rng.uniform(0.0, 8.0)))
    else:  # cancerous: disordered fine structure
        w_fine = 0.55 - d * rng.uniform(0.0, 0.35)
        n_foci = 12 - int(round(d * rng.uniform(0.0, 8.0)))
    img = (0.85 - w_fine) * coarse + w_fine * fine + noise
    for _ in range(n_foci):
        cy, cx = rng.integers(8, size - 8, 2)
        img[cy - 3:cy + 3, cx - 3:cx + 3] += 0.4
    return np.clip(img, 0.0, 1.0)


def generate_image(seed: int, label: int, size: int = 512,
                   difficulty: float = 0.0,
                   label_noise: float = 0.0) -> np.ndarray:
    """One deterministic (size, size) uint16 frame whose quality issue
    (extreme-dark, low-contrast, artifacts or none) is drawn from the
    seed with the corpus's mix. `label_noise` is the probability that the
    frame is drawn from the other class's texture under its nominal
    label."""
    rng = np.random.default_rng(seed)
    if label_noise > 0.0 and rng.random() < label_noise:
        label = 1 - label
    img = _texture(rng, size, label, difficulty)

    u = rng.random()
    dark_p = QUALITY_MIX["extreme_dark"]
    lc_p = QUALITY_MIX["low_contrast"]
    art_p = QUALITY_MIX["artifacts"]
    if u < dark_p:
        img = img * (100.0 / 65535.0)          # mean < 150
    elif u < dark_p + lc_p:
        img = 0.0045 + img * (250.0 / 65535.0)  # std < 80, mean > 150
    elif u < dark_p + lc_p + art_p:
        img = img * 0.03                        # bright speckle spikes
        n_spikes = rng.integers(5, 20)
        ys = rng.integers(0, size, n_spikes)
        xs = rng.integers(0, size, n_spikes)
        img[ys, xs] = 1.0
    else:
        img = 0.02 + img * 0.55
    return (np.clip(img, 0.0, 1.0) * 65535.0).astype(np.uint16)


def generate_corpus(
    out_dir: str | Path,
    n_images: int = 450,
    size: int = 512,
    seed: int = 42,
    difficulty: float = 0.0,
    label_noise: float = 0.0,
) -> Tuple[int, int]:
    """Write the corpus as 16-bit PNGs under out_dir/{normal,cancerous}
    (`<class>_<i:04d>.png`; the extra frame of an odd count is class 0).

    Idempotent for matching parameters (files that exist are kept); the
    parameters are stamped in ``out_dir/_meta.json``, and a corpus made
    with other parameters is wiped and made anew, so a config change is
    never silently ignored. Returns (n_normal, n_cancer)."""
    out_dir = Path(out_dir)
    params = {"n_images": n_images, "size": size, "seed": seed,
              "difficulty": difficulty, "label_noise": label_noise}
    meta_path = out_dir / "_meta.json"
    if out_dir.exists():
        stale = True
        if meta_path.exists():
            try:
                stale = json.loads(meta_path.read_text()) != params
            except (ValueError, OSError):
                stale = True
        if stale and any((out_dir / c).exists() for c in ("normal", "cancerous")):
            for c in ("normal", "cancerous"):
                shutil.rmtree(out_dir / c, ignore_errors=True)
    n_per_class = n_images // 2
    counts = []
    for class_idx, class_name in enumerate(("normal", "cancerous")):
        d = out_dir / class_name
        d.mkdir(parents=True, exist_ok=True)
        count = n_per_class + (n_images % 2 if class_idx == 0 else 0)
        for i in range(count):
            path = d / f"{class_name}_{i:04d}.png"
            if path.exists():
                continue
            img = generate_image(seed * 1_000_003 + class_idx * 100_000 + i,
                                 class_idx, size, difficulty, label_noise)
            path.write_bytes(encode_png(img))
        counts.append(count)
    meta_path.write_text(json.dumps(params))
    return counts[0], counts[1]


def generate_corpus_arrays(
    n_images: int = 64,
    size: int = 128,
    seed: int = 42,
    difficulty: float = 0.0,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory corpus: (N, size, size, 1) uint16 frames and (N,) int32
    labels, half of each class (the extra frame of an odd N is class 0)."""
    n_per_class = n_images // 2
    imgs, labels = [], []
    for class_idx in range(2):
        count = n_per_class + (n_images % 2 if class_idx == 0 else 0)
        for i in range(count):
            imgs.append(generate_image(seed * 1_000_003 + class_idx * 100_000 + i,
                                       class_idx, size, difficulty, label_noise))
            labels.append(class_idx)
    return np.stack(imgs)[..., None], np.asarray(labels, dtype=np.int32)
