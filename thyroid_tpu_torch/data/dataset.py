"""CARS thyroid dataset: corpus indexing and bulk decode (counterpart of
thyroid_tpu/data/dataset.py).

The host decodes a split once into one (N, H, W, 1) uint16 array;
resizing, quality preprocessing and normalisation run batched on the
device (data/pipeline.py). Decoding is the port's own (data/imageio.py):
PNG and TIFF, uint8 sources × 257, color to gray, pixel-equal to the JAX
package's cv2 chain. `load_images` runs it on a thread pool; zlib, which
does most of the work, releases the GIL.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from ..utils.logging import get_logger
from .corpus import CLASS_NAMES, resolve_split, scan_corpus
from .imageio import decode_image

__all__ = ["CARSThyroidDataset", "decode_image"]

logger = get_logger(__name__)


class CARSThyroidDataset:
    """Indexed view over one split of the corpus ("all" for every frame).

    Config fields read (the dataset group's YAML keys): data_path,
    split_dir, split_file, fold, split_file_prefix, val/test_split_ratio,
    random_seed, synthetic, synthetic_size, synthetic_difficulty,
    synthetic_label_noise.
    """

    def __init__(self, config: Any, split: str = "train", transform=None):
        self.config = config
        self.split = split
        self.transform = transform

        data_path = Path(self._get("data_path"))
        if self._get("synthetic", False):
            from .synthetic import generate_corpus

            n = int(self._get("synthetic_size", 450))
            diff = float(self._get("synthetic_difficulty", 0.0))
            noise = float(self._get("synthetic_label_noise", 0.0))
            # idempotent: regenerates only when the stamped parameters
            # differ; under torchrun rank 0 writes it, the others wait
            from ..parallel.mesh import barrier, is_lead_process

            if is_lead_process():
                if not (data_path / "normal").exists():
                    logger.info("generating synthetic corpus (%d images, "
                                "difficulty %.2f, label noise %.2f) at %s",
                                n, diff, noise, data_path)
                generate_corpus(data_path, n_images=n, difficulty=diff,
                                label_noise=noise)
            barrier()

        self.all_paths, self.all_labels, self.patient_ids = scan_corpus(data_path)
        if len(self.all_paths) == 0:
            raise FileNotFoundError(
                f"no images under {data_path}/(normal|cancerous) — check data_path")

        if split == "all":
            idx = np.arange(len(self.all_paths))
        else:
            splits = resolve_split(
                self.all_labels,
                split_dir=self._get("split_dir", "data/splits"),
                split_file=self._get("split_file", None),
                fold=self._get("fold", None),
                prefix=self._get("split_file_prefix", "split_fold_"),
                val_split_ratio=self._get("val_split_ratio", 0.15),
                test_split_ratio=self._get("test_split_ratio", 0.15) or 0.15,
                random_seed=self._get("random_seed", 42),
            )
            if split not in splits:
                raise KeyError(f"split '{split}' not in split file (has {list(splits)})")
            idx = np.asarray(splits[split], dtype=np.int64)

        self.indices = idx
        self.labels = self.all_labels[idx]
        self.paths: List[Path] = [self.all_paths[i] for i in idx]

    def _get(self, key: str, default: Any = ...) -> Any:
        cfg = self.config
        if hasattr(cfg, key):
            return getattr(cfg, key)
        if isinstance(cfg, dict) and key in cfg:
            return cfg[key]
        if default is ...:
            raise KeyError(key)
        return default

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> tuple[np.ndarray, int]:
        img = decode_image(self.paths[i])[..., None]
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[i])

    def load_images(self, num_threads: int = 8) -> np.ndarray:
        """Decode the whole split → (N, H, W, 1) uint16 (frames of one
        shape)."""
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            imgs = list(pool.map(decode_image, self.paths))
        return np.stack(imgs)[..., None]

    def class_distribution(self) -> Dict[str, int]:
        return {CLASS_NAMES[c]: int((self.labels == c).sum()) for c in (0, 1)}
