"""PyTorch + CUDA port of thyroid_tpu for one NVIDIA H100.

The JAX package `thyroid_tpu` is the reference this package is held
against; nothing here imports it (or JAX). Public functions keep the JAX
layouts (NHWC images, (B, H, W, 3, C) qkv, (in, out) weight matrices) so
the two can be compared like with like.

Slice 1 serves swin_tiny from raw 512² frames: preprocess → 12 Swin
blocks → softmax, through four hand-written CUDA kernels
(`thyroid_tpu_torch/csrc/`). Slice 2 trains it (two attention kernels);
slice 3 adds the quality-aware preprocessing to both paths (four kernels:
statistics, median + bilateral stencil, CLAHE apply single and dual).
The k-fold experiment runs from a corpus on disk: config composition
(`config/`), corpus splits and PNG/TIFF decoding (`data/`), `experiment/`
(`python -m thyroid_tpu_torch.experiment.manager ...`).
"""

__version__ = "0.1.0"
