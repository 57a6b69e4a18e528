"""Fused 3×3 median + bilateral artifact stencil (counterpart of
thyroid_tpu/ops/stencil.py).

`fused_median_bilateral` calls the op `thyroid_tpu_torch::median_bilateral`,
which launches the CUDA kernel `csrc/stencil.cu` on a CUDA tensor and runs
its plain PyTorch version, `median_bilateral_plain`
(ops/image.py `median_filter_3x3`, then `bilateral_filter` of the median),
on a CPU tensor. The median pads its input by edge replication, the
bilateral pads the median by reflect-101; the kernel follows the plain
version's tap order and float32 rounding (see its source note).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .image import bilateral_filter, bilateral_taps, median_filter_3x3

MAX_TAPS = 64                       # room in the kernel's weight table
RADII = (1, 2, 3)                   # d = 3, 5, 7: the kernel's instantiations


def median_bilateral_plain(x8: torch.Tensor, d: int = 5,
                           sigma_color: float = 50.0,
                           sigma_space: float = 50.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (median, bilateral of the median), both like x8."""
    med = median_filter_3x3(x8)
    return med, bilateral_filter(med, d=d, sigma_color=sigma_color,
                                 sigma_space=sigma_space)


class _Taps(ctypes.Structure):
    _fields_ = [("sw", ctypes.c_float * MAX_TAPS)]


def _check_stencil(x8: torch.Tensor, d: int) -> None:
    if x8.dtype != torch.float32:
        raise TypeError(f"fused_median_bilateral takes float32, got {x8.dtype}")
    if x8.dim() != 4 or x8.shape[-1] != 1:
        raise ValueError(f"fused_median_bilateral takes (B, H, W, 1), got "
                         f"{tuple(x8.shape)}")
    if not x8.is_contiguous():
        raise ValueError("fused_median_bilateral needs a contiguous tensor")
    r = d // 2
    if d % 2 == 0 or r not in RADII:
        raise ValueError(f"the stencil kernel takes d in (3, 5, 7), got {d}")
    h, w = x8.shape[1], x8.shape[2]
    if h <= r or w <= r:
        raise ValueError(f"frame {h}x{w} too small for a reflect-101 pad "
                         f"of {r}")


def _stencil_cpu(x8, d, sigma_color, sigma_space):
    med, bil = median_bilateral_plain(x8, d, sigma_color, sigma_space)
    return med.contiguous(), bil.contiguous()


def _stencil_fake(x8, d, sigma_color, sigma_space):
    _check_stencil(x8, d)
    return torch.empty_like(x8), torch.empty_like(x8)


def _stencil_cuda(x8, d, sigma_color, sigma_space):
    _check_stencil(x8, d)
    b, h, w, _ = x8.shape
    med = torch.empty_like(x8)
    bil = torch.empty_like(x8)
    if b == 0:
        return med, bil
    taps = _Taps()
    for i, (_, _, sw) in enumerate(bilateral_taps(d, sigma_space)):
        taps.sw[i] = sw
    fn = _build.function("stencil", "tt_median_bilateral", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _Taps,
        ctypes.c_void_p])
    status = fn(_build.ptr(x8), _build.ptr(med), _build.ptr(bil), b, h, w,
                d // 2, 1.0 / (2.0 * sigma_color ** 2), taps,
                _build.stream_ptr(x8.device))
    _build.check("stencil", status, "fused_median_bilateral")
    _build.count_launch(fused_median_bilateral)
    return med, bil


_stencil_op = _build.define_op(
    "median_bilateral(Tensor x8, int d, float sigma_color, float sigma_space) "
    "-> (Tensor, Tensor)",
    cpu=_stencil_cpu, cuda=_stencil_cuda, fake=_stencil_fake)


def fused_median_bilateral(x8: torch.Tensor, d: int = 5,
                           sigma_color: float = 50.0,
                           sigma_space: float = 50.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x8 (B, H, W, 1) float32 on the 8-bit scale → (3×3 median, d×d
    bilateral of the median), both (B, H, W, 1) float32
    (`thyroid_tpu_torch::median_bilateral`)."""
    return _stencil_op(x8, int(d), float(sigma_color), float(sigma_space))


fused_median_bilateral.launches = 0


def median_bilateral_launch(d: int = 5) -> Dict[str, int]:
    """How fused_median_bilateral launches at window d: output tiles of
    `tile_w` x `tile_h`, `threads` a block, `smem_bytes` of dynamic shared
    memory a block (the colour table, two input windows and the medians),
    registers a thread, blocks an SM and the blocks of its persistent
    grid."""
    out = (ctypes.c_int * 7)()
    fn = _build.function("stencil", "tt_median_bilateral_config", [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    _build.check("stencil", fn(d // 2, out), "median_bilateral_launch")
    return dict(zip(("tile_w", "tile_h", "threads", "smem_bytes", "registers",
                     "blocks_per_sm", "grid"), out))
