"""Batched CLAHE on 8-bit and uint16-scale frames (counterpart of
thyroid_tpu/ops/clahe.py).

cv2's CLAHE rebuilt per image and batched (reference
quality_preprocessing.py:125-147): normalise each uint16 image to its own
[min, max] as 8 bit, per-tile 256-bin histograms, clip and redistribute
(integer-exact to cv2's clahe.cpp), CDF → LUT, then each pixel blends the
LUTs of its four neighbouring tiles by cv2's bilinear rule, and the result
goes back to the image's own range.

The histogram and LUT chain is plain PyTorch on every device (a bincount
and a cumsum, exact: the counts are integers below 2²⁴). The per-pixel
apply is the kernel:
- `apply_luts` (csrc/clahe.cu `tt_apply_luts`; plain: `_interp_luts`),
  one grid's LUTs;
- `apply_luts_dual` (csrc/clahe.cu `tt_apply_luts_dual`; plain: both
  grids through `_interp_luts` and a per-image select), each image taking
  the coarse or the fine grid's LUTs.
A CUDA tensor launches the kernel, a CPU tensor takes the plain version.
Tiles need not have even sides.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import numpy as np
import torch

from . import _build

Grid = Tuple[int, int]


def _tile_hists(x8: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Per-tile 256-bin histograms of integer-valued x8 (B, H, W) in
    [0, 255] (clipped there) → (B, gh, gw, 256) float32 counts."""
    b, h, w = x8.shape
    gh, gw = grid
    th, tw = h // gh, w // gw
    dev = x8.device
    v = torch.clamp(x8, 0, 255).to(torch.int64)
    ty = torch.arange(h, device=dev) // th
    tx = torch.arange(w, device=dev) // tw
    tile = (ty[:, None] * gw + tx[None, :])                       # (H, W)
    idx = (torch.arange(b, device=dev)[:, None, None] * (gh * gw) + tile) \
        * 256 + v
    return torch.bincount(idx.reshape(-1), minlength=b * gh * gw * 256) \
        .to(torch.float32).reshape(b, gh, gw, 256)


def _luts_from_hists(hist: torch.Tensor, area: int,
                     clip_limit: float) -> torch.Tensor:
    """Clipped-histogram CDF LUTs, (B, gh, gw, 256) counts → LUTs, integer
    valued in [0, 255]. Clip and redistribute as cv2's clahe.cpp: the
    limit is max(int(clip_limit·area/256), 1); every bin gains excess//256
    and the residual goes +1 at a time on bins 0, step, 2·step, … with
    step = max(256//residual, 1); LUT = saturate(round(cdf·255/area))."""
    clip = float(max(int(clip_limit * area / 256.0), 1))
    clipped = torch.clamp(hist, max=clip)
    excess = (hist - clipped).sum(dim=-1, keepdim=True)
    batch_inc = torch.floor(excess / 256.0)
    residual = excess - batch_inc * 256.0
    step = torch.clamp(torch.floor(256.0 / torch.clamp(residual, min=1.0)),
                       min=1.0)
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    residual_inc = ((torch.remainder(bins, step) == 0)
                    & (torch.floor(bins / step) < residual)).to(torch.float32)
    cdf = torch.cumsum(clipped + batch_inc + residual_inc, dim=-1)
    return torch.clamp(torch.round(cdf * (255.0 / area)), 0.0, 255.0)


def _blend_coords(n: int, t: int, g: int, device):
    """cv2's tile coordinates along one axis of n pixels, tiles of t:
    f = p/t − 0.5 in float32, weight f − floor(f), neighbours
    clamp(floor(f)) and clamp(floor(f) + 1) to [0, g − 1]. Computed with
    numpy's float32 division, which csrc/clahe.cu repeats."""
    f = np.arange(n, dtype=np.float32) / np.float32(t) - np.float32(0.5)
    fl = np.floor(f)
    i0 = np.clip(fl, 0, g - 1).astype(np.int64)
    i1 = np.clip(fl + 1, 0, g - 1).astype(np.int64)
    return (torch.from_numpy(f - fl).to(device), torch.from_numpy(i0).to(device),
            torch.from_numpy(i1).to(device))


def _interp_luts(x8: torch.Tensor, luts: torch.Tensor,
                 grid: Grid) -> torch.Tensor:
    """Bilinear blend of the 4 neighbouring tile LUTs at each pixel's
    value (the gather formulation): x8 (B, H, W), luts (B, gh, gw, 256) →
    (B, H, W) float32, top = f00·(1 − wx) + f01·wx, bottom likewise,
    out = top·(1 − wy) + bottom·wy."""
    b, h, w = x8.shape
    gh, gw = grid
    wy, y0, y1 = _blend_coords(h, h // gh, gh, x8.device)
    wx, x0, x1 = _blend_coords(w, w // gw, gw, x8.device)
    wy, wx = wy[None, :, None], wx[None, None, :]
    v = torch.clamp(x8, 0, 255).to(torch.int64)
    flat = luts.reshape(-1)
    base = torch.arange(b, device=x8.device).reshape(b, 1, 1) * gh

    def gather(yy, xx):
        idx = ((base + yy.reshape(1, h, 1)) * gw + xx.reshape(1, 1, w)) \
            * 256 + v
        return flat[idx]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _check_apply(name: str, x8: torch.Tensor, *luts: torch.Tensor) -> None:
    for t in (x8,) + luts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if t.device != x8.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _lut_args(luts: torch.Tensor, b: int, grid: Grid, h: int, w: int):
    gh, gw = grid
    if luts.shape != (b, gh, gw, 256):
        raise ValueError(f"LUTs {tuple(luts.shape)} do not match "
                         f"({b}, {gh}, {gw}, 256)")
    if h < gh or w < gw:
        raise ValueError(f"grid {grid} has more tiles than the {h}x{w} frame")
    return (_build.ptr(luts), gh, gw, h // gh, w // gw)


_GRID_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int]


def apply_luts(x8: torch.Tensor, luts: torch.Tensor, grid: Grid) -> torch.Tensor:
    """CLAHE LUT apply: x8 (B, H, W) float32 bins (clipped to [0, 255]),
    luts (B, gh, gw, 256) float32, integer valued in [0, 255] → the
    blended (B, H, W) float32."""
    if x8.device.type == "cpu":
        return _interp_luts(x8, luts, grid)
    if x8.device.type != "cuda":
        raise ValueError(f"unsupported device {x8.device}")
    _check_apply("apply_luts", x8, luts)
    b, h, w = x8.shape
    out = torch.empty_like(x8)
    if b == 0:
        return out
    fn = _build.function("clahe", "tt_apply_luts", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, *_GRID_ARGS, ctypes.c_void_p])
    status = fn(_build.ptr(x8), _build.ptr(out), b, h, w,
                *_lut_args(luts, b, grid, h, w), _build.stream_ptr(x8.device))
    _build.check("clahe", status, "apply_luts")
    apply_luts.launches += 1
    return out


apply_luts.launches = 0


def apply_luts_dual(x8: torch.Tensor, luts_c: torch.Tensor,
                    luts_f: torch.Tensor, use_coarse: torch.Tensor,
                    grid_c: Grid, grid_f: Grid) -> torch.Tensor:
    """`apply_luts` with a per-image choice of grid: image i blends
    luts_c (grid_c) where use_coarse[i], else luts_f (grid_f)."""
    b, h, w = x8.shape
    if x8.device.type == "cpu":
        return torch.where(use_coarse.reshape(b, 1, 1),
                           _interp_luts(x8, luts_c, grid_c),
                           _interp_luts(x8, luts_f, grid_f))
    if x8.device.type != "cuda":
        raise ValueError(f"unsupported device {x8.device}")
    _check_apply("apply_luts_dual", x8, luts_c, luts_f)
    if use_coarse.shape != (b,) or use_coarse.device != x8.device:
        raise ValueError("use_coarse must be a (B,) tensor on x8's device")
    sel = use_coarse.to(torch.int32).contiguous()
    out = torch.empty_like(x8)
    if b == 0:
        return out
    fn = _build.function("clahe", "tt_apply_luts_dual", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *_GRID_ARGS, *_GRID_ARGS,
        ctypes.c_void_p])
    status = fn(_build.ptr(x8), _build.ptr(sel), _build.ptr(out), b, h, w,
                *_lut_args(luts_c, b, grid_c, h, w),
                *_lut_args(luts_f, b, grid_f, h, w),
                _build.stream_ptr(x8.device))
    _build.check("clahe", status, "apply_luts_dual")
    apply_luts_dual.launches += 1
    return out


apply_luts_dual.launches = 0


def _check_grid(h: int, w: int, grid: Grid) -> None:
    if h % grid[0] or w % grid[1]:
        raise ValueError(f"image {h}x{w} not divisible by CLAHE grid {grid}")


def clahe_8bit(x8: torch.Tensor, clip_limit: float = 2.0,
               grid: Grid = (8, 8)) -> torch.Tensor:
    """CLAHE on integer-valued (B, H, W) float32 in [0, 255]; H and W
    divisible by the grid. Returns the blended values (not yet rounded)."""
    b, h, w = x8.shape
    _check_grid(h, w, grid)
    area = (h // grid[0]) * (w // grid[1])
    luts = _luts_from_hists(_tile_hists(x8, grid), area, clip_limit)
    return apply_luts(x8, luts, grid)


def _uint16_roundtrip(x: torch.Tensor,
                      eq_fn: Callable[[torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """Range-preserving uint16 round trip (reference
    quality_preprocessing.py:125-147): per-image [min, max] → 8 bit →
    `eq_fn` → round (cv2's saturate_cast) → back to [min, max], floored
    (the uint16 cast). Flat images pass through. x (B, H, W, 1).

    The way back is computed as the JAX package's compiled program
    computes it: q = eq·float32(1/255) (XLA turns the division by a
    constant into that product), then one rounding of q·span + lo (a fused
    multiply-add). The product and the sum are exact in float64, so one
    rounding from float64 is the fused result on every device."""
    b = x.shape[0]
    img = x[..., 0]
    flat = img.reshape(b, -1)
    lo = flat.amin(dim=1).reshape(b, 1, 1)
    hi = flat.amax(dim=1).reshape(b, 1, 1)
    span = hi - lo
    x8 = torch.floor((img - lo) / (span + 1e-8) * 255.0)   # uint8 cast
    eq = torch.round(eq_fn(x8))
    out = ((eq * (1.0 / 255.0)).double() * span.double() + lo.double()) \
        .to(torch.float32)
    out = torch.clamp(out, 0.0, 65535.0)
    out = torch.where(span <= 0, img, out)                  # flat: identity
    return torch.floor(out)[..., None]


def clahe_uint16(x: torch.Tensor, clip_limit: float = 2.0,
                 grid: Grid = (8, 8)) -> torch.Tensor:
    """Range-preserving uint16 CLAHE: x (B, H, W, 1) float32 on the uint16
    scale → same shape. Flat images pass through."""
    return _uint16_roundtrip(
        x, lambda x8: clahe_8bit(x8, clip_limit=clip_limit, grid=grid))


def _dual_luts(x8: torch.Tensor, clip_coarse: float, grid_coarse: Grid,
               clip_fine: float, grid_fine: Grid
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fine-grid histogram pass for both LUT chains: the coarse tile
    histograms are the exact 2×2 sums of the fine ones."""
    b, h, w = x8.shape
    gch, gcw = grid_coarse
    area_f = (h // grid_fine[0]) * (w // grid_fine[1])
    hist_f = _tile_hists(x8, grid_fine)
    hist_c = hist_f.reshape(b, gch, 2, gcw, 2, 256).sum(dim=(2, 4))
    return (_luts_from_hists(hist_c, 4 * area_f, clip_coarse),
            _luts_from_hists(hist_f, area_f, clip_fine))


def _check_dual(h: int, w: int, grid_coarse: Grid, grid_fine: Grid) -> None:
    if tuple(grid_fine) != (2 * grid_coarse[0], 2 * grid_coarse[1]):
        raise ValueError(f"dual CLAHE needs grid_fine == 2*grid_coarse, got "
                         f"{grid_coarse} vs {grid_fine}")
    _check_grid(h, w, grid_fine)


def clahe_8bit_dual(x8: torch.Tensor, use_coarse: torch.Tensor,
                    clip_coarse: float, grid_coarse: Grid, clip_fine: float,
                    grid_fine: Grid) -> torch.Tensor:
    """Per-image choice between two CLAHE parameterisations with one
    histogram pass and one apply: image i takes (clip_coarse, grid_coarse)
    where use_coarse[i], else (clip_fine, grid_fine); grid_fine must be
    2×grid_coarse. Per image equal to `clahe_8bit` with its own
    parameters."""
    _, h, w = x8.shape
    _check_dual(h, w, grid_coarse, grid_fine)
    luts_c, luts_f = _dual_luts(x8, clip_coarse, grid_coarse, clip_fine,
                                grid_fine)
    return apply_luts_dual(torch.clamp(x8, 0, 255), luts_c, luts_f,
                           use_coarse, grid_coarse, grid_fine)


def clahe_uint16_dual(x: torch.Tensor, use_coarse: torch.Tensor,
                      clip_coarse: float, grid_coarse: Grid, clip_fine: float,
                      grid_fine: Grid) -> torch.Tensor:
    """The uint16 round trip over `clahe_8bit_dual`: per image equal to
    `clahe_uint16` with that image's parameters. x (B, H, W, 1)."""
    return _uint16_roundtrip(
        x, lambda x8: clahe_8bit_dual(x8, use_coarse, clip_coarse,
                                      grid_coarse, clip_fine, grid_fine))
