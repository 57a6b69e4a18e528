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
  the coarse or the fine grid's LUTs;
- `apply_luts_dual_fused` (csrc/clahe.cu `tt_apply_luts_dual_fused`;
  plain: `apply_luts_dual_fused_plain`), the dual apply with the uint16
  round trip's way back and the per-image apply/pass-through select in one
  pass, which `clahe_uint16_dual_fused` (plain:
  `clahe_uint16_dual_fused_plain`, JAX's own definition) runs. The quality
  pipeline does not call it, as in the JAX package.
Each apply is an op (`thyroid_tpu_torch::apply_luts`, `apply_luts_dual`,
`apply_luts_dual_fused`; ops/_build.py `define_op`): a CUDA tensor launches
the kernel, a CPU tensor takes the plain version.
Tiles need not have even sides.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _build

Grid = Tuple[int, int]


def _tile_hists(x8: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Per-tile 256-bin histograms of integer-valued x8 (B, H, W) in
    [0, 255] (clipped there) → (B, gh, gw, 256) float32 counts, summed
    by index_add_ (exact: integer counts below 2²⁴) into a fixed number of
    bins, so that the traced program's shapes do not depend on the data."""
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
    idx = idx.reshape(-1)
    ones = torch.ones((), dtype=torch.float32, device=dev).expand(idx.shape)
    return torch.zeros(b * gh * gw * 256, dtype=torch.float32, device=dev) \
        .index_add_(0, idx, ones).reshape(b, gh, gw, 256)


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


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c of float32 tensors with one rounding to float32, as a fused
    multiply-add gives it. The float64 product is exact (24 + 24 bits); the
    float64 sum is rounded to odd (an inexact sum whose last bit is even
    moves one step towards the exact value, by TwoSum's error term), so
    that the final rounding to float32 equals the single rounding of the
    exact a·b + c."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _blend_coords(n: int, t: int, g: int, device):
    """cv2's tile coordinates along one axis of n pixels, tiles of t:
    f = p/t − 0.5, weight f − floor(f), neighbours clamp(floor(f)) and
    clamp(floor(f) + 1) to [0, g − 1]. Rounded as the JAX package's
    compiled program rounds it: XLA turns the division by the constant t
    into a product by float32(1/t), and the CPU's code generator fuses the
    product and the −0.5 into one multiply-add, so f = fma(p,
    float32(1/t), −0.5) with one rounding; csrc/clahe.cu repeats it."""
    p = torch.arange(n, dtype=torch.float32)
    f = _fma32(p, torch.tensor(np.float32(1.0) / np.float32(t)),
               torch.tensor(-0.5))
    fl = torch.floor(f)
    i0 = torch.clamp(fl, 0, g - 1).to(torch.int64)
    i1 = torch.clamp(fl + 1, 0, g - 1).to(torch.int64)
    return (f - fl).to(device), i0.to(device), i1.to(device)


def _lerp(a: torch.Tensor, b: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """a·(1 − w) + b·w rounded as the compiled JAX program rounds it: the
    product b·w rounded to float32, then the first product and the sum in
    one multiply-add (the code generator fuses the sum's first operand)."""
    return _fma32(a, 1 - wgt, b * wgt)


def _interp_luts(x8: torch.Tensor, luts: torch.Tensor,
                 grid: Grid) -> torch.Tensor:
    """Bilinear blend of the 4 neighbouring tile LUTs at each pixel's
    value (the gather formulation): x8 (B, H, W), luts (B, gh, gw, 256) →
    (B, H, W) float32, top = f00·(1 − wx) + f01·wx, bottom likewise,
    out = top·(1 − wy) + bottom·wy, each through `_lerp`'s roundings."""
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

    top = _lerp(gather(y0, x0), gather(y0, x1), wx)
    bot = _lerp(gather(y1, x0), gather(y1, x1), wx)
    return _lerp(top, bot, wy)


def _check_apply(name: str, x8: torch.Tensor, *luts: torch.Tensor) -> None:
    for t in (x8,) + luts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if t.device != x8.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _check_luts(luts: torch.Tensor, b: int, grid: Grid, h: int, w: int) -> None:
    gh, gw = grid
    if luts.shape != (b, gh, gw, 256):
        raise ValueError(f"LUTs {tuple(luts.shape)} do not match "
                         f"({b}, {gh}, {gw}, 256)")
    if h < gh or w < gw:
        raise ValueError(f"grid {tuple(grid)} has more tiles than the {h}x{w} "
                         f"frame")


def _lut_args(luts: torch.Tensor, grid: Grid, h: int, w: int):
    gh, gw = grid
    return (_build.ptr(luts), gh, gw, h // gh, w // gw)


_GRID_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int]


def _check_single(x8, luts, grid):
    _check_apply("apply_luts", x8, luts)
    b, h, w = x8.shape
    _check_luts(luts, b, grid, h, w)


def _single_cpu(x8, luts, grid):
    return _interp_luts(x8, luts, tuple(grid)).contiguous()


def _single_fake(x8, luts, grid):
    _check_single(x8, luts, grid)
    return torch.empty_like(x8)


def _single_cuda(x8, luts, grid):
    _check_single(x8, luts, grid)
    b, h, w = x8.shape
    out = torch.empty_like(x8)
    if b == 0:
        return out
    fn = _build.function("clahe", "tt_apply_luts", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, *_GRID_ARGS, ctypes.c_void_p])
    status = fn(_build.ptr(x8), _build.ptr(out), b, h, w,
                *_lut_args(luts, grid, h, w), _build.stream_ptr(x8.device))
    _build.check("clahe", status, "apply_luts")
    _build.count_launch(apply_luts)
    return out


_single_op = _build.define_op(
    "apply_luts(Tensor x8, Tensor luts, int[] grid) -> Tensor",
    cpu=_single_cpu, cuda=_single_cuda, fake=_single_fake)


def apply_luts(x8: torch.Tensor, luts: torch.Tensor, grid: Grid) -> torch.Tensor:
    """CLAHE LUT apply: x8 (B, H, W) float32 bins (clipped to [0, 255]),
    luts (B, gh, gw, 256) float32, integer valued in [0, 255] → the
    blended (B, H, W) float32 (`thyroid_tpu_torch::apply_luts`)."""
    return _single_op(x8, luts, list(grid))


apply_luts.launches = 0


def _check_flags(x8: torch.Tensor, **flags: torch.Tensor) -> None:
    for name, flag in flags.items():
        if flag.shape != (x8.shape[0],) or flag.device != x8.device:
            raise ValueError(f"{name} must be a (B,) tensor on x8's device")


def _check_dual_apply(x8, luts_c, luts_f, use_coarse, grid_c, grid_f):
    _check_apply("apply_luts_dual", x8, luts_c, luts_f)
    b, h, w = x8.shape
    _check_luts(luts_c, b, grid_c, h, w)
    _check_luts(luts_f, b, grid_f, h, w)
    _check_flags(x8, use_coarse=use_coarse)


def _dual_cpu(x8, luts_c, luts_f, use_coarse, grid_c, grid_f):
    return _blend_dual(x8, luts_c, luts_f, use_coarse, tuple(grid_c),
                       tuple(grid_f)).contiguous()


def _dual_fake(x8, luts_c, luts_f, use_coarse, grid_c, grid_f):
    _check_dual_apply(x8, luts_c, luts_f, use_coarse, grid_c, grid_f)
    return torch.empty_like(x8)


def _dual_cuda(x8, luts_c, luts_f, use_coarse, grid_c, grid_f):
    _check_dual_apply(x8, luts_c, luts_f, use_coarse, grid_c, grid_f)
    b, h, w = x8.shape
    sel = use_coarse.to(torch.int32).contiguous()
    out = torch.empty_like(x8)
    if b == 0:
        return out
    fn = _build.function("clahe", "tt_apply_luts_dual", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *_GRID_ARGS, *_GRID_ARGS,
        ctypes.c_void_p])
    status = fn(_build.ptr(x8), _build.ptr(sel), _build.ptr(out), b, h, w,
                *_lut_args(luts_c, grid_c, h, w),
                *_lut_args(luts_f, grid_f, h, w),
                _build.stream_ptr(x8.device))
    _build.check("clahe", status, "apply_luts_dual")
    _build.count_launch(apply_luts_dual)
    return out


_dual_op = _build.define_op(
    "apply_luts_dual(Tensor x8, Tensor luts_c, Tensor luts_f, "
    "Tensor use_coarse, int[] grid_c, int[] grid_f) -> Tensor",
    cpu=_dual_cpu, cuda=_dual_cuda, fake=_dual_fake)


def apply_luts_dual(x8: torch.Tensor, luts_c: torch.Tensor,
                    luts_f: torch.Tensor, use_coarse: torch.Tensor,
                    grid_c: Grid, grid_f: Grid) -> torch.Tensor:
    """`apply_luts` with a per-image choice of grid: image i blends
    luts_c (grid_c) where use_coarse[i], else luts_f (grid_f)
    (`thyroid_tpu_torch::apply_luts_dual`)."""
    return _dual_op(x8, luts_c, luts_f, use_coarse, list(grid_c), list(grid_f))


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


def _to_8bit(x: torch.Tensor):
    """The round trip's way there: x (B, H, W, 1) → (img (B, H, W), lo,
    span (B, 1, 1) each, x8 = floor((img − lo) / (span + 1e-8) · 255), the
    uint8 cast)."""
    b = x.shape[0]
    img = x[..., 0]
    flat = img.reshape(b, -1)
    lo = flat.amin(dim=1).reshape(b, 1, 1)
    span = flat.amax(dim=1).reshape(b, 1, 1) - lo
    return img, lo, span, torch.floor((img - lo) / (span + 1e-8) * 255.0)


def _from_8bit(eq: torch.Tensor, img: torch.Tensor, lo: torch.Tensor,
               span: torch.Tensor) -> torch.Tensor:
    """The round trip's way back: the rounded 8-bit eq (B, H, W) → floor of
    eq/255·span + lo clamped to [0, 65535]; a flat image (span ≤ 0) keeps
    img, floored.

    Computed as the JAX package's compiled program computes it: XLA turns
    eq / 255 · span into eq · (span · float32(1/255)), the per-image scale
    rounded to float32 once, and the CPU's code generator fuses the product
    by eq and the + lo into one multiply-add, rounded once:
    fma(eq, float32(span · float32(1/255)), lo)."""
    scale = span * torch.tensor(np.float32(1.0 / 255.0))
    out = _fma32(eq, scale, lo)
    out = torch.clamp(out, 0.0, 65535.0)
    out = torch.where(span <= 0, img, out)                  # flat: identity
    return torch.floor(out)


def _uint16_roundtrip(x: torch.Tensor,
                      eq_fn: Callable[[torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """Range-preserving uint16 round trip (reference
    quality_preprocessing.py:125-147): per-image [min, max] → 8 bit →
    `eq_fn` → round (cv2's saturate_cast) → back to [min, max], floored
    (the uint16 cast). Flat images pass through. x (B, H, W, 1)."""
    img, lo, span, x8 = _to_8bit(x)
    return _from_8bit(torch.round(eq_fn(x8)), img, lo, span)[..., None]


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


def _blend_dual(x8: torch.Tensor, luts_c: torch.Tensor, luts_f: torch.Tensor,
                use_coarse: torch.Tensor, grid_c: Grid, grid_f: Grid) -> torch.Tensor:
    """Plain dual-grid blend: both grids through `_interp_luts` and a
    per-image select."""
    return torch.where(use_coarse.reshape(x8.shape[0], 1, 1),
                       _interp_luts(x8, luts_c, grid_c),
                       _interp_luts(x8, luts_f, grid_f))


def apply_luts_dual_fused_plain(x8: torch.Tensor, img: torch.Tensor,
                                luts_c: torch.Tensor, luts_f: torch.Tensor,
                                use_coarse: torch.Tensor, apply: torch.Tensor,
                                lo: torch.Tensor, span: torch.Tensor,
                                grid_c: Grid, grid_f: Grid) -> torch.Tensor:
    """Plain version of apply_luts_dual_fused: the dual blend, rounded,
    taken back to the uint16 scale where apply, img elsewhere."""
    b = x8.shape[0]
    eq = torch.round(_blend_dual(torch.clamp(x8, 0, 255), luts_c, luts_f,
                                 use_coarse, grid_c, grid_f))
    back = _from_8bit(eq, img, lo.reshape(b, 1, 1), span.reshape(b, 1, 1))
    return torch.where(apply.reshape(b, 1, 1), back, img)


def _check_fused(x8, img, luts_c, luts_f, use_coarse, apply, lo, span,
                 grid_c, grid_f):
    _check_apply("apply_luts_dual_fused", x8, img, luts_c, luts_f, lo, span)
    b, h, w = x8.shape
    if img.shape != x8.shape or lo.shape != (b,) or span.shape != (b,):
        raise ValueError(f"img {tuple(img.shape)}, lo {tuple(lo.shape)} and "
                         f"span {tuple(span.shape)} do not match x8 "
                         f"{tuple(x8.shape)}")
    _check_flags(x8, use_coarse=use_coarse, apply=apply)
    _check_luts(luts_c, b, grid_c, h, w)
    _check_luts(luts_f, b, grid_f, h, w)


def _fused_cpu(x8, img, luts_c, luts_f, use_coarse, apply, lo, span, grid_c,
               grid_f):
    return apply_luts_dual_fused_plain(
        x8, img, luts_c, luts_f, use_coarse, apply, lo, span, tuple(grid_c),
        tuple(grid_f)).contiguous()


def _fused_fake(x8, img, luts_c, luts_f, use_coarse, apply, lo, span, grid_c,
                grid_f):
    _check_fused(x8, img, luts_c, luts_f, use_coarse, apply, lo, span, grid_c,
                 grid_f)
    return torch.empty_like(img)


def _fused_cuda(x8, img, luts_c, luts_f, use_coarse, apply, lo, span, grid_c,
                grid_f):
    _check_fused(x8, img, luts_c, luts_f, use_coarse, apply, lo, span, grid_c,
                 grid_f)
    b, h, w = x8.shape
    sel = use_coarse.to(torch.int32).contiguous()
    take = apply.to(torch.int32).contiguous()
    out = torch.empty_like(img)
    if b == 0:
        return out
    fn = _build.function("clahe", "tt_apply_luts_dual_fused", [
        *[ctypes.c_void_p] * 7, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *_GRID_ARGS, *_GRID_ARGS, ctypes.c_void_p])
    status = fn(_build.ptr(x8), _build.ptr(img), _build.ptr(sel),
                _build.ptr(take), _build.ptr(lo), _build.ptr(span),
                _build.ptr(out), b, h, w, *_lut_args(luts_c, grid_c, h, w),
                *_lut_args(luts_f, grid_f, h, w), _build.stream_ptr(x8.device))
    _build.check("clahe", status, "apply_luts_dual_fused")
    _build.count_launch(apply_luts_dual_fused)
    return out


_fused_op = _build.define_op(
    "apply_luts_dual_fused(Tensor x8, Tensor img, Tensor luts_c, "
    "Tensor luts_f, Tensor use_coarse, Tensor apply, Tensor lo, Tensor span, "
    "int[] grid_c, int[] grid_f) -> Tensor",
    cpu=_fused_cpu, cuda=_fused_cuda, fake=_fused_fake)


def apply_luts_dual_fused(x8: torch.Tensor, img: torch.Tensor,
                          luts_c: torch.Tensor, luts_f: torch.Tensor,
                          use_coarse: torch.Tensor, apply: torch.Tensor,
                          lo: torch.Tensor, span: torch.Tensor,
                          grid_c: Grid, grid_f: Grid) -> torch.Tensor:
    """The dual apply with the round trip's way back and the branch select
    in one pass: x8 (B, H, W) float32 bins, img (B, H, W) float32 the frames
    on the uint16 scale, the two grids' LUTs, use_coarse and apply (B,)
    bool, lo and span (B,) float32 → (B, H, W) float32: where apply, the
    equalised frame back on [lo, lo + span], floored (a flat frame: img
    floored); elsewhere img (`thyroid_tpu_torch::apply_luts_dual_fused`)."""
    return _fused_op(x8, img, luts_c, luts_f, use_coarse, apply, lo, span,
                     list(grid_c), list(grid_f))


apply_luts_dual_fused.launches = 0


def clahe_uint16_dual_fused_plain(x: torch.Tensor, use_coarse: torch.Tensor,
                                  apply: torch.Tensor, clip_coarse: float,
                                  grid_coarse: Grid, clip_fine: float,
                                  grid_fine: Grid) -> torch.Tensor:
    """Plain version of clahe_uint16_dual_fused, the JAX package's own
    definition of it: where(apply, clahe_uint16_dual(x, …), x), with the
    dual apply in plain PyTorch."""
    def eq_fn(x8):
        luts_c, luts_f = _dual_luts(x8, clip_coarse, grid_coarse, clip_fine,
                                    grid_fine)
        return _blend_dual(torch.clamp(x8, 0, 255), luts_c, luts_f,
                           use_coarse, grid_coarse, grid_fine)

    return torch.where(apply.reshape(-1, 1, 1, 1), _uint16_roundtrip(x, eq_fn), x)


def clahe_uint16_dual_fused(x: torch.Tensor, use_coarse: torch.Tensor,
                            apply: torch.Tensor, clip_coarse: float,
                            grid_coarse: Grid, clip_fine: float,
                            grid_fine: Grid,
                            method: Optional[str] = None) -> torch.Tensor:
    """The dual-grid uint16 CLAHE with the round trip's way back and the
    pipeline's per-image branch select in the apply kernel
    (apply_luts_dual_fused): equal to

        where(apply, clahe_uint16_dual(x, use_coarse, …), x)

    x (B, H, W, 1) float32 on the uint16 scale; use_coarse, apply (B,)
    bool. The way there and the histogram and LUT chain stay plain
    PyTorch, as in clahe_uint16_dual. `method` is accepted for the JAX
    signature and has no effect, but "pallas" keeps the JAX package's
    refusal of odd tile sides."""
    h, w = x.shape[1], x.shape[2]
    _check_dual(h, w, grid_coarse, grid_fine)
    if method == "pallas" and ((h // grid_fine[0]) % 2 or (w // grid_fine[1]) % 2):
        raise ValueError(f"quadrant CLAHE needs even tile sides, got "
                         f"{h // grid_fine[0]}x{w // grid_fine[1]}")
    img, lo, span, x8 = _to_8bit(x)
    luts_c, luts_f = _dual_luts(x8, clip_coarse, grid_coarse, clip_fine,
                                grid_fine)
    return apply_luts_dual_fused(x8, img.contiguous(), luts_c, luts_f,
                                 use_coarse, apply, lo.reshape(-1),
                                 span.reshape(-1), grid_coarse,
                                 grid_fine)[..., None]
