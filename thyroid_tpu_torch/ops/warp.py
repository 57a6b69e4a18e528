"""Separable image warps: rotation, shear and elastic resampling as shifts
along one axis (counterpart of thyroid_tpu/ops/warp.py).

The JAX package builds these for the TPU, where per-pixel gathers run
near-serially: every tap is a static shifted slice of an edge-padded
tensor, selected by `floor(shift) == k`. The port keeps them as options
(`rotate(method="shear3")`, `elastic_deform(method="separable")`) and
computes the same numbers; its defaults are the direct gather forms
(ops/augment.py `affine_warp`, ops/image.py `elastic_deform`).

- `shift_axis_bilinear`: bilinear sampling at coord + shift along one
  axis, edge-replicated, optionally masked with the gather path's
  half-pixel validity test; "tree" (O(log S) selects, shifts constant
  along the axis) and "taps" (one select per integer shift) are
  bit-identical.
- `shear_x_fast` / `shear_y_fast`: exact single-axis shears.
- `rotate_shear3`: rot90 plus the three-shear factorisation
  ShearX(−tan ρ/2)·ShearY(sin ρ)·ShearX(−tan ρ/2) of the residual
  |ρ| ≤ 45°, with the exact validity mask of the full rotation (three 1-D
  resamples filter slightly differently from one 2-D one).
- `elastic_separable`: two-pass elastic resampling with the fields
  clipped to ±max_disp (the x-displacement taken at the pre-shift
  coordinate).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .image import edge_pad


def shift_axis_bilinear(x: torch.Tensor, shifts: torch.Tensor, axis: int,
                        max_shift: int, valid_fill: Optional[float] = None,
                        method: Optional[str] = None) -> torch.Tensor:
    """out = x sampled at (coord + shifts) along `axis` (1: H, 2: W),
    bilinear, edge-replicated; shifts (B, H, W) or broadcastable to it
    (per image, row or pixel), clipped to ±max_shift. With `valid_fill`,
    samples whose unclipped source coordinate lies outside
    [-0.5, size - 0.5] get that value.

    method "tree" needs shifts of extent 1 along `axis` (level k advances
    the tensor by 2^k where bit k of floor(shift) + S is set); "taps"
    selects one shifted slice per integer shift in [-S, S]. None: "tree"
    when the shifts are constant along `axis`, else "taps"."""
    b, h, w, c = x.shape
    size = x.shape[axis]
    s = int(max_shift)
    axis_constant = shifts.dim() == 3 and shifts.shape[axis] == 1
    if method is None:
        method = "tree" if axis_constant else "taps"
    if method == "tree" and not axis_constant:
        raise ValueError(
            "method='tree' needs shifts constant along the shifted axis "
            f"(extent 1 at axis {axis}); got {tuple(shifts.shape)}")
    if method == "tree":
        sh = torch.clamp(shifts, -s, s)
        k = torch.floor(sh)
        f = (sh - k)[..., None]
        t = k.to(torch.int32) + s                        # in [0, 2S]
        nbits = max(1, int(2 * s).bit_length())          # 2**nbits > 2S
        y = edge_pad(x, axis, s, (1 << nbits) - s)      # size + 2**nbits
        for lvl in reversed(range(nbits)):
            bmag = 1 << lvl
            cur = y.shape[axis]
            keep = y.narrow(axis, 0, cur - bmag)
            stepped = y.narrow(axis, bmag, cur - bmag)
            pred = (((t >> lvl) & 1) == 1)[..., None]
            y = torch.where(pred, stepped, keep)
        # size + 1 remain: the floor tap and its +1 neighbour
        out = y.narrow(axis, 0, size)
        nxt = y.narrow(axis, 1, size)
    elif method == "taps":
        sh = torch.clamp(shifts.expand(b, h, w), -s, s)
        k = torch.floor(sh)
        f = (sh - k)[..., None]
        ki = k.to(torch.int32)
        xp = edge_pad(x, axis, s, s + 1)
        out = torch.zeros_like(x)
        nxt = torch.zeros_like(x)
        for kk in range(-s, s + 1):
            sel = (ki == kk)[..., None]
            out = torch.where(sel, xp.narrow(axis, kk + s, size), out)
            nxt = torch.where(sel, xp.narrow(axis, kk + s + 1, size), nxt)
    else:
        raise ValueError(f"unknown shift method {method!r}")
    res = out * (1 - f) + nxt * f
    if valid_fill is not None:
        coord = torch.arange(size, dtype=torch.float32, device=x.device)
        coord = coord.reshape((1, size, 1) if axis == 1 else (1, 1, size))
        src = coord + shifts
        valid = (src >= -0.5) & (src <= size - 0.5)
        res = torch.where(valid[..., None], res, float(valid_fill))
    return res


def shear_x_fast(x: torch.Tensor, shx: torch.Tensor, fill: Optional[float],
                 max_shift: Optional[int] = None) -> torch.Tensor:
    """x-shear about the centre: out[y, j] = x[y, j + shx·(y − cy)]."""
    b, h, w, _ = x.shape
    cy = (h - 1) / 2.0
    rows = (torch.arange(h, dtype=torch.float32, device=x.device) - cy) \
        .reshape(1, h, 1)
    shifts = shx.reshape(b, 1, 1) * rows
    return shift_axis_bilinear(x, shifts, axis=2, max_shift=max_shift or w,
                               valid_fill=fill)


def shear_y_fast(x: torch.Tensor, shy: torch.Tensor, fill: Optional[float],
                 max_shift: Optional[int] = None) -> torch.Tensor:
    """y-shear about the centre: out[i, x] = x[i + shy·(x − cx), x]."""
    b, h, w, _ = x.shape
    cx = (w - 1) / 2.0
    cols = (torch.arange(w, dtype=torch.float32, device=x.device) - cx) \
        .reshape(1, 1, w)
    shifts = shy.reshape(b, 1, 1) * cols
    return shift_axis_bilinear(x, shifts, axis=1, max_shift=max_shift or h,
                               valid_fill=fill)


def rotate_shear3(x: torch.Tensor, angles_deg: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """Per-image rotation (CCW) of square images by rot90 and three shears
    of the residual |ρ| ≤ 45°; validity mask and fill from the exact
    inverse-rotation coordinates."""
    b, h, w, _ = x.shape
    if h != w:
        raise ValueError("rotate_shear3 needs square images")
    from .augment import cos_sin

    theta = torch.deg2rad(angles_deg.to(torch.float32))
    n90 = torch.round(theta / (math.pi / 2.0))
    rho = theta - n90 * (math.pi / 2.0)
    # the source's quarter turn first: out = in∘R(n90·90°)∘R(rho)
    n = (n90.to(torch.int32) % 4).reshape(b, 1, 1, 1)
    g = torch.zeros_like(x)
    for k in range(4):
        g = torch.where(n == k, torch.rot90(x, k, dims=(1, 2)), g)
    # float64 and one rounding, as cos_sin: the same bits on every device
    t = -torch.tan((rho / 2.0).to(torch.float64)).to(torch.float32)
    s = cos_sin(rho)[1]
    # the largest |shift|: tan(22.5°) = 0.4142, sin(45°) = 0.7072
    s_x = int(math.ceil(0.4143 * (h - 1) / 2.0)) + 1
    s_y = int(math.ceil(0.7072 * (w - 1) / 2.0)) + 1
    out = shear_x_fast(g, t, fill=None, max_shift=s_x)
    out = shear_y_fast(out, s, fill=None, max_shift=s_y)
    out = shear_x_fast(out, t, fill=None, max_shift=s_x)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device) - cy,
        torch.arange(w, dtype=torch.float32, device=x.device) - cx,
        indexing="ij")
    cos, sin = (v.reshape(b, 1, 1) for v in cos_sin(theta))
    sx_c = cos * xx[None] - sin * yy[None] + cx
    sy_c = sin * xx[None] + cos * yy[None] + cy
    valid = ((sx_c >= -0.5) & (sx_c <= w - 0.5)
             & (sy_c >= -0.5) & (sy_c <= h - 0.5))
    return torch.where(valid[..., None], out, float(fill))


def elastic_separable(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                      max_disp: int) -> torch.Tensor:
    """Two-pass elastic resampling with per-pixel displacement fields dy,
    dx (B, H, W), clipped to ±max_disp; edges replicated (map_coordinates
    mode="nearest")."""
    out = shift_axis_bilinear(x, dy, axis=1, max_shift=max_disp)
    return shift_axis_bilinear(out, dx, axis=2, max_shift=max_disp)
