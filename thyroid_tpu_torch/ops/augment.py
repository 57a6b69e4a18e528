"""Batched augmentation on the device (counterpart of
thyroid_tpu/ops/augment.py).

NHWC float32 batches in [0, 1]; every op works per image. The JAX package
derives each draw from a PRNG key; the port draws from an explicit
`torch.Generator` (on the batch's device) and keeps the drawing apart from
the arithmetic: each composed transform has a `draw_*` function that
returns its per-image parameters (gates, angles, factors, op choices,
noise, displacement fields, permutation, λ, box centre) as a dict of
tensors, and a deterministic `apply_*(x, params)`. The public function is
`apply_*(x, draw_*(generator, ...))`. The random streams are not JAX's;
fed the same parameters, the arithmetic is.

- normalisation: `microscopy_normalize`;
- geometry: flips, `affine_warp` (bilinear, clamped taps, half-pixel
  validity mask), `rotate` ("gather", the default, or "shear3" through
  ops/warp.py), `random_rotation`, `shear`, `translate`;
- intensity: brightness, contrast, sharpness, `auto_contrast`, `equalize`
  and `posterize` on the 8-bit grid, `solarize`, noise, `random_blur`;
- the ladders: `microscopy_augment`, `random_patch_drop`, `train_augment`
  (levels light, medium, heavy);
- ViT: `randaugment` (12 ops, each computed for the whole batch and
  selected per image, as JAX's switch under vmap runs every branch),
  `compute_patch_quality`, `quality_aware_patch_augment`, `vit_augment`;
- `mixup`, `cutmix`, `mixup_cutmix` (one shared permutation, λ ~ Beta(α, α)
  drawn from the generator as a ratio of two Gamma draws), `tta_views`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .image import (apply_elastic, draw_elastic, gaussian_blur,
                    per_image_quantile)

Params = Dict[str, Any]


def params_to(params: Params, device) -> Params:
    """A (nested) parameter dict with every tensor moved to `device`."""
    return {k: params_to(v, device) if isinstance(v, dict)
            else v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in params.items()}


def _rand(generator: torch.Generator, shape, lo: float = 0.0,
          hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u if (lo, hi) == (0.0, 1.0) else lo + u * (hi - lo)


def _gate(generator: torch.Generator, b: int, p: float) -> torch.Tensor:
    """(B,) bool, each True with probability p."""
    return _rand(generator, (b,)) < p


def _b4(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1, 1, 1)


def cos_sin(theta: torch.Tensor):
    """cos and sin of float32 angles (radians), taken in float64 and rounded
    once to float32, so that the CPU and the card give the same bits (their
    float32 cos and sin differ in the last place, which a warp's source
    coordinate, up to about 160 pixels, turns into 1e-5 of a pixel)."""
    t = theta.to(torch.float64)
    return torch.cos(t).to(torch.float32), torch.sin(t).to(torch.float32)


def beta_sample(generator: torch.Generator, alpha: float) -> torch.Tensor:
    """One λ ~ Beta(α, α) as G₁ / (G₁ + G₂), G ~ Gamma(α, 1), both from
    `generator` (torch.distributions.Beta takes no generator); a float32
    scalar tensor on the generator's device."""
    conc = torch.full((2,), float(alpha), dtype=torch.float32,
                      device=generator.device)
    g = torch._standard_gamma(conc, generator=generator)
    return g[0] / (g[0] + g[1])


# ------------------------------------------------------------ normalisation


def microscopy_normalize(x: torch.Tensor,
                         input_range: Tuple[float, float] = (0.0, 65535.0),
                         output_range: Tuple[float, float] = (0.0, 1.0),
                         clip_percentile: Optional[Tuple[float, float]] = (1.0, 99.0)
                         ) -> torch.Tensor:
    """uint16 microscopy normalisation: clip to each image's percentiles
    (exact quantiles) and scale, or scale the input range; then map to
    `output_range`."""
    if clip_percentile is not None:
        lo = per_image_quantile(x, clip_percentile[0] / 100.0)
        hi = per_image_quantile(x, clip_percentile[1] / 100.0)
        x = torch.minimum(torch.maximum(x, lo), hi)
        x = (x - lo) / (hi - lo + 1e-8)
    else:
        in_lo, in_hi = input_range
        x = (x - in_lo) / (in_hi - in_lo)
    out_lo, out_hi = output_range
    return x * (out_hi - out_lo) + out_lo


# ----------------------------------------------------------------- geometry


def hflip(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Mirror the images whose (B,) gate is set, left-right."""
    return torch.where(_b4(gate), torch.flip(x, dims=(2,)), x)


def vflip(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return torch.where(_b4(gate), torch.flip(x, dims=(1,)), x)


def random_hflip(x: torch.Tensor, generator: torch.Generator,
                 p: float = 0.5) -> torch.Tensor:
    return hflip(x, _gate(generator, x.shape[0], p))


def random_vflip(x: torch.Tensor, generator: torch.Generator,
                 p: float = 0.5) -> torch.Tensor:
    return vflip(x, _gate(generator, x.shape[0], p))


def affine_warp(x: torch.Tensor, matrices: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Inverse-affine warp about the centre with bilinear sampling.
    matrices (B, 2, 3) map output pixel coordinates [x, y, 1] (centred) to
    input coordinates; taps are clamped to the image, and samples outside
    [-0.5, size - 0.5] get `fill`."""
    b, h, w, c = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device) - cy,
        torch.arange(w, dtype=torch.float32, device=x.device) - cx,
        indexing="ij")
    base = torch.stack([xx, yy, torch.ones_like(yy)], dim=0).reshape(3, -1)
    src = torch.einsum("bij,jk->bik", matrices.to(torch.float32), base)
    sx = src[:, 0].reshape(b, h, w) + cx
    sy = src[:, 1].reshape(b, h, w) + cy
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    valid = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    flat = x.reshape(b, h * w, c)

    def tap(iy, ix):
        idx = torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)
        idx = idx.reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(valid[..., None], out, float(fill))


def _matrices(a, b_, c, d, e, f) -> torch.Tensor:
    """(B, 2, 3) from six (B,) rows [[a, b, c], [d, e, f]]."""
    return torch.stack([torch.stack([a, b_, c], -1),
                        torch.stack([d, e, f], -1)], dim=1)


def rotate(x: torch.Tensor, angles_deg: torch.Tensor, fill: float = 0.0,
           method: Optional[str] = None) -> torch.Tensor:
    """Rotate each image by its own angle (degrees, CCW). "gather" (the
    default, PIL-exact): one bilinear affine warp. "shear3": rot90 and
    three shears (ops/warp.py), square images; its interior filters about
    one grey level away from the direct warp."""
    if method == "shear3":
        from .warp import rotate_shear3

        return rotate_shear3(x, angles_deg, fill=fill)
    if method not in (None, "gather"):
        raise ValueError(f"unknown rotation method {method!r}")
    cos, sin = cos_sin(torch.deg2rad(angles_deg.to(torch.float32)))
    zero = torch.zeros_like(cos)
    return affine_warp(x, _matrices(cos, -sin, zero, sin, cos, zero), fill)


def random_rotation(x: torch.Tensor, generator: torch.Generator,
                    degrees: float = 90.0, fill: float = 0.0,
                    method: Optional[str] = None) -> torch.Tensor:
    """A uniform angle in [-degrees, degrees) per image."""
    angles = _rand(generator, (x.shape[0],), -degrees, degrees)
    return rotate(x, angles, fill=fill, method=method)


def shear(x: torch.Tensor, shear_x: torch.Tensor, shear_y: torch.Tensor,
          fill: float = 0.0) -> torch.Tensor:
    one, zero = torch.ones_like(shear_x), torch.zeros_like(shear_x)
    return affine_warp(x, _matrices(one, shear_x, zero, shear_y, one, zero),
                       fill)


def translate(x: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
              fill: float = 0.0) -> torch.Tensor:
    """Translate by (tx, ty) pixels per image."""
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return affine_warp(x, _matrices(one, zero, -tx, zero, one, -ty), fill)


# ---------------------------------------------------------------- intensity


def adjust_brightness(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * _b4(factors), 0.0, 1.0)


def adjust_contrast(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Blend with the per-image mean (torchvision's grayscale contrast)."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((x - mean) * _b4(factors) + mean, 0.0, 1.0)


def adjust_sharpness(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Blend with a σ = 1 blur (factor > 1 sharpens, < 1 blurs)."""
    blurred = gaussian_blur(x, sigma=1.0)
    return torch.clamp(blurred + (x - blurred) * _b4(factors), 0.0, 1.0)


def auto_contrast(x: torch.Tensor) -> torch.Tensor:
    """Per-image min/max stretch on the 8-bit grid (TF.autocontrast)."""
    x8 = torch.floor(x * 255.0)
    b = x.shape[0]
    flat = x8.reshape(b, -1)
    lo = _b4(flat.amin(dim=1))
    hi = _b4(flat.amax(dim=1))
    out = (x8 - lo) * (255.0 / torch.clamp(hi - lo, min=1.0))
    out = torch.where(hi > lo, out, x8)
    return torch.clamp(torch.round(out), 0.0, 255.0) / 255.0


def equalize(x: torch.Tensor) -> torch.Tensor:
    """Global histogram equalisation on the 8-bit grid (TF.equalize): a LUT
    from the cumulative histogram with step = (N − count of the last
    nonzero bin) // 255; a step of 0 keeps the image. The histogram counts
    are integers (exact in float32 below 2²⁴ pixels an image)."""
    b, h, w, c = x.shape
    x8 = torch.clamp(torch.floor(x * 255.0), 0.0, 255.0)
    idx = x8.to(torch.int64).reshape(b, -1)
    hist = torch.zeros((b, 256), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    cdf = torch.cumsum(hist, dim=1).to(torch.float32)
    hist = hist.to(torch.float32)
    nonzero = (hist > 0).to(torch.int32)
    last_idx = 255 - torch.argmax(torch.flip(nonzero, dims=(1,)), dim=1)
    last_count = torch.gather(hist, 1, last_idx[:, None])[:, 0]
    step = torch.floor((h * w * c - last_count) / 255.0)
    lut = torch.floor((cdf - hist / 2.0 + step[:, None] / 2.0)
                      / torch.clamp(step, min=1.0)[:, None])
    lut = torch.clamp(lut, 0.0, 255.0)
    out = torch.gather(lut, 1, idx).reshape(b, h, w, c)
    out = torch.where(_b4(step > 0), out, x8)
    return out / 255.0


def posterize(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Keep the top `bits` bits of each 8-bit value (bits per image)."""
    x8 = torch.clamp(torch.floor(x * 255.0), 0.0, 255.0).to(torch.int32)
    shift = _b4(8 - bits.to(torch.int32))
    return ((x8 >> shift) << shift).to(x.dtype) / 255.0


def solarize(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Invert pixels ≥ the image's threshold (in [0, 1])."""
    return torch.where(x >= _b4(thresholds), 1.0 - x, x)


def gaussian_noise(x: torch.Tensor, noise: torch.Tensor,
                   std: float) -> torch.Tensor:
    """x + std·noise, noise standard normal of x's shape."""
    return x + noise * std


def blend_blur(x: torch.Tensor, sigmas: torch.Tensor,
               hi: float) -> torch.Tensor:
    """Per-image σ blur as a cross-fade with the blur at σ = hi:
    x·(1 − σ/hi) + blur·σ/hi."""
    blurred = gaussian_blur(x, sigma=hi)
    t = _b4(sigmas / hi)
    return x * (1 - t) + blurred * t


def _blur_hi(sigma_range: Tuple[float, float]) -> float:
    return max(sigma_range[1], 1e-3)


def random_blur(x: torch.Tensor, generator: torch.Generator,
                sigma_range: Tuple[float, float] = (0.0, 1.0)) -> torch.Tensor:
    """A uniform σ in `sigma_range` per image (blend_blur)."""
    sig = _rand(generator, (x.shape[0],), *sigma_range)
    return blend_blur(x, sig, _blur_hi(sigma_range))


# ------------------------------------------------------- microscopy ladder


def draw_microscopy_augment(generator: torch.Generator, shape,
                            brightness_range=(0.8, 1.2),
                            contrast_range=(0.8, 1.2),
                            blur_sigma_range=(0.0, 1.0),
                            p: float = 0.5) -> Params:
    b = shape[0]
    return {
        "bright_gate": _gate(generator, b, 0.5),
        "bright": _rand(generator, (b,), *brightness_range),
        "contrast_gate": _gate(generator, b, 0.5),
        "contrast": _rand(generator, (b,), *contrast_range),
        "noise_gate": _gate(generator, b, 0.3),
        "noise": torch.randn(tuple(shape), generator=generator,
                             device=generator.device),
        "blur_gate": _gate(generator, b, 0.3),
        "blur_sigma": _rand(generator, (b,), *blur_sigma_range),
        "gate": _gate(generator, b, p),
    }


def apply_microscopy_augment(x: torch.Tensor, params: Params,
                             noise_std: float = 0.02,
                             blur_sigma_range=(0.0, 1.0)) -> torch.Tensor:
    """Brightness (p 0.5), contrast against the mean (0.5), noise (0.3),
    blur (0.3), clipped; the whole chain gated per image."""
    out = torch.where(_b4(params["bright_gate"]), x * _b4(params["bright"]), x)
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = torch.where(_b4(params["contrast_gate"]),
                      (out - mean) * _b4(params["contrast"]) + mean, out)
    out = torch.where(_b4(params["noise_gate"]),
                      gaussian_noise(out, params["noise"], noise_std), out)
    out = torch.where(_b4(params["blur_gate"]),
                      blend_blur(out, params["blur_sigma"],
                                 _blur_hi(blur_sigma_range)), out)
    out = torch.clamp(out, 0.0, 1.0)
    return torch.where(_b4(params["gate"]), out, x)


def microscopy_augment(x: torch.Tensor, generator: torch.Generator,
                       brightness_range=(0.8, 1.2), contrast_range=(0.8, 1.2),
                       noise_std: float = 0.02, blur_sigma_range=(0.0, 1.0),
                       p: float = 0.5) -> torch.Tensor:
    params = draw_microscopy_augment(generator, x.shape, brightness_range,
                                     contrast_range, blur_sigma_range, p)
    return apply_microscopy_augment(x, params, noise_std, blur_sigma_range)


def draw_patch_drop(generator: torch.Generator, shape, patch_size: int = 32,
                    max_patches: int = 5, p: float = 0.3) -> Params:
    b, h, w, _ = shape
    dev = generator.device
    return {
        "gate": _gate(generator, b, p),
        "n_active": torch.randint(1, max_patches + 1, (b,),
                                  generator=generator, device=dev),
        "y0": torch.randint(0, max(h - patch_size, 1), (max_patches, b),
                            generator=generator, device=dev),
        "x0": torch.randint(0, max(w - patch_size, 1), (max_patches, b),
                            generator=generator, device=dev),
    }


def apply_patch_drop(x: torch.Tensor, params: Params,
                     patch_size: int = 32) -> torch.Tensor:
    """Set up to max_patches squares (patch i while i < n_active) to their
    own per-channel mean, in turn, on the gated images."""
    b, h, w, c = x.shape
    yy = torch.arange(h, device=x.device).reshape(1, h, 1, 1)
    xx = torch.arange(w, device=x.device).reshape(1, 1, w, 1)
    out = x
    for i in range(params["y0"].shape[0]):
        y0, x0 = _b4(params["y0"][i]), _b4(params["x0"][i])
        in_patch = ((yy >= y0) & (yy < y0 + patch_size)
                    & (xx >= x0) & (xx < x0 + patch_size))
        area = in_patch.sum(dim=(1, 2), keepdim=True)
        mean_val = (out * in_patch).sum(dim=(1, 2), keepdim=True) \
            / torch.clamp(area, min=1)
        active = _b4(i < params["n_active"]) & _b4(params["gate"])
        out = torch.where(active & in_patch, mean_val, out)
    return out


def random_patch_drop(x: torch.Tensor, generator: torch.Generator,
                      patch_size: int = 32, max_patches: int = 5,
                      p: float = 0.3) -> torch.Tensor:
    return apply_patch_drop(
        x, draw_patch_drop(generator, x.shape, patch_size, max_patches, p),
        patch_size)


# ---------------------------------------------------------------- RandAugment


def _mag(m: float, lo: float, hi: float) -> float:
    """The magnitude mapping lo + (hi − lo)·m/30."""
    return lo + (hi - lo) * m / 30.0


RANDAUGMENT_OPS = ("autocontrast", "brightness", "contrast", "equalize",
                   "posterize", "rotate", "sharpness", "shear_x", "shear_y",
                   "solarize", "translate_x", "translate_y")


def randaugment_op(x: torch.Tensor, op: str, m: float,
                   fill: float = 1.0) -> torch.Tensor:
    """One of the 12 RandAugment ops at magnitude m on every image."""
    b, h, w = x.shape[:3]

    def full(v):
        return torch.full((b,), float(v), dtype=torch.float32, device=x.device)

    mag = full(_mag(m, 0.05, 1.95))
    if op == "autocontrast":
        return auto_contrast(x)
    if op == "brightness":
        return adjust_brightness(x, mag)
    if op == "contrast":
        return adjust_contrast(x, mag)
    if op == "equalize":
        return equalize(x)
    if op == "posterize":
        return posterize(x, torch.full((b,), int(_mag(m, 8, 4)),
                                       dtype=torch.int32, device=x.device))
    if op == "rotate":
        return rotate(x, full(_mag(m, -30.0, 30.0)), fill=fill, method="gather")
    if op == "sharpness":
        return adjust_sharpness(x, mag)
    s, zero = full(_mag(m, -0.3, 0.3)), full(0.0)
    if op == "shear_x":
        return shear(x, s, zero, fill=fill)
    if op == "shear_y":
        return shear(x, zero, s, fill=fill)
    if op == "solarize":
        return solarize(x, full(_mag(m, 1.0, 0.0)))
    if op == "translate_x":
        return translate(x, full(_mag(m, -0.3, 0.3) * w), zero, fill=fill)
    if op == "translate_y":
        return translate(x, zero, full(_mag(m, -0.3, 0.3) * h), fill=fill)
    raise ValueError(f"unknown RandAugment op {op!r}")


def draw_randaugment(generator: torch.Generator, b: int, n: int = 2) -> Params:
    """(n, B) op choices in [0, 12)."""
    return {"choice": torch.randint(0, len(RANDAUGMENT_OPS), (n, b),
                                    generator=generator,
                                    device=generator.device)}


def apply_randaugment(x: torch.Tensor, params: Params, m: float = 9.0,
                      fill: float = 1.0) -> torch.Tensor:
    """Each round applies the op each image chose; every op runs on the
    whole batch and the chosen result is taken per image (each op is per
    image, so this equals the per-image call)."""
    out = x
    for choice in params["choice"]:
        pick = _b4(choice)
        res = out
        for k, op in enumerate(RANDAUGMENT_OPS):
            res = torch.where(pick == k, randaugment_op(out, op, m, fill), res)
        out = res
    return torch.clamp(out, 0.0, 1.0)


def randaugment(x: torch.Tensor, generator: torch.Generator, n: int = 2,
                m: float = 9.0, fill: float = 1.0) -> torch.Tensor:
    """Grayscale-safe RandAugment over the 12-op space: `n` rounds, one op
    per image each."""
    return apply_randaugment(x, draw_randaugment(generator, x.shape[0], n),
                             m, fill)


# ---------------------------------------------- quality-aware patch augment


def compute_patch_quality(x: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """Per-patch quality (std + (1 − 2|mean − 0.5|) + variance) / 3:
    (B, H, W, C) → (B, H/ps, W/ps)."""
    b, h, w, c = x.shape
    ph, pw = h // patch_size, w // patch_size
    patches = x.reshape(b, ph, patch_size, pw, patch_size, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, -1)
    contrast = patches.std(dim=-1, correction=0)
    intensity_quality = 1.0 - 2.0 * torch.abs(patches.mean(dim=-1) - 0.5)
    local_var = patches.var(dim=-1, correction=0)
    return (contrast + intensity_quality + local_var) / 3.0


def draw_patch_quality(generator: torch.Generator, shape, patch_size: int = 16,
                       strong_aug_prob: float = 0.8,
                       patch_drop_prob: float = 0.1) -> Params:
    b, h, w, _ = shape
    ph, pw = h // patch_size, w // patch_size
    return {
        "strong": _rand(generator, (b, ph, pw)) < strong_aug_prob,
        "drop": _rand(generator, (b, ph, pw)) < patch_drop_prob,
        "aug_type": torch.randint(0, 4, (b, ph, pw), generator=generator,
                                  device=generator.device),
        "noise": torch.randn(tuple(shape), generator=generator,
                             device=generator.device),
        "bright": _rand(generator, (b,), 0.7, 1.3),
    }


def apply_patch_quality(x: torch.Tensor, params: Params, patch_size: int = 16,
                        quality_threshold: float = 0.7) -> torch.Tensor:
    """Patches of quality below the threshold are, where drawn, strongly
    augmented (noise, σ = 1 blur, brightness or contrast by their drawn
    type) or dropped to 0; clipped to [0, 1]."""
    low_q = compute_patch_quality(x, patch_size) < quality_threshold

    def up(a):
        return a.repeat_interleave(patch_size, 1) \
            .repeat_interleave(patch_size, 2)[..., None]

    aug_type = params["aug_type"]
    noise = x + params["noise"] * 0.05
    blur = gaussian_blur(x, sigma=1.0)
    bright = x * _b4(params["bright"])
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    contr = (x - mean) * 1.3 + mean
    aug = torch.where(up(aug_type == 0), noise,
                      torch.where(up(aug_type == 1), blur,
                                  torch.where(up(aug_type == 2), bright, contr)))
    out = torch.where(up(low_q & params["strong"]), aug, x)
    out = torch.where(up(low_q & params["drop"]), 0.0, out)
    return torch.clamp(out, 0.0, 1.0)


def quality_aware_patch_augment(x: torch.Tensor, generator: torch.Generator,
                                patch_size: int = 16,
                                quality_threshold: float = 0.7,
                                strong_aug_prob: float = 0.8,
                                patch_drop_prob: float = 0.1) -> torch.Tensor:
    params = draw_patch_quality(generator, x.shape, patch_size,
                                strong_aug_prob, patch_drop_prob)
    return apply_patch_quality(x, params, patch_size, quality_threshold)


# ------------------------------------------------------------ MixUp / CutMix


def _box(h: int, w: int, lam: torch.Tensor, cy: torch.Tensor,
         cx: torch.Tensor):
    """CutMix's box for λ, centred at (cy, cx): half sides floor(side ·
    √(1 − λ)) // 2, clipped to the image → (in-box mask (1, H, W, 1), λ
    corrected to the box's area)."""
    cut_rat = torch.sqrt(1.0 - lam)
    cut_h = torch.floor(h * cut_rat).to(torch.int64)
    cut_w = torch.floor(w * cut_rat).to(torch.int64)
    y1 = torch.clamp(cy - cut_h // 2, 0, h)
    y2 = torch.clamp(cy + cut_h // 2, 0, h)
    x1 = torch.clamp(cx - cut_w // 2, 0, w)
    x2 = torch.clamp(cx + cut_w // 2, 0, w)
    yy = torch.arange(h, device=lam.device).reshape(1, h, 1, 1)
    xx = torch.arange(w, device=lam.device).reshape(1, 1, w, 1)
    in_box = (yy >= y1) & (yy < y2) & (xx >= x1) & (xx < x2)
    lam_adj = 1.0 - ((x2 - x1) * (y2 - y1)).to(torch.float32) / (h * w)
    return in_box, lam_adj


def _beta_or_one(generator: torch.Generator, alpha: float) -> torch.Tensor:
    if alpha > 0:
        return beta_sample(generator, alpha)
    return torch.ones((), dtype=torch.float32, device=generator.device)


def mixup(x: torch.Tensor, labels: torch.Tensor, generator: torch.Generator,
          alpha: float = 0.8):
    """→ (λ·x + (1 − λ)·x[perm], labels, labels[perm], λ)."""
    params = {"lam_mixup": _beta_or_one(generator, alpha),
              "index": torch.randperm(x.shape[0], generator=generator,
                                      device=generator.device)}
    return apply_mixup_cutmix(x, labels, params)


def cutmix(x: torch.Tensor, labels: torch.Tensor, generator: torch.Generator,
           alpha: float = 1.0):
    """→ (x with a box from x[perm], labels, labels[perm], λ corrected to
    the realised box area)."""
    b, h, w, _ = x.shape
    dev = generator.device
    params = {"lam_cutmix": _beta_or_one(generator, alpha),
              "index": torch.randperm(b, generator=generator, device=dev),
              "cy": torch.randint(0, h, (), generator=generator, device=dev),
              "cx": torch.randint(0, w, (), generator=generator, device=dev)}
    return apply_mixup_cutmix(x, labels, params)


def draw_mixup_cutmix(generator: torch.Generator, shape,
                      mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                      prob: float = 1.0, switch_prob: float = 0.5) -> Params:
    """The batch's permutation, λ of each active mode, CutMix's box centre,
    the MixUp/CutMix switch and the apply gate (scalars as 0-d tensors)."""
    b, h, w, _ = shape
    dev = generator.device
    params: Params = {"index": torch.randperm(b, generator=generator, device=dev)}
    if mixup_alpha > 0:
        params["lam_mixup"] = beta_sample(generator, mixup_alpha)
    if cutmix_alpha > 0:
        params["lam_cutmix"] = beta_sample(generator, cutmix_alpha)
        params["cy"] = torch.randint(0, h, (), generator=generator, device=dev)
        params["cx"] = torch.randint(0, w, (), generator=generator, device=dev)
    if mixup_alpha > 0 and cutmix_alpha > 0:
        params["use_cutmix"] = _rand(generator, ()) < switch_prob
    if prob < 1.0:
        params["apply"] = _rand(generator, ()) < prob
    return params


def apply_mixup_cutmix(x: torch.Tensor, labels: torch.Tensor, params: Params):
    """→ (mixed x, labels, labels[perm], λ): MixUp, CutMix (λ corrected to
    the box), or the drawn switch between them; the apply gate keeps x and
    λ = 1 where it is off."""
    b, h, w, _ = x.shape
    index = params["index"]
    shuffled = x[index]
    lam = torch.ones((), dtype=torch.float32, device=x.device)
    mixed = x
    if "lam_mixup" in params:
        lam_m = params["lam_mixup"]
        mixed_m = lam_m * x + (1.0 - lam_m) * shuffled
        mixed, lam = mixed_m, lam_m
    if "lam_cutmix" in params:
        in_box, lam_c = _box(h, w, params["lam_cutmix"], params["cy"],
                             params["cx"])
        mixed_c = torch.where(in_box, shuffled, x)
        if "use_cutmix" in params:
            use = params["use_cutmix"]
            mixed = torch.where(use, mixed_c, mixed)
            lam = torch.where(use, lam_c, lam)
        else:
            mixed, lam = mixed_c, lam_c
    if "apply" in params:
        mixed = torch.where(params["apply"], mixed, x)
        lam = torch.where(params["apply"], lam, torch.ones_like(lam))
    return mixed, labels, labels[index], lam


def mixup_cutmix(x: torch.Tensor, labels: torch.Tensor,
                 generator: torch.Generator, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, prob: float = 1.0,
                 switch_prob: float = 0.5):
    """Batch MixUp/CutMix for the training step: one shared permutation; a
    per-batch draw picks CutMix over MixUp with `switch_prob` when both
    alphas are active; `prob` gates the whole. → (mixed_x, labels_a,
    labels_b, lam)."""
    params = draw_mixup_cutmix(generator, x.shape, mixup_alpha, cutmix_alpha,
                               prob, switch_prob)
    return apply_mixup_cutmix(x, labels, params)


# ------------------------------------------------------------ the pipelines


def draw_train_augment(generator: torch.Generator, shape,
                       level: str = "medium") -> Params:
    """The level ladder's draws for a batch of `shape` (B, H, W, C)."""
    if level == "none":
        return {}
    b = shape[0]
    heavy = level == "heavy"
    params: Params = {
        "hflip": _gate(generator, b, 0.5),
        "vflip": _gate(generator, b, 0.5),
        "angle": _rand(generator, (b,), *((-180.0, 180.0) if heavy
                                          else (-90.0, 90.0))),
    }
    if level in ("medium", "heavy"):
        params["elastic_gate"] = _gate(generator, b, 0.5 if heavy else 0.3)
        params["elastic"] = draw_elastic(generator, shape)
        rng = (0.7, 1.3) if heavy else (0.8, 1.2)
        params["microscopy"] = draw_microscopy_augment(
            generator, shape, rng, rng, p=0.7 if heavy else 0.5)
    if heavy:
        params["patch_drop"] = draw_patch_drop(generator, shape, 32, 5, 0.3)
        params["blur_gate"] = _gate(generator, b, 0.3)
        params["blur_sigma"] = _rand(generator, (b,), 0.1, 2.0)
    return params


def apply_train_augment(x: torch.Tensor, params: Params,
                        level: str = "medium",
                        rotate_method: Optional[str] = None,
                        elastic_method: Optional[str] = None) -> torch.Tensor:
    """The light/medium/heavy ladder: flips (0.5 each), rotation (±90°,
    heavy ±180°); medium and heavy add elastic deformation (p 0.3, heavy
    0.5; α 50, heavy 80; σ 5) and the microscopy chain; heavy adds patch
    drop and a (0.1, 2.0) blur (p 0.3). Clipped to [0, 1]. Any other
    level name takes the light ladder, as in the JAX package."""
    if level == "none":
        return x
    heavy = level == "heavy"
    x = hflip(x, params["hflip"])
    x = vflip(x, params["vflip"])
    x = rotate(x, params["angle"], method=rotate_method)
    if level in ("medium", "heavy"):
        warped = apply_elastic(x, params["elastic"], alpha=80.0 if heavy else 50.0,
                               sigma=5.0, method=elastic_method)
        x = torch.where(_b4(params["elastic_gate"]), warped, x)
        x = apply_microscopy_augment(x, params["microscopy"],
                                     noise_std=0.03 if heavy else 0.02)
    if heavy:
        x = apply_patch_drop(x, params["patch_drop"], 32)
        x = torch.where(_b4(params["blur_gate"]),
                        blend_blur(x, params["blur_sigma"], 2.0), x)
    return torch.clamp(x, 0.0, 1.0)


def train_augment(x: torch.Tensor, generator: torch.Generator,
                  level: str = "medium") -> torch.Tensor:
    """The augmentation ladder on a [0, 1] NHWC batch (normalisation and
    resize happen upstream in the data pipeline)."""
    return apply_train_augment(x, draw_train_augment(generator, x.shape, level),
                               level)


def draw_vit_augment(generator: torch.Generator, shape,
                     use_randaugment: bool = True,
                     use_patch_quality: bool = True, randaugment_n: int = 2,
                     patch_quality_p: float = 0.5) -> Params:
    b = shape[0]
    params: Params = {"hflip": _gate(generator, b, 0.5),
                      "vflip": _gate(generator, b, 0.5)}
    if use_randaugment:
        params["randaugment"] = draw_randaugment(generator, b, randaugment_n)
    if use_patch_quality:
        params["patch_gate"] = _gate(generator, b, patch_quality_p)
        params["patch_quality"] = draw_patch_quality(generator, shape)
    return params


def apply_vit_augment(x: torch.Tensor, params: Params,
                      randaugment_m: float = 9.0) -> torch.Tensor:
    """Flips, RandAugment(n, m) and the gated quality-aware patch
    augmentation, each present in `params` as drawn."""
    x = hflip(x, params["hflip"])
    x = vflip(x, params["vflip"])
    if "randaugment" in params:
        x = apply_randaugment(x, params["randaugment"], m=randaugment_m)
    if "patch_quality" in params:
        x = torch.where(_b4(params["patch_gate"]),
                        apply_patch_quality(x, params["patch_quality"]), x)
    return x


def vit_augment(x: torch.Tensor, generator: torch.Generator,
                use_randaugment: bool = True, use_patch_quality: bool = True,
                randaugment_n: int = 2, randaugment_m: float = 9.0,
                patch_quality_p: float = 0.5) -> torch.Tensor:
    """The ViT training augmentation: flips + RandAugment(n, m) +
    quality-aware patch augmentation, with the flags and magnitudes the
    data pipeline reads from the dataset config."""
    params = draw_vit_augment(generator, x.shape, use_randaugment,
                              use_patch_quality, randaugment_n,
                              patch_quality_p)
    return apply_vit_augment(x, params, randaugment_m)


def tta_views(x: torch.Tensor) -> List[torch.Tensor]:
    """The 5 deterministic TTA views: identity, hflip, vflip, rot90,
    rot270."""
    return [x, torch.flip(x, dims=(2,)), torch.flip(x, dims=(1,)),
            torch.rot90(x, 1, dims=(1, 2)), torch.rot90(x, 3, dims=(1, 2))]
