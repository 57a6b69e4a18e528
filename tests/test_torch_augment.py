"""The port's augmentation (thyroid_tpu_torch/ops/augment.py, ops/warp.py
and the blur, quantile and elastic parts of ops/image.py) against the JAX
package on the CPU, on numpy-seeded [0, 1] images of 4 × 32² (and 3 × 48
× 40 where a non-square image matters).

- every op on fixed parameters: the 8-bit ops, flips, brightness and
  solarize bit-equal; warps, blurs, elastic (both methods on the same
  fields), patch ops and normalisation within 1e-5;
- the composed transforms (train_augment at each level, vit_augment,
  mixup_cutmix) fed JAX's own draws (tests/torch_parity.py repeats each
  JAX function's splits and draws) within 1e-5, one 8-bit level allowed
  on at most 1e-3 of the elements; each JAX program runs once (module
  fixtures);
- the port's draws: one seed gives the same parameters, and gate rates,
  angle ranges and λ's mean and variance under Beta(α, α) hold within 5σ.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (assert_close_8bit, jax_elastic_params,
                                jax_mixup_cutmix_params,
                                jax_patch_quality_params,
                                jax_train_augment_params,
                                jax_vit_augment_params)
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu.ops import augment as JA
from thyroid_tpu.ops import image as JI
from thyroid_tpu.ops import warp as JW
from thyroid_tpu_torch.ops import augment as TA
from thyroid_tpu_torch.ops import image as TI
from thyroid_tpu_torch.ops import warp as TW

TOL = 1e-5
SHAPE = (4, 32, 32, 1)


def _images(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _both(fn_jax, fn_port, *arrays, jit=True):
    """(JAX result, port result) as numpy, the inputs as jnp and torch; the
    JAX function jitted (one compile, not one per operation) unless `jit`
    is False (XLA turns a division by a constant into a product with its
    reciprocal, one float32 rounding away from the eager division)."""
    fn = jax.jit(fn_jax) if jit else fn_jax
    want = fn(*[jnp.asarray(a) for a in arrays])
    got = fn_port(*[torch.from_numpy(np.asarray(a)) for a in arrays])
    return np.asarray(want), got.numpy()


RS = np.random.RandomState(7)
ANGLES = RS.uniform(-180, 180, 4).astype(np.float32)
FACTORS = RS.uniform(0.3, 1.9, 4).astype(np.float32)
SHX = RS.uniform(-0.3, 0.3, 4).astype(np.float32)
SHIFT = RS.uniform(-6, 6, 4).astype(np.float32)
THRESH = RS.uniform(0.2, 0.9, 4).astype(np.float32)
BITS = np.asarray([1, 4, 6, 8], np.int32)

# name: (JAX function, port function, input arrays), bit-equal results
EXACT = {
    "hflip": (lambda x, g: jnp.where(g.reshape(-1, 1, 1, 1), x[:, :, ::-1], x),
              TA.hflip, (BITS > 4,)),
    "vflip": (lambda x, g: jnp.where(g.reshape(-1, 1, 1, 1), x[:, ::-1], x),
              TA.vflip, (BITS < 7,)),
    "brightness": (JA.adjust_brightness, TA.adjust_brightness, (FACTORS,)),
    "solarize": (JA.solarize, TA.solarize, (THRESH,)),
    "posterize": (JA.posterize, TA.posterize, (BITS,)),
    "auto_contrast": (JA.auto_contrast, TA.auto_contrast, ()),
    "equalize_sort": (lambda x: JA.equalize(x, method="sort"), TA.equalize, ()),
    "equalize_onehot": (lambda x: JA.equalize(x, method="onehot"), TA.equalize, ()),
    "tta_views": (lambda x: jnp.stack(JA.tta_views(x)),
                  lambda x: torch.stack(TA.tta_views(x)), ()),
}


@pytest.mark.unit
@pytest.mark.parametrize("name", list(EXACT))
def test_ops_bit_equal(name):
    fj, ft, extra = EXACT[name]
    x = _images(1)
    # a flat image and one of two values exercise equalize's step 0 and
    # auto_contrast's hi == lo
    x[2] = 0.5
    x[3] = np.where(x[3] > 0.5, 0.75, 0.25)
    want, got = _both(fj, ft, x, *extra, jit=False)
    np.testing.assert_array_equal(got, want)


def _affine(x, m):
    return JA.affine_warp(x, m, fill=0.3)


MATS = np.stack([np.asarray([[1.1, 0.2, 1.5], [-0.1, 0.9, -2.0]], np.float32),
                 np.asarray([[0.7, -0.7, 0.0], [0.7, 0.7, 0.0]], np.float32),
                 np.eye(2, 3, dtype=np.float32),
                 np.asarray([[-1.0, 0.0, 0.5], [0.0, 1.2, 0.0]], np.float32)])

# name: (JAX function, port function, input arrays), within TOL
CLOSE = {
    "affine_warp": (_affine, lambda x, m: TA.affine_warp(x, m, fill=0.3), (MATS,)),
    "rotate_gather": (lambda x, a: JA.rotate(x, a, fill=0.2, method="gather"),
                      lambda x, a: TA.rotate(x, a, fill=0.2), (ANGLES,)),
    "rotate_shear3": (lambda x, a: JA.rotate(x, a, method="shear3"),
                      lambda x, a: TA.rotate(x, a, method="shear3"), (ANGLES,)),
    "shear": (lambda x, s: JA.shear(x, s, -s[::-1], fill=1.0),
              lambda x, s: TA.shear(x, s, -s.flip(0), fill=1.0), (SHX,)),
    "translate": (lambda x, t: JA.translate(x, t, -t[::-1], fill=1.0),
                  lambda x, t: TA.translate(x, t, -t.flip(0), fill=1.0), (SHIFT,)),
    "shear_x_fast": (lambda x, s: JW.shear_x_fast(x, s, fill=0.0),
                     lambda x, s: TW.shear_x_fast(x, s, fill=0.0), (SHX,)),
    "shear_y_fast": (lambda x, s: JW.shear_y_fast(x, s, fill=None, max_shift=6),
                     lambda x, s: TW.shear_y_fast(x, s, fill=None, max_shift=6),
                     (SHX,)),
    "contrast": (JA.adjust_contrast, TA.adjust_contrast, (FACTORS,)),
    "sharpness": (JA.adjust_sharpness, TA.adjust_sharpness, (FACTORS,)),
    "blur_sigma1": (lambda x: JI.gaussian_blur(x, 1.0),
                    lambda x: TI.gaussian_blur(x, 1.0), ()),
    "blur_sigma5": (lambda x: JI.gaussian_blur(x, 5.0),
                    lambda x: TI.gaussian_blur(x, 5.0), ()),
    "patch_quality": (JA.compute_patch_quality, TA.compute_patch_quality, ()),
    "microscopy_normalize": (lambda x: JA.microscopy_normalize(x * 60000.0),
                             lambda x: TA.microscopy_normalize(x * 60000.0), ()),
    "microscopy_normalize_range": (
        lambda x: JA.microscopy_normalize(x * 60000.0, clip_percentile=None,
                                          output_range=(-1.0, 1.0)),
        lambda x: TA.microscopy_normalize(x * 60000.0, clip_percentile=None,
                                          output_range=(-1.0, 1.0)), ()),
    "per_image_quantile": (lambda x: JI.per_image_quantile(x, 0.37),
                           lambda x: TI.per_image_quantile(x, 0.37), ()),
    "anscombe": (JI.anscombe, TI.anscombe, ()),
    "inverse_anscombe": (lambda x: JI.inverse_anscombe(x + 1.3),
                         lambda x: TI.inverse_anscombe(x + 1.3), ()),
}


@pytest.mark.unit
@pytest.mark.parametrize("name", list(CLOSE))
def test_ops_close(name):
    fj, ft, extra = CLOSE[name]
    want, got = _both(fj, ft, _images(2), *extra)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.unit
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("per", ["image", "row", "pixel"])
def test_shift_axis_bilinear(axis, per):
    """Per-image, per-row and per-pixel shifts (the taps method; the tree
    method where the shifts are constant along the axis, bit-equal to the
    taps), with and without the validity fill, on a 48 × 40 image."""
    x = _images(3, (3, 48, 40, 2))
    rs = np.random.RandomState(4)
    shape = {"image": (3, 1, 1), "pixel": (3, 48, 40),
             "row": (3, 48, 1) if axis == 2 else (3, 1, 40)}[per]
    shifts = rs.uniform(-7, 7, shape).astype(np.float32)
    methods = ["taps"] + (["tree"] if per != "pixel" else [])
    outs = []
    for method in methods:
        for fill in (None, 0.25):
            want = jax.jit(lambda x, s: JW.shift_axis_bilinear(
                x, s, axis, 5, valid_fill=fill, method=method))(
                    jnp.asarray(x), jnp.asarray(shifts))
            got = TW.shift_axis_bilinear(torch.from_numpy(x),
                                         torch.from_numpy(shifts), axis, 5,
                                         valid_fill=fill, method=method)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                       rtol=0)
            outs.append(got)
    if len(methods) == 2:
        assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    if per == "pixel":
        with pytest.raises(ValueError, match="tree"):
            TW.shift_axis_bilinear(torch.from_numpy(x), torch.from_numpy(shifts),
                                   axis, 5, method="tree")


@pytest.mark.unit
@pytest.mark.parametrize("method", ["gather", "separable"])
def test_elastic_deform_same_fields(method):
    """Both methods on the fields JAX draws from one key, and
    elastic_separable itself on blurred fields."""
    x = _images(5)
    key = jax.random.PRNGKey(11)
    params = {k: torch.from_numpy(np.array(v))
              for k, v in jax_elastic_params(key, SHAPE).items()}
    want = jax.jit(lambda x, k: JI.elastic_deform(
        x, k, alpha=50.0, sigma=5.0, method=method))(jnp.asarray(x), key)
    got = TI.apply_elastic(torch.from_numpy(x), params, 50.0, 5.0, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    dy = np.random.RandomState(6).uniform(-4, 4, (4, 32, 32)).astype(np.float32)
    dx = -dy[:, ::-1].copy()
    want = jax.jit(lambda *a: JW.elastic_separable(*a, 4))(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(dx))
    got = TW.elastic_separable(torch.from_numpy(x), torch.from_numpy(dy),
                               torch.from_numpy(dx), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.unit
def test_patch_drop_and_quality_augment_on_jax_draws():
    """random_patch_drop (48² images, 16-pixel patches, 2 channels) and
    quality_aware_patch_augment on the draws JAX makes from their keys."""
    from tests.torch_parity import _jax_patch_drop, _torch_tree

    x = _images(8, (3, 48, 48, 2))
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda x, k: JA.random_patch_drop(
        x, k, patch_size=16, max_patches=4, p=0.9))(jnp.asarray(x), key)
    params = _torch_tree(_jax_patch_drop(key, x.shape, 16, 4, 0.9))
    got = TA.apply_patch_drop(torch.from_numpy(x), params, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert not np.array_equal(got.numpy(), x)
    x = _images(9, (3, 48, 48, 1)) * 0.6
    want = jax.jit(JA.quality_aware_patch_augment)(jnp.asarray(x), key)
    params = _torch_tree(jax_patch_quality_params(key, x.shape))
    got = TA.apply_patch_quality(torch.from_numpy(x), params)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.unit
@pytest.mark.parametrize("op", TA.RANDAUGMENT_OPS)
def test_randaugment_ops(op):
    """Each RandAugment op at m = 9, fill 1.0, against JAX's branch on each
    image alone (as its switch calls it)."""
    x = _images(12)
    choice = TA.RANDAUGMENT_OPS.index(op)
    got = TA.apply_randaugment(torch.from_numpy(x),
                               {"choice": torch.full((1, 4), choice)}, m=9.0)
    want = np.clip(np.asarray(jax.jit(lambda x: _jax_randaugment_op(x, op))(
        jnp.asarray(x))), 0, 1)
    assert_close_8bit(got.numpy(), want)


def _jax_randaugment_op(x, op):
    m = 9.0
    mag = JA._mag(m, 0.05, 1.95)
    b, h, w = x.shape[:3]
    full = lambda v: jnp.full((b,), v)
    s = full(JA._mag(m, -0.3, 0.3))
    return {
        "autocontrast": lambda: JA.auto_contrast(x),
        "brightness": lambda: JA.adjust_brightness(x, full(mag)),
        "contrast": lambda: JA.adjust_contrast(x, full(mag)),
        "equalize": lambda: JA.equalize(x, method="sort"),
        "posterize": lambda: JA.posterize(x, full(int(JA._mag(m, 8, 4)))),
        "rotate": lambda: JA.rotate(x, full(JA._mag(m, -30.0, 30.0)), fill=1.0,
                                    method="gather"),
        "sharpness": lambda: JA.adjust_sharpness(x, full(mag)),
        "shear_x": lambda: JA.shear(x, s, jnp.zeros_like(s), fill=1.0),
        "shear_y": lambda: JA.shear(x, jnp.zeros_like(s), s, fill=1.0),
        "solarize": lambda: JA.solarize(x, full(JA._mag(m, 1.0, 0.0))),
        "translate_x": lambda: JA.translate(x, s * w, jnp.zeros_like(s), fill=1.0),
        "translate_y": lambda: JA.translate(x, jnp.zeros_like(s), s * h, fill=1.0),
    }[op]()


# ------------------------------------------------------ composed transforms

LEVELS = ("light", "medium", "heavy")


@pytest.fixture(scope="module")
def composed():
    """{case: (JAX output, port output on JAX's draws)}: each jitted JAX
    program runs once."""
    x = _images(20)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    out = {}
    for i, level in enumerate(LEVELS):
        key = jax.random.PRNGKey(100 + i)
        want = JA.train_augment(xj, key, level=level)
        got = TA.apply_train_augment(
            xt, jax_train_augment_params(key, SHAPE, level), level)
        out[level] = (np.asarray(want), got.numpy())
    key = jax.random.PRNGKey(7)
    want = JA.vit_augment(xj, key)
    got = TA.apply_vit_augment(xt, jax_vit_augment_params(key, SHAPE))
    out["vit"] = (np.asarray(want), got.numpy())
    labels = np.arange(4, dtype=np.int32)
    for name, (ma, ca, prob, seed) in {"mixup_cutmix": (0.8, 1.0, 1.0, 3),
                                       "mixup_cutmix_seed2": (0.8, 1.0, 1.0, 4),
                                       "cutmix_gated": (0.0, 1.0, 0.5, 1)}.items():
        key = jax.random.PRNGKey(seed)
        wx, wa, wb, wl = JA.mixup_cutmix(xj, jnp.asarray(labels), key,
                                         mixup_alpha=ma, cutmix_alpha=ca,
                                         prob=prob)
        params = jax_mixup_cutmix_params(key, SHAPE, ma, ca, prob)
        gx, ga, gb, gl = TA.apply_mixup_cutmix(xt, torch.from_numpy(labels),
                                               params)
        out[name] = ((np.asarray(wx), np.asarray(wa), np.asarray(wb),
                      float(wl)),
                     (gx.numpy(), ga.numpy(), gb.numpy(), float(gl)))
    return x, out


@pytest.mark.unit
@pytest.mark.parametrize("case", [*LEVELS, "vit"])
def test_composed_on_jax_draws(composed, case):
    x, out = composed
    want, got = out[case]
    assert_close_8bit(got, want)
    assert not np.allclose(got, x, atol=1e-3)      # the draws did something


@pytest.mark.unit
@pytest.mark.parametrize("case", ["mixup_cutmix", "mixup_cutmix_seed2",
                                  "cutmix_gated"])
def test_mixup_cutmix_on_jax_draws(composed, case):
    _, out = composed
    (wx, wa, wb, wl), (gx, ga, gb, gl) = out[case]
    np.testing.assert_allclose(gx, wx, atol=TOL, rtol=0)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gb, wb)
    assert abs(gl - wl) <= 1e-6, (gl, wl)


@pytest.mark.unit
@pytest.mark.parametrize("fn", ["mixup", "cutmix"])
def test_standalone_mixup_cutmix_on_jax_draws(fn):
    """JAX's standalone mixup (λ from the key's first half, the permutation
    from its second) and cutmix (λ, permutation, box centre from four
    halves) against the port's arithmetic on those draws; λ and the
    labels exact."""
    x = _images(21)
    labels = np.arange(4, dtype=np.int32)
    key = jax.random.PRNGKey(9)
    want = getattr(JA, fn)(jnp.asarray(x), jnp.asarray(labels), key)
    if fn == "mixup":
        k1, k2 = jax.random.split(key)
        params = {"lam_mixup": jax.random.beta(k1, 0.8, 0.8),
                  "index": jax.random.permutation(k2, 4)}
    else:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        params = {"lam_cutmix": jax.random.beta(k1, 1.0, 1.0),
                  "index": jax.random.permutation(k2, 4),
                  "cy": jax.random.randint(k3, (), 0, 32),
                  "cx": jax.random.randint(k4, (), 0, 32)}
    params = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    got = TA.apply_mixup_cutmix(torch.from_numpy(x), torch.from_numpy(labels),
                                params)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL,
                               rtol=0)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert abs(float(got[3]) - float(want[3])) <= 1e-6


@pytest.mark.unit
def test_level_none_and_unknown():
    """Level none returns the batch; a level of another name takes the
    light ladder, as JAX's train_augment does."""
    x = torch.from_numpy(_images(0))
    assert TA.train_augment(x, torch.Generator().manual_seed(0), "none") is x
    assert torch.equal(TA.train_augment(x, torch.Generator().manual_seed(0),
                                        "extreme"),
                       TA.train_augment(x, torch.Generator().manual_seed(0),
                                        "light"))


# ------------------------------------------------------------------ draws


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


DRAWS = {
    "light": lambda g: TA.draw_train_augment(g, SHAPE, "light"),
    "medium": lambda g: TA.draw_train_augment(g, SHAPE, "medium"),
    "heavy": lambda g: TA.draw_train_augment(g, SHAPE, "heavy"),
    "vit": lambda g: TA.draw_vit_augment(g, SHAPE),
    "mixup_cutmix": lambda g: TA.draw_mixup_cutmix(g, SHAPE, 0.8, 1.0, 0.7),
}


@pytest.mark.unit
@pytest.mark.parametrize("case", list(DRAWS))
def test_draws_follow_the_seed(case):
    """One seed, the same parameters (and the structure JAX's mirror
    gives); another seed, others."""
    a = _flat(DRAWS[case](torch.Generator().manual_seed(5)))
    b = _flat(DRAWS[case](torch.Generator().manual_seed(5)))
    c = _flat(DRAWS[case](torch.Generator().manual_seed(6)))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    key = jax.random.PRNGKey(0)
    mirror = {"light": lambda: jax_train_augment_params(key, SHAPE, "light"),
              "medium": lambda: jax_train_augment_params(key, SHAPE, "medium"),
              "heavy": lambda: jax_train_augment_params(key, SHAPE, "heavy"),
              "vit": lambda: jax_vit_augment_params(key, SHAPE),
              "mixup_cutmix": lambda: jax_mixup_cutmix_params(key, SHAPE, 0.8,
                                                              1.0, 0.7)}[case]()
    mirror = _flat(mirror)
    assert set(mirror) == set(a)
    assert all(tuple(mirror[k].shape) == tuple(a[k].shape) for k in a)


def _within_5_sigma(mean, want, var, n):
    assert abs(mean - want) <= 5 * math.sqrt(var / n), (mean, want)


@pytest.mark.unit
@pytest.mark.parametrize("level", LEVELS)
def test_ladder_gate_rates_and_ranges(level):
    """Over 20,000 images: the flip gates at 0.5, the elastic gate at 0.3
    (heavy 0.5), angles inside ±90° (heavy ±180°) with mean 0 and variance
    deg²/3."""
    n = 20_000
    p = TA.draw_train_augment(torch.Generator().manual_seed(1), (n, 8, 8, 1),
                              level)
    for k in ("hflip", "vflip"):
        _within_5_sigma(p[k].float().mean().item(), 0.5, 0.25, n)
    deg = 180.0 if level == "heavy" else 90.0
    a = p["angle"]
    assert a.min() >= -deg and a.max() < deg
    _within_5_sigma(a.mean().item(), 0.0, deg * deg / 3, n)
    if level != "light":
        q = 0.5 if level == "heavy" else 0.3
        _within_5_sigma(p["elastic_gate"].float().mean().item(), q, q * (1 - q), n)
        mic = p["microscopy"]
        q = 0.7 if level == "heavy" else 0.5
        _within_5_sigma(mic["gate"].float().mean().item(), q, q * (1 - q), n)
        _within_5_sigma(mic["noise"].mean().item(), 0.0, 1.0, mic["noise"].numel())
    if level == "heavy":
        s = p["blur_sigma"]
        assert s.min() >= 0.1 and s.max() < 2.0
        n_act = p["patch_drop"]["n_active"]
        assert n_act.min() == 1 and n_act.max() == 5


@pytest.mark.unit
@pytest.mark.parametrize("alpha", [0.8, 1.0, 2.5])
def test_beta_lambda_moments(alpha):
    """λ ~ Beta(α, α) from the explicit generator: mean 1/2 and variance
    1/(4(2α + 1)) within 5σ over 3,000 draws, all in (0, 1); the global
    RNG is not touched."""
    n = 3000
    torch.manual_seed(0)
    before = torch.get_rng_state()
    g = torch.Generator().manual_seed(2)
    lam = torch.stack([TA.beta_sample(g, alpha) for _ in range(n)]).double()
    assert torch.equal(torch.get_rng_state(), before)
    assert lam.min() > 0 and lam.max() < 1
    var = 1 / (4 * (2 * alpha + 1))
    _within_5_sigma(lam.mean().item(), 0.5, var, n)
    # the sample variance's own variance: (μ4 − σ⁴)/n, μ4 of Beta(α, α)
    mu4 = 3 * var ** 2 * (2 * alpha + 1) / (2 * alpha + 3)
    _within_5_sigma(lam.var().item(), var, mu4 - var ** 2, n)


@pytest.mark.unit
def test_vit_and_mixup_draw_rates():
    n = 20_000
    g = torch.Generator().manual_seed(3)
    p = TA.draw_vit_augment(g, (n, 32, 32, 1))
    _within_5_sigma(p["patch_gate"].float().mean().item(), 0.5, 0.25, n)
    choice = p["randaugment"]["choice"]
    assert choice.shape == (2, n) and choice.min() == 0 and choice.max() == 11
    pq = p["patch_quality"]
    m = pq["strong"].numel()
    _within_5_sigma(pq["strong"].float().mean().item(), 0.8, 0.16, m)
    _within_5_sigma(pq["drop"].float().mean().item(), 0.1, 0.09, m)
    b = pq["bright"]
    assert b.min() >= 0.7 and b.max() < 1.3
    uses = [TA.draw_mixup_cutmix(g, (8, 32, 32, 1), 0.8, 1.0, 0.6)
            for _ in range(2000)]
    _within_5_sigma(np.mean([u["use_cutmix"].item() for u in uses]), 0.5,
                    0.25, 2000)
    _within_5_sigma(np.mean([u["apply"].item() for u in uses]), 0.6, 0.24, 2000)
    assert all(sorted(u["index"].tolist()) == list(range(8)) for u in uses[:50])


@pytest.mark.unit
def test_public_functions_draw_and_apply():
    """Each public function is apply(x, draw(generator)): the same seed
    gives the same output as drawing and applying by hand; the standalone
    mixup and cutmix return a permutation's labels and λ in [0, 1]."""
    x = torch.from_numpy(_images(30))
    labels = torch.arange(4)
    for fn, draw, apply in (
            (lambda g: TA.train_augment(x, g, "heavy"),
             lambda g: TA.draw_train_augment(g, x.shape, "heavy"),
             lambda p: TA.apply_train_augment(x, p, "heavy")),
            (lambda g: TA.vit_augment(x, g),
             lambda g: TA.draw_vit_augment(g, x.shape),
             lambda p: TA.apply_vit_augment(x, p)),
            (lambda g: TI.elastic_deform(x, g, 30.0, 4.0),
             lambda g: TI.draw_elastic(g, x.shape),
             lambda p: TI.apply_elastic(x, p, 30.0, 4.0))):
        assert torch.equal(fn(torch.Generator().manual_seed(9)),
                           apply(draw(torch.Generator().manual_seed(9))))
    g = torch.Generator().manual_seed(4)
    for fn in (TA.mixup, TA.cutmix):
        mixed, la, lb, lam = fn(x, labels, g)
        assert torch.equal(la, labels) and sorted(lb.tolist()) == [0, 1, 2, 3]
        assert 0 <= float(lam) <= 1 and mixed.shape == x.shape
    for fn in (TA.random_hflip, TA.random_vflip, TA.random_rotation,
               TA.random_blur, TA.microscopy_augment, TA.random_patch_drop,
               TA.randaugment, TA.quality_aware_patch_augment):
        y = fn(x, torch.Generator().manual_seed(1))
        assert y.shape == x.shape and bool(torch.isfinite(y).all())
        assert torch.equal(y, fn(x, torch.Generator().manual_seed(1)))
    moved = TA.params_to(TA.draw_vit_augment(g, x.shape), "cpu")
    assert moved["randaugment"]["choice"].device.type == "cpu"
