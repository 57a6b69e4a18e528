"""The port's quality-aware preprocessing (thyroid_tpu_torch.ops.quality and
the modules under it) against the JAX package on the same inputs, on the
CPU, where each port wrapper runs its plain version.

Tolerances, with their reasons:
- the statistics kernel: quantile, max and min bit-equal (the same
  bisection brackets, exact counts); mean and std rtol 1e-5, the JAX
  kernel test's bound (summation order);
- the stencil: median bit-equal (the same comparator network); bilateral
  below 1e-2 grey levels, the JAX kernel test's bound (exp and tap order);
- the CLAHE apply: bit-equal to the JAX gather formulation, below 1e-4 of
  the Pallas quadrant kernels, as test_pallas_equals_gather_path;
- CLAHE on the uint16 scale, the whole quality pipeline (merged and
  classic) and its branches: bit-equal; the port rounds each step as the
  compiled JAX program does (see ops/clahe.py `_uint16_roundtrip` and
  ops/quality.py), so no rounding flip is allowed;
- prepare_images and the serving engine: 1e-5 on [0, 1] images and on
  probabilities, the port's existing preprocessing and serving bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import SMALL_SWIN, jax_swin
from thyroid_tpu.data import synthetic as jsyn
from thyroid_tpu.ops import clahe as jclahe
from thyroid_tpu.ops import image as jimg
from thyroid_tpu.ops import quality as jquality
from thyroid_tpu.ops.percentile import fused_stats_quantile as jax_stats
from thyroid_tpu.ops.stencil import fused_median_bilateral as jax_stencil
from thyroid_tpu_torch.data import synthetic as tsyn
from thyroid_tpu_torch.data.pipeline import prepare_images
from thyroid_tpu_torch.ops import clahe as tclahe
from thyroid_tpu_torch.ops import image as timg
from thyroid_tpu_torch.ops import quality as tquality
from thyroid_tpu_torch.ops.percentile import (fused_stats_quantile,
                                              stats_quantile_plain)
from thyroid_tpu_torch.ops.stencil import (fused_median_bilateral,
                                           median_bilateral_plain)

RS = np.random.RandomState(33)
SIDE = 64
COUNTED = (fused_stats_quantile, fused_median_bilateral, tclahe.apply_luts,
           tclahe.apply_luts_dual)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _kind(frame):
    """The quality branch a (H, W) uint16-scale frame takes, by the port's
    masks: "extreme_dark", "low_contrast", "artifacts" or "clean"."""
    masks = timg.quality_issue_masks(_t(frame[None, ..., None].astype(np.float32)))
    for k in ("extreme_dark", "low_contrast", "artifacts"):
        if bool(masks[k][0]):
            return k
    return "clean"


def _quality_batch():
    """(11, 64, 64, 1) frames hitting every branch: two synthetic frames of
    each kind (seeds found by scanning), and three crafted ones: a bright
    4×4 block that keeps a median above 250 (the bilateral select), a flat
    frame (span 0: CLAHE passes it through) and a dim frame with two spikes
    whose 8-bit artifact frame is all 0 (darkened below 0.1×: the guard
    blends it back)."""
    picked = {"extreme_dark": [], "low_contrast": [], "artifacts": [],
              "clean": []}
    seed = 0
    while min(len(v) for v in picked.values()) < 2:
        frame = tsyn.generate_image(seed, seed % 2, SIDE)
        if len(picked[_kind(frame)]) < 2:
            picked[_kind(frame)].append(frame.astype(np.float32))
        seed += 1
    block = np.floor(RS.rand(SIDE, SIDE) * 1500).astype(np.float32)
    block[20:24, 30:34] = 65535.0
    flat = np.full((SIDE, SIDE), 4321.0, np.float32)
    dim = np.floor(RS.rand(SIDE, SIDE) * 200 + 20).astype(np.float32)
    dim[5, 5], dim[40, 7] = 60000.0, 50000.0
    frames = [f for v in picked.values() for f in v]
    return np.stack(frames + [block, flat, dim])[..., None]


@pytest.fixture(scope="module")
def batch():
    return _quality_batch()


# ---------------------------------------------------------------- synthetic


@pytest.mark.unit
@pytest.mark.parametrize("seed,label,size,difficulty,noise", [
    (0, 0, 64, 0.0, 0.0), (7, 1, 96, 0.6, 0.0), (1_000_003, 1, 64, 0.3, 0.2),
    (42, 0, 512, 0.0, 0.0)])
def test_generate_image_bit_equal(seed, label, size, difficulty, noise):
    want = jsyn.generate_image(seed, label, size, difficulty, noise)
    got = tsyn.generate_image(seed, label, size, difficulty, noise)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


@pytest.mark.unit
def test_generate_corpus_arrays_bit_equal():
    assert tsyn.QUALITY_MIX == jsyn.QUALITY_MIX
    for args in ((5, 32, 3, 0.5, 0.1), (4, 48, 42, 0.0, 0.0)):
        (gi, gl), (wi, wl) = tsyn.generate_corpus_arrays(*args), \
            jsyn.generate_corpus_arrays(*args)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gl.dtype == wl.dtype


# ---------------------------------------------------------------- image ops


@pytest.mark.unit
def test_gamma_stats_and_masks(batch):
    x = batch
    np.testing.assert_array_equal(
        timg.gamma_correct(_t(x), 0.8).numpy(),
        np.asarray(jimg.gamma_correct(jnp.asarray(x), 0.8)))
    got = {k: v.numpy() for k, v in timg.quality_stats(_t(x)).items()}
    want = _np(jimg.quality_stats(jnp.asarray(x)))
    for k in ("max", "min"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    got = timg.quality_issue_masks(_t(x))
    want = _np(jimg.quality_issue_masks(jnp.asarray(x)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.unit
@pytest.mark.parametrize("gamma", [0.8, 0.5])
def test_gamma_all_uint16_values(gamma):
    """Every integer input of the uint16 scale (the pipeline's frames are
    integer valued), bit-equal to the JAX program's float32 power."""
    x = np.arange(65536, dtype=np.float32).reshape(1, 256, 256, 1)
    np.testing.assert_array_equal(
        timg.gamma_correct(_t(x), gamma).numpy(),
        np.asarray(jimg.gamma_correct(jnp.asarray(x), gamma)))


@pytest.mark.unit
def test_suppress_artifacts(batch):
    """Both branches of the bilateral select (the block frame keeps a
    median above 250). Against the JAX function jitted alone, which sums
    the bilateral's taps in float32 in order, a flat region of some values
    (3, 6, 7, 255, …) comes out just below its value and floors one grey
    level (256) lower; the port's float64 sum gives the value, as the JAX
    quality program does (test_quality_preprocess holds that bit-equal)."""
    x = batch
    got = timg.suppress_artifacts(_t(x)).numpy()
    want = np.asarray(jimg.suppress_artifacts(jnp.asarray(x)))
    diff = got - want
    assert set(np.unique(diff)) <= {0.0, 256.0}
    bilateral = np.zeros(len(x), bool)
    med = timg.median_filter_3x3(torch.floor(_t(x) / 256.0))
    bilateral[(med.reshape(len(x), -1).amax(1) > 250).numpy()] = True
    assert bilateral.any()
    assert not diff[~bilateral].any()       # the median branch is exact


# ---------------------------------------------------------------- kernel 12


@pytest.mark.unit
@pytest.mark.parametrize("shape", [(4, 64, 64, 1), (2, 31, 33, 1)])
def test_fused_stats_quantile(shape):
    x = (RS.rand(*shape) * 65535).astype(np.float32)
    x[0, 0, 0] = 65535.0
    got = {k: v.numpy() for k, v in fused_stats_quantile(_t(x), 0.999).items()}
    kernel = _np(jax_stats(jnp.asarray(x), q=0.999, interpret=True))
    xla = _np(jimg.quality_stats(jnp.asarray(x)))
    xla["quantile"] = np.asarray(
        jimg.per_image_quantile_fast(jnp.asarray(x), 0.999)).ravel()
    for want in (kernel, xla):
        for k in ("quantile", "max", "min"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("mean", "std"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    plain = stats_quantile_plain(_t(x), 0.999)
    for k, v in plain.items():
        np.testing.assert_array_equal(v.numpy(), got[k])


# ---------------------------------------------------------------- kernel 13


@pytest.mark.unit
@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (1, 37, 29, 1)])
def test_fused_median_bilateral(shape):
    """Random 8-bit frames: structure at every border and corner, where the
    median's edge replication and the bilateral's reflect-101 differ."""
    x8 = np.floor(RS.rand(*shape) * 256).astype(np.float32)
    med, bil = fused_median_bilateral(_t(x8))
    plain_med, plain_bil = median_bilateral_plain(_t(x8))
    np.testing.assert_array_equal(med.numpy(), plain_med.numpy())
    np.testing.assert_array_equal(bil.numpy(), plain_bil.numpy())
    k_med, k_bil = jax_stencil(jnp.asarray(x8), interpret=True)
    x_med = jimg.median_filter_3x3(jnp.asarray(x8))
    x_bil = jimg.bilateral_filter(x_med)
    for want_med, want_bil in ((k_med, k_bil), (x_med, x_bil)):
        np.testing.assert_array_equal(med.numpy(), np.asarray(want_med))
        assert np.abs(bil.numpy() - np.asarray(want_bil)).max() < 1e-2


@pytest.mark.unit
def test_bilateral_flat_regions_exact():
    """A flat region's bilateral is its value, exactly (float64 sums); the
    JAX float32 sum is within its 1e-2 bound of it."""
    x8 = np.repeat(np.arange(256, dtype=np.float32), 36).reshape(256, 6, 6, 1)
    got = timg.bilateral_filter(_t(x8)).numpy()
    np.testing.assert_array_equal(got, x8)
    want = np.asarray(jimg.bilateral_filter(jnp.asarray(x8)))
    assert np.abs(got - want).max() < 1e-2


@pytest.mark.unit
def test_stencil_rejects_even_d():
    with pytest.raises(ValueError, match="odd d"):
        timg.bilateral_filter(torch.zeros(1, 8, 8, 1), d=4)


# ---------------------------------------------------------------- kernels 14, 15


def _x8_luts(b, h, w, grid):
    x8 = np.floor(RS.rand(b, h, w) * 256).astype(np.float32)
    luts = np.floor(RS.rand(b, grid[0], grid[1], 256) * 256).astype(np.float32)
    return x8, luts


@pytest.mark.unit
@pytest.mark.parametrize("h,w,grid", [(64, 64, (8, 8)), (56, 70, (8, 7)),
                                      (64, 48, (4, 6)), (60, 60, (4, 4))])
def test_interp_luts_exact(h, w, grid):
    """The gather formulation, bit-equal at even and odd tile sides to JAX's
    as every caller in the JAX package runs it: compiled under jit, where
    XLA rounds the tile coordinates and the blend otherwise than eager
    operations do (see ops/clahe.py `_blend_coords` and `_lerp`)."""
    x8, luts = _x8_luts(2, h, w, grid)
    got = tclahe.apply_luts(_t(x8), _t(luts), grid).numpy()
    np.testing.assert_array_equal(got, tclahe._interp_luts(_t(x8), _t(luts),
                                                           grid).numpy())
    want = np.asarray(jax.jit(jclahe._interp_luts, static_argnames="grid")(
        jnp.asarray(x8), jnp.asarray(luts), grid))
    np.testing.assert_array_equal(got, want)


@pytest.mark.unit
@pytest.mark.parametrize("grid", [(8, 8), (4, 8), (16, 16)])
def test_interp_luts_pallas(grid):
    x8, luts = _x8_luts(2, 64, 64, grid)
    got = tclahe.apply_luts(_t(x8), _t(luts), grid).numpy()
    want = np.asarray(jclahe._interp_luts_pallas(
        jnp.asarray(x8), jnp.asarray(luts), grid, interpret=True))
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.unit
def test_interp_luts_pallas_dual():
    x8, luts_f = _x8_luts(4, 64, 64, (16, 16))
    luts_c = np.floor(RS.rand(4, 8, 8, 256) * 256).astype(np.float32)
    sel = np.array([True, False, False, True])
    got = tclahe.apply_luts_dual(_t(x8), _t(luts_c), _t(luts_f), _t(sel),
                                 (8, 8), (16, 16)).numpy()
    want = np.asarray(jclahe._interp_luts_pallas_dual(
        jnp.asarray(x8), jnp.asarray(luts_c), jnp.asarray(luts_f),
        jnp.asarray(sel), (8, 8), (16, 16), interpret=True))
    assert np.abs(got - want).max() < 1e-4
    for i in range(4):
        np.testing.assert_array_equal(got[i], tclahe.apply_luts(
            _t(x8[i:i + 1]), _t((luts_c if sel[i] else luts_f)[i:i + 1]),
            (8, 8) if sel[i] else (16, 16)).numpy()[0])


# ---------------------------------------------------------------- CLAHE


@pytest.mark.unit
@pytest.mark.parametrize("grid,clip", [((8, 8), 2.0), ((4, 8), 0.03),
                                       ((16, 16), 0.5)])
def test_hists_and_luts(grid, clip):
    x8 = np.floor(RS.rand(2, 64, 64) * 256).astype(np.float32)
    x8[1, :, :20] = 17.0                        # a tile far over the clip
    hist = tclahe._tile_hists(_t(x8), grid)
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(jclahe._tile_hists(jnp.asarray(x8), grid)))
    area = (64 // grid[0]) * (64 // grid[1])
    np.testing.assert_array_equal(
        tclahe._luts_from_hists(hist, area, clip).numpy(),
        np.asarray(jclahe._luts_from_hists(jnp.asarray(hist.numpy()), area,
                                           clip)))


@pytest.mark.unit
def test_clahe_uint16_and_dual():
    """The uint16 round trip, single grid and dual, including a flat frame
    (span 0, pass-through) and a frame spanning the whole uint16 range. Its
    own RandomState: its frames do not depend on which tests ran before it
    in the process."""
    x = (np.random.RandomState(33).rand(4, 64, 64, 1) * 65535) \
        .astype(np.float32)
    x[1] = 1234.0
    x[2, 0, 0], x[2, 1, 1] = 0.0, 65535.0
    x = np.floor(x)
    for grid, clip in (((16, 16), 2.0), ((32, 32), 0.03)):
        np.testing.assert_array_equal(
            tclahe.clahe_uint16(_t(x), clip, grid).numpy(),
            np.asarray(jclahe.clahe_uint16(jnp.asarray(x), clip, grid)))
    sel = np.array([True, False, False, True])
    got = tclahe.clahe_uint16_dual(_t(x), _t(sel), 2.0, (16, 16), 0.03,
                                   (32, 32)).numpy()
    want = np.asarray(jclahe.clahe_uint16_dual(
        jnp.asarray(x), jnp.asarray(sel), clip_coarse=2.0,
        grid_coarse=(16, 16), clip_fine=0.03, grid_fine=(32, 32)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], x[1])
    with pytest.raises(ValueError, match="grid_fine"):
        tclahe.clahe_8bit_dual(torch.zeros(1, 64, 64), torch.zeros(1, dtype=bool),
                               2.0, (8, 8), 0.03, (24, 24))
    with pytest.raises(ValueError, match="not divisible"):
        tclahe.clahe_uint16(torch.zeros(1, 60, 64, 1), 2.0, (16, 16))


# ---------------------------------------------------------------- pipeline


@pytest.mark.unit
@pytest.mark.parametrize("merged", [None, False])
def test_quality_preprocess(batch, merged):
    """Every branch fires, and the output is bit-equal to the JAX
    pipeline's; on CPU tensors no kernel launches."""
    masks = _np(jimg.quality_issue_masks(jnp.asarray(batch)))
    for k in ("extreme_dark", "low_contrast", "artifacts"):
        assert masks[k].sum() >= 2, k
    assert (~(masks["extreme_dark"] | masks["low_contrast"]
              | masks["artifacts"])).sum() >= 2
    for fn in COUNTED:
        fn.launches = 0
    got = tquality.quality_preprocess(_t(batch), merged=merged).numpy()
    assert [fn.launches for fn in COUNTED] == [0, 0, 0, 0]
    want = np.asarray(jquality.quality_preprocess(jnp.asarray(batch),
                                                  merged=merged))
    np.testing.assert_array_equal(got, want)
    # the flat frame passed through; the dim frame tripped the guard
    np.testing.assert_array_equal(got[-2], batch[-2])
    processed, stats, _ = tquality.quality_branches(_t(batch), merged=merged)
    too_bright, too_dark = tquality.over_correction(processed, stats["mean"])
    assert bool(too_dark[-1]) and not bool(too_bright.any())


@pytest.mark.unit
def test_quality_preprocess_and_normalize(batch):
    got = tquality.quality_preprocess_and_normalize(_t(batch)).numpy()
    want = np.asarray(jquality.quality_preprocess_and_normalize(
        jnp.asarray(batch)))
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.unit
def test_classic_path_parameters():
    """A parameter table whose grids do not nest runs the classic path, as
    in the JAX package on the CPU; a grid that does not divide the frame
    raises in both."""
    params = tquality.QualityParams(extreme_dark_grid=(4, 4),
                                    low_contrast_grid=(16, 16),
                                    low_contrast_clip=2.0)
    x = np.floor(RS.rand(2, 64, 64, 1) * 60).astype(np.float32)
    x[1] += 300.0                               # low contrast
    got = tquality.quality_preprocess(_t(x), params).numpy()
    want = np.asarray(jquality.quality_preprocess(
        jnp.asarray(x), jquality.QualityParams(**params._asdict())))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)
    x = np.zeros((1, 40, 40, 1), np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        tquality.quality_preprocess(_t(x))
    with pytest.raises(ValueError, match="not divisible"):
        jquality.quality_preprocess(jnp.asarray(x))


@pytest.mark.unit
def test_prepare_images_quality(batch):
    """Chunks of 32 (here of 5, patched) change no value; 1e-5 against the
    JAX prepare_images on uint16 frames."""
    from thyroid_tpu.data.pipeline import prepare_images as jax_prepare
    from thyroid_tpu_torch.data import pipeline

    raw = batch.astype(np.uint16)
    got = prepare_images(_t(raw), 32, quality=True).numpy()
    want = np.asarray(jax_prepare(jnp.asarray(raw), 32, quality=True))
    assert got.shape == (len(raw), 32, 32, 1)
    assert np.abs(got - want).max() < 1e-5
    old = pipeline.QUALITY_CHUNK
    try:
        pipeline.QUALITY_CHUNK = 5
        np.testing.assert_array_equal(
            prepare_images(_t(raw), 32, quality=True).numpy(), got)
    finally:
        pipeline.QUALITY_CHUNK = old


@pytest.mark.unit
def test_engine_quality_matches_jax_engine(batch):
    """InferenceEngine(quality=True) against the JAX engine on the same
    SMALL_SWIN weights and raw 64×64 frames; atol 1e-5 on probabilities."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    params = jax_swin(SMALL_SWIN)[1]
    raw = batch[:8]
    jax_engine = JaxEngine(model_config=SMALL_SWIN, buckets=(8,),
                           variables={"params": params}, quality=True)
    port = InferenceEngine(SMALL_SWIN, params=params, buckets=(8,),
                           quality=True, device="cpu")
    want = jax_engine.predict(raw)
    got = port.predict(raw)
    assert got.shape == (8, 2)
    assert np.abs(got - want).max() < 1e-5
    plain = InferenceEngine(SMALL_SWIN, params=params, buckets=(8,),
                            device="cpu").predict(raw)
    assert np.abs(plain - got).max() > 1e-4    # quality changed the inputs
    jax.clear_caches()
