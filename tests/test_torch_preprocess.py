"""Port preprocessing (thyroid_tpu_torch.ops.image / ops.percentile /
data.pipeline) against the JAX package on the same inputs, on the CPU.

Tolerance 1e-5 on [0, 1] outputs: the JAX kernel-vs-XLA percentile test's
own bound (tests/unit/test_ops_image.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.data.pipeline import prepare_images as jax_prepare
from thyroid_tpu.ops import image as jimg
from thyroid_tpu.ops.percentile import fused_percentile_normalize as jax_fused
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.data.pipeline import prepare_images
from thyroid_tpu_torch.ops import image as timg
from thyroid_tpu_torch.ops.percentile import (fused_percentile_normalize,
                                              percentile_normalize_plain)

RS = np.random.RandomState(21)


def _u16(*shape):
    return (RS.rand(*shape) * 65535).astype(np.float32)


@pytest.mark.unit
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_to_uint16_scale(dtype):
    x = (RS.rand(2, 8, 8, 1) * (255 if dtype == np.uint8 else 65535)) \
        .astype(dtype)
    want = np.asarray(jimg.to_uint16_scale(jnp.asarray(x)))
    got = timg.to_uint16_scale(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        timg.normalize_uint16(torch.from_numpy(want.copy())).numpy(),
        np.asarray(jimg.normalize_uint16(jnp.asarray(want))), atol=1e-7)


@pytest.mark.unit
@pytest.mark.parametrize("in_size,out_size", [(512, 224), (32, 48), (32, 32),
                                              (17, 5)],
                         ids=["down", "up", "identity", "odd"])
def test_resize_bilinear(in_size, out_size):
    x = RS.rand(2, in_size, in_size + 3, 2).astype(np.float32)
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(x),
                                           (out_size, out_size + 1)))
    got = timg.resize_bilinear(torch.from_numpy(x), (out_size, out_size + 1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.unit
@pytest.mark.parametrize("shape", [(8, 32, 32, 1), (3, 17, 19, 1),
                                   (12, 16, 16, 3)])
def test_percentile_normalize(shape):
    x = _u16(*shape)
    xt = torch.from_numpy(x)
    ref_xla = np.asarray(jimg.adaptive_normalize(jnp.asarray(x), "percentile",
                                                 use_kernel=False))
    ref_kernel = np.asarray(jax_fused(jnp.asarray(x), interpret=True))
    got = fused_percentile_normalize(xt).numpy()
    assert np.abs(got - ref_xla).max() < 1e-5
    assert np.abs(got - ref_kernel).max() < 1e-5
    np.testing.assert_array_equal(
        timg.adaptive_normalize(xt, "percentile").numpy(), got)
    np.testing.assert_array_equal(percentile_normalize_plain(xt).numpy(), got)


@pytest.mark.unit
def test_quantile_and_minmax():
    x = _u16(3, 20, 20, 1)
    for q in (0.01, 0.5, 0.99):
        np.testing.assert_array_equal(
            timg.per_image_quantile_fast(torch.from_numpy(x), q).numpy(),
            np.asarray(jimg.per_image_quantile_fast(jnp.asarray(x), q)))
    got = timg.adaptive_normalize(torch.from_numpy(x), "minmax").numpy()
    want = np.asarray(jimg.adaptive_normalize(jnp.asarray(x), "minmax"))
    assert np.abs(got - want).max() < 1e-6
    with pytest.raises(ValueError):
        timg.adaptive_normalize(torch.from_numpy(x), "nope")


@pytest.mark.unit
def test_standardize():
    x = RS.rand(2, 4, 4, 3).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_allclose(
        timg.standardize(torch.from_numpy(x), mean, std).numpy(),
        np.asarray(jimg.standardize(jnp.asarray(x), mean, std)), atol=1e-6)


@pytest.mark.unit
def test_prepare_images_real_shape():
    """(2, 512, 512, 1) raw frames → 224, as the serving path runs it."""
    raw = _u16(2, 512, 512, 1)
    want = np.asarray(jax_prepare(jnp.asarray(raw), 224))
    got = prepare_images(torch.from_numpy(raw), 224)
    assert got.shape == (2, 224, 224, 1) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.unit
def test_prepare_images_chunks_and_uint8(monkeypatch):
    from thyroid_tpu_torch.data import pipeline

    raw = (RS.rand(5, 24, 24, 1) * 255).astype(np.uint8)
    whole = prepare_images(torch.from_numpy(raw), 16)
    monkeypatch.setattr(pipeline, "CHUNK", 2)
    chunked = prepare_images(torch.from_numpy(raw), 16)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    want = np.asarray(jax_prepare(jnp.asarray(raw), 16))
    assert np.abs(whole.numpy() - want).max() < 1e-5


@pytest.mark.unit
def test_quality_pipeline_not_ported():
    """The quality pipeline is ported (tests/test_torch_quality.py); like
    the JAX package's, it refuses frames its CLAHE grids do not divide."""
    with pytest.raises(ValueError, match="not divisible by CLAHE grid"):
        prepare_images(torch.zeros(1, 8, 8, 1), 4, quality=True)
    with pytest.raises(ValueError, match="not divisible by CLAHE grid"):
        jax_prepare(jnp.zeros((1, 8, 8, 1)), 4, quality=True)
