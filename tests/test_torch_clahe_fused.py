"""The port's fused dual-grid uint16 CLAHE (clahe_uint16_dual_fused, whose
CPU path is its plain version) against the JAX package's, on the CPU,
bit-equal, on the JAX test's batch: a flat frame and mixed per-image grid
and apply flags (tests/unit/test_ops_image.py
test_dual_fused_epilogue_matches_composition)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.ops import clahe as jclahe
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.ops import clahe as tclahe

KW = dict(clip_coarse=2.0, grid_coarse=(16, 16), clip_fine=0.03,
          grid_fine=(32, 32))


def _batch(seed, b=5, side=64):
    x = (np.random.RandomState(seed).rand(b, side, side, 1) * 65535) \
        .astype(np.float32)
    x[3] = 1234.0                                    # flat frame: span 0
    return x


@pytest.mark.unit
@pytest.mark.parametrize("seed", [0, 1])
def test_dual_fused_matches_jax(seed):
    x = _batch(seed)
    use_coarse = np.array([True, False, False, True, False])
    apply = np.array([True, True, False, True, True])
    want = np.asarray(jclahe.clahe_uint16_dual_fused(
        jnp.asarray(x), jnp.asarray(use_coarse), jnp.asarray(apply), **KW))
    got = tclahe.clahe_uint16_dual_fused(
        torch.from_numpy(x), torch.from_numpy(use_coarse),
        torch.from_numpy(apply), **KW)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # untouched frames pass through as they are, the flat one floored
    assert np.array_equal(got.numpy()[2], x[2])
    assert np.array_equal(got.numpy()[3], np.floor(x[3]))
    assert not np.array_equal(got.numpy()[0], x[0])


@pytest.mark.unit
def test_dual_fused_equals_composition_and_checks_grids():
    """The port's own composition where(apply, clahe_uint16_dual(…), x)
    gives the same frames; the grid checks of the JAX function hold."""
    x = torch.from_numpy(_batch(2))
    use_coarse = torch.tensor([False, True, True, False, True])
    apply = torch.tensor([True, False, True, True, True])
    got = tclahe.clahe_uint16_dual_fused(x, use_coarse, apply, **KW)
    eq = tclahe.clahe_uint16_dual(x, use_coarse, **KW)
    assert torch.equal(got, torch.where(apply.reshape(-1, 1, 1, 1), eq, x))
    with pytest.raises(ValueError, match="2\\*grid_coarse"):
        tclahe.clahe_uint16_dual_fused(x, use_coarse, apply, 2.0, (8, 8),
                                       0.03, (32, 32))
    with pytest.raises(ValueError, match="divisible"):
        tclahe.clahe_uint16_dual_fused(x[:, :60, :60], use_coarse, apply,
                                       **KW)
    odd = dict(KW, grid_coarse=(8, 8), grid_fine=(16, 16))
    xo = torch.from_numpy(_batch(3, side=48))
    with pytest.raises(ValueError, match="even tile"):
        tclahe.clahe_uint16_dual_fused(xo, use_coarse, apply, **odd,
                                       method="pallas")
    # without method="pallas", odd tiles are taken, as in the JAX package
    assert tclahe.clahe_uint16_dual_fused(xo, use_coarse, apply,
                                          **odd).shape == xo.shape
