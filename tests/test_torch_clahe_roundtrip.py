"""The port's uint16 CLAHE round trip (thyroid_tpu_torch.ops.clahe, whose CPU
path is its plain version) against the JAX package's jitted functions, on
the CPU, bit for bit.

Two roundings decide single pixels here, and the port repeats both as XLA
compiles them on the CPU (ops/clahe.py `_blend_coords`, `_lerp` and
`_from_8bit`):
- tile sides that are not powers of two (3 and 5 below), where the tile
  coordinate p/t − 0.5 and the bilinear blend round at every step; a
  difference there moves a pixel by one 8-bit level, 256 or 257 uint16
  levels on the way back;
- the way back eq/255·span + lo at any tile side, where a difference moves
  a pixel by one uint16 level. The seeds below are frames on which that
  happened before the repair.
Frames are floor(RandomState(seed).rand(B, S, S, 1)·65535); no difference
is allowed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.ops import clahe as jclahe
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.ops import clahe as tclahe


def _frames(seed, b, side):
    return np.floor(np.random.RandomState(seed).rand(b, side, side, 1)
                    * 65535).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.unit
@pytest.mark.parametrize("seed,b,side,grid,clip", [
    (0, 2, 48, (16, 16), 2.0),      # tiles of 3
    (1, 2, 96, (32, 32), 2.0),      # tiles of 3
    (2, 2, 80, (16, 16), 2.0),      # tiles of 5
    (3, 2, 48, (16, 16), 0.03),     # tiles of 3, another clip
    (21, 4, 64, (16, 16), 2.0),     # the way back, tiles of 4
    (21, 4, 64, (8, 8), 2.0),       # the way back, tiles of 8
    (25, 4, 64, (16, 16), 2.0),
    (25, 4, 64, (8, 8), 2.0),
    (35, 4, 64, (16, 16), 2.0),
    (35, 4, 64, (8, 8), 2.0),
])
def test_clahe_uint16_matches_jit(seed, b, side, grid, clip):
    x = _frames(seed, b, side)
    want = np.asarray(jclahe.clahe_uint16(jnp.asarray(x), clip, grid))
    got = tclahe.clahe_uint16(_t(x), clip, grid).numpy()
    np.testing.assert_array_equal(got, want)


_DUAL = dict(clip_coarse=2.0, grid_coarse=(8, 8), clip_fine=0.03,
             grid_fine=(16, 16))


@pytest.mark.unit
@pytest.mark.parametrize("seed,side", [(21, 64), (5, 48)])
def test_dual_and_fused_match_jit(seed, side):
    """clahe_uint16_dual and clahe_uint16_dual_fused_plain on one batch with
    a flat frame, mixed grids and mixed apply flags (tiles of 8 and 4 at
    64², 6 and 3 at 48²)."""
    x = _frames(seed, 4, side)
    x[1] = 1234.0
    sel = np.array([True, False, False, True])
    apply = np.array([True, True, False, True])
    want = np.asarray(jclahe.clahe_uint16_dual(jnp.asarray(x), jnp.asarray(sel),
                                               **_DUAL))
    got = tclahe.clahe_uint16_dual(_t(x), _t(sel), **_DUAL).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jclahe.clahe_uint16_dual_fused(
        jnp.asarray(x), jnp.asarray(sel), jnp.asarray(apply), **_DUAL))
    got = tclahe.clahe_uint16_dual_fused_plain(_t(x), _t(sel), _t(apply),
                                               **_DUAL).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.unit
def test_fma32_rounds_once():
    """`_fma32` gives the single rounding of a·b + c, also where the float64
    sum itself rounds onto a float32 tie: (1 + 2⁻¹²)² + 2⁻⁸⁰ lies just above
    the tie 1 + 2⁻¹¹ + 2⁻²⁴, so it rounds up, while float32 after float64
    rounds it to even, down."""
    a = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -23], dtype=torch.float32)
    c = torch.tensor([2.0 ** -80, -1.0], dtype=torch.float32)
    b = torch.tensor([1.0 + 2.0 ** -12, 1.0 - 2.0 ** -23], dtype=torch.float32)
    got = tclahe._fma32(a, b, c).numpy()
    want = np.array([1.0 + 2.0 ** -11 + 2.0 ** -23, -(2.0 ** -46)],
                    dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    two_step = (a.double() * b.double() + c.double()).float().numpy()
    assert two_step[0] == np.float32(1.0 + 2.0 ** -11) != got[0]
    assert (a * b + c).numpy()[1] == 0.0 != got[1]
