"""The port's depthwise convolutions (ops/depthwise.py,
ops/depthwise_pallas.py) against the JAX package on the CPU: the kernel's
plain version against JAX's Pallas kernel in interpret mode, the shifted
multiply-accumulates at strides 1 and 2, and the autograd backward against
JAX's custom_vjp, on numpy-seeded inputs. Weights are drawn in flax's
(k, k, 1, C) layout and handed to the port as (C, 1, k, k)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.ops import depthwise_pallas
from thyroid_tpu_torch.ops.depthwise import shift_depthwise_conv

# efficientnet_b0's stride-1 depthwise shapes (tests/unit/test_depthwise_pallas.py
# B0_SHAPES) with sides and batches cut, plus odd sides 9 × 17 and 17 × 9
SHAPES = [
    (1, 28, 28, 32, 3),
    (1, 14, 14, 144, 3),
    (1, 14, 14, 240, 5),
    (2, 7, 7, 480, 3),
    (2, 7, 7, 672, 5),
    (2, 4, 4, 1152, 5),
    (1, 9, 17, 40, 3),
    (2, 17, 9, 24, 5),
]


def _inputs(b, h, w, c, k, seed=7):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, c).astype(np.float32)
    ker = (rs.randn(k, k, 1, c) * 0.2).astype(np.float32)
    return x, ker


def _port_w(ker):
    return torch.from_numpy(np.ascontiguousarray(ker.transpose(3, 2, 0, 1)))


@pytest.mark.unit
@pytest.mark.parametrize("b,h,w,c,k", SHAPES)
def test_plain_matches_pallas_f32(b, h, w, c, k):
    """float32 within 1e-4·max(1, max|ref|), the JAX kernel test's bound;
    a CPU call runs the plain version and counts no launch."""
    from thyroid_tpu.ops.depthwise_pallas import depthwise_conv2d_pallas

    x, ker = _inputs(b, h, w, c, k)
    want = np.asarray(depthwise_conv2d_pallas(jnp.asarray(x), jnp.asarray(ker),
                                              None, True))
    before = depthwise_pallas.depthwise_conv2d_pallas.launches
    got = depthwise_pallas.depthwise_conv2d_pallas(torch.from_numpy(x),
                                                   _port_w(ker))
    assert depthwise_pallas.depthwise_conv2d_pallas.launches == before
    assert got.dtype == torch.float32 and got.shape == (b, h, w, c)
    assert np.abs(got.numpy() - want).max() < 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.unit
def test_plain_matches_pallas_bf16():
    """bf16 operands, float32 sums, a bf16 output: within 0.1·max(1,
    max|ref|), the JAX kernel test's bound (its reference is XLA's conv);
    here the two agree to one bf16 rounding."""
    from thyroid_tpu.ops.depthwise_pallas import depthwise_conv2d_pallas

    x, ker = _inputs(2, 14, 14, 240, 5)
    xb, kb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(ker).astype(jnp.bfloat16)
    want = np.asarray(depthwise_conv2d_pallas(xb, kb, None, True)
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    wt = _port_w(np.asarray(kb.astype(jnp.float32))).bfloat16()
    got = depthwise_pallas.depthwise_conv2d_pallas(xt, wt)
    assert got.dtype == torch.bfloat16
    ref = max(1.0, np.abs(want).max())
    err = np.abs(got.float().numpy() - want).max()
    assert err < 0.1 * ref and err <= 2 ** -7 * ref, err


@pytest.mark.unit
@pytest.mark.parametrize("strides", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_shift_depthwise_conv_matches_jax(strides, k):
    """The shifted multiply-accumulates at both strides on an odd side,
    float32, within 1e-6 (the same products and sums in the same order)."""
    from thyroid_tpu.ops.depthwise import shift_depthwise_conv as jax_shift

    x, ker = _inputs(2, 15, 13, 24, k, seed=k)
    want = np.asarray(jax_shift(jnp.asarray(x), jnp.asarray(ker), strides))
    got = shift_depthwise_conv(torch.from_numpy(x), _port_w(ker), strides)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.unit
def test_backward_matches_jax_custom_vjp():
    """dx and dw of sum(sin(conv)) through the autograd Function against
    JAX's custom_vjp (its XLA backward): atol 2e-4 and 2e-3, the JAX test's
    bounds for its backward against autodiff of XLA's conv."""
    from thyroid_tpu.ops.depthwise_pallas import depthwise_conv2d_pallas

    x, ker = _inputs(2, 14, 14, 48, 3)

    def loss(x, ker):
        return jnp.sum(jnp.sin(depthwise_conv2d_pallas(x, ker, None, True)))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(ker))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _port_w(ker).requires_grad_()
    torch.sin(depthwise_pallas.depthwise_conv2d_pallas(xt, wt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(gw).transpose(3, 2, 0, 1), atol=2e-3,
                               rtol=2e-4)
    assert np.abs(np.asarray(gw)).max() > 1e-2
