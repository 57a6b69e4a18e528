"""Port token kernels (thyroid_tpu_torch.ops.token_fused) against the JAX
Pallas kernels in interpret mode, on the CPU, at the JAX tests' shapes
(tests/unit/test_token_fused.py).

float32 tolerances are the JAX tests' own (1e-5 LN+matmul, 2e-5 LN+MLP).
The bfloat16 cases allow one bf16 rounding step at the largest output
(2^-7 relative), since the two frameworks may round a float32 value that
sits on a bf16 boundary differently after summing in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.ops import token_fused as jtf
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.ops import token_fused as ttf

RS = np.random.RandomState(11)


def _f32(*shape, scale=1.0, shift=0.0):
    return (shift + scale * RS.randn(*shape)).astype(np.float32)


def _compare(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "f32":
        return np.abs(got - want).max()
    return np.abs(got - want).max() / (2 ** -7 * max(1.0, np.abs(want).max()))


def _cast(a, dtype):
    return (jnp.asarray(a, jnp.bfloat16) if dtype == "bf16" else jnp.asarray(a),
            torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16"
                                   else torch.float32))


@pytest.mark.unit
@pytest.mark.parametrize("lead,c,out_dim,use_bias,dtype", [
    ((2, 16, 16), 96, 288, True, "f32"),
    ((4, 64), 128, 384, False, "f32"),
    ((2, 16, 16), 96, 288, True, "bf16"),
    # 130 rows: two 64-row tiles of the card's kernel and two rows more
    ((130,), 96, 288, True, "f32"),
    ((130,), 96, 288, True, "bf16"),
    # PatchMerging's reduction 4C -> 2C, without a bias
    ((2, 33), 384, 192, False, "f32"),
    ((2, 33), 384, 192, False, "bf16"),
    # widths that are not multiples of 8
    ((33,), 40, 20, True, "f32"),
    ((33,), 40, 20, False, "bf16"),
])
def test_fused_ln_matmul(lead, c, out_dim, use_bias, dtype):
    x = _f32(*lead, c)
    g, b = _f32(c, scale=0.1, shift=1.0), _f32(c, scale=0.1)
    w = _f32(c, out_dim, scale=c ** -0.5)
    wb = _f32(out_dim, scale=0.1) if use_bias else None
    xj, xt = _cast(x, dtype)
    want = jtf.fused_ln_matmul(xj, jnp.asarray(g), jnp.asarray(b),
                               jnp.asarray(w),
                               None if wb is None else jnp.asarray(wb),
                               interpret=True)
    got = ttf.fused_ln_matmul(xt, torch.from_numpy(g), torch.from_numpy(b),
                              torch.from_numpy(w),
                              None if wb is None else torch.from_numpy(wb))
    assert got.dtype == xt.dtype and got.shape == (*lead, out_dim)
    err = _compare(got, want, dtype)
    assert err < (1e-5 if dtype == "f32" else 1.0), err


@pytest.mark.unit
@pytest.mark.parametrize("lead,c,hidden,dtype", [
    ((2, 8, 8), 96, 384, "f32"),
    # hidden 1024 > the JAX kernel's 512 chunk: its f32 accumulator runs
    # across two sequential chunks
    ((2, 64), 128, 1024, "f32"),
    ((2, 8, 8), 96, 384, "bf16"),
    # swin_large's last stage (C = 1536, hidden 6144), a few dozen rows
    ((2, 16), 1536, 6144, "f32"),
])
def test_fused_ln_mlp_residual(lead, c, hidden, dtype):
    x = _f32(*lead, c)
    g, b = _f32(c, scale=0.1, shift=1.0), _f32(c, scale=0.1)
    w1, b1 = _f32(c, hidden, scale=c ** -0.5), _f32(hidden, scale=0.1)
    w2, b2 = _f32(hidden, c, scale=hidden ** -0.5), _f32(c, scale=0.1)
    xj, xt = _cast(x, dtype)
    want = jtf.fused_ln_mlp_residual(
        xj, *(jnp.asarray(a) for a in (g, b, w1, b1, w2, b2)), interpret=True)
    got = ttf.fused_ln_mlp_residual(
        xt, *(torch.from_numpy(a) for a in (g, b, w1, b1, w2, b2)))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    err = _compare(got, want, dtype)
    assert err < (2e-5 if dtype == "f32" else 1.0), err


@pytest.mark.unit
def test_wrappers_reject_bad_widths():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ttf.fused_ln_matmul(x, torch.ones(8), torch.zeros(8),
                            torch.zeros(7, 3), None)
    with pytest.raises(ValueError):
        ttf.fused_ln_mlp_residual(x, torch.ones(8), torch.zeros(8),
                                  torch.zeros(8, 16), torch.zeros(16),
                                  torch.zeros(8, 16), torch.zeros(8))


@pytest.mark.unit
@pytest.mark.parametrize("which", ["ln_matmul", "ln_mlp_residual"])
def test_serving_kernels_refuse_autograd(which):
    """The serving token wrappers refuse nothing under autograd: with grad
    mode on and any one input requiring grad, the gradient flows to it and
    equals torch autograd through the plain version (float32, 1e-5
    relative); under torch.no_grad they give the same output."""
    c, h = 8, 16
    x = torch.from_numpy(_f32(5, c))
    g, b = torch.ones(c), torch.zeros(c)
    w1 = torch.from_numpy(_f32(c, h, scale=0.1))
    if which == "ln_matmul":
        fn, plain = ttf.fused_ln_matmul, ttf.ln_matmul_plain
        args = [x, g, b, w1, torch.zeros(h)]
    else:
        fn, plain = ttf.fused_ln_mlp_residual, ttf.ln_mlp_residual_plain
        args = [x, g, b, w1, torch.zeros(h),
                torch.from_numpy(_f32(h, c, scale=0.1)), torch.zeros(c)]
    want = fn(*args)
    cot = torch.from_numpy(_f32(*want.shape))
    for i in range(len(args)):
        grad_args = list(args)
        grad_args[i] = args[i].clone().requires_grad_()
        (got,) = torch.autograd.grad(fn(*grad_args), grad_args[i], cot)
        (ref,) = torch.autograd.grad(plain(*grad_args), grad_args[i], cot)
        assert got.shape == args[i].shape
        assert (got - ref).abs().max() <= 1e-5 * max(1.0, ref.abs().max())
        with torch.no_grad():
            assert torch.equal(fn(*grad_args), want)
