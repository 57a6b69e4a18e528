"""Gradients of the port's token kernels (thyroid_tpu_torch.ops.token_fused:
fused_ln_matmul, fused_ln_mlp, fused_ln_mlp_residual) against jax.grad of
the JAX wrappers, whose custom_vjps run the Pallas backward kernels in
interpret mode, on the CPU, at the JAX tests' shapes
(tests/unit/test_token_fused.py: TestFusedGradients, TestPaddedTokenBlocks).

float32: 2e-4 relative to max(1, max|want|), the JAX tests' _cmp_grads
bound. bfloat16: 2^-6 relative to max(1, max|want|), four bf16 rounding
steps (2^-8 each) on the way to a gradient: the recomputed hidden layer,
dH, gelu(hr) and dX, each of which the two frameworks may round on the
other side of a bf16 boundary after summing in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.ops import token_fused as jtf
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.ops import token_fused as ttf

RS = np.random.RandomState(21)
BF16_TOL = 2 ** -6


def _f32(*shape, scale=1.0, shift=0.0):
    return (shift + scale * RS.randn(*shape)).astype(np.float32)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _mlp_args(c, hidden):
    return (_f32(c, scale=0.1, shift=1.0), _f32(c, scale=0.1),
            _f32(c, hidden, scale=c ** -0.5), _f32(hidden, scale=0.1),
            _f32(hidden, c, scale=hidden ** -0.5), _f32(c, scale=0.1))


def _grads_both(jfn, tfn, x, params, cot, dtype, loss="dot"):
    """(JAX grads, port grads) of sum(f(x, *params) * cot) (or sum(f²))
    with respect to x and every parameter; x in `dtype`, params float32."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def jloss(x, *p):
        y = jfn(x, *p, interpret=True).astype(jnp.float32)
        return (y * cot).sum() if loss == "dot" else (y ** 2).sum()

    want = jax.grad(jloss, argnums=tuple(range(1 + len(params))))(
        jnp.asarray(x, jdt), *(jnp.asarray(p) for p in params))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    y = tfn(tx, *tp).float()
    if loss == "dot":
        (y * torch.from_numpy(cot)).sum().backward()
    else:
        (y ** 2).sum().backward()
    got = [tx.grad] + [p.grad for p in tp]
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    return want, got


@pytest.mark.unit
@pytest.mark.parametrize("lead,c,out_dim", [
    ((2, 24), 96, 288),
    # swin_tiny's last-stage QKV width: the dX product over O = 2304 and the
    # dγ/dβ sums over rows at C = 768
    ((70,), 768, 2304),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_matmul_grads_match_jax(dtype, lead, c, out_dim):
    x = _f32(*lead, c)
    params = (_f32(c, scale=0.1, shift=1.0), _f32(c, scale=0.1),
              _f32(c, out_dim, scale=c ** -0.5), _f32(out_dim, scale=0.1))
    cot = _f32(*lead, out_dim)
    before = ttf.fused_ln_matmul.launches, ttf.fused_ln_matmul_bwd.launches
    want, got = _grads_both(jtf.fused_ln_matmul, ttf.fused_ln_matmul, x,
                            params, cot, dtype)
    tol = 2e-4 if dtype == "f32" else BF16_TOL
    for name, g, w in zip(["x", "gamma", "beta", "w", "wb"], got, want):
        assert _rel(g, w) < tol, (name, _rel(g, w))
    # the CPU runs the plain versions: no kernel launch is counted
    assert (ttf.fused_ln_matmul.launches,
            ttf.fused_ln_matmul_bwd.launches) == before


@pytest.mark.unit
@pytest.mark.parametrize("residual,hidden,dtype", [
    (True, 384, "f32"), (False, 384, "f32"),
    # hidden 1024 > the JAX kernel's 512 chunk: two sequential chunks
    (False, 1024, "f32"),
    (False, 384, "bf16"), (True, 384, "bf16"),
])
def test_ln_mlp_grads_match_jax(residual, hidden, dtype):
    lead, c = (2, 16), 128
    x = _f32(*lead, c)
    params = _mlp_args(c, hidden)
    cot = _f32(*lead, c)
    jfn = jtf.fused_ln_mlp_residual if residual else jtf.fused_ln_mlp
    tfn = ttf.fused_ln_mlp_residual if residual else ttf.fused_ln_mlp
    counters = (ttf.fused_ln_mlp, ttf.fused_ln_mlp_residual,
                ttf.fused_ln_mlp_bwd_dx, ttf.fused_ln_mlp_bwd_dw)
    before = [f.launches for f in counters]
    want, got = _grads_both(jfn, tfn, x, params, cot, dtype)
    tol = 2e-4 if dtype == "f32" else BF16_TOL
    for name, g, w in zip(["x", "gamma", "beta", "w1", "b1", "w2", "b2"],
                          got, want):
        assert _rel(g, w) < tol, (name, _rel(g, w))
    assert [f.launches for f in counters] == before


@pytest.mark.unit
@pytest.mark.parametrize("t,c,hidden,dtype", [
    (130, 96, 384, "bf16"),
    # widths that are not multiples of 8 (the card stages padded copies)
    (130, 40, 160, "f32"),
    (130, 40, 160, "bf16"),
])
def test_ln_mlp_weight_grads_match_jax_call(t, c, hidden, dtype):
    """dW1, db1, dW2 of fused_ln_mlp_bwd_dw against the JAX backward call
    (_ln_mlp_bwd_call, its Pallas dw kernel in interpret mode) on the same
    x and dY, 130 tokens (two 64-row tiles and two rows): 2e-4 (float32)
    or 2^-6 (bfloat16) relative to max(1, max|want|)."""
    x, dy = _f32(t, c), _f32(t, c)
    g, b, w1, b1, w2, _ = _mlp_args(c, hidden)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jtf._ln_mlp_bwd_call(
        jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b),
        jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt),
        jnp.asarray(dy, jdt), residual=False, eps=1e-5, interpret=True)[3:]
    before = ttf.fused_ln_mlp_bwd_dw.launches
    got = ttf.fused_ln_mlp_bwd_dw(
        torch.from_numpy(x).to(tdt), *map(torch.from_numpy, (g, b, w1, b1, w2)),
        torch.from_numpy(dy).to(tdt))
    assert ttf.fused_ln_mlp_bwd_dw.launches == before
    tol = 2e-4 if dtype == "f32" else BF16_TOL
    for name, gv, wv in zip(["w1", "b1", "w2"], got, want):
        assert gv.dtype == torch.float32
        wv = np.asarray(jnp.asarray(wv, jnp.float32)).reshape(gv.shape)
        assert _rel(gv, wv) < tol, (name, _rel(gv, wv))


@pytest.mark.unit
def test_prime_token_grads_match_jax():
    """2·197 tokens (the JAX kernel pads them to its block), loss sum(y²)
    of the residual MLP, every gradient within 2e-4."""
    c, hidden = 64, 256
    x = _f32(2, 197, c)
    params = (_f32(c, scale=0.1, shift=1.0), _f32(c, scale=0.1),
              _f32(c, hidden, scale=1 / 8), _f32(hidden, scale=0.1),
              _f32(hidden, c, scale=1 / 16), _f32(c, scale=0.1))
    want, got = _grads_both(jtf.fused_ln_mlp_residual, ttf.fused_ln_mlp_residual,
                            x, params, None, "f32", loss="square")
    for g, w in zip(got, want):
        assert _rel(g, w) < 2e-4


@pytest.mark.unit
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_ln_mlp_forward_matches_jax(dtype):
    """The no-residual forward against JAX's fused_ln_mlp: 2e-5 in float32
    (the JAX test's bound), one bf16 step (2^-7 relative) in bfloat16."""
    x = _f32(2, 8, 96)
    params = _mlp_args(96, 384)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = jtf.fused_ln_mlp(jnp.asarray(x, jdt), *map(jnp.asarray, params),
                            interpret=True)
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    got = ttf.fused_ln_mlp(xt, *map(torch.from_numpy, params))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert _rel(got, want) < (2e-5 if dtype == "f32" else 2 ** -7)
    assert torch.equal(
        ttf.fused_ln_mlp_residual(xt, *map(torch.from_numpy, params)),
        ttf.ln_mlp_plain(xt.reshape(-1, 96), *map(torch.from_numpy, params),
                         residual=True).reshape(xt.shape))


@pytest.mark.unit
@pytest.mark.parametrize("residual", [True, False])
def test_bwd_plain_matches_autograd_of_plain(residual):
    """The explicit backward formulas (ln_matmul_bwd_plain,
    ln_mlp_bwd_plain) against torch autograd of the plain forwards, float32,
    1e-5 relative to max(1, max|ref|)."""
    c, hidden, t = 64, 256, 37
    x = torch.from_numpy(_f32(t, c))
    g, b, w1, b1, w2, b2 = map(torch.from_numpy, _mlp_args(c, hidden))
    dy = torch.from_numpy(_f32(t, c))
    leaves = [v.clone().requires_grad_() for v in (x, g, b, w1, b1, w2)]
    out = ttf.ln_mlp_plain(*leaves, b2, residual=residual)
    want = torch.autograd.grad(out, leaves, dy)
    got = ttf.ln_mlp_bwd_plain(x, g, b, w1, b1, w2, dy, residual)
    for i, (gv, wv) in enumerate(zip(got, want)):   # x, γ, β, W1, b1, W2
        assert _rel(gv, wv.numpy()) < 1e-5, i

    dyq = torch.from_numpy(_f32(t, 3 * c))
    wq = torch.from_numpy(_f32(c, 3 * c, scale=c ** -0.5))
    leaves = [v.clone().requires_grad_() for v in (x, g, b, wq)]
    want = torch.autograd.grad(ttf.ln_matmul_plain(*leaves, None), leaves[:3], dyq)
    got = ttf.ln_matmul_bwd_plain(x, g, wq, dyq)
    for gv, wv in zip(got, want):
        assert _rel(gv, wv.numpy()) < 1e-5


@pytest.mark.unit
def test_grad_types_and_rounding():
    """bf16 x with float32 parameters: dX in bf16, every parameter gradient
    float32; the incoming gradient is rounded to bf16 before the backward,
    as the JAX custom_vjps do, so the gradients equal the plain backward's
    on the rounded gradient; a missing QKV bias gets no gradient."""
    c, hidden = 32, 128
    x = torch.from_numpy(_f32(3, 5, c)).to(torch.bfloat16)
    g, b, w1, b1, w2, b2 = map(torch.from_numpy, _mlp_args(c, hidden))
    cot = torch.from_numpy(_f32(3, 5, c))
    leaves = [v.clone().requires_grad_() for v in (x, g, b, w1, b1, w2, b2)]
    ttf.fused_ln_mlp(*leaves).float().backward(cot)
    want = ttf.ln_mlp_bwd_plain(x.reshape(-1, c), g, b, w1, b1, w2,
                                cot.reshape(-1, c).to(torch.bfloat16), False)
    got = [leaves[i].grad for i in (0, 1, 2, 3, 4, 5)]
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0].reshape(-1, c), want[0])
    for gv, wv in zip(got[1:], (want[1], want[2], want[3], want[4], want[5])):
        assert gv.dtype == torch.float32 and torch.equal(gv, wv)
    assert torch.equal(leaves[6].grad,
                       cot.to(torch.bfloat16).float().reshape(-1, c).sum(0))

    wq = torch.from_numpy(_f32(c, 3 * c, scale=0.1)).requires_grad_()
    xq = x.clone().requires_grad_()
    ttf.fused_ln_matmul(xq, g, b, wq, None).float().sum().backward()
    assert xq.grad.dtype == torch.bfloat16 and wq.grad.dtype == torch.float32
