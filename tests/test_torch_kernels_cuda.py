"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes with ragged edges (rows and columns that do not fill a
tile). Marked `cuda`: they skip without a card, and run on the machine that
has one with
`python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`.

Tolerance: float32 1e-4 and bfloat16 1e-2 relative to max(1, max|plain|),
as chip_smoke.py holds the main-path shapes; the attention backward's
dbias, and the token backward kernels' dgamma, dbeta, dW1, db1 and dW2, sums
over windows or tokens taken in another order, 1e-4 (float32) and 1e-3
(bfloat16) relative to max(1, max|plain|). The quality kernels: the
statistics' quantile, max and min exact, mean and std rtol 1e-5 (float64
sums against PyTorch's float32 ones); the stencil's median exact and its
bilateral within 1e-2 grey levels (the JAX kernel test's bound); the CLAHE
apply exact. The depthwise kernel: RTOL (it is bit-equal to its plain
version by construction); its autograd backward's dw, a sum over B·H·W,
DBIAS_RTOL."""
import pytest
import torch

from thyroid_tpu_torch.models.cnn.efficientnet import stride1_depthwise_shapes
from thyroid_tpu_torch.models.vit.swin import shift_attention_mask
from thyroid_tpu_torch.ops import (attention, clahe, depthwise_pallas,
                                   percentile, stencil, token_fused)

RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DBIAS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _close(got, want, dtype, rtol=RTOL):
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= rtol[dtype] * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 17, 19, 1), (2, 224, 224, 1)])
def test_percentile(gen, dtype, shape):
    x = (torch.rand(*shape, generator=gen, device="cuda") * 65535).to(dtype)
    before = percentile.fused_percentile_normalize.launches
    got = percentile.fused_percentile_normalize(x)
    assert percentile.fused_percentile_normalize.launches == before + 1
    want = percentile.percentile_normalize_plain(x)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,o,bias", [(70, 96, 288, True), (33, 40, 20, False),
                                        (130, 1536, 768, False)])
def test_ln_matmul(gen, dtype, t, c, o, bias):
    args = (_rn(gen, t, c, dtype=dtype), 1 + _rn(gen, c, scale=0.1),
            _rn(gen, c, scale=0.1), _rn(gen, c, o, scale=c ** -0.5, dtype=dtype),
            _rn(gen, o, scale=0.1) if bias else None)
    _close(token_fused.fused_ln_matmul(*args),
           token_fused.ln_matmul_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,h", [(45, 96, 384), (33, 100, 200),
                                   (40, 1024, 4096)])
def test_ln_mlp_residual(gen, dtype, t, c, h):
    args = (_rn(gen, t, c, dtype=dtype), 1 + _rn(gen, c, scale=0.1),
            _rn(gen, c, scale=0.1), _rn(gen, c, h, scale=c ** -0.5, dtype=dtype),
            _rn(gen, h, scale=0.1), _rn(gen, h, c, scale=h ** -0.5, dtype=dtype),
            _rn(gen, c, scale=0.1))
    _close(token_fused.fused_ln_mlp_residual(*args),
           token_fused.ln_mlp_residual_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,r,c,heads,ws,shift", [
    (2, 16, 96, 3, 4, 2), (1, 14, 384, 12, 7, 3), (3, 7, 768, 24, 7, 0),
    (1, 16, 64, 1, 8, 4)])
def test_swin_block_attention(gen, dtype, b, r, c, heads, ws, shift):
    n = ws * ws
    mask = shift_attention_mask(r, r, ws, shift)
    args = (_rn(gen, b, r, r, 3, c, dtype=dtype), _rn(gen, b, r, r, c, dtype=dtype),
            _rn(gen, c, c, scale=0.05, dtype=dtype), _rn(gen, c, scale=0.1),
            _rn(gen, heads, n, n, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    _close(attention.fused_swin_block_attention(*args, **kw),
           attention.swin_block_attention_plain(*args, **kw), dtype)


# (tokens, width, hidden): ragged row blocks, widths that are not multiples
# of 64 or 4, hidden widths with a partial chunk of 128 and of 16
TOKEN_BWD_CASES = [(70, 96, 384), (33, 40, 200), (130, 768, 3072), (45, 100, 72)]


def _token_args(gen, dtype, t, c, h, out=None):
    """x, γ, β, W1 (c, h), b1, W2 (h, c), dY (t, out or c)."""
    return (_rn(gen, t, c, dtype=dtype), 1 + _rn(gen, c, scale=0.1),
            _rn(gen, c, scale=0.1), _rn(gen, c, h, scale=c ** -0.5, dtype=dtype),
            _rn(gen, h, scale=0.1), _rn(gen, h, c, scale=h ** -0.5, dtype=dtype),
            _rn(gen, t, out or c, dtype=dtype))


def _close_all(got, want, dtype, sums):
    """dX-like outputs at RTOL, sums over tokens at DBIAS_RTOL."""
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, dtype, DBIAS_RTOL if i in sums else RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,h", TOKEN_BWD_CASES)
def test_ln_matmul_bwd(gen, dtype, t, c, h):
    """Kernel 9 against its plain version (dX; dγ, dβ as sums over tokens),
    and two runs bit-equal (no atomics)."""
    x, g, _, w, _, _, dy = _token_args(gen, dtype, t, c, h, out=h)
    before = token_fused.fused_ln_matmul_bwd.launches
    got = token_fused.fused_ln_matmul_bwd(x, g, w, dy)
    assert token_fused.fused_ln_matmul_bwd.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _close_all(got, token_fused.ln_matmul_bwd_plain(x, g, w, dy), dtype, (1, 2))
    again = token_fused.fused_ln_matmul_bwd(x, g, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("t,c,h", TOKEN_BWD_CASES)
def test_ln_mlp_bwd(gen, dtype, residual, t, c, h):
    """Kernels 10 (dX, dγ, dβ) and 11 (dW1, db1, dW2) against the plain
    backward, and two runs bit-equal (no atomics)."""
    args = _token_args(gen, dtype, t, c, h)
    dx_before = token_fused.fused_ln_mlp_bwd_dx.launches
    dw_before = token_fused.fused_ln_mlp_bwd_dw.launches
    got = token_fused.fused_ln_mlp_bwd_dx(*args, residual=residual) \
        + token_fused.fused_ln_mlp_bwd_dw(*args)
    assert (token_fused.fused_ln_mlp_bwd_dx.launches,
            token_fused.fused_ln_mlp_bwd_dw.launches) == (dx_before + 1, dw_before + 1)
    assert got[0].dtype == dtype and all(v.dtype == torch.float32 for v in got[1:])
    want = token_fused.ln_mlp_bwd_plain(*args, residual)
    _close_all(got, want, dtype, (1, 2, 3, 4, 5))
    again = token_fused.fused_ln_mlp_bwd_dx(*args, residual=residual) \
        + token_fused.fused_ln_mlp_bwd_dw(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,h", [(45, 96, 384), (33, 100, 200)])
def test_ln_mlp_no_residual(gen, dtype, t, c, h):
    x, g, b, w1, b1, w2, _ = _token_args(gen, dtype, t, c, h)
    b2 = _rn(gen, c, scale=0.1)
    before = token_fused.fused_ln_mlp.launches
    got = token_fused.fused_ln_mlp(x, g, b, w1, b1, w2, b2)
    assert token_fused.fused_ln_mlp.launches == before + 1
    _close(got, token_fused.ln_mlp_plain(x, g, b, w1, b1, w2, b2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_token_autograd_reaches_the_kernels(gen, dtype):
    """Autograd through fused_ln_matmul and fused_ln_mlp launches one
    forward and the backward kernels once each, and its gradients equal
    the kernels' own (cast to the parameters' float32)."""
    t, c, h = 70, 96, 384
    x, g, b, w1, b1, w2, dy = _token_args(gen, dtype, t, c, h)
    b2 = _rn(gen, c, scale=0.1)
    counters = (token_fused.fused_ln_mlp, token_fused.fused_ln_mlp_bwd_dx,
                token_fused.fused_ln_mlp_bwd_dw)
    before = [f.launches for f in counters]
    leaves = [v.clone().requires_grad_() for v in (x, g, b, w1, b1, w2, b2)]
    token_fused.fused_ln_mlp(*leaves).backward(dy)
    assert [f.launches for f in counters] == [n + 1 for n in before]
    want = token_fused.fused_ln_mlp_bwd_dx(x, g, b, w1, b1, w2, dy, residual=False) \
        + token_fused.fused_ln_mlp_bwd_dw(x, g, b, w1, b1, w2, dy)
    for leaf, w in zip(leaves[:6], want):
        assert torch.equal(leaf.grad, w.to(leaf.dtype))
    assert torch.equal(leaves[6].grad, dy.float().sum(0))

    wq = _rn(gen, c, 3 * c, scale=c ** -0.5)
    dyq = _rn(gen, t, 3 * c, dtype=dtype)
    before = token_fused.fused_ln_matmul_bwd.launches
    xq, gq = x.clone().requires_grad_(), g.clone().requires_grad_()
    token_fused.fused_ln_matmul(xq, gq, b, wq, None).backward(dyq)
    assert token_fused.fused_ln_matmul_bwd.launches == before + 1
    dx, dg, _ = token_fused.fused_ln_matmul_bwd(x, g, wq.to(dtype), dyq)
    assert torch.equal(xq.grad, dx) and torch.equal(gq.grad, dg)


@pytest.mark.cuda
def test_token_bwd_refuses(gen):
    """Widths above 768 and a dY that does not match raise; they never fall
    back to the plain version."""
    x, g, b, w1, b1, w2, dy = _token_args(gen, torch.float32, 8, 1024, 64)
    with pytest.raises(ValueError):
        token_fused.fused_ln_mlp_bwd_dx(x, g, b, w1, b1, w2, dy, residual=False)
    with pytest.raises(ValueError):
        token_fused.fused_ln_mlp_bwd_dw(x, g, b, w1, b1, w2, dy)
    x, g, b, w1, b1, w2, dy = _token_args(gen, torch.float32, 8, 64, 64)
    with pytest.raises(ValueError):
        token_fused.fused_ln_mlp_bwd_dw(x, g, b, w1, b1, w2, dy[:4])
    with pytest.raises(ValueError):
        token_fused.fused_ln_matmul_bwd(x, g, w1, dy.to(torch.bfloat16))


SWIN_TRAIN_CASES = [
    (1, 8, 32, 1, 4, 0), (1, 16, 96, 3, 4, 2), (1, 14, 192, 6, 7, 0),
    (1, 14, 384, 12, 7, 3), (1, 7, 768, 24, 7, 0), (1, 16, 64, 1, 8, 4),
    (1, 16, 128, 4, 8, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,r,c,heads,ws,shift", SWIN_TRAIN_CASES)
def test_swin_attention_forward(gen, dtype, b, r, c, heads, ws, shift):
    n = ws * ws
    mask = shift_attention_mask(r, r, ws, shift)
    args = (_rn(gen, b, r, r, 3, c, dtype=dtype), _rn(gen, heads, n, n, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)
    kw = dict(window_size=ws, num_heads=heads)
    before = attention.fused_swin_attention.launches
    got = attention.fused_swin_attention(*args, **kw)
    assert attention.fused_swin_attention.launches == before + 1
    _close(got, attention.swin_attention_plain(
        *args, **kw, scale=(c // heads) ** -0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,r,c,heads,ws,shift", SWIN_TRAIN_CASES)
def test_swin_attention_backward(gen, dtype, b, r, c, heads, ws, shift):
    """The backward kernel against its plain version, and autograd through
    fused_swin_attention reaching it (one forward and one backward launch)."""
    n = ws * ws
    mask = shift_attention_mask(r, r, ws, shift)
    qkv = _rn(gen, b, r, r, 3, c, dtype=dtype)
    bias = _rn(gen, heads, n, n, scale=0.1)
    m = torch.from_numpy(mask).cuda() if mask is not None else None
    dout = _rn(gen, b, r, r, c, dtype=dtype)
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    dq, db = attention.fused_swin_attention_bwd(qkv, dout, bias, m, **kw)
    dq_ref, db_ref = attention.swin_attention_bwd_plain(qkv, dout, bias, m, **kw)
    assert dq.dtype == dtype and db.dtype == torch.float32
    _close(dq, dq_ref, dtype)
    _close(db, db_ref, dtype, DBIAS_RTOL)

    fwd, bwd = (attention.fused_swin_attention.launches,
                attention.fused_swin_attention.bwd_launches)
    tq, tb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    out = attention.fused_swin_attention(tq, tb, m, **kw)
    out.backward(dout)
    assert (attention.fused_swin_attention.launches,
            attention.fused_swin_attention.bwd_launches) == (fwd + 1, bwd + 1)
    torch.cuda.synchronize()
    assert torch.equal(tq.grad, dq) and torch.equal(tb.grad, db)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((3, 17, 19, 1), 0), ((4, 512, 512, 1), 0),
                                          ((1, 1, 7, 1), 0), ((2, 64, 64, 1), 1)])
def test_stats_quantile(gen, shape, offset):
    """n % 4 != 0 takes the scalar loads, 512² the float4 ones; a view
    that starts 4 bytes into its storage takes the scalar loads too."""
    n = torch.Size(shape).numel()
    buf = torch.floor(torch.rand(n + offset, generator=gen, device="cuda") * 65535)
    x = buf[offset:].reshape(shape)
    before = percentile.fused_stats_quantile.launches
    got = percentile.fused_stats_quantile(x, 0.999)
    assert percentile.fused_stats_quantile.launches == before + 1
    want = percentile.stats_quantile_plain(x, 0.999)
    torch.cuda.synchronize()
    for k in ("quantile", "max", "min"):
        assert torch.equal(got[k], want[k]), k
    for k in ("mean", "std"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 5, 7])
@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (3, 67, 45, 1), (1, 4, 33, 1)])
def test_median_bilateral(gen, d, shape):
    """Ragged tiles, and frames only a few pixels high, where the
    bilateral's reflect-101 reaches past the median's replicated edge."""
    x8 = torch.floor(torch.rand(*shape, generator=gen, device="cuda") * 256)
    before = stencil.fused_median_bilateral.launches
    med, bil = stencil.fused_median_bilateral(x8, d=d)
    assert stencil.fused_median_bilateral.launches == before + 1
    want_med, want_bil = stencil.median_bilateral_plain(x8, d=d)
    torch.cuda.synchronize()
    assert torch.equal(med, want_med)
    assert (bil - want_bil).abs().max().item() <= 1e-2


def _luts(gen, b, grid):
    return torch.floor(torch.rand(b, grid[0], grid[1], 256, generator=gen,
                                  device="cuda") * 256)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,grid", [(512, 512, (16, 16)), (512, 512, (32, 32)),
                                      (511, 511, (7, 9)), (63, 45, (9, 5)),
                                      (64, 64, (32, 32))])
def test_apply_luts(gen, h, w, grid):
    """Odd tile sides (73×56, 7×9), which the TPU kernel refused, and 2×2
    tiles, whose band needs 80 KB of LUT rows (above the 48 KB default)."""
    x8 = torch.floor(torch.rand(2, h, w, generator=gen, device="cuda") * 300) - 20
    luts = _luts(gen, 2, grid)
    before = clahe.apply_luts.launches
    got = clahe.apply_luts(x8, luts, grid)
    assert clahe.apply_luts.launches == before + 1
    want = clahe._interp_luts(x8, luts, grid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,grids", [(512, ((16, 16), (32, 32))),
                                     (90, ((3, 5), (6, 10)))])
def test_apply_luts_dual(gen, h, grids):
    x8 = torch.floor(torch.rand(5, h, h, generator=gen, device="cuda") * 256)
    luts_c, luts_f = _luts(gen, 5, grids[0]), _luts(gen, 5, grids[1])
    sel = torch.tensor([True, False, False, True, False], device="cuda")
    got = clahe.apply_luts_dual(x8, luts_c, luts_f, sel, *grids)
    want = torch.where(sel.reshape(5, 1, 1),
                       clahe._interp_luts(x8, luts_c, grids[0]),
                       clahe._interp_luts(x8, luts_f, grids[1]))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_quality_wrappers_refuse(gen):
    """A wrong dtype or a non-contiguous input raises; it never falls back
    to the plain version."""
    x = torch.rand(2, 64, 64, 1, generator=gen, device="cuda")
    luts = _luts(gen, 2, (4, 4))
    for bad in (x.double(), x.transpose(1, 2)):
        with pytest.raises((TypeError, ValueError)):
            percentile.fused_stats_quantile(bad, 0.999)
        with pytest.raises((TypeError, ValueError)):
            stencil.fused_median_bilateral(bad)
        with pytest.raises((TypeError, ValueError)):
            clahe.apply_luts(bad[..., 0], luts, (4, 4))
    with pytest.raises(ValueError):
        stencil.fused_median_bilateral(x, d=4)
    with pytest.raises(ValueError):
        clahe.apply_luts(x[..., 0], luts[:1], (4, 4))
    with pytest.raises(ValueError):
        clahe.apply_luts_dual(x[..., 0], luts, luts, torch.ones(3, dtype=torch.bool,
                                                                device="cuda"),
                              (4, 4), (4, 4))


# every stride-1 depthwise shape of efficientnet_b0 at 224² and of
# efficientnet_b3 at 300² (sides 75, 19 and 10), batches cut to 2 and 1
DW_SHAPES = sorted(set(stride1_depthwise_shapes("efficientnet_b0", 2, 224))
                   | set(stride1_depthwise_shapes("efficientnet_b3", 1, 300)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,k", DW_SHAPES)
def test_depthwise(gen, dtype, b, h, w, c, k):
    """Q2-17 against its plain version, one launch counted, and two runs
    bit-equal."""
    x = _rn(gen, b, h, w, c, dtype=dtype)
    wt = _rn(gen, c, 1, k, k, scale=0.2, dtype=dtype)
    before = depthwise_pallas.depthwise_conv2d_pallas.launches
    got = depthwise_pallas.depthwise_conv2d_pallas(x, wt)
    assert depthwise_pallas.depthwise_conv2d_pallas.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, depthwise_pallas.depthwise_conv2d_plain(x, wt), dtype)
    assert torch.equal(got, depthwise_pallas.depthwise_conv2d_pallas(x, wt))


@pytest.mark.cuda
def test_depthwise_backward_and_refusals(gen):
    """Autograd through the wrapper gives the plain version's gradients; a
    wrong dtype, a non-contiguous input, a kernel size the kernel does not
    take and a weight of another dtype raise: never the plain version."""
    x = _rn(gen, 2, 17, 9, 40)
    wt = _rn(gen, 40, 1, 5, 5, scale=0.2)
    dy = _rn(gen, 2, 17, 9, 40)
    grads = []
    for fn in (depthwise_pallas.depthwise_conv2d_pallas,
               depthwise_pallas.depthwise_conv2d_plain):
        xa, wa = x.clone().requires_grad_(), wt.clone().requires_grad_()
        fn(xa, wa).backward(dy)
        grads.append((xa.grad, wa.grad))
    _close(grads[0][0], grads[1][0], torch.float32)
    _close(grads[0][1], grads[1][1], torch.float32, DBIAS_RTOL)
    for bad_x, bad_w in ((x.double(), wt.double()), (x.transpose(1, 2), wt),
                         (x, wt.bfloat16()), (x, _rn(gen, 40, 1, 4, 4))):
        with pytest.raises((TypeError, ValueError)):
            depthwise_pallas.depthwise_conv2d_pallas(bad_x, bad_w)


# rows 7 and 8 in float32: within 2e-5 of max(1, max|plain|) (the JAX
# LN-kernel test's bound; sums over C up to 768 in another order)
ATTN_RTOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bw,heads,n,d,nw", [(8, 3, 49, 32, 4), (6, 2, 16, 24, 1),
                                             (5, 1, 64, 40, 0)])
def test_window_attention(gen, dtype, bw, heads, n, d, nw):
    """Row 8 against its plain version: ragged N (49), a head width that is
    not a multiple of 32, no mask; one launch counted."""
    q, k, v = (_rn(gen, bw, heads, n, d, dtype=dtype) for _ in range(3))
    bias = _rn(gen, heads, n, n, scale=0.1)
    mask = torch.where(torch.rand(nw, n, n, generator=gen, device="cuda") > 0.8,
                       -100.0, 0.0) if nw else None
    before = attention.fused_window_attention.launches
    got = attention.fused_window_attention(q, k, v, bias, mask)
    assert attention.fused_window_attention.launches == before + 1
    assert got.dtype == dtype
    _close(got, attention.window_attention_reference(q, k, v, bias, mask), dtype,
           ATTN_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,r,c,heads,ws,shift,qkv_bias", [
    (2, 16, 96, 3, 4, 2, True), (1, 14, 384, 12, 7, 3, False),
    (3, 7, 768, 24, 7, 0, True), (1, 8, 40, 1, 8, 0, True)])
def test_swin_ln_attention(gen, dtype, b, r, c, heads, ws, shift, qkv_bias):
    """Row 7 against its plain version at shifted and unshifted maps, widths
    96-768, a 3·dh of 120 columns (one partial projection tile) and no QKV
    bias; one launch counted; forward only."""
    n = ws * ws
    mask = shift_attention_mask(r, r, ws, shift)
    args = (_rn(gen, b, r, r, c, dtype=dtype), 1 + _rn(gen, c, scale=0.1),
            _rn(gen, c, scale=0.1), _rn(gen, c, 3 * c, scale=c ** -0.5),
            _rn(gen, 3 * c, scale=0.1) if qkv_bias else None,
            _rn(gen, heads, n, n, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    before = attention.fused_swin_ln_attention.launches
    got = attention.fused_swin_ln_attention(*args, **kw)
    assert attention.fused_swin_ln_attention.launches == before + 1
    _close(got, attention.swin_ln_attention_plain(*args, **kw), dtype, ATTN_RTOL)
    with pytest.raises(ValueError):
        attention.fused_swin_ln_attention(args[0].transpose(1, 2), *args[1:], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("h,grids", [(512, ((16, 16), (32, 32))),
                                     (90, ((3, 5), (6, 10)))])
def test_clahe_uint16_dual_fused(gen, h, grids):
    """Row 16 bit-equal to its plain version: mixed grid and apply flags, a
    flat frame (span 0, floored) and an untouched one (passed through)."""
    x = torch.rand(5, h, h, 1, generator=gen, device="cuda") * 65535
    x[3] = 1234.5
    sel = torch.tensor([True, False, False, True, False], device="cuda")
    app = torch.tensor([True, True, False, True, True], device="cuda")
    kw = dict(clip_coarse=2.0, grid_coarse=grids[0], clip_fine=0.03,
              grid_fine=grids[1])
    before = clahe.apply_luts_dual_fused.launches
    got = clahe.clahe_uint16_dual_fused(x, sel, app, **kw)
    assert clahe.apply_luts_dual_fused.launches == before + 1
    want = clahe.clahe_uint16_dual_fused_plain(x, sel, app, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[2], x[2]) and torch.equal(got[3], torch.floor(x[3]))
