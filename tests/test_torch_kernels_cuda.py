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
apply exact. The depthwise kernel: bit-equal to its plain version (its
stated contract); its autograd backward's dw, a sum over B·H·W,
DBIAS_RTOL. Row 8's bf16 tensor-core kernel also within MODEL_RTOL of the
model of its roundings (tests/test_torch_window_attention_tc.py), differing
from it in at most MODEL_SHARE of the elements."""
import pytest
import torch

from thyroid_tpu_torch.models.cnn.efficientnet import stride1_depthwise_shapes
from thyroid_tpu_torch.models.vit.swin import shift_attention_mask
from thyroid_tpu_torch.ops import (attention, clahe, depthwise_pallas,
                                   percentile, stencil, token_fused)
from tests.test_torch_window_attention_tc import (MODEL_RTOL, MODEL_SHARE,
                                                  window_attention_tc_model)

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


def _same_bits(got, want):
    """Bit-equal, a NaN equal to any NaN."""
    torch.cuda.synchronize()
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    same = (got.view(ints) == want.view(ints)) | (torch.isnan(got) & torch.isnan(want))
    return got.shape == want.shape and got.dtype == want.dtype and bool(same.all())


def _percentile_batch(gen, b, side, dtype, kind):
    """b uint16-scale images side x side: uniform ("random"), or "mixed":
    image i constant (i % 4 == 0), two-valued (90% 17, 10% 60000), uniform
    with a +inf pixel, uniform."""
    x = torch.rand(b, side, side, 1, generator=gen, device="cuda") * 65535
    if kind == "mixed":
        x[0::4] = 4321.0
        x[1::4] = torch.where(x[1::4] < 0.9 * 65535, 17.0, 60000.0)
        x[2::4, 5, 7] = float("inf")
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "mixed"])
@pytest.mark.parametrize("side", [224, 256])
@pytest.mark.parametrize("b", [1, 3, 32, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_percentile_bit_equal(gen, dtype, b, side, kind):
    """Kernel 1 bit-equal to percentile_normalize_plain (NaN to NaN) on
    constant, two-valued and inf-holding images, 1-23 steps, at the served
    buckets' sizes: each image staged on chip by its cluster, and every
    cluster in the first wave up to bucket 32 (and at 128 × 224² in bf16);
    two runs bit-equal."""
    x = _percentile_batch(gen, b, side, dtype, kind)
    launch = percentile.percentile_normalize_launch(x)
    image = x[0].numel() * x.element_size()
    assert launch["staged"] == 1 and launch["cluster"] in (1, 2, 4, 8), launch
    assert launch["stage_bytes"] == -(-image // (16 * launch["cluster"])) * 16, launch
    assert launch["clusters_at_once"] >= (b if b <= 32 or image == 224 * 224 * 2 else 1), launch
    for iters in (1, 7, 22, 23):
        got = percentile.fused_percentile_normalize(x, iters=iters)
        again = percentile.fused_percentile_normalize(x, iters=iters)
        want = percentile.percentile_normalize_plain(x, iters=iters)
        assert _same_bits(got, want), iters
        assert _same_bits(again, got), iters


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset", [((1, 512, 512, 1), 0), ((3, 17, 19, 1), 0),
                                          ((2, 224, 224, 1), 1)])
def test_percentile_streamed(gen, dtype, shape, offset):
    """Kernel 1's streamed slices, bit-equal: a 512² image of one cluster
    (1 MB in float32: above 8 CTAs' stages), odd sizes (not whole 16-byte
    units) and a view one element off its storage's start."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    base = _percentile_batch(gen, n + offset, 1, dtype, "random").reshape(-1)
    x = base[offset:].reshape(shape)
    launch = percentile.percentile_normalize_launch(x)
    assert launch["staged"] == int(dtype == torch.bfloat16 and shape[1] == 512), launch
    for iters in (7, 22):
        got = percentile.fused_percentile_normalize(x, iters=iters)
        assert _same_bits(got, percentile.percentile_normalize_plain(x, iters=iters))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,o,bias", [(70, 96, 288, True), (33, 40, 20, False),
                                        (130, 1536, 768, False), (130, 96, 288, True)])
def test_ln_matmul(gen, dtype, t, c, o, bias):
    args = (_rn(gen, t, c, dtype=dtype), 1 + _rn(gen, c, scale=0.1),
            _rn(gen, c, scale=0.1), _rn(gen, c, o, scale=c ** -0.5, dtype=dtype),
            _rn(gen, o, scale=0.1) if bias else None)
    _close(token_fused.fused_ln_matmul(*args),
           token_fused.ln_matmul_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,h", [(45, 96, 384), (33, 100, 200),
                                   (40, 1024, 4096), (200, 1536, 6144)])
def test_ln_mlp_residual(gen, dtype, t, c, h):
    """Ragged rows and widths, and swin_base's and swin_large's last stages
    (C = 1024, 1536): in float32 the scalar kernel takes 16 rows a block
    above C = 1024, where 32 rows do not fit in shared memory."""
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
    (1, 16, 64, 1, 8, 4), (4, 56, 96, 3, 7, 3), (2, 28, 192, 6, 7, 3),
    (2, 7, 1024, 32, 7, 0), (2, 7, 1536, 48, 7, 0)])
def test_swin_block_attention(gen, dtype, b, r, c, heads, ws, shift):
    """Kernel 4 against its plain version and two runs bit-equal: in bf16
    the tensor-core kernel, with CTAs of two windows and paired heads
    (stage 1 at batch 4), swin_base's and swin_large's last stages (C =
    1024, 1536: column blocks); in float32 the scalar attention into a
    float32 workspace and the scalar projection, at every width up to
    swin_large's 1536."""
    n = ws * ws
    mask = shift_attention_mask(r, r, ws, shift)
    args = (_rn(gen, b, r, r, 3, c, dtype=dtype), _rn(gen, b, r, r, c, dtype=dtype),
            _rn(gen, c, c, scale=0.05, dtype=dtype), _rn(gen, c, scale=0.1),
            _rn(gen, heads, n, n, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    got = attention.fused_swin_block_attention(*args, **kw)
    _close(got, attention.swin_block_attention_plain(*args, **kw), dtype)
    assert torch.equal(got, attention.fused_swin_block_attention(*args, **kw))


# (tokens, width, hidden): ragged row blocks, widths that are not multiples
# of 64 or 4, hidden widths with a partial chunk of 128 and of 16, and the
# wide path past C = 768: swin_base's and swin_large's stage 4 (two windows
# of 49 tokens) and a width that is not a multiple of 64
TOKEN_BWD_CASES = [(70, 96, 384), (33, 40, 200), (130, 768, 3072), (45, 100, 72),
                   (98, 1024, 4096), (98, 1536, 6144), (70, 1000, 4000)]


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


def _close_to_exact(got, want, exact, sums):
    """bf16 past C = 768: dX at RTOL of the plain version; each sum over
    tokens within DBIAS_RTOL of it, or no farther from the float64
    evaluation of the same roundings (`exact`) than 1.5 times the plain
    float32 version's own distance from it. A C-deep float32 contraction
    flips some bf16 roundings of the hidden layer (hr, dH) whichever order
    it sums in; at C = 1536 the plain version's dW sums stand 1e-3 of
    their largest value from `exact`, as far as the kernel's (PERF.md)."""
    bf = torch.bfloat16
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        if i not in sums:
            _close(g, w, bf)
            continue
        g, w, e = g.double(), w.double(), e.double()
        torch.cuda.synchronize()
        err = (g - w).abs().max().item()
        if err <= DBIAS_RTOL[bf] * max(1.0, w.abs().max().item()):
            continue
        own = (w - e).abs().max().item()
        assert (g - e).abs().max().item() <= 1.5 * own, (i, err, own)


# kernel 9's own cases: the token cases (h as the output width O) and the
# QKV shapes O = 3C, up to swin_large's last stage, and a ragged C = 40
LN_MATMUL_BWD_CASES = TOKEN_BWD_CASES + [(100, 96, 288), (70, 384, 1152),
                                         (130, 768, 2304), (45, 40, 120),
                                         (98, 1024, 3072), (98, 1536, 4608)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c,h", LN_MATMUL_BWD_CASES)
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
    if dtype == torch.bfloat16 and c > 768:
        _close_to_exact(got, want, token_fused.ln_mlp_bwd_plain(
            *args, residual, acc=torch.float64), (1, 2, 3, 4, 5))
    else:
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
    """A dY that does not match raises, at a narrow width and on the wide
    path; no width is refused (JAX's kernels take any C), and a call never
    falls back to the plain version."""
    x, g, b, w1, b1, w2, dy = _token_args(gen, torch.float32, 8, 1024, 64)
    with pytest.raises(ValueError):
        token_fused.fused_ln_mlp_bwd_dx(x, g, b, w1, b1, w2, dy[:, :512],
                                        residual=False)
    with pytest.raises(ValueError):
        token_fused.fused_ln_mlp_bwd_dw(x, g, b, w1, b1, w2, dy.to(torch.bfloat16))
    before = token_fused.fused_ln_mlp_bwd_dw.launches
    token_fused.fused_ln_mlp_bwd_dw(x, g, b, w1, b1, w2, dy)
    assert token_fused.fused_ln_mlp_bwd_dw.launches == before + 1
    x, g, b, w1, b1, w2, dy = _token_args(gen, torch.float32, 8, 64, 64)
    with pytest.raises(ValueError):
        token_fused.fused_ln_mlp_bwd_dw(x, g, b, w1, b1, w2, dy[:4])
    with pytest.raises(ValueError):
        token_fused.fused_ln_matmul_bwd(x, g, w1, dy.to(torch.bfloat16))


# (B, H, C, heads, ws, shift): the bf16 kernels' work items of one head
# (C = 32, 64) and of a pair and a single (3 heads), windows of 16, 49 and
# 64 tokens, two windows a CTA walks in turn (B = 2 at stage 1's width),
# and swin_large's last stage (C = 1536, 48 heads)
SWIN_TRAIN_CASES = [
    (1, 8, 32, 1, 4, 0), (1, 16, 96, 3, 4, 2), (1, 14, 192, 6, 7, 0),
    (1, 14, 384, 12, 7, 3), (1, 7, 768, 24, 7, 0), (1, 16, 64, 1, 8, 4),
    (1, 16, 128, 4, 8, 0), (2, 14, 96, 3, 7, 3), (1, 7, 1536, 48, 7, 0)]


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
@pytest.mark.parametrize("b,r,c,heads,ws,shift", [
    (2, 14, 96, 3, 7, 3), (4, 28, 192, 6, 7, 3), (1, 7, 1536, 48, 7, 0)])
def test_swin_attention_bf16_deterministic(gen, b, r, c, heads, ws, shift):
    """The bf16 backward keeps per-CTA dbias sums added in a fixed order
    (no atomics): two runs are bit-equal in dqkv and dbias, and so are two
    runs of the forward."""
    n = ws * ws
    mask = shift_attention_mask(r, r, ws, shift)
    qkv = _rn(gen, b, r, r, 3, c, dtype=torch.bfloat16)
    bias = _rn(gen, heads, n, n, scale=0.1)
    m = torch.from_numpy(mask).cuda() if mask is not None else None
    dout = _rn(gen, b, r, r, c, dtype=torch.bfloat16)
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    dq, db = attention.fused_swin_attention_bwd(qkv, dout, bias, m, **kw)
    dq2, db2 = attention.fused_swin_attention_bwd(qkv, dout, bias, m, **kw)
    out = attention.fused_swin_attention(qkv, bias, m, **kw)
    out2 = attention.fused_swin_attention(qkv, bias, m, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(db, db2)
    assert torch.equal(out, out2)


@pytest.mark.cuda
def test_swin_attention_bf16_refuses(gen):
    """A bf16 head width the tensor-core kernels do not take (12: not a
    multiple of 8) raises from the launch, forward and backward; it is
    never sent to the scalar float32 kernels."""
    qkv = _rn(gen, 1, 8, 8, 3, 36, dtype=torch.bfloat16)
    bias = _rn(gen, 3, 16, 16, scale=0.1)
    kw = dict(window_size=4, num_heads=3, scale=12 ** -0.5)
    with pytest.raises(RuntimeError):
        attention.fused_swin_attention(qkv, bias, None, **kw)
    with pytest.raises(RuntimeError):
        attention.fused_swin_attention_bwd(
            qkv, _rn(gen, 1, 8, 8, 36, dtype=torch.bfloat16), bias, None, **kw)


def _stats_input(gen, shape, offset, kind):
    """A batch of `shape` starting `offset` floats into its storage: random
    uint16-scale integers, a constant image, or two values."""
    n = torch.Size(shape).numel()
    buf = torch.floor(torch.rand(n + offset, generator=gen, device="cuda") * 65535)
    if kind == "constant":
        buf.fill_(1234.0)
    elif kind == "two":
        buf = torch.where(buf < 40000, 17.0, 60000.0)
    return buf[offset:].reshape(shape)


# (shape, offset, kind, iters). The kernel takes an image as a cluster of 16
# CTAs: 512² is staged in their shared memory; n % 4 != 0, a view 4 bytes
# into its storage and 1024² (256 KiB a CTA, above its 92 KiB) stream from
# global memory; n = 7 and n = 12 leave CTAs without pixels; 50x50
# (625 float4s) does not split evenly; iters 1, 7 and 23 are not multiples
# of the 8 steps a counting pass settles.
STATS_CASES = [((3, 17, 19, 1), 0, "random", 22), ((4, 512, 512, 1), 0, "random", 22),
               ((1, 1, 7, 1), 0, "random", 22), ((2, 64, 64, 1), 1, "random", 22),
               ((2, 3, 4, 1), 0, "random", 22), ((2, 50, 50, 1), 0, "random", 22),
               ((1, 1024, 1024, 1), 0, "random", 22), ((2, 512, 512, 1), 0, "constant", 22),
               ((2, 512, 512, 1), 0, "two", 22), ((2, 64, 64, 1), 0, "two", 22),
               ((2, 512, 512, 1), 0, "random", 1), ((2, 512, 512, 1), 0, "random", 7),
               ((2, 512, 512, 1), 0, "random", 23), ((2, 17, 19, 1), 0, "random", 23)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset,kind,iters", STATS_CASES)
def test_stats_quantile(gen, shape, offset, kind, iters):
    """The quantile, max and min bit-equal to the plain version, the mean
    and std within 1e-5, at every path of the kernel (see STATS_CASES)."""
    x = _stats_input(gen, shape, offset, kind)
    before = percentile.fused_stats_quantile.launches
    got = percentile.fused_stats_quantile(x, 0.999, iters)
    assert percentile.fused_stats_quantile.launches == before + 1
    want = percentile.stats_quantile_plain(x, 0.999, iters)
    torch.cuda.synchronize()
    for k in ("quantile", "max", "min"):
        assert torch.equal(got[k], want[k]), k
    for k in ("mean", "std"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((32, 512, 512, 1), 0), ((2, 1024, 1024, 1), 0),
                                          ((3, 17, 19, 1), 1)])
def test_stats_quantile_deterministic(gen, shape, offset):
    """Two runs give the same bits in all five outputs (the cluster's sums
    are combined in a fixed order), staged and streamed."""
    x = _stats_input(gen, shape, offset, "random")
    a = percentile.fused_stats_quantile(x, 0.999)
    b = percentile.fused_stats_quantile(x, 0.999)
    torch.cuda.synchronize()
    for k in a:
        assert torch.equal(a[k], b[k]), k


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 5, 7])
def test_median_bilateral_mixed_tiles(gen, d):
    """One launch in which some tiles hold only 8-bit integers (the colour
    table) and others fractional, negative or above-255 values (the
    per-tap expf): frame 0 integral, frame 1 integral but for a fractional
    patch, frame 2 integral but for a band outside [0, 255]."""
    x8 = torch.floor(torch.rand(3, 130, 200, 1, generator=gen, device="cuda") * 256)
    x8[1, 40:60, 90:150] += 0.25
    x8[2, 100:104] = x8[2, 100:104] * 1.5 - 20.0
    med, bil = stencil.fused_median_bilateral(x8, d=d)
    want_med, want_bil = stencil.median_bilateral_plain(x8, d=d)
    torch.cuda.synchronize()
    assert torch.equal(med, want_med)
    assert (bil - want_bil).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 5, 7])
@pytest.mark.parametrize("h,w", [(96, 128), (37, 100), (130, 68), (50, 101)])
def test_median_bilateral_storage_offset(gen, d, h, w):
    """The same frames at a 16-byte aligned start (16-byte copies inside
    the frame) and 4 bytes into their storage (4-byte copies only) give the
    same bits, and the plain version's median; frames whose sides are not
    multiples of the 64x32 tile put windows past the frame's far edges, and
    a width that is not a multiple of 4 takes 4-byte copies at any start."""
    n = 2 * h * w
    buf = torch.floor(torch.rand(n + 1, generator=gen, device="cuda") * 256)
    aligned = buf[:n].reshape(2, h, w, 1).clone()
    shifted = buf[1:].reshape(2, h, w, 1)
    shifted.copy_(aligned)
    got_a = stencil.fused_median_bilateral(aligned, d=d)
    got_s = stencil.fused_median_bilateral(shifted, d=d)
    want_med, want_bil = stencil.median_bilateral_plain(aligned, d=d)
    torch.cuda.synchronize()
    assert torch.equal(got_a[0], got_s[0]) and torch.equal(got_a[1], got_s[1])
    assert torch.equal(got_a[0], want_med)
    assert (got_a[1] - want_bil).abs().max().item() <= 1e-2


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
@pytest.mark.parametrize("b,h,w,grids", [
    (4, 512, 512, ((16, 16), (32, 32))), (7, 105, 99, ((3, 3), (6, 6))),
    (9, 64, 48, ((4, 4), (8, 8))), (2, 37, 41, ((1, 1), (2, 2)))])
def test_apply_luts_dual_shapes(gen, b, h, w, grids):
    """Kernel 15 bit-equal to the plain blend at the quality grids on 512²
    frames, odd tile sides (35 × 33; 17 × 16 with rows and columns past the
    last whole tile), a width of no whole 16-byte units (99, 41), batches
    whose rows split unevenly over the persistent blocks, one-tile grids
    and random coarse/fine selections; kernel 14 likewise on each grid."""
    x8 = torch.floor(torch.rand(b, h, w, generator=gen, device="cuda") * 300) - 20
    luts_c, luts_f = _luts(gen, b, grids[0]), _luts(gen, b, grids[1])
    sel = torch.rand(b, generator=gen, device="cuda") < 0.5
    sel[0], sel[-1] = True, False
    got = clahe.apply_luts_dual(x8, luts_c, luts_f, sel, *grids)
    want = torch.where(sel.reshape(b, 1, 1), clahe._interp_luts(x8, luts_c, grids[0]),
                       clahe._interp_luts(x8, luts_f, grids[1]))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for lut, grid in ((luts_c, grids[0]), (luts_f, grids[1])):
        assert torch.equal(clahe.apply_luts(x8, lut, grid), clahe._interp_luts(x8, lut, grid))


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
# efficientnet_b3 at 300² (sides 75, 19 and 10), batches cut to 2 and 1;
# then ragged channel counts, whose rows of bytes take 8-byte copies (C =
# 20 in bf16) and 16-byte ones with a part-empty group (C = 36 in float32),
# and an odd C at k = 7 (bf16: 2-byte loads; no EfficientNet conv has k = 7)
DW_SHAPES = sorted(set(stride1_depthwise_shapes("efficientnet_b0", 2, 224))
                   | set(stride1_depthwise_shapes("efficientnet_b3", 1, 300))) \
    + [(1, 9, 17, 20, 3), (2, 17, 9, 36, 5), (1, 12, 13, 17, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,k", DW_SHAPES)
def test_depthwise(gen, dtype, b, h, w, c, k):
    """Q2-17 bit-equal to its plain version (its stated contract), one
    launch counted, and two runs bit-equal."""
    x = _rn(gen, b, h, w, c, dtype=dtype)
    wt = _rn(gen, c, 1, k, k, scale=0.2, dtype=dtype)
    before = depthwise_pallas.depthwise_conv2d_pallas.launches
    got = depthwise_pallas.depthwise_conv2d_pallas(x, wt)
    assert depthwise_pallas.depthwise_conv2d_pallas.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, depthwise_pallas.depthwise_conv2d_plain(x, wt))
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
    """Row 8 against its plain version: ragged N (49), head widths that are
    not multiples of 16 (24, 40: the scalar kernel in both types), no mask;
    one launch counted."""
    q, k, v = (_rn(gen, bw, heads, n, d, dtype=dtype) for _ in range(3))
    bias = _rn(gen, heads, n, n, scale=0.1)
    mask = torch.where(torch.rand(nw, n, n, generator=gen, device="cuda") > 0.8,
                       -100.0, 0.0) if nw else None
    assert attention.window_attention_route(q, k, v) == (
        "wgmma" if dtype == torch.bfloat16 and d % 16 == 0 else "scalar")
    before = attention.fused_window_attention.launches
    got = attention.fused_window_attention(q, k, v, bias, mask)
    assert attention.fused_window_attention.launches == before + 1
    assert got.dtype == dtype
    _close(got, attention.window_attention_reference(q, k, v, bias, mask), dtype,
           ATTN_RTOL)


def _window_tc_check(record_property, q, k, v, bias, mask):
    """Row 8 in bf16 on wgmma: within ATTN_RTOL of the plain version, within
    MODEL_RTOL of the model of its roundings and differing from it in at
    most MODEL_SHARE of the elements (both recorded as the test's
    properties, model_err and model_share, for a JUnit report); two runs
    bit-equal, one launch a call."""
    assert attention.window_attention_route(q, k, v) == "wgmma"
    before = attention.fused_window_attention.launches
    got = attention.fused_window_attention(q, k, v, bias, mask)
    again = attention.fused_window_attention(q, k, v, bias, mask)
    assert attention.fused_window_attention.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, attention.window_attention_reference(q, k, v, bias, mask),
           torch.bfloat16, ATTN_RTOL)
    model = window_attention_tc_model(q, k, v, bias, mask).float()
    err = (got.float() - model).abs().max().item()
    assert err <= MODEL_RTOL * max(1.0, model.abs().max().item()), err
    share = (got.float() != model).float().mean().item()
    record_property("model_err", err / max(1.0, model.abs().max().item()))
    record_property("model_share", share)
    assert share <= MODEL_SHARE, share
    assert torch.equal(got, again)


# (b, r, c, heads, ws, shift) of row 8's blocks: swin_tiny's four stages at
# batch 32, shifted and unshifted (stage 4's 7 x 7 map never shifts), and
# swin_large's stage 4 (48 heads)
WINDOW_TC_STAGES = [(32, 56, 96, 3, 7, 0), (32, 56, 96, 3, 7, 3), (32, 28, 192, 6, 7, 0),
                    (32, 28, 192, 6, 7, 3), (32, 14, 384, 12, 7, 0), (32, 14, 384, 12, 7, 3),
                    (32, 7, 768, 24, 7, 0), (32, 7, 1536, 48, 7, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,c,heads,ws,shift", WINDOW_TC_STAGES)
def test_window_attention_tc_stages(gen, record_property, b, r, c, heads, ws, shift):
    """Row 8's tensor-core kernel at the Swin block shapes."""
    n, nw = ws * ws, (r // ws) ** 2
    q, k, v = (_rn(gen, b * nw, heads, n, c // heads, dtype=torch.bfloat16)
               for _ in range(3))
    mask = shift_attention_mask(r, r, ws, shift)
    _window_tc_check(record_property, q, k, v, _rn(gen, heads, n, n, scale=0.1),
                     torch.from_numpy(mask).cuda() if mask is not None else None)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [16, 49, 64])
@pytest.mark.parametrize("bw,heads,nw", [(1001, 1, 7), (20, 7, 0), (3, 2, 1)])
def test_window_attention_tc_ragged(gen, record_property, bw, heads, nw, n, d):
    """Row 8's tensor-core kernel at every window size it pads (16, 49) or
    fills (64) and head widths 16-64: 1,001 items, not a multiple of the
    CTAs, so that the CTAs' runs differ by one item and cross groups; 140;
    6, fewer than the CTAs. Masks of -100 where a uniform draw exceeds
    0.8."""
    q, k, v = (_rn(gen, bw, heads, n, d, dtype=torch.bfloat16) for _ in range(3))
    mask = torch.where(torch.rand(nw, n, n, generator=gen, device="cuda") > 0.8,
                       -100.0, 0.0) if nw else None
    _window_tc_check(record_property, q, k, v, _rn(gen, heads, n, n, scale=0.1), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,r,c,heads,ws,shift,qkv_bias", [
    (2, 16, 96, 3, 4, 2, True), (1, 14, 384, 12, 7, 3, False),
    (3, 7, 768, 24, 7, 0, True), (1, 8, 40, 1, 8, 0, True),
    (4, 56, 96, 3, 7, 3, True), (2, 14, 384, 12, 7, 3, True),
    (3, 63, 96, 3, 7, 0, False)])
def test_swin_ln_attention(gen, dtype, b, r, c, heads, ws, shift, qkv_bias):
    """Row 7 against its plain version at shifted and unshifted maps, widths
    96-768, a 3·dh of 120 columns (one partial projection tile) and no QKV
    bias; in bf16 two windows a CTA where the windows are many (256 windows
    of paired heads; 243, an odd count, whose last CTA has one); one launch
    counted; forward only."""
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
@pytest.mark.parametrize("c,heads", [(40, 2), (1088, 34)])
def test_swin_ln_attention_bf16_widths(gen, c, heads):
    """The bf16 kernel takes head widths that are multiples of 8 up to 64
    and C up to 1536 (C = 1088: its normalised rows from a workspace), and
    raises on a head width of 20; float32 takes both where its shared
    memory allows. It never falls back."""
    ws = 4
    args = (_rn(gen, 1, 8, 8, c), 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1),
            _rn(gen, c, 3 * c, scale=c ** -0.5), None, _rn(gen, heads, 16, 16, scale=0.1),
            None)
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    if c <= 768:  # float32's shared memory stops below C = 900
        _close(attention.fused_swin_ln_attention(*args, **kw),
               attention.swin_ln_attention_plain(*args, **kw), torch.float32, ATTN_RTOL)
    xb = args[0].bfloat16()
    if (c // heads) % 8:
        with pytest.raises(ValueError, match="head width"):
            attention.fused_swin_ln_attention(xb, *args[1:], **kw)
    else:
        _close(attention.fused_swin_ln_attention(xb, *args[1:], **kw),
               attention.swin_ln_attention_plain(xb, *args[1:], **kw), torch.bfloat16,
               ATTN_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,c,heads,shift", [(2, 7, 1088, 34, 0), (1, 14, 1536, 48, 3),
                                               (32, 7, 1536, 48, 0), (33, 7, 1536, 48, 0)])
def test_swin_ln_attention_bf16_wide(gen, b, r, c, heads, shift):
    """bf16 above C = 1024, where the A tiles do not fit beside the ring
    and the windows' normalised rows stream from a workspace: C = 1088 (17
    k-tiles), swin_large's stage 4 (C = 1536, 48 heads of 32, 7 × 7 maps:
    one window a CTA at batch 1, two at batch 32, and at 33 a last CTA with
    one) and a shifted 14 × 14 map; within the bf16 RTOL of the plain
    version, two runs bit-equal; C = 1600 still raises."""
    ws, n = 7, 49
    mask = shift_attention_mask(r, r, ws, shift)
    args = (_rn(gen, b, r, r, c, dtype=torch.bfloat16), 1 + _rn(gen, c, scale=0.1),
            _rn(gen, c, scale=0.1), _rn(gen, c, 3 * c, scale=c ** -0.5),
            _rn(gen, 3 * c, scale=0.1), _rn(gen, heads, n, n, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    before = attention.fused_swin_ln_attention.launches
    got = attention.fused_swin_ln_attention(*args, **kw)
    again = attention.fused_swin_ln_attention(*args, **kw)
    assert attention.fused_swin_ln_attention.launches == before + 2
    _close(got, attention.swin_ln_attention_plain(*args, **kw), torch.bfloat16, ATTN_RTOL)
    assert torch.equal(got, again)
    wide = 1600
    big = (_rn(gen, 1, 7, 7, wide, dtype=torch.bfloat16), 1 + _rn(gen, wide, scale=0.1),
           _rn(gen, wide, scale=0.1), _rn(gen, wide, 3 * wide, scale=wide ** -0.5), None,
           _rn(gen, 50, n, n, scale=0.1), None)
    with pytest.raises(ValueError, match="1536"):
        attention.fused_swin_ln_attention(*big, window_size=ws, num_heads=50)


@pytest.mark.cuda
@pytest.mark.parametrize("h,grids", [(512, ((16, 16), (32, 32))),
                                     (90, ((3, 5), (6, 10))), (66, ((3, 3), (6, 6)))])
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
