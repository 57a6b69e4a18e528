"""Port `fused_swin_attention` (thyroid_tpu_torch.ops.attention), the
differentiable W-MSA of the training path, against the JAX Pallas kernel
and its custom_vjp backward in interpret mode, on the CPU, at the JAX
tests' shapes (tests/unit/test_pallas_attention.py) plus one stage-4 shape.
Tolerances are the JAX tests' own: forward 1e-5 absolute; dqkv and dbias
2e-5 relative to max(1, max|ref|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.models.vit.swin import shift_attention_mask
from thyroid_tpu.ops import attention as jattn
from thyroid_tpu_torch.ops import attention as tattn

CASES = [
    (2, 8, 8, 96, 3, 4, 0),
    (2, 8, 8, 192, 6, 4, 2),      # 6 heads: uneven TPU lane groups (4, 2)
    (4, 4, 4, 128, 4, 4, 0),      # one window per image
    (1, 7, 7, 768, 24, 7, 0),     # swin_tiny stage 4
]


def _inputs(B, H, W, C, heads, ws, shift, seed=11):
    rs = np.random.RandomState(seed)
    n = ws * ws
    qkv = rs.randn(B, H, W, 3, C).astype(np.float32)
    bias = (rs.randn(heads, n, n) * 0.1).astype(np.float32)
    wvec = rs.randn(B, H, W, C).astype(np.float32)
    return qkv, bias, shift_attention_mask(H, W, ws, shift), wvec


def _rel(a, b):
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


@pytest.mark.unit
@pytest.mark.parametrize("B,H,W,C,heads,ws,shift", CASES)
def test_forward_and_grads_match_jax(B, H, W, C, heads, ws, shift):
    qkv, bias, mask, wvec = _inputs(B, H, W, C, heads, ws, shift)
    mask_j = None if mask is None else jnp.asarray(mask)

    def loss(q, b):
        out = jattn.fused_swin_attention(q, b, mask_j, window_size=ws,
                                         num_heads=heads, interpret=True)
        return (out * wvec).sum(), out

    (_, want), (gq, gb) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(bias))

    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    before = (tattn.fused_swin_attention.launches,
              tattn.fused_swin_attention.bwd_launches)
    got = tattn.fused_swin_attention(
        tq, tb, None if mask is None else torch.from_numpy(mask),
        window_size=ws, num_heads=heads)
    (got * torch.from_numpy(wvec)).sum().backward()
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() < 1e-5
    assert _rel(tq.grad.numpy(), np.asarray(gq)) < 2e-5
    assert tb.grad.dtype == torch.float32 and tb.grad.shape == (heads, ws * ws, ws * ws)
    assert _rel(tb.grad.numpy(), np.asarray(gb)) < 2e-5
    # the CPU runs the plain versions: no kernel launch is counted
    assert (tattn.fused_swin_attention.launches,
            tattn.fused_swin_attention.bwd_launches) == before


@pytest.mark.unit
@pytest.mark.parametrize("B,H,W,C,heads,ws,shift", CASES[:2])
def test_bwd_plain_matches_autograd_of_plain(B, H, W, C, heads, ws, shift):
    """The explicit backward formulas against torch autograd of the plain
    forward, float32, 1e-5 relative."""
    qkv, bias, mask, wvec = _inputs(B, H, W, C, heads, ws, shift, seed=12)
    m = None if mask is None else torch.from_numpy(mask)
    kw = dict(window_size=ws, num_heads=heads, scale=(C // heads) ** -0.5)
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = tattn.swin_attention_plain(tq, tb, m, **kw)
    dq_ref, db_ref = torch.autograd.grad(out, (tq, tb), torch.from_numpy(wvec))
    dq, db = tattn.swin_attention_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(wvec), torch.from_numpy(bias),
        m, **kw)
    assert dq.shape == (B, H, W, 3, C) and db.shape == bias.shape
    assert _rel(dq.numpy(), dq_ref.numpy()) < 1e-5
    assert _rel(db.numpy(), db_ref.numpy()) < 1e-5


@pytest.mark.unit
def test_bf16_grad_types_and_rounding():
    """bf16 qkv: the forward output and dqkv are bf16, dbias float32, the
    mask gets no gradient; the incoming gradient is rounded to bf16 before
    the backward, as the JAX custom_vjp does."""
    qkv, bias, mask, wvec = _inputs(2, 8, 8, 96, 3, 4, 2, seed=13)
    tq = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    tm = torch.from_numpy(mask).requires_grad_()
    out = tattn.fused_swin_attention(tq, tb, tm, window_size=4, num_heads=3)
    assert out.dtype == torch.bfloat16
    g = torch.from_numpy(wvec)
    out.float().backward(g)
    assert tq.grad.dtype == torch.bfloat16 and tb.grad.dtype == torch.float32
    assert tm.grad is None
    dq, db = tattn.swin_attention_bwd_plain(
        tq.detach(), g.to(torch.bfloat16), tb.detach(), tm.detach(),
        window_size=4, num_heads=3, scale=32 ** -0.5)
    assert torch.equal(tq.grad, dq) and torch.equal(tb.grad, db)


@pytest.mark.unit
def test_rows_per_step_is_ignored_and_shapes_checked():
    qkv, bias, mask, _ = _inputs(2, 8, 8, 96, 3, 4, 2, seed=14)
    args = (torch.from_numpy(qkv), torch.from_numpy(bias),
            torch.from_numpy(mask))
    a = tattn.fused_swin_attention(*args, window_size=4, num_heads=3)
    b = tattn.fused_swin_attention(*args, window_size=4, num_heads=3,
                                   rows_per_step=1)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tattn.fused_swin_attention(args[0], args[1][:2], args[2],
                                   window_size=4, num_heads=3)
    with pytest.raises(ValueError):
        tattn.fused_swin_attention(args[0], args[1], args[2][:1],
                                   window_size=4, num_heads=3)
