"""The port's per-window attention (fused_window_attention) and its LN +
QKV + W-MSA serving op (fused_swin_ln_attention) against the JAX package's
Pallas kernels in interpret mode, on the CPU, on numpy-seeded inputs; the
port runs its plain versions here (window_attention_reference,
swin_ln_attention_plain)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.ops import attention as jattn
from thyroid_tpu.models.vit.swin import shift_attention_mask
from thyroid_tpu_torch.ops import attention as tattn
from thyroid_tpu_torch.ops import fused_window_attention


def _qkvb(seed, bw=8, h=3, n=49, d=32):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(bw, h, n, d).astype(np.float32) for _ in range(3))
    bias = (rs.randn(h, n, n) * 0.1).astype(np.float32)
    mask = np.where(rs.rand(4, n, n) > 0.8, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


@pytest.mark.unit
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "shift_mask"])
def test_fused_window_attention_matches_jax(masked):
    """(8, 3, 49, 32) float32 against JAX's kernel in interpret mode, 1e-5
    (tests/unit/test_pallas_attention.py's bound against its reference)."""
    q, k, v, bias, mask = _qkvb(0)
    m = mask if masked else None
    want = np.asarray(jattn.fused_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if m is None else jnp.asarray(m), interpret=True))
    got = fused_window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        None if m is None else torch.from_numpy(m))
    assert got.shape == (8, 3, 49, 32) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.unit
def test_fused_window_attention_bf16():
    """bf16 q/k/v: a bf16 result within 0.05 of the float32 JAX kernel, as
    the JAX package's own bf16 test holds its kernel; and within one bf16
    rounding of JAX's bf16 kernel output."""
    q, k, v, bias, _ = _qkvb(1)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want32 = np.asarray(jattn.fused_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), interpret=True))
    want16 = np.asarray(jattn.fused_window_attention(
        *jb, jnp.asarray(bias), interpret=True).astype(jnp.float32))
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jb]
    got = fused_window_attention(*tb, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want32).max() < 0.05
    assert np.abs(got - want16).max() <= 2 ** -7 * max(1.0, np.abs(want16).max())


@pytest.mark.unit
def test_fused_window_attention_refuses():
    q, k, v, bias, mask = (torch.from_numpy(a) for a in _qkvb(2))
    with pytest.raises(ValueError, match="mask"):
        fused_window_attention(q, k, v, bias, mask[:3])
    with pytest.raises(ValueError, match="bias"):
        fused_window_attention(q, k, v, bias[:2])
    with pytest.raises(RuntimeError, match="no backward"):
        fused_window_attention(q.requires_grad_(), k, v, bias)


def _ln_inputs(seed, B, H, W, C, heads, ws, shift, with_bias=True):
    rs = np.random.RandomState(seed)
    n = ws * ws
    x = rs.randn(B, H, W, C).astype(np.float32)
    g = (1 + 0.1 * rs.randn(C)).astype(np.float32)
    bln = (0.1 * rs.randn(C)).astype(np.float32)
    wqkv = (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32)
    bqkv = (0.1 * rs.randn(3 * C)).astype(np.float32) if with_bias else None
    bias = (rs.randn(heads, n, n) * 0.1).astype(np.float32)
    mask = shift_attention_mask(H, W, ws, shift)
    return x, g, bln, wqkv, bqkv, bias, mask


# the three cases of tests/unit/test_pallas_attention.py's _ln_case tests:
# one lane group, several groups with a shift mask, no QKV bias with images
# packed per grid step; then Swin's own 7 x 7 window, and swin_large's
# stage 4 (C = 1536, 48 heads of 32) on one 7 x 7 window, the width the bf16
# kernel streams its normalised rows at
LN_CASES = [((2, 8, 8, 96, 3, 4, 0), True), ((2, 8, 8, 192, 6, 4, 2), True),
            ((4, 4, 4, 128, 4, 4, 0), False), ((1, 14, 14, 96, 3, 7, 3), True),
            ((1, 7, 7, 1536, 48, 7, 0), True)]


@pytest.mark.unit
@pytest.mark.parametrize("case,with_bias", LN_CASES,
                         ids=["single_group", "multi_group_shifted",
                              "no_bias_batch_packed", "window_7_shifted",
                              "swin_large_stage4"])
def test_swin_ln_attention_matches_jax(case, with_bias):
    """swin_ln_attention_plain (what fused_swin_ln_attention runs on the
    CPU) against JAX's fused_swin_ln_attention in interpret mode, 2e-5 (the
    JAX test's bound against its XLA composition)."""
    B, H, W, C, heads, ws, shift = case
    x, g, bln, wqkv, bqkv, bias, mask = _ln_inputs(7, *case, with_bias)
    want = np.asarray(jattn.fused_swin_ln_attention(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(bln), jnp.asarray(wqkv),
        None if bqkv is None else jnp.asarray(bqkv), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), window_size=ws,
        num_heads=heads, interpret=True))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = tattn.fused_swin_ln_attention(
        t(x), t(g), t(bln), t(wqkv), t(bqkv), t(bias), t(mask),
        window_size=ws, num_heads=heads)
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 2e-5


@pytest.mark.unit
def test_swin_ln_attention_bf16_and_refusals():
    """bf16 x: xn and the weight rounded to bf16, the output bf16, within
    one bf16 rounding of JAX's bf16 kernel; forward only."""
    case = (2, 8, 8, 96, 3, 4, 2)
    x, g, bln, wqkv, bqkv, bias, mask = _ln_inputs(8, *case)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jattn.fused_swin_ln_attention(
        xb, jnp.asarray(g), jnp.asarray(bln), jnp.asarray(wqkv),
        jnp.asarray(bqkv), jnp.asarray(bias), jnp.asarray(mask), window_size=4,
        num_heads=3, interpret=True).astype(jnp.float32))
    args = [torch.from_numpy(a) for a in (g, bln, wqkv, bqkv, bias, mask)]
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = tattn.fused_swin_ln_attention(xt, *args, window_size=4, num_heads=3)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() \
        <= 2 ** -7 * max(1.0, np.abs(want).max())
    with pytest.raises(ValueError, match="mask"):
        tattn.fused_swin_ln_attention(xt, *args[:5], args[5][:2],
                                      window_size=4, num_heads=3)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.fused_swin_ln_attention(xt.float().requires_grad_(), *args,
                                      window_size=4, num_heads=3)
