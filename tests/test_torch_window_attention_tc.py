"""A plain-torch model of the roundings of fused_window_attention's bf16
tensor-core kernel (csrc/window_attention.cu, window_attention_tc_kernel),
held against the JAX package's fused_window_attention in interpret mode on
the CPU. tests/test_torch_kernels_cuda.py holds the card's kernel to the
model at MODEL_RTOL.

The kernel's roundings, which the model repeats in float32:
- S = q kᵀ from the bf16 operands accumulated in float32, then S·scale
  (the scale in float32 on the accumulator, not q·scale rounded to bf16);
- the side table bias[h] + mask[b % nW], added in float32 once per group of
  items, then added to S·scale;
- the softmax in float32, max-shifted, e^x (the kernel's __expf, the model's
  exp) and one reciprocal a row: P = e · (1 / Σe);
- P rounded to bf16 (JAX keeps it in float32), P v accumulated in float32,
  O rounded to bf16.
JAX is imported inside the tests that call it, so that the card's test
file can import the model where JAX is not installed."""
from __future__ import annotations

from typing import Optional

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.vit.swin import shift_attention_mask
from thyroid_tpu_torch.ops import attention

# the model against JAX's bf16 kernel, relative to max(1, max|JAX|): the
# bf16 tolerance rows 7 and 8 are held to (chip_smoke.py ATTN_RTOL)
ATTN_RTOL_BF16 = 1e-2
# the card's kernel against the model, relative to max(1, max|model|):
# where the kernel's sums and __expf land a P or an O on the other side of
# a bf16 rounding boundary than the model's, one element moves by one bf16
# step of P times v or of O. A float64 stand-in for the kernel differs from
# the model by at most 1.6e-3 of that at the swin_tiny and swin_large stage
# shapes, in 1.5e-4 of the elements; the kernel may differ in at most
# MODEL_SHARE of them (a kernel that kept P in float32 differs in 40%).
MODEL_RTOL, MODEL_SHARE = 4e-3, 2e-2


def window_attention_tc_model(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None, *,
                              round_p: bool = True,
                              round_o: bool = True) -> torch.Tensor:
    """The bf16 tensor-core kernel's roundings on q, k, v (BW, h, N, d) in
    bf16, bias (h, N, N), mask (nW, N, N) or None → O (BW, h, N, d) in bf16
    (float32 with round_o=False; round_p=False keeps P in float32)."""
    bw, h, n, d = q.shape
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is None:
        s = s + bias.float()[None]
    else:
        nw = mask.shape[0]
        table = bias.float()[None] + mask.float()[:, None]        # (nW, h, N, N)
        s = (s.reshape(bw // nw, nw, h, n, n) + table[None]).reshape(bw, h, n, n)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    if round_p:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(torch.bfloat16) if round_o else o


def _inputs(seed, windows, heads, r, shift, ws=7, d=32):
    """bf16 q, k, v (windows, heads, ws², d) as numpy float32 holding bf16
    values, the bias N(0, 0.1²) and the shift mask of an r × r map."""
    rs = np.random.RandomState(seed)
    n = ws * ws
    qkv = [torch.from_numpy(rs.randn(windows, heads, n, d).astype(np.float32))
           .bfloat16() for _ in range(3)]
    bias = (rs.randn(heads, n, n) * 0.1).astype(np.float32)
    mask = shift_attention_mask(r, r, ws, shift)
    return qkv, bias, mask


def _jax_bf16(qkv, bias, mask):
    import jax.numpy as jnp

    from thyroid_tpu.ops import attention as jattn

    jq = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in qkv]
    out = jattn.fused_window_attention(
        *jq, jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


# (windows, heads, map side, shift): swin_tiny's stage 3 at batch 8 (32
# windows of a 14 × 14 map, 12 heads; batch 32's 128 windows take 4× the
# interpret mode's time) unshifted and shifted (4 window masks), and a
# 48-head stage 4 (swin_large's, 4 images of one window)
CASES = [(32, 12, 14, 0), (32, 12, 14, 3), (4, 48, 7, 0)]


@pytest.mark.unit
@pytest.mark.parametrize("windows,heads,r,shift", CASES,
                         ids=["stage3", "stage3_shifted", "stage4_48_heads"])
def test_model_matches_jax(windows, heads, r, shift):
    """The model in bf16 against JAX's fused_window_attention on the same
    bf16 inputs in interpret mode, within the bf16 tolerance."""
    qkv, bias, mask = _inputs(windows * heads + shift, windows, heads, r, shift)
    want = _jax_bf16(qkv, bias, mask)
    got = window_attention_tc_model(
        *qkv, torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and got.shape == qkv[0].shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= ATTN_RTOL_BF16 * max(1.0, np.abs(want).max()), err


@pytest.mark.unit
@pytest.mark.parametrize("shift", [0, 3], ids=["unshifted", "shifted"])
def test_model_rounds_only_p(shift):
    """Without P's rounding the model is window_attention_reference's
    float32 arithmetic; with it, O moves by at most bf16's unit roundoff
    of each P times |v|: |ΔO| ≤ 2⁻⁸ Σ_k P_k |v_k| (8 significant bits)."""
    qkv, bias, mask = _inputs(5 + shift, 8, 6, 14, shift)
    bias_t = torch.from_numpy(bias)
    mask_t = None if mask is None else torch.from_numpy(mask)
    exact = window_attention_tc_model(*qkv, bias_t, mask_t, round_p=False,
                                      round_o=False)
    rounded = window_attention_tc_model(*qkv, bias_t, mask_t, round_o=False)
    ref = attention.window_attention_reference(
        *(t.float() for t in qkv), bias_t, mask_t)
    assert torch.allclose(exact, ref, rtol=0, atol=1e-5)
    q, k, v = (t.float() for t in qkv)
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5 + bias_t[None]
    if mask_t is not None:
        nw = mask_t.shape[0]
        s = (s.reshape(-1, nw, *s.shape[1:]) + mask_t[None, :, None]).reshape(s.shape)
    p = torch.softmax(s, dim=-1)
    bound = 2.0 ** -8 * torch.einsum("bhqk,bhkd->bhqd", p, v.abs()) + 1e-6
    assert bool(((rounded - exact).abs() <= bound).all())
    assert bool((rounded != exact).any())


@pytest.mark.unit
def test_route_on_the_cpu():
    """CPU tensors take the plain version whatever the type or width."""
    qkv, bias, _ = _inputs(3, 2, 2, 7, 0)
    before = attention.fused_window_attention.launches
    got = attention.fused_window_attention(*qkv, torch.from_numpy(bias))
    want = attention.window_attention_reference(*qkv, torch.from_numpy(bias))
    assert torch.equal(got, want)
    assert attention.fused_window_attention.launches == before
