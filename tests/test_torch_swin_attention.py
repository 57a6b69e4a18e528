"""Port Swin attention half-block (thyroid_tpu_torch.ops.attention) against
the JAX Pallas kernel in interpret mode, on the CPU, at the JAX tests'
shapes (tests/unit/test_pallas_attention.py). Tolerance 1e-4, the JAX
test's own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thyroid_tpu.models.vit.swin import shift_attention_mask as jax_mask
from thyroid_tpu.ops import attention as jattn
from thyroid_tpu_torch.models.vit import swin as tswin
from thyroid_tpu_torch.ops import attention as tattn

RS = np.random.RandomState(7)


@pytest.mark.unit
@pytest.mark.parametrize("B,H,W,C,heads,ws,shift", [
    (2, 16, 16, 96, 3, 4, 0),
    (2, 16, 16, 192, 6, 4, 2),     # 6 heads: uneven TPU lane groups (4, 2)
    (2, 14, 14, 384, 12, 7, 3),
    (6, 7, 7, 768, 24, 7, 0),      # one window per image
    (2, 14, 14, 96, 3, 7, 3),      # Swin's ws = 7, shifted, at stage 1's width
    (1, 7, 7, 1536, 48, 7, 0),     # swin_large's widest stage
])
def test_fused_swin_block_attention(B, H, W, C, heads, ws, shift):
    n = ws * ws
    qkv = RS.randn(B, H, W, 3, C).astype(np.float32)
    xres = RS.randn(B, H, W, C).astype(np.float32)
    wp = (RS.randn(C, C) * 0.05).astype(np.float32)
    bp = (RS.randn(C) * 0.1).astype(np.float32)
    bias = (RS.randn(heads, n, n) * 0.1).astype(np.float32)
    mask = jax_mask(H, W, ws, shift)
    np.testing.assert_array_equal(
        tswin.shift_attention_mask(H, W, ws, shift), mask)
    want = jattn.fused_swin_block_attention(
        jnp.asarray(qkv), jnp.asarray(xres), jnp.asarray(wp), jnp.asarray(bp),
        jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
        window_size=ws, num_heads=heads, interpret=True)
    got = tattn.fused_swin_block_attention(
        torch.from_numpy(qkv), torch.from_numpy(xres), torch.from_numpy(wp),
        torch.from_numpy(bp), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask),
        window_size=ws, num_heads=heads)
    assert got.shape == (B, H, W, C)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4


@pytest.mark.unit
def test_window_attention_reference_and_partition():
    from thyroid_tpu.models.vit.swin import window_partition, window_reverse

    bw, h, n, d = 8, 3, 16, 32
    q, k, v = (RS.randn(bw, h, n, d).astype(np.float32) for _ in range(3))
    bias = (RS.randn(h, n, n) * 0.1).astype(np.float32)
    mask = jax_mask(8, 8, 4, 2)                 # 4 windows per image
    want = jattn.window_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v, bias, mask)))
    got = tattn.window_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, bias, mask)))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5

    x = RS.randn(2, 8, 12, 5).astype(np.float32)
    win = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        win.numpy(), np.asarray(window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        tswin.window_reverse(win, 4, 8, 12).numpy(),
        np.asarray(window_reverse(jnp.asarray(win.numpy()), 4, 8, 12)))


@pytest.mark.unit
def test_relative_position_index_matches():
    from thyroid_tpu.models.vit.swin import relative_position_index

    for ws in (4, 7):
        np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                      relative_position_index(ws))


@pytest.mark.unit
def test_rejects_shapes_that_do_not_tile():
    qkv = torch.zeros(1, 6, 6, 3, 8)
    with pytest.raises(ValueError):
        tattn.fused_swin_block_attention(
            qkv, torch.zeros(1, 6, 6, 8), torch.zeros(8, 8), None,
            torch.zeros(2, 16, 16), window_size=4, num_heads=2)


@pytest.mark.unit
def test_block_attention_refuses_autograd():
    """The serving half-block has no backward: with grad mode on and an
    input requiring grad it raises and points at fused_swin_attention."""
    args = [torch.from_numpy(RS.randn(*s).astype(np.float32))
            for s in ((1, 8, 8, 3, 16), (1, 8, 8, 16), (16, 16), (16,),
                      (2, 16, 16))]
    kw = dict(window_size=4, num_heads=2)
    want = tattn.fused_swin_block_attention(*args, **kw)
    for i in range(len(args)):
        grad_args = list(args)
        grad_args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="fused_swin_attention"):
            tattn.fused_swin_block_attention(*grad_args, **kw)
        with torch.no_grad():
            assert torch.equal(
                tattn.fused_swin_block_attention(*grad_args, **kw), want)
