"""Swin's `attn_softmax_dtype: bf16` and `use_checkpoint: true` in the port,
on the CPU: the bf16 scores of the plain attention against JAX's forward
(`preferred_element_type=bf16`), and a checkpointed train step against the
same step without checkpointing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_swin
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import load_jax_params
from thyroid_tpu_torch.models.vit import swin as tswin

# two stages, the first with a shifted block, every block on the plain
# windows attention (the only path that reads the softmax dtype)
SOFTMAX_SWIN = {"name": "swin_tiny", "img_size": 32, "embed_dim": 16,
                "depths": (2, 2), "num_heads": (2, 4), "window_size": 4,
                "in_channels": 1, "num_classes": 2,
                "use_pallas_attention": False, "attn_softmax_dtype": "bf16"}


def _x(seed, n=3, side=32):
    return np.random.RandomState(seed).randn(n, side, side, 1).astype(np.float32)


@pytest.mark.unit
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bf16_softmax_matches_jax(dtype):
    """Logits of a narrow Swin with bf16 scores within 2e-2 of JAX's (the
    bf16 tolerance of the repo's Swin tests: bf16 rounds at different
    places in the two frameworks), in a bf16 and a float32 model; the
    option is not inert: float32 scores move the port's logits."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg = dict(SOFTMAX_SWIN, dtype=dtype)
    _, params = jax_swin(cfg)
    jmodel = JaxRegistry.create_model(cfg)
    x = _x(3)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(x)))
    model = create_and_init(cfg, device="cpu")
    load_jax_params(model, params)
    f32_scores = create_and_init(dict(cfg, attn_softmax_dtype=None), device="cpu")
    load_jax_params(f32_scores, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        other = f32_scores(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() < 2e-2, (got, want)
    assert np.ptp(want[:, 0]) > 1e-3
    assert not np.array_equal(got, other)


@pytest.mark.unit
def test_bf16_scores_round_as_jax():
    """One window attention of a float32 model with bf16 scores against
    JAX's module: q·kᵀ, bias and mask in bf16 and the softmax in bf16 give
    outputs within a bf16 rounding of the probabilities (2^-8 relative)."""
    from thyroid_tpu.models.vit.swin import WindowAttention as JaxAttention

    rs = np.random.RandomState(4)
    dim, heads, ws = 16, 2, 4
    n = ws * ws
    x = rs.randn(4, n, dim).astype(np.float32)
    mask = np.where(rs.rand(2, n, n) < 0.3, -100.0, 0.0).astype(np.float32)
    jmod = JaxAttention(dim=dim, window_size=ws, num_heads=heads,
                        softmax_dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(rs.randn(*a.shape) * 0.3, np.float32), shapes)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x),
                                          jnp.asarray(mask)))
    mod = tswin.WindowAttention(dim, ws, heads, softmax_dtype=torch.bfloat16)
    with torch.no_grad():
        mod.qkv.kernel.copy_(torch.from_numpy(params["qkv"]["kernel"]))
        mod.qkv.bias.copy_(torch.from_numpy(params["qkv"]["bias"]))
        mod.proj.kernel.copy_(torch.from_numpy(params["proj"]["kernel"]))
        mod.proj.bias.copy_(torch.from_numpy(params["proj"]["bias"]))
        mod.relative_position_bias_table.copy_(
            torch.from_numpy(params["relative_position_bias_table"]))
        got = mod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 ** -8 * scale, np.abs(got - want).max()


# a narrow three-stage Swin with DropPath and dropout on, so that the
# checkpointed recompute has to draw the masks it drew the first time
CKPT_SWIN = {"name": "swin_tiny", "img_size": 32, "embed_dim": 16,
             "depths": (2, 2, 2), "num_heads": (2, 2, 4), "window_size": 4,
             "in_channels": 1, "num_classes": 3, "drop_path_rate": 0.3,
             "drop_rate": 0.1, "attn_drop_rate": 0.1}


def _step(cfg, x, y, seed=7):
    """(loss, {name: grad}, block forwards begun, the generator's state) of
    one training forward and backward, the dropout draws from a generator
    seeded with `seed`."""
    torch.manual_seed(0)
    model = create_and_init(cfg, device="cpu")
    calls = [0]
    for mod in model.modules():
        if isinstance(mod, tswin.SwinBlock):
            mod.register_forward_pre_hook(lambda *a: calls.__setitem__(0, calls[0] + 1))
    gen = torch.Generator().manual_seed(seed)
    logits = model(torch.from_numpy(x), train=True, generator=gen)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach(), grads, calls[0], gen.get_state()


@pytest.mark.unit
@pytest.mark.parametrize("kernels", [False, True])
def test_checkpoint_step_equals_plain_step(kernels):
    """use_checkpoint: true runs every block's forward again in the
    backward (12 block forwards for 6 blocks) and gives the loss and every
    gradient of the step without it, bit for bit, with DropPath and
    dropout drawing from the generator; the generator ends where it ends
    without checkpointing. On the plain path and on the spatial kernels'
    path (their plain versions on the CPU)."""
    cfg = dict(CKPT_SWIN, use_pallas_attention=kernels)
    if kernels:   # the fused spatial path takes no attention dropout
        cfg["attn_drop_rate"] = 0.0
    x = _x(11, n=4)
    y = np.array([0, 1, 2, 1])
    loss, grads, calls, state = _step(cfg, x, y)
    loss_c, grads_c, calls_c, state_c = _step(dict(cfg, use_checkpoint=True), x, y)
    assert (calls, calls_c) == (6, 12)
    assert torch.equal(loss, loss_c)
    assert grads.keys() == grads_c.keys() and len(grads) > 20
    for k in grads:
        assert torch.equal(grads[k], grads_c[k]), k
    assert torch.equal(state, state_c)


@pytest.mark.unit
def test_swin_arguments_read_both_options():
    """swin_arguments maps the two keys as JAX's build_swin does."""
    args = tswin.swin_arguments({"name": "swin_base", "attn_softmax_dtype": "bfloat16",
                                 "use_checkpoint": True})
    assert args["softmax_dtype"] == torch.bfloat16 and args["use_checkpoint"]
    args = tswin.swin_arguments({"name": "swin_base"})
    assert args["softmax_dtype"] == torch.float32 and not args["use_checkpoint"]
