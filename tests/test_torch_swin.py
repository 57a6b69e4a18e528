"""Port Swin (thyroid_tpu_torch.models.vit.swin) and the JAX→port weight
carrier (models/from_jax.py) against the JAX package, on the CPU, in
float32, with the JAX golden tests' parameter bump so that logits of a
random init are not flat."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import JittedModule, SMALL_SWIN, count_leaves, jax_swin
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init, num_parameters
from thyroid_tpu_torch.models.from_jax import load_jax_params, to_jax_params
from thyroid_tpu_torch.models.registry import ModelRegistry, resolve_dtype

SWIN_TINY = {"name": "swin_tiny", "in_channels": 1, "num_classes": 2}


def _jax_logits(config, params, x, use_pallas):
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    model = JittedModule(JaxRegistry.create_model(
        dict(config, use_pallas_attention=use_pallas)))
    return np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                  train=False))


def _port_logits(config, params, x):
    model = create_and_init(config, device="cpu")
    load_jax_params(model, params)
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def tiny():
    """JAX swin_tiny (registry config, as served) with bumped params."""
    return jax_swin(SWIN_TINY)


@pytest.mark.unit
def test_load_jax_params_is_strict(tiny):
    _, params = tiny
    assert count_leaves(params) == 173
    model = create_and_init(SWIN_TINY, device="cpu")
    load_jax_params(model, params)
    assert num_parameters(model) == 27_517_820
    block = params["stage_2"]["block_5"]
    np.testing.assert_array_equal(
        model.stage_2.block_5.attn.qkv.kernel.detach().numpy(),
        block["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(
        model.patch_embed.weight.detach().numpy(),
        params["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    back = to_jax_params(model)
    assert count_leaves(back) == 173
    np.testing.assert_array_equal(back["patch_embed"]["kernel"],
                                  params["patch_embed"]["kernel"])

    missing = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(KeyError, match="head"):
        load_jax_params(model, missing)
    extra = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(model, extra)
    bad = dict(params, head={"kernel": np.zeros((3, 2), np.float32),
                             "bias": params["head"]["bias"]})
    with pytest.raises(ValueError, match="head.kernel"):
        load_jax_params(model, bad)


@pytest.mark.unit
def test_full_width_swin_tiny_matches_jax(tiny):
    """Full-width, full-depth swin_tiny, batch 1, against the JAX plain
    path. atol 1e-4 on logits: twelve blocks of float32 summation-order
    drift between XLA and PyTorch."""
    _, params = tiny
    x = np.random.RandomState(3).randn(1, 224, 224, 1).astype(np.float32)
    want = _jax_logits(SWIN_TINY, params, x, use_pallas=False)
    got = _port_logits(SWIN_TINY, params, x)
    assert got.shape == (1, 2) and got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-4, (got, want)


@pytest.mark.unit
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["jax_pallas_interpret", "jax_xla"])
def test_small_swin_matches_jax(use_pallas):
    """img 64, embed 32, depths (2, 2), heads (1, 2), window 4: shifted and
    unshifted blocks, one PatchMerging. atol 1e-5, the JAX package's own
    fused-vs-XLA model bound."""
    _, params = jax_swin(SMALL_SWIN)
    x = np.random.RandomState(4).randn(2, 64, 64, 1).astype(np.float32)
    want = _jax_logits(SMALL_SWIN, params, x, use_pallas)
    got = _port_logits(SMALL_SWIN, params, x)
    assert np.abs(got - want).max() < 1e-5, (got, want)
    assert np.ptp(want[:, 0]) > 1e-3      # the comparison is not vacuous


@pytest.mark.unit
@pytest.mark.parametrize("flag", ["medical_adaptations", "contrast_adaptive",
                                  "quality_guided", "uncertainty_head", "ape"])
def test_swin_option_matches_jax(flag):
    """Each Swin option alone on the small Swin, float32, against JAX's
    fused path (use_pallas_attention, Pallas in interpret mode): logits
    within 1e-5, and with the uncertainty head its output too."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg = dict(SMALL_SWIN, **{flag: True})
    _, params = jax_swin(cfg)
    x = np.random.RandomState(6).randn(2, 64, 64, 1).astype(np.float32)
    jmodel = JittedModule(JaxRegistry.create_model(
        dict(cfg, use_pallas_attention=True)))
    want = jmodel.apply({"params": params}, jnp.asarray(x), train=False,
                        return_uncertainty=True)
    model = create_and_init(cfg, device="cpu")
    load_jax_params(model, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), return_uncertainty=True)
    heads = flag in ("medical_adaptations", "uncertainty_head")
    assert isinstance(got, tuple) == heads == isinstance(want, tuple)
    for g, w in zip(got, want) if heads else ((got, want),):
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-5, flag
    logits = np.asarray(want[0] if heads else want)
    assert np.ptp(logits[:, 0]) > 1e-3     # the comparison is not vacuous


@pytest.mark.unit
def test_unported_modes_raise():
    # window padding and swin_medical build now
    padded = ModelRegistry.create_model(dict(SMALL_SWIN, img_size=80))
    assert not padded.stage_0.block_0.padded           # 20x20 maps, window 4
    assert padded.stage_1.block_0.pad == (2, 2)        # 10x10 maps
    model = create_and_init(SMALL_SWIN, device="cpu")
    x = torch.zeros(1, 64, 64, 1)
    # capture is ported (tests/test_torch_capture.py holds it to JAX)
    with torch.no_grad():
        _, inter = model(x, capture=True)
    assert "final_tokens" in inter and "stage_1/stage_features" in inter
    # training is ported; its DropPath needs an explicit generator
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
    out = model(x, train=True, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 2) and out.requires_grad
    medical = ModelRegistry.create_model({"name": "swin_medical"})
    assert medical.img_size == 256 and medical.uncertainty_1 is not None
    assert medical.stage_0.block_0.pad == (6, 6)       # 64x64 maps, window 7


@pytest.mark.unit
def test_registry_and_dtype():
    assert "swin_tiny" in ModelRegistry.list_models("vit")
    assert resolve_dtype({"dtype": "bf16"}) is torch.bfloat16
    assert resolve_dtype({}) is torch.float32
    with pytest.raises(ValueError):
        ModelRegistry.create_model({"name": "no_such_model"})
    model = create_and_init(dict(SMALL_SWIN, dtype="bf16"), device="cpu")
    with torch.no_grad():
        out = model(torch.zeros(2, 64, 64, 1))
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    # the serving forward's kernels have no backward: they refuse autograd
    with pytest.raises(RuntimeError, match="no backward"):
        model(torch.zeros(2, 64, 64, 1))
