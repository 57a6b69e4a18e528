"""The port's capture path (`forward(x, capture=True)` of every family the
JAX registry builds) against the JAX package's sown "intermediates" on the
CPU in float32, on the same numpy-drawn, bumped weights and inputs: the
keys (the port's "block_0/Attention_0/attention" against JAX's
"['block_0']/['Attention_0']/['attention']/[0]"), their sort order (at
depth 12 too, where JAX's string order runs 0, 1, 10, 11, 2, …), shapes,
the attention probabilities within ATTN_ATOL and tokens and features
within FEAT_RTOL of max|JAX|. The port is built as served (token kernels,
the Swin kernels), which a capture forward never takes."""
import contextlib
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (MEDICAL_SWIN, SMALL_EFFNET, SMALL_SWIN,
                                JittedModule, jax_cnn, jax_params, jax_swin,
                                one_torch_thread)  # noqa: F401
from thyroid_tpu_torch.analysis.attention import (attention_rollout,
                                                  collect_attention_maps)
from thyroid_tpu_torch.models.base import ModelRegistry
from thyroid_tpu_torch.models.from_jax import load_jax_variables

# attention probabilities (softmax outputs in [0, 1]) and tokens / features
# over max|JAX|: float32 sums of the same products in other orders
ATTN_ATOL, FEAT_RTOL = 1e-5, 1e-4


def vit_config(family: str, **over):
    cfg = {"name": f"{family}_tiny", "img_size": 32, "patch_size": 8,
           "embed_dim": 48, "depth": 2, "num_heads": 3, "in_channels": 1,
           "num_classes": 2, "dtype": "f32", "drop_path_rate": 0.0}
    return dict(cfg, **over)


def port_key(jax_key: str) -> str:
    """JAX's "['a']/['b']/[0]" → the port's "a/b"."""
    return re.sub(r"\['([^']*)'\]", r"\1", jax_key).removesuffix("/[0]")


def jax_capture(model, variables, x):
    """(JAX's eval output, {JAX key: numpy} in JAX's sorted order)."""
    out, inter = JittedModule(model).apply(
        variables, jnp.asarray(x), train=False, capture=True,
        mutable=["intermediates"])
    flat = jax.tree_util.tree_flatten_with_path(inter["intermediates"])[0]
    named = sorted(("/".join(str(k) for k in path), np.asarray(v))
                   for path, v in flat)
    return np.asarray(out), dict(named)


# every kernel wrapper a model forward can call, by the module that calls it
KERNEL_WRAPPERS = {
    "thyroid_tpu_torch.models.layers": ("fused_ln_matmul", "fused_ln_mlp_residual"),
    "thyroid_tpu_torch.models.vit.swin": (
        "fused_swin_attention", "fused_swin_block_attention",
        "fused_swin_ln_attention", "fused_ln_matmul", "fused_ln_mlp",
        "fused_ln_mlp_residual"),
    "thyroid_tpu_torch.models.cnn.efficientnet": ("depthwise_conv2d_pallas",),
}


@contextlib.contextmanager
def no_kernel_wrappers():
    """Within the block, calling any kernel wrapper from a model raises: on
    the CPU the wrappers run their plain versions, whose values alone
    cannot show which path a forward took."""
    import importlib

    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper was called")

    with contextlib.ExitStack() as stack:
        for module, names in KERNEL_WRAPPERS.items():
            mod = importlib.import_module(module)
            for name in names:
                stack.enter_context(mock.patch.object(mod, name, refuse))
        yield


def port_capture(config, variables, x):
    """The port built from `config` (token_kernels and the Swin kernels on)
    with JAX's variables → (output, intermediates as numpy), its capture
    forward calling no kernel wrapper."""
    model = ModelRegistry.create_model(dict(config, token_kernels=True))
    load_jax_variables(model, variables)
    with torch.no_grad(), no_kernel_wrappers():
        out, inter = model.eval()(torch.from_numpy(x), capture=True)
    return out.numpy(), {k: v.numpy() for k, v in inter.items()}


def assert_capture_matches(config, variables, jmodel, x):
    want_out, want = jax_capture(jmodel, variables, x)
    got_out, got = port_capture(config, variables, x)
    # the same keys, and sorting the port's gives JAX's order
    assert list(got) == [port_key(k) for k in want]
    assert list(got) == sorted(got)
    for (k, w), g in zip(want.items(), got.values()):
        assert g.shape == w.shape, k
        err = np.abs(g - w).max()
        if "attention" in k:
            assert err <= ATTN_ATOL, (k, err)
        else:
            assert err <= FEAT_RTOL * max(1.0, np.abs(w).max()), (k, err)
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=1e-4)
    return got_out, got


@pytest.fixture(scope="module")
def deep_vit():
    """A depth-12 ViT at width 24 (JAX module, params): the string order."""
    cfg = vit_config("vit", depth=12, embed_dim=24)
    model, params = jax_params(cfg, seed=5)
    return cfg, model, params


@pytest.mark.unit
@pytest.mark.parametrize("family,quality", [("vit", True), ("deit", False)],
                         ids=["vit-quality_aware", "deit"])
def test_vit_deit_capture(family, quality):
    """Each block's attention, the final tokens and (quality_aware) the
    patch scores JAX sows on every forward."""
    cfg = vit_config(family, quality_aware=quality)
    jmodel, params = jax_params(cfg, seed=3)
    x = np.random.RandomState(1).randn(2, 32, 32, 1).astype(np.float32)
    _, got = assert_capture_matches(cfg, {"params": params}, jmodel, x)
    n = 16 + (1 if family == "vit" else 2)
    assert got["block_1/Attention_0/attention"].shape == (2, 3, n, n)
    assert got["final_tokens"].shape == (2, n, 48)
    assert ("patch_embed/patch_quality" in got) == quality


@pytest.mark.unit
def test_key_order_at_depth_12(deep_vit):
    """At depth 12 JAX's keys sort as strings, block 10 and 11 after 1;
    the port's sort the same way. collect_attention_maps returns the maps
    in that order, so the rollout multiplies them so (against JAX's
    attention_rollout of its maps in its order) and the last is block 9's."""
    from thyroid_tpu.analysis.attention import attention_rollout as jax_rollout

    cfg, jmodel, params = deep_vit
    x = np.random.RandomState(2).randn(1, 32, 32, 1).astype(np.float32)
    _, got = assert_capture_matches(cfg, {"params": params}, jmodel, x)
    blocks = [int(k.split("/")[0][6:]) for k in got if "attention" in k]
    assert blocks == [0, 1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9]
    model = ModelRegistry.create_model(cfg)
    load_jax_variables(model, {"params": params})
    maps = collect_attention_maps(model.eval(), None, torch.from_numpy(x))
    np.testing.assert_array_equal(maps[-1], got["block_9/Attention_0/attention"])
    _, want = jax_capture(jmodel, {"params": params}, x)
    want_maps = [v for k, v in want.items() if "attention" in k]
    assert np.abs(attention_rollout(maps) - jax_rollout(want_maps)).max() <= 1e-4


@pytest.mark.unit
@pytest.mark.parametrize("config", [dict(SMALL_SWIN, img_size=32), MEDICAL_SWIN],
                         ids=["small", "medical-padded"])
def test_swin_capture(config):
    """Window attention per block (after the contrast scaling), each
    stage's tokens before its merge, the final tokens and, with the
    uncertainty head, its output; the medical Swin pads both stages. A
    Swin built with `use_pallas_attention: false` serves on that plain
    path: no kernel wrapper, the capture forward's output."""
    jmodel, params = jax_swin(config, seed=1)
    side = config["img_size"]
    x = np.random.RandomState(3).randn(2, side, side, 1).astype(np.float32)
    out, got = assert_capture_matches(config, {"params": params}, jmodel, x)
    plain = ModelRegistry.create_model(dict(config, use_pallas_attention=False))
    load_jax_variables(plain, {"params": params})
    with torch.no_grad(), no_kernel_wrappers():
        np.testing.assert_array_equal(plain.eval()(torch.from_numpy(x)).numpy(), out)
    stages = [k for k in got if k.endswith("stage_features")]
    assert stages == ["stage_0/stage_features", "stage_1/stage_features"]
    assert ("uncertainty" in got) == bool(config.get("uncertainty_head"))


CNNS = {
    "resnet18": {"name": "resnet18", "layers": (1, 1, 1, 1), "width": 8,
                 "in_channels": 1, "num_classes": 2, "dtype": "f32",
                 "dropout_rate": 0.0},
    "densenet121": {"name": "densenet121", "growth_rate": 8,
                    "block_config": (1, 1), "num_init_features": 16,
                    "in_channels": 1, "num_classes": 2, "dtype": "f32"},
    "efficientnet_b0": SMALL_EFFNET,
}


@pytest.mark.unit
@pytest.mark.parametrize("name", list(CNNS))
def test_cnn_capture(name):
    """The feature map JAX sows for GradCAM, narrow models at 32².
    Inception has no narrow form (75² its smallest side, full width):
    tests/test_torch_inception.py holds its forward to JAX and checks its
    "features"."""
    cfg = CNNS[name]
    x = np.random.RandomState(4).randn(2, 32, 32, 1).astype(np.float32)
    jmodel, variables = jax_cnn(cfg, seed=2)
    _, got = assert_capture_matches(cfg, variables, jmodel, x)
    assert list(got) == ["features"] and got["features"].ndim == 4
