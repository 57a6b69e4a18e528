"""The port's ViT and DeiT (thyroid_tpu_torch/models/vit/{vit,deit}.py and
the transformer part of models/layers.py) against the JAX package on the
CPU in float32: narrow models (depth 2, width 48, 32², patch 8) on
numpy-drawn, bumped weights, forward under both `token_kernels` values (JAX's
fused path with its Pallas kernels in interpret mode), the patch-quality
scores JAX sows, one Trainer step with DeiT's dual loss (plain and with
MixUp/CutMix on JAX's draws) and with ViT's CE; the golden vit_tiny and
deit_tiny logits from JAX's PRNGKey(0) init with `token_kernels: false`;
the variable trees of the six registry names and their YAMLs; the loss
helpers and the sinusoidal table."""
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (flat_tree, global_rel, golden_input,
                                golden_variables, jax_mixup_cutmix_params,
                                jax_params, jax_step, port_step,
                                tree_shapes_equal)
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models import layers as port_layers
from thyroid_tpu_torch.models.from_jax import load_jax_params, to_jax_params
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.models.vit import deit as port_deit
from thyroid_tpu_torch.models.vit import vit as port_vit
from thyroid_tpu_torch.training.configs import TRAINING_VIT

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
# forward and step tolerances, float32 on one CPU: the two frameworks sum
# the same products in other orders
FWD_ATOL, FWD_RTOL = 1e-5, 1e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def narrow(family: str, token_kernels: bool = False, **over):
    cfg = {"name": "vit_tiny" if family == "vit" else "deit_tiny",
           "img_size": 32, "patch_size": 8, "embed_dim": 48, "depth": 2,
           "num_heads": 3, "in_channels": 1, "num_classes": 2, "dtype": "f32",
           "drop_path_rate": 0.0, "token_kernels": token_kernels}
    return dict(cfg, **over)


@lru_cache(maxsize=None)
def small(family: str, quality_aware: bool = False, sincos: bool = False):
    """Bumped numpy parameters of the narrow model (the tree does not
    depend on token_kernels)."""
    over = {"quality_aware": quality_aware}
    if sincos:
        over.update(pos_embed_type="sinusoidal", pool_type="gap")
    _, params = jax_params(narrow(family, **over), seed=3)
    return params


def _port(cfg, params):
    model = ModelRegistry.create_model(cfg)
    load_jax_params(model, params)
    return model.eval()


CASES = [("vit", False, False, False), ("vit", True, False, False),
         ("deit", False, False, False), ("deit", True, False, False),
         ("vit", True, True, True), ("vit", False, True, True)]


@pytest.mark.unit
@pytest.mark.parametrize("family,tk,quality,sincos", CASES,
                         ids=["vit-plain", "vit-token_kernels", "deit-plain",
                              "deit-token_kernels",
                              "vit-sincos-gap-quality-token_kernels",
                              "vit-sincos-gap-quality-plain"])
def test_forward_matches_jax(family, tk, quality, sincos):
    """The eval forward of the port against JAX's module with the same
    token_kernels value (True: LN + QKV and LN + MLP + residual through
    JAX's Pallas kernels in interpret mode and the port's plain versions
    of kernels 2 and 3), within FWD_ATOL / FWD_RTOL; with quality_aware,
    the patch-quality scores JAX sows, within 1e-6."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    over = {"quality_aware": quality}
    if sincos:
        over.update(pos_embed_type="sinusoidal", pool_type="gap")
    cfg = narrow(family, tk, **over)
    params = small(family, quality, sincos)
    x = np.random.RandomState(2).randn(3, 32, 32, 1).astype(np.float32)
    jmodel = JaxRegistry.create_model(cfg)
    want, inter = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=False, mutable=["intermediates"]))(
            params, jnp.asarray(x))
    port = _port(cfg, params)
    assert all(getattr(port, f"block_{i}").token_kernels == tk for i in range(2))
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_patch_quality=quality)
    if quality:
        got, scores = got
        want_scores = inter["intermediates"]["patch_embed"]["patch_quality"][0]
        np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                                   atol=1e-6, rtol=1e-6)
        assert scores.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    assert np.abs(np.asarray(want)[0] - np.asarray(want)[1]).max() > 1e-3


@pytest.mark.unit
@pytest.mark.parametrize("family", ["vit", "deit"])
def test_fused_path_launches_the_token_kernels(family, monkeypatch):
    """With token_kernels an eval forward calls fused_ln_matmul and
    fused_ln_mlp_residual once per block each (their plain versions on the
    CPU); a training forward and token_kernels false call neither."""
    calls = {"ln_matmul": 0, "ln_mlp": 0}
    real_mm, real_mlp = port_layers.fused_ln_matmul, port_layers.fused_ln_mlp_residual

    def mm(*a, **k):
        calls["ln_matmul"] += 1
        return real_mm(*a, **k)

    def mlp(*a, **k):
        calls["ln_mlp"] += 1
        return real_mlp(*a, **k)

    monkeypatch.setattr(port_layers, "fused_ln_matmul", mm)
    monkeypatch.setattr(port_layers, "fused_ln_mlp_residual", mlp)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 32, 32, 1)
                         .astype(np.float32))
    model = _port(narrow(family, True), small(family))
    with torch.no_grad():
        model(x)
        assert calls == {"ln_matmul": 2, "ln_mlp": 2}
        model(x, train=True, generator=torch.Generator().manual_seed(0))
        _port(narrow(family, False), small(family))(x)
    assert calls == {"ln_matmul": 2, "ln_mlp": 2}


def _batch(seed, n=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 32, 32, 1).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.int32)
    w = np.ones(n, np.float32)
    w[-1] = 0.5
    return x, y, w


@pytest.mark.unit
@pytest.mark.parametrize("family,mix", [("deit", False), ("deit", True),
                                        ("vit", False)],
                         ids=["deit-dual_loss", "deit-dual_loss-mixup_cutmix",
                              "vit-ce"])
def test_train_step_matches_jax(family, mix, tmp_path, monkeypatch):
    """One Trainer step (vit.yaml: label smoothing 0.1) from the same
    parameters: DeiT's loss mode "deit", 0.5·CE(cls) + 0.5·CE(dist) (with
    MixUp/CutMix on JAX's draws: the mixed CE of each head), ViT's CE;
    the loss within LOSS_RTOL and the gradients' global difference within
    GRAD_RTOL of their norm, against JAX's _train_step_impl loss in one
    jitted value_and_grad. token_kernels is on: training takes the plain
    path in both. The metric logits of DeiT are the heads' mean."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg = narrow(family, True)
    params = small(family)
    tcfg = dict(TRAINING_VIT, mixup_alpha=0.8, cutmix_alpha=1.0) if mix \
        else TRAINING_VIT
    x, y, w = _batch(10)
    _, mix_rng = jax.random.split(jax.random.PRNGKey(3))
    want, grads_want, _ = jax_step(
        JaxRegistry.create_model(cfg), {"params": params}, x, y, w,
        loss_mode="deit" if family == "deit" else "ce", label_smoothing=0.1,
        mix_rng=mix_rng if mix else None)
    mirror = jax_mixup_cutmix_params(mix_rng, x.shape, 0.8, 1.0) if mix else None
    got, grads, stats, tm = port_step(cfg, tcfg, {"params": params}, x, y, w,
                                      monkeypatch, tmp_path, mirror)
    assert stats is None
    assert abs(got - want) <= LOSS_RTOL * max(1.0, abs(want)), (got, want)
    assert global_rel(grads, grads_want) < GRAD_RTOL
    assert float(tm["w_sum"]) == float(w.sum())


@pytest.mark.unit
def test_quality_head_gets_zero_gradients(tmp_path, monkeypatch):
    """vit_tiny.yaml sets quality_aware: the head's parameters exist, no
    loss reads its scores, and a step gives them zero gradients, as
    jax.grad does."""
    cfg = narrow("vit", True, quality_aware=True)
    params = small("vit", True)
    x, y, w = _batch(11)
    _, grads, _, _ = port_step(cfg, TRAINING_VIT, {"params": params}, x, y, w,
                               monkeypatch, tmp_path)
    flat = flat_tree(grads)
    head = [k for k in flat if k.startswith("patch_embed.quality_conv")]
    assert len(head) == 4 and all(not flat[k].any() for k in head)
    assert flat["patch_embed.proj.kernel"].any()


@pytest.mark.unit
@pytest.mark.parametrize("name", ["vit_tiny", "deit_tiny"])
def test_golden_logits(name):
    """The golden fixture's logits from the port on JAX's initial
    variables with token_kernels false (the fixtures were recorded on
    JAX's CPU default), at tests/unit/test_golden_parity.py's tolerance;
    the fused path's logits within 2e-3 of the plain path's."""
    rec = np.load(GOLDEN / f"{name}.npz")
    cfg, variables = golden_variables(name)
    x = torch.from_numpy(golden_input(224))
    with torch.no_grad():
        got = _port(dict(cfg, token_kernels=False), variables["params"])(x).numpy()
        fused = _port(cfg, variables["params"])(x).numpy()
    np.testing.assert_allclose(got, rec["logits"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(fused, got, atol=2e-3, rtol=0)


ALL = list(port_vit.VIT_PARAMS) + list(port_deit.DEIT_PARAMS)


@pytest.mark.unit
@pytest.mark.parametrize("name", ALL)
def test_variable_tree_and_yaml(name):
    """vit/deit tiny/small/base from the registry: names and shapes
    against JAX's init (jax.eval_shape at 32², patch 16 → 4 patches, the
    position table at that size); the YAML under configs/model/vit builds
    with its nested params read (quality head, token_kernels default,
    drop path, widths)."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    cfg = {"name": name, "img_size": 32}
    model = JaxRegistry.create_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 1)),
        train=False))
    port = ModelRegistry.create_model(cfg)
    tree_shapes_equal({"params": to_jax_params(port)}, shapes)
    ycfg = yaml.safe_load((ROOT / "configs" / "model" / "vit" / f"{name}.yaml")
                          .read_text())
    built = ModelRegistry.create_model(ycfg)
    p = ycfg["params"]
    assert isinstance(built, port_deit.DeiT if name.startswith("deit")
                      else port_vit.VisionTransformer)
    assert built.embed_dim == p["embed_dim"] and built.depth == p["depth"]
    assert built.token_kernels and built.block_0.token_kernels
    assert (built.patch_embed.quality_conv1 is not None) == p["quality_aware"]
    assert built.pos_embed.shape == (1, 196 + len(built.prefix), p["embed_dim"])
    rate = getattr(built, f"block_{p['depth'] - 1}").drop_path.rate
    assert rate == pytest.approx(p["drop_path_rate"])


@pytest.mark.unit
def test_round_trip_strict_capture_and_defaults():
    """load_jax_params / to_jax_params are exact inverses and strict; the
    capture forward gives the same logits on the plain path and records
    each block's attention; token_kernels defaults to True unless a config
    sets it (JAX: True on its accelerator, False on its CPU); the
    registry's bare names keep JAX's builder defaults."""
    params = small("deit")
    model = _port(narrow("deit"), params)
    back = flat_tree(to_jax_params(model))
    want = flat_tree(params)
    assert set(back) == set(want) and all(np.array_equal(back[k], want[k])
                                          for k in want)
    bad = {k: v for k, v in params.items() if k != "head_dist"}
    with pytest.raises(KeyError, match="head_dist"):
        load_jax_params(model, bad)
    with torch.no_grad():
        logits, inter = model(torch.zeros(1, 32, 32, 1), capture=True)
        assert torch.equal(logits, model(torch.zeros(1, 32, 32, 1)))
    assert list(inter) == ["block_0/Attention_0/attention",
                           "block_1/Attention_0/attention", "final_tokens"]
    assert port_layers.token_kernels_default({"name": "vit_tiny"})
    assert not port_layers.token_kernels_default({"params": {"token_kernels": False}})
    from thyroid_tpu.models.layers import token_kernels_default as jax_default

    assert jax_default({"token_kernels": True}) and \
        not jax_default({"token_kernels": False})
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros(1, 30, 30, 1))


@pytest.mark.unit
@pytest.mark.parametrize("n,dim", [(17, 48), (197, 192), (5, 8)])
def test_sincos_pos_embed(n, dim):
    from thyroid_tpu.models.layers import sincos_pos_embed as jax_sincos

    np.testing.assert_allclose(port_layers.sincos_pos_embed(n, dim).numpy(),
                               np.asarray(jax_sincos(n, dim)), atol=2e-6, rtol=0)


@pytest.mark.unit
def test_loss_helpers():
    """deit_dual_loss and classification_outputs_to_logits against JAX's,
    with label smoothing and sample weights."""
    from thyroid_tpu.training import losses as jl

    from thyroid_tpu_torch.training import losses as pl

    rs = np.random.RandomState(6)
    a, b = rs.randn(5, 2).astype(np.float32), rs.randn(5, 2).astype(np.float32)
    y = np.array([0, 1, 1, 0, 1], np.int32)
    w = rs.rand(5).astype(np.float32)
    want = jl.deit_dual_loss((jnp.asarray(a), jnp.asarray(b)), jnp.asarray(y),
                             0.1, jnp.asarray(w))
    got = pl.deit_dual_loss((torch.from_numpy(a), torch.from_numpy(b)),
                            torch.from_numpy(y), 0.1, torch.from_numpy(w))
    assert abs(float(got) - float(want)) < 1e-6
    np.testing.assert_allclose(
        pl.classification_outputs_to_logits((torch.from_numpy(a),
                                             torch.from_numpy(b))).numpy(),
        np.asarray(jl.classification_outputs_to_logits((jnp.asarray(a),
                                                        jnp.asarray(b)))),
        atol=1e-7)
    assert pl.classification_outputs_to_logits(torch.from_numpy(a)) is not None
