"""Shared helpers of the tests that hold the PyTorch port (thyroid_tpu_torch)
against the JAX package on the same inputs and weights, on the CPU."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import pytest

# a small Swin with shifted and unshifted blocks in both stages
SMALL_SWIN = {"name": "swin_tiny", "img_size": 64, "embed_dim": 32,
              "depths": (2, 2), "num_heads": (1, 2), "window_size": 4,
              "in_channels": 1, "num_classes": 2}
# its float32 training configuration without DropPath (the two frameworks
# draw DropPath from different random streams)
SMALL_F32 = dict(SMALL_SWIN, dtype="f32", drop_path_rate=0.0)
# a narrow Swin as the YAML keys build it, medical adaptations on: 40² input,
# so that both stages pad their maps to the window (10 → 12, 5 → 8), with
# the absolute position embedding and the uncertainty head
MEDICAL_SWIN = {"name": "swin_tiny", "img_size": 40, "embed_dim": 16,
                "depths": (1, 1), "num_heads": (2, 2), "window_size": 4,
                "in_channels": 1, "num_classes": 2,
                "medical_adaptations": True, "ape": True,
                "uncertainty_head": True}


def perturb(tree: Dict[str, Any]) -> Dict[str, Any]:
    """p + 0.01·sin(0.7·i) on every leaf (the JAX golden tests' bump), so
    that near-constant logits of a random init do not make a comparison
    vacuous."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = perturb(v)
        else:
            wave = np.sin(np.arange(v.size, dtype=np.float32) * 0.7)
            out[k] = (v + 0.01 * wave.reshape(v.shape)).astype(np.float32)
    return out


def jax_swin(config: Dict[str, Any], seed: int = 0):
    """(JAX module, bumped params as numpy) for a Swin config. The tree's
    structure and shapes come from the JAX module's own init (traced with
    jax.eval_shape, not run); the values are drawn with numpy: unit
    LayerNorm scales, zero biases, per-head contrast scales 1 + N(0, 0.5²),
    N(0, 0.02²) elsewhere."""
    import jax
    import jax.numpy as jnp

    from thyroid_tpu.models.registry import ModelRegistry

    model = ModelRegistry.create_model(config)
    img = config.get("img_size", 224)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, img, img, config.get("in_channels", 1))), train=False))
    rs = np.random.RandomState(seed)

    def draw(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = draw(v)
            elif k == "scale":
                out[k] = np.ones(v.shape, np.float32)
            elif k == "bias":
                out[k] = np.zeros(v.shape, np.float32)
            elif k == "contrast_scale":
                out[k] = (1 + 0.5 * rs.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = (0.02 * rs.randn(*v.shape)).astype(np.float32)
        return out

    return model, perturb(draw(shapes["params"]))


def count_leaves(tree: Dict[str, Any]) -> int:
    return sum(count_leaves(v) if hasattr(v, "items") else 1
               for v in tree.values())


def small_batch(seed: int, n: int = 4):
    """(images, int32 labels, weights with the last one 0.5) of SMALL_SWIN's
    input size, from a numpy seed."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 64, 64, 1).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.int32)
    w = np.ones(n, np.float32)
    w[-1] = 0.5
    return x, y, w


def flat_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested parameter tree as {"a.b.c": numpy array}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_trees_close(got, want, atol: float, rtol: float) -> None:
    got, want = flat_tree(got), flat_tree(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


# a narrow, shallow efficientnet at 32² that keeps every block kind: expand
# ratio 1 and 6, stride 1 and 2, k 3 and 5, residual blocks (mbconv0_0 and
# mbconv5_1), float32, no dropout or drop path (the frameworks draw them
# from different random streams)
SMALL_EFFNET = {"name": "efficientnet_b0", "width_mult": 0.25,
                "depth_mult": 0.3, "img_size": 32, "in_channels": 1,
                "num_classes": 2, "dtype": "f32", "dropout_rate": 0.0,
                "drop_path_rate": 0.0}


def jax_cnn(config: Dict[str, Any], seed: int = 0):
    """(JAX module, variables as numpy) for a CNN config with BatchNorm.
    The tree comes from the JAX module's own init traced with
    jax.eval_shape; the values are drawn with numpy: conv and dense kernels
    N(0, 1/fan_in), unit scales, zero biases, the parameters bumped as in
    `perturb`; batch_stats mean 0 and var 1 (`jax_train_stats` makes them
    non-trivial)."""
    import jax
    import jax.numpy as jnp

    from thyroid_tpu.models.registry import ModelRegistry

    model = ModelRegistry.create_model(config)
    return model, jax_module_variables(
        model, jnp.zeros((1, 32, 32, config.get("in_channels", 1))), seed)


def jax_module_variables(module, x, seed: int = 0) -> Dict[str, Any]:
    """Variables of a flax module with BatchNorm for the input x, as
    numpy: the tree from module.init traced with jax.eval_shape; conv and
    dense kernels N(0, 1/fan_in), unit scales, zero biases, the parameters
    bumped as in `perturb`; batch_stats mean 0 and var 1."""
    import jax

    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, x, train=False))
    rs = np.random.RandomState(seed)

    def draw(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = draw(v)
            elif k in ("scale", "var"):
                out[k] = np.ones(v.shape, np.float32)
            elif k in ("bias", "mean"):
                out[k] = np.zeros(v.shape, np.float32)
            else:
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rs.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
        return out

    return {"params": perturb(draw(shapes["params"])),
            "batch_stats": draw(shapes["batch_stats"])}


def jax_train_stats(model, variables: Dict[str, Any], x) -> Dict[str, Any]:
    """`variables` with running statistics equal to the batch statistics
    of one JAX train-mode forward on `x`: the forward moves the running
    statistics from (0, 1) to 0.1·batch + 0.9·(0, 1), which gives the
    batch's back. (Statistics short of convergence, the initial mean 0 and
    var 1 still weighing, shrink the signal block by block until eval
    logits no longer depend on the input.)"""
    import jax

    _, upd = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(variables, x)

    def batch(tree):
        return {k: batch(v) if hasattr(v, "items") else
                (10 * np.asarray(v) if k == "mean"
                 else np.maximum(10 * np.asarray(v) - 9, 1e-3)).astype(np.float32)
                for k, v in tree.items()}

    return {"params": variables["params"],
            "batch_stats": batch(upd["batch_stats"])}


# --------------------------------------------------------------- augmentation
# JAX's augmentation draws, repeated split by split and draw by draw from
# the key each JAX function takes, as the port's parameter dicts
# (thyroid_tpu_torch/ops/augment.py draw_* / apply_*). A mis-mirrored draw
# makes the port's apply_* disagree with the JAX function's output.


def _torch_tree(tree):
    import torch

    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_gate(key, b: int, p: float):
    import jax

    return np.asarray(jax.random.uniform(key, (b,)) < p)


def _jax_uniform(key, shape, lo: float, hi: float):
    import jax

    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def jax_elastic_params(key, shape):
    import jax

    b, h, w, _ = shape
    k1, k2 = jax.random.split(key)
    return {"dx": _jax_uniform(k1, (b, h, w, 1), -1.0, 1.0),
            "dy": _jax_uniform(k2, (b, h, w, 1), -1.0, 1.0)}


def _jax_microscopy(key, shape, brightness, contrast, blur, p):
    import jax

    b = shape[0]
    keys = jax.random.split(key, 9)
    return {"bright_gate": _jax_gate(keys[0], b, 0.5),
            "bright": _jax_uniform(keys[1], (b,), *brightness),
            "contrast_gate": _jax_gate(keys[2], b, 0.5),
            "contrast": _jax_uniform(keys[3], (b,), *contrast),
            "noise_gate": _jax_gate(keys[4], b, 0.3),
            "noise": np.asarray(jax.random.normal(keys[5], shape)),
            "blur_gate": _jax_gate(keys[6], b, 0.3),
            "blur_sigma": _jax_uniform(keys[7], (b,), *blur),
            "gate": _jax_gate(keys[8], b, p)}


def _jax_patch_drop(key, shape, patch_size, max_patches, p):
    import jax

    b, h, w, _ = shape
    keys = jax.random.split(key, 2 + max_patches)
    y0, x0 = [], []
    for i in range(max_patches):
        ky, kx = jax.random.split(keys[2 + i])
        y0.append(np.asarray(jax.random.randint(
            ky, (b, 1, 1, 1), 0, max(h - patch_size, 1))).reshape(b))
        x0.append(np.asarray(jax.random.randint(
            kx, (b, 1, 1, 1), 0, max(w - patch_size, 1))).reshape(b))
    return {"gate": _jax_gate(keys[0], b, p),
            "n_active": np.asarray(jax.random.randint(keys[1], (b,), 1,
                                                      max_patches + 1)),
            "y0": np.stack(y0), "x0": np.stack(x0)}


def jax_train_augment_params(key, shape, level: str):
    """thyroid_tpu.ops.augment.train_augment's draws at `level`."""
    import jax

    if level == "none":
        return {}
    b = shape[0]
    heavy = level == "heavy"
    keys = jax.random.split(key, 9)
    deg = 180.0 if heavy else 90.0
    out = {"hflip": _jax_gate(keys[0], b, 0.5),
           "vflip": _jax_gate(keys[1], b, 0.5),
           "angle": _jax_uniform(keys[2], (b,), -deg, deg)}
    if level in ("medium", "heavy"):
        rng = (0.7, 1.3) if heavy else (0.8, 1.2)
        out["elastic_gate"] = _jax_gate(keys[3], b, 0.5 if heavy else 0.3)
        out["elastic"] = jax_elastic_params(keys[4], shape)
        out["microscopy"] = _jax_microscopy(keys[5], shape, rng, rng,
                                            (0.0, 1.0), 0.7 if heavy else 0.5)
    if heavy:
        out["patch_drop"] = _jax_patch_drop(keys[6], shape, 32, 5, 0.3)
        out["blur_gate"] = _jax_gate(keys[7], b, 0.3)
        out["blur_sigma"] = _jax_uniform(keys[8], (b,), 0.1, 2.0)
    return _torch_tree(out)


def jax_patch_quality_params(key, shape, patch_size: int = 16):
    import jax

    b, h, w, _ = shape
    ph, pw = h // patch_size, w // patch_size
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return {"strong": np.asarray(jax.random.uniform(k1, (b, ph, pw)) < 0.8),
            "drop": np.asarray(jax.random.uniform(k2, (b, ph, pw)) < 0.1),
            "aug_type": np.asarray(jax.random.randint(k3, (b, ph, pw), 0, 4)),
            "noise": np.asarray(jax.random.normal(k4, shape)),
            "bright": _jax_uniform(k5, (b, 1, 1, 1), 0.7, 1.3).reshape(b)}


def jax_vit_augment_params(key, shape, randaugment_n: int = 2,
                           patch_quality_p: float = 0.5):
    """thyroid_tpu.ops.augment.vit_augment's draws (both parts on)."""
    import jax

    b = shape[0]
    keys = jax.random.split(key, 5)
    choice = np.stack([np.asarray(jax.random.randint(k, (b,), 0, 12))
                       for k in jax.random.split(keys[2], randaugment_n)])
    return _torch_tree({
        "hflip": _jax_gate(keys[0], b, 0.5),
        "vflip": _jax_gate(keys[1], b, 0.5),
        "randaugment": {"choice": choice},
        "patch_gate": _jax_gate(keys[3], b, patch_quality_p),
        "patch_quality": jax_patch_quality_params(keys[4], shape)})


def jax_mixup_cutmix_params(key, shape, mixup_alpha: float = 0.8,
                            cutmix_alpha: float = 1.0, prob: float = 1.0,
                            switch_prob: float = 0.5):
    """thyroid_tpu.ops.augment.mixup_cutmix's draws."""
    import jax

    b, h, w, _ = shape
    k_perm, k_switch, k_lm, k_lc, k_cy, k_cx, k_apply = jax.random.split(key, 7)
    out = {"index": np.asarray(jax.random.permutation(k_perm, b))}
    if mixup_alpha > 0:
        out["lam_mixup"] = np.asarray(jax.random.beta(k_lm, mixup_alpha,
                                                      mixup_alpha))
    if cutmix_alpha > 0:
        out["lam_cutmix"] = np.asarray(jax.random.beta(k_lc, cutmix_alpha,
                                                       cutmix_alpha))
        out["cy"] = np.asarray(jax.random.randint(k_cy, (), 0, h))
        out["cx"] = np.asarray(jax.random.randint(k_cx, (), 0, w))
    if mixup_alpha > 0 and cutmix_alpha > 0:
        out["use_cutmix"] = np.asarray(jax.random.bernoulli(k_switch, switch_prob))
    if prob < 1.0:
        out["apply"] = np.asarray(jax.random.bernoulli(k_apply, prob))
    return _torch_tree(out)


def assert_close_8bit(got, want, atol: float = 1e-5, share: float = 1e-3):
    """`got` within atol of `want`, but for elements one 8-bit level off
    (an upstream rounding crossed a floor onto the 8-bit grid): each within
    1/255 + atol, at most `share` of the elements."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= 1 / 255 + atol, err.max()
    off = int((err > atol).sum())
    assert off <= share * err.size, (off, err.size)


# --------------------------------------------------------------- train steps
# One training step's loss, gradients and updated running statistics, as
# JAX's Trainer computes them and as the port's Trainer does, on the same
# variables and batch.


def jax_params(config: Dict[str, Any], seed: int = 0, img: int = 32):
    """(JAX module, bumped parameters as numpy) of a model without
    BatchNorm (ViT, DeiT): the tree from the module's own init traced with
    jax.eval_shape on an img² input; unit LayerNorm scales, zero biases,
    N(0, 0.02²) elsewhere (jax_swin's draw), bumped as in `perturb`."""
    return jax_swin(dict(config, img_size=img), seed)


def pool_choice(x, window_shape, strides=None, padding="VALID"):
    """For flax's nn.max_pool(x, window_shape, strides, padding) on NHWC x:
    (B, Ho, Wo, C) int32 flat input positions h·W + w of each window's
    first maximum in row-major window order (padding taps count as −inf)."""
    import jax.numpy as jnp

    kh, kw = window_shape
    sh, sw = strides or (1, 1)
    (ph0, ph1), (pw0, pw1) = ((0, 0), (0, 0)) if padding == "VALID" else padding
    b, h, w, c = x.shape
    xp = jnp.pad(x, ((0, 0), (ph0, ph1), (pw0, pw1), (0, 0)),
                 constant_values=-jnp.inf)
    ho, wo = (h + ph0 + ph1 - kh) // sh + 1, (w + pw0 + pw1 - kw) // sw + 1
    taps = jnp.stack([xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
                      for i in range(kh) for j in range(kw)], axis=-1)
    k = jnp.argmax(taps, axis=-1)
    rows = jnp.arange(ho)[None, :, None, None] * sh - ph0 + k // kw
    cols = jnp.arange(wo)[None, None, :, None] * sw - pw0 + k % kw
    return (rows * w + cols).astype(jnp.int32)


def jax_step(model, variables: Dict[str, Any], x, y, w, *,
             loss_mode: str = "ce", label_smoothing: float = 0.0,
             mix_rng=None, mix=(0.8, 1.0), decisions=None, pools=None):
    """(loss, gradients, updated batch_stats or None) of JAX's
    _train_step_impl on (x, y, w): MixUp/CutMix on `mix_rng` when given,
    the train-mode forward (mutable batch_stats where the model has them;
    dropout draws from a fixed key, so configs without dropout agree), then
    the loss of `loss_mode` ("deit" with a tuple: 0.5·ce + 0.5·ce; any
    other tuple: ce(main) + 0.4·ce(aux)); one jitted value_and_grad. With
    a list `decisions`, every flax.linen.relu call of the forward appends
    its decisions x > 0 to it, in call order, as numpy arrays; with a list
    `pools`, every flax.linen.max_pool call appends the input position of
    each output's maximum (`pool_choice`)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from thyroid_tpu.ops.augment import mixup_cutmix
    from thyroid_tpu.training.losses import cross_entropy, mixed_cross_entropy

    has_stats = "batch_stats" in variables

    def loss_fn(params, batch_stats, x, y, w):
        labels_b = lam = None
        if mix_rng is not None:
            x, _, labels_b, lam = mixup_cutmix(x, y, mix_rng, mixup_alpha=mix[0],
                                               cutmix_alpha=mix[1])

        def ce(lgts):
            if mix_rng is not None:
                return mixed_cross_entropy(lgts, y, labels_b, lam,
                                           label_smoothing, w)
            return cross_entropy(lgts, y, label_smoothing, w)

        v = {"params": params}
        rngs = {"dropout": jax.random.PRNGKey(0)}
        seen, chosen, relu, max_pool = [], [], fnn.relu, fnn.max_pool
        if decisions is not None:
            fnn.relu = lambda a: seen.append(a > 0) or relu(a)
        if pools is not None:
            fnn.max_pool = lambda a, *args, **kw: chosen.append(
                pool_choice(a, *args, **kw)) or max_pool(a, *args, **kw)
        try:
            if has_stats:
                v["batch_stats"] = batch_stats
                out, upd = model.apply(v, x, train=True,
                                       mutable=["batch_stats"], rngs=rngs)
                new_stats = upd["batch_stats"]
            else:
                out, new_stats = model.apply(v, x, train=True, rngs=rngs), None
        finally:
            fnn.relu, fnn.max_pool = relu, max_pool
        if loss_mode == "deit" and isinstance(out, tuple):
            loss = 0.5 * ce(out[0]) + 0.5 * ce(out[1])
        elif isinstance(out, tuple):
            loss = ce(out[0]) + 0.4 * ce(out[1])
        else:
            loss = ce(out)
        return loss, (new_stats, seen, chosen)

    (loss, (stats, seen, chosen)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables.get("batch_stats"), jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(w))
    if decisions is not None:
        decisions.extend(np.asarray(d) for d in seen)
    if pools is not None:
        pools.extend(np.asarray(c) for c in chosen)
    tree = jax.tree.map(np.asarray, grads)
    return float(loss), tree, (jax.tree.map(np.asarray, stats)
                               if stats is not None else None)


def port_step(config, training, variables, x, y, w, monkeypatch, tmp_path,
              mirror=None, impose=None, flips=None, impose_pools=None,
              **trainer_kw):
    """(loss, gradients as a JAX tree, updated batch_stats as a JAX tree or
    None, metric state) of one port Trainer.train_step on the CPU from
    `variables`; with `mirror`, the MixUp/CutMix draw is replaced by it
    (JAX's draw, jax_mixup_cutmix_params). With `impose` (jax_step's
    decisions), each torch.nn.functional.relu call of the step takes the
    next decision d (x·d) and appends (decisions it takes the other way
    on its own, elements) to `flips`; with `impose_pools` (jax_step's
    pools), each torch.nn.functional.max_pool2d call takes the next
    positions and appends its own differing choices to `flips` likewise."""
    import torch
    import torch.nn.functional as F

    from thyroid_tpu_torch.models.from_jax import jax_tree
    from thyroid_tpu_torch.models.registry import ModelRegistry
    from thyroid_tpu_torch.training import engine as port_engine
    from thyroid_tpu_torch.training import metrics as tmetrics
    from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT
    from thyroid_tpu_torch.training.engine import Trainer

    if mirror is not None:
        monkeypatch.setattr(port_engine, "draw_mixup_cutmix",
                            lambda *a, **k: mirror)
    grads = {}
    loss_and_grads = Trainer.loss_and_grads

    def keep(self, *args):
        out = loss_and_grads(self, *args)
        grads.update(out[2])
        return out

    monkeypatch.setattr(Trainer, "loss_and_grads", keep)
    if impose is not None:
        calls = iter(impose)

        def decide(a, inplace=False):
            d = torch.from_numpy(next(calls))
            flips.append((int((d != (a > 0)).sum()), d.numel()))
            return a * d

        monkeypatch.setattr(F, "relu", decide)
    if impose_pools is not None:
        pools, max_pool2d = iter(impose_pools), F.max_pool2d

        def pick(a, *args, **kw):
            own, idx = max_pool2d(a, *args, return_indices=True, **kw)
            d = torch.from_numpy(next(pools)).permute(0, 3, 1, 2).long()
            flips.append((int((d != idx).sum()), d.numel()))
            return a.flatten(2).gather(2, d.flatten(2)).view(own.shape)

        monkeypatch.setattr(F, "max_pool2d", pick)
    pt = Trainer(ModelRegistry.create_model(config), config, training,
                 TRAINER_DEFAULT, steps_per_epoch=2, output_dir=tmp_path,
                 variables=variables, device="cpu", **trainer_kw)
    tm, _ = pt.train_step(tmetrics.zero_metric_state(), torch.from_numpy(x),
                          torch.from_numpy(y).long(), torch.from_numpy(w))
    monkeypatch.undo()
    stats = jax_tree(pt.state.batch_stats, pt.state.layout) \
        if pt.state.batch_stats else None
    return (float(tm["loss_sum"]) / float(tm["w_sum"]),
            jax_tree(grads, pt.state.layout), stats, tm)


def global_rel(got, want) -> float:
    """|got − want| / |want| over every leaf of two trees (global norms)."""
    g, w = flat_tree(got), flat_tree(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))
    num = sum(float(np.sum((g[k] - w[k]) ** 2)) for k in w)
    den = sum(float(np.sum(w[k] ** 2)) for k in w)
    return (num / den) ** 0.5


def golden_variables(name: str, img: int = 224):
    """JAX's create_and_init(PRNGKey(0)) of the golden config
    ({"name", "img_size", "in_channels": 1, "num_classes": 2}) with
    test_golden_parity's 0.01·sin bump on the parameters, in one jitted
    program, as numpy; → (config, variables)."""
    import jax
    import jax.numpy as jnp

    from thyroid_tpu.models.base import create_and_init as jax_create

    cfg = {"name": name, "img_size": img, "in_channels": 1, "num_classes": 2}

    def bump(p):
        wave = jnp.sin(jnp.arange(p.size, dtype=jnp.float32) * 0.7)
        return p + 0.01 * wave.reshape(p.shape).astype(p.dtype)

    def init(key):
        variables = jax_create(cfg, key)[1]
        return {**variables, "params": jax.tree.map(bump, variables["params"])}

    return cfg, jax.tree.map(np.asarray, jax.jit(init)(jax.random.PRNGKey(0)))


def golden_input(img: int, batch: int = 2) -> np.ndarray:
    """test_golden_parity's fixed input."""
    rs = np.random.RandomState(12345)
    return rs.rand(batch, img, img, 1).astype(np.float32) * 2 - 1


def tree_shapes_equal(port_variables, jax_shapes) -> None:
    """The port's JAX tree (to_jax_variables) against jax.eval_shape's, by
    collection, name and shape."""
    import jax

    assert set(port_variables) == set(jax_shapes), \
        (set(port_variables), set(jax_shapes))
    for col in port_variables:
        want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    jax_shapes[col])[0]}
        got = {k: tuple(v.shape) for k, v in flat_tree(port_variables[col]).items()}
        assert got == want, (col, sorted(set(got) ^ set(want)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side of a test module that
    imports this fixture: its tensors are small, so one thread is as fast
    alone, and under the suite's parallel workers it does not wait on
    threads the other workers' processes hold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JittedModule:
    """A flax module whose `apply` is jitted, one program per keyword
    set, for the JAX package's functions that call `model.apply` op by op
    (its analysis functions): JAX's CPU takes several times longer
    unjitted. Every other attribute is the module's."""

    def __init__(self, module):
        self.module = module
        self._programs: Dict[Any, Any] = {}

    def apply(self, variables, x, **kw):
        import jax

        key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                           for k, v in kw.items()))
        if key not in self._programs:
            self._programs[key] = jax.jit(
                lambda v, x: self.module.apply(v, x, **kw))
        return self._programs[key](variables, x)

    def __getattr__(self, name):
        return getattr(self.module, name)
