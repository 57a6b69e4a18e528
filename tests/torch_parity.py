"""Shared helpers of the tests that hold the PyTorch port (thyroid_tpu_torch)
against the JAX package on the same inputs and weights, on the CPU."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

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
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 32, 32, config.get("in_channels", 1))), train=False))
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

    return model, {"params": perturb(draw(shapes["params"])),
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
