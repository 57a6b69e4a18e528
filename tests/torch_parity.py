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
