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
    LayerNorm scales, zero biases, N(0, 0.02²) elsewhere."""
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
