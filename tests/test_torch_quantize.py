"""Int8 serving of the port (thyroid_tpu_torch/serving/quantize.py) against
the JAX package's interceptor (thyroid_tpu/serving/quantize.py), on the
CPU: the quantization primitives and single int8 layers bit for bit, the
set of quantized layers of whole models by JAX path, and the int8 engine
beside JAX's."""
import numpy as np
import pytest
import torch

from tests.torch_parity import (SMALL_SWIN, jax_cnn, jax_params,
                                one_torch_thread)  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import jax_layout
from thyroid_tpu_torch.serving import quantize as q
from thyroid_tpu_torch.serving.engine import InferenceEngine

BF16 = torch.bfloat16


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == BF16 else t.numpy()


PRIMITIVES = {
    # name: (array, JAX out_axis, port out_axis or None for an activation)
    "dense weight": (np.random.RandomState(0).randn(48, 40), 1, 1),
    "conv weight": (np.random.RandomState(1).randn(3, 3, 16, 32), 3, 0),
    "activation": (np.random.RandomState(2).randn(4, 9, 9, 33) * 3.0, None, None),
    "activation at ties": (np.arange(-254, 256).reshape(2, -1) / 2.0, None, None),
    "zero activation": (np.zeros((4, 4)), None, None),
    "zero weight": (np.zeros((3, 5)), 1, 1),
}


@pytest.mark.unit
@pytest.mark.parametrize("case", PRIMITIVES)
def test_primitives_bit_equal(case):
    """`_quantize_weight` / `_quantize_act` equal JAX's bit for bit: the
    int8 values and the float32 scales (the all-zero inputs take the
    1e-12 floor; the half-integer ramp hits round-half-to-even)."""
    from thyroid_tpu.serving import quantize as jq

    arr, jax_axis, port_axis = PRIMITIVES[case]
    arr = arr.astype(np.float32)
    if jax_axis is None:
        want_q, want_s = jq._quantize_act(_jnp(arr))
        got_q, got_s = q._quantize_act(torch.from_numpy(arr))
    else:
        want_q, want_s = jq._quantize_weight(_jnp(arr), out_axis=jax_axis)
        t = torch.from_numpy(arr)
        if arr.ndim == 4:          # HWIO → the port's OIHW
            t = t.permute(3, 2, 0, 1)
        got_q, got_s = q._quantize_weight(t, out_axis=port_axis)
        if arr.ndim == 4:
            got_q = got_q.permute(2, 3, 1, 0)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if case == "activation at ties":
        assert np.abs(got_q.numpy()).max() == 127


# single layers: (kind, JAX module kwargs, input shape, dtype, QuantConfig
# kwargs, quantized?)
LAYERS = {
    "conv SAME stride 2": ("conv", dict(features=48, kernel_size=(3, 3), strides=(2, 2),
                                        padding="SAME"), (2, 15, 13, 40), "bf16", {}, True),
    "conv explicit padding": ("conv", dict(features=40, kernel_size=(3, 2),
                                           padding=[(1, 2), (0, 1)], use_bias=False),
                              (2, 9, 9, 36), "bf16", {}, True),
    "conv 1x1": ("conv", dict(features=64, kernel_size=(1, 1)), (3, 5, 5, 48), "bf16",
                 {}, True),
    "grouped conv, skip_depthwise off": ("conv", dict(features=64, kernel_size=(3, 3),
                                                      feature_group_count=2, padding="SAME",
                                                      use_bias=False),
                                         (2, 7, 7, 64), "bf16",
                                         {"skip_depthwise": False}, True),
    "depthwise conv (skipped)": ("conv", dict(features=64, kernel_size=(3, 3),
                                              feature_group_count=64, padding="SAME",
                                              use_bias=False),
                                 (2, 7, 7, 64), "bf16", {}, False),
    "dense": ("dense", dict(features=96), (3, 7, 64), "bf16", {}, True),
    "dense float32 with a bias": ("dense", dict(features=40), (5, 33), "f32", {}, True),
    "thin head (skipped)": ("dense", dict(features=2), (4, 128), "f32", {}, False),
}


def _flax_layer(kind, kw, dtype):
    import flax.linen as nn
    import jax.numpy as jnp

    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return (nn.Conv if kind == "conv" else nn.Dense)(dtype=dt, **kw)


def _layer_params(kind, kw, shape, seed):
    """numpy parameters of the flax layer for an input of `shape`: kernel
    N(0, 1/fan_in) in flax's layout, bias N(0, 0.1²) where it has one."""
    rs = np.random.RandomState(seed)
    cin, cout = shape[-1], kw["features"]
    kshape = ((cin, cout) if kind == "dense" else
              tuple(kw["kernel_size"]) + (cin // kw.get("feature_group_count", 1), cout))
    params = {"kernel": (rs.randn(*kshape) / np.sqrt(np.prod(kshape[:-1])))
              .astype(np.float32)}
    if kw.get("use_bias", True):
        params["bias"] = (0.1 * rs.randn(cout)).astype(np.float32)
    return {"params": params}


def _jax_apply(layer, variables, x, cfg=None, jit=False):
    """The flax layer under JAX's int8 interceptor (the float layer when
    cfg is None), op by op: the interceptor's formula as written. Jitted,
    XLA's CPU fuses the float32 epilogue (`· (s_x·s_w) + bias` into one
    multiply-add, and the grouped conv's too) and moves 2-4% of the
    float32 results by one unit in the last place from the formula, and
    from the port on the CPU and the card; a bf16 result hides it."""
    import jax
    from thyroid_tpu.serving import quantize as jq

    def run(v, x):
        if cfg is None:
            return layer.apply(v, x)
        with jq.int8_serving(jq.QuantConfig(**cfg)):
            return layer.apply(v, x)

    return np.asarray((jax.jit(run) if jit else run)(variables, _jnp(x)), np.float32)


def _port_layer(kind, kw, params, x, dtype, cfg):
    """The port's call site for the JAX layer on its parameters: the int8
    result, or None where the layer is not eligible."""
    dt = BF16 if dtype == "bf16" else torch.float32
    w = torch.from_numpy(np.asarray(params["kernel"]))
    b = torch.from_numpy(np.asarray(params["bias"])) if "bias" in params else None
    xt = torch.from_numpy(x)
    with q.int8_serving(q.QuantConfig(**cfg)):
        if kind == "dense":
            return q.dense_site(xt, w, b, dt)
        w = w.permute(3, 2, 0, 1)
        pad = kw.get("padding", "SAME")
        groups = kw.get("feature_group_count", 1)
        stride = kw.get("strides", (1, 1))
        return q.conv_site(xt, w, b, dt, stride, pad, groups)


@pytest.mark.unit
@pytest.mark.parametrize("case", LAYERS)
def test_single_layer_bit_equal(case):
    """A port int8 call site against JAX's interceptor on one flax layer,
    the same weights and input: bit-equal outputs (int8 product, scales,
    bias and the cast); a skipped layer is skipped by both (the port
    returns None, JAX's interceptor leaves the float layer). The padding
    cases are asymmetric: SAME at stride 2 on odd sides, explicit (1, 2) /
    (0, 1)."""
    kind, kw, shape, dtype, cfg, quantized = LAYERS[case]
    layer = _flax_layer(kind, kw, dtype)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    variables = _layer_params(kind, kw, shape, 5)
    # a float32 result op by op (see _jax_apply), a bf16 one jitted
    want = _jax_apply(layer, variables, x, cfg, jit=dtype == "bf16")
    got = _port_layer(kind, kw, variables["params"], x, dtype, cfg)
    if not quantized:
        assert got is None
        np.testing.assert_array_equal(want, _jax_apply(layer, variables, x, jit=True))
        return
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.unit
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_dequantized_products_close(kind):
    """accumulate_int32=False (dequantize, then a float32 product) against
    JAX's: float32 sums in another order, rtol 1e-5 of the largest."""
    kw = (dict(features=48, kernel_size=(3, 3), strides=(2, 2), padding="SAME")
          if kind == "conv" else dict(features=64))
    shape = (2, 11, 11, 40) if kind == "conv" else (6, 40)
    layer = _flax_layer(kind, kw, "f32")
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    variables = _layer_params(kind, kw, shape, 7)
    cfg = {"accumulate_int32": False}
    want = _jax_apply(layer, variables, x, cfg, jit=True)
    got = _np(_port_layer(kind, kw, variables["params"], x, "f32", cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------- which layers run int8

SET_CONFIGS = {
    "resnet18": {"name": "resnet18", "width": 16, "img_size": 32, "in_channels": 1,
                 "num_classes": 2},
    "efficientnet_b0": {"name": "efficientnet_b0", "width_mult": 0.5, "depth_mult": 0.3,
                        "img_size": 32, "in_channels": 1, "num_classes": 2},
    "vit_tiny": {"name": "vit_tiny", "embed_dim": 64, "depth": 2, "num_heads": 2,
                 "patch_size": 8, "img_size": 32, "in_channels": 1, "num_classes": 2,
                 "token_kernels": False},
    "swin, kernels on": dict(SMALL_SWIN, use_pallas_attention=True),
    "swin, kernels off": dict(SMALL_SWIN, use_pallas_attention=False),
    "medical swin": {"name": "swin_tiny", "img_size": 40, "embed_dim": 64,
                     "depths": (1, 1), "num_heads": (2, 4), "window_size": 4,
                     "in_channels": 1, "num_classes": 2, "medical_adaptations": True,
                     "uncertainty_head": True},
}


def jax_quantized_layers(config):
    """The JAX paths ("a/b/c") of the nn.Dense/nn.Conv calls that JAX's
    int8 interceptor rewrites in one eval forward: an outer interceptor
    asks JAX's own `_eligible`, while tracing only (jax.eval_shape)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from thyroid_tpu.models.registry import ModelRegistry
    from thyroid_tpu.serving import quantize as jq

    model = ModelRegistry.create_model(config)
    img = config["img_size"]
    x = jnp.zeros((2, img, img, 1))
    seen = set()

    def record(next_fn, args, kwargs, context):
        mod = context.module
        if (context.method_name == "__call__" and args
                and isinstance(args[0], jnp.ndarray)
                and isinstance(mod, (nn.Dense, nn.Conv))
                and jq._eligible(mod, args[0], jq.QuantConfig())):
            seen.add("/".join(mod.path))
        return next_fn(*args, **kwargs)

    def forward():
        variables = model.init(jax.random.PRNGKey(0), x, train=False)
        seen.clear()
        with nn.intercept_methods(record), jq.int8_serving():
            return model.apply(variables, x, train=False)

    jax.eval_shape(forward)
    return seen


def port_quantized_layers(config, **forward_kw):
    """The JAX paths of the layers the port runs in int8 in one eval
    forward on the CPU, from the kernels its int32 products name."""
    model = create_and_init(config, device="cpu")
    names = {id(p): n for n, p in model.named_parameters()}
    layout = jax_layout(model)
    seen = set()

    def observe(kernel, a, b, y):
        path = layout[names[id(kernel)]][1]
        seen.add(path.rsplit(".", 1)[0].replace(".", "/"))

    img = config["img_size"]
    with torch.inference_mode(), q.observing(observe), q.int8_serving():
        model(torch.rand(2, img, img, 1), **forward_kw)
    return seen


@pytest.mark.unit
@pytest.mark.parametrize("name", SET_CONFIGS)
def test_quantized_layer_set_equals_jax(name):
    """The set of layers run in int8 equals JAX's, by JAX path. JAX
    computes Swin's uncertainty head on every forward; the port when asked
    (return_uncertainty), as its plain forward skips it."""
    config = SET_CONFIGS[name]
    kw = {"return_uncertainty": True} if config.get("uncertainty_head") else {}
    want = jax_quantized_layers(config)
    got = port_quantized_layers(config, **kw)
    assert got == want, (sorted(got - want), sorted(want - got))
    assert want or name == "swin, kernels on"
    if name == "swin, kernels on":
        # the fused path's projections, MLPs and merges read raw parameters
        assert not want
    if name == "swin, kernels off":
        assert {p.rsplit("/", 1)[-1] for p in want} == {"proj"}


# ----------------------------------------------------------- whole engines

ENGINE_CASES = {
    # name: (config, frames' side, raw frames?), JAX's own engine and
    # model-level cases (tests/unit/test_quantize.py), narrowed
    "resnet18": (SET_CONFIGS["resnet18"], 32, False),
    "vit_tiny": (dict(SET_CONFIGS["vit_tiny"], drop_path_rate=0.0), 32, True),
}


def _jax_variables(name, config):
    if name == "vit_tiny":
        return {"params": jax_params(config)[1]}
    return jax_cnn(config)[1]


@pytest.mark.unit
@pytest.mark.parametrize("name", ENGINE_CASES)
def test_int8_engine_matches_jax(name):
    """InferenceEngine(quantize="int8") against JAX's on the same weights
    and frames, float32 models. The int8 products are exact on both sides;
    the float32 parts around them (the stem, BatchNorm, attention) round
    differently, and a value that lands on the other side of an int8 step
    moves its layer's output by one step of s_x·s_w. Bound: atol 2e-3 on
    the probabilities, and equal decisions."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine

    config, side, raw = ENGINE_CASES[name]
    variables = _jax_variables(name, config)
    rs = np.random.RandomState(8)
    frames = rs.rand(4, side, side, 1).astype(np.float32)
    if raw:
        frames = frames * 65535.0
    kw = dict(buckets=(4,), raw_inputs=raw, quantize="int8")
    want = JaxEngine(model_config=config, variables=variables, **kw).predict(frames)
    port = InferenceEngine(config, variables=variables, device="cpu", **kw)
    got = port.predict(frames)
    assert got.shape == (4, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    float_probs = InferenceEngine(config, variables=variables, device="cpu",
                                  buckets=(4,), raw_inputs=raw).predict(frames)
    assert np.abs(got - float_probs).max() > 0      # int8 changed something
    assert np.ptp(want[:, 0]) > 1e-4               # not a vacuous comparison


@pytest.mark.unit
def test_int8_engine_switches_off_token_kernels():
    """As JAX's engine: the model is built from a copy of the config with
    token_kernels False (the ViT blocks' plain path, whose Dense layers are
    the int8 sites); the engine keeps the config it was given."""
    config = dict(SET_CONFIGS["vit_tiny"])
    del config["token_kernels"]
    engine = InferenceEngine(config, device="cpu", buckets=(2,), quantize="int8",
                             raw_inputs=False)
    assert "token_kernels" not in engine.model_config
    blocks = [m for m in engine.model.modules() if hasattr(m, "token_kernels")]
    assert blocks and not any(m.token_kernels for m in blocks)
    float_engine = InferenceEngine(config, device="cpu", buckets=(2,), raw_inputs=False)
    assert all(m.token_kernels for m in float_engine.model.modules()
               if hasattr(m, "token_kernels"))
    probs = engine.predict(np.random.RandomState(9).rand(2, 32, 32, 1))
    assert probs.shape == (2, 2) and np.isfinite(probs).all()


@pytest.mark.unit
def test_int8_switch_is_per_context():
    """The int8 switch is a context variable: another thread does not see
    it, and it ends with its `with`."""
    import threading

    x = torch.randn(3, 64)
    w = torch.randn(64, 64)
    assert q.dense_site(x, w, None, torch.float32) is None
    inner = []
    with q.int8_serving():
        assert q.dense_site(x, w, None, torch.float32) is not None
        t = threading.Thread(target=lambda: inner.append(
            q.dense_site(x, w, None, torch.float32)))
        t.start()
        t.join()
    assert inner == [None]
    assert q.dense_site(x, w, None, torch.float32) is None


@pytest.mark.unit
def test_int_matmul_pads_exactly():
    """The card's form of the product, zero padding to more than 16 rows
    and K and N multiples of 8, b column-major, is exact: run here on the
    CPU at efficientnet_b0's squeeze-excite shape (1 row at bucket 1, K
    1152, N 48) and at shapes that need every pad."""
    rs = np.random.RandomState(10)
    for m, k, n in ((1, 1152, 48), (5, 37, 3), (17, 8, 8)):
        a = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rs.randint(-127, 128, (k, n)).astype(np.int8))
        want = (a.int() @ b.int()).numpy()
        np.testing.assert_array_equal(q.padded_int_mm(a, b).numpy(), want)
        np.testing.assert_array_equal(q.int_matmul(a, b).numpy(), want)
