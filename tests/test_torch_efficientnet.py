"""Port EfficientNet (thyroid_tpu_torch.models.cnn.efficientnet), its
BatchNorm, the variable carrier with batch_stats and the serving engine,
against the JAX package on the CPU in float32, on numpy-drawn weights with
the golden tests' bump and running statistics left by JAX train-mode
forwards (the initial mean 0, var 1 would hide an eval-mode fault). The
full-model comparisons use JAX's library depthwise conv (dw_pallas_conv
off): the JAX package's own test holds its two paths equal, and
tests/test_torch_depthwise.py holds the port's plain depthwise against
JAX's kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (SMALL_EFFNET, flat_tree, jax_cnn,
                                jax_train_stats)
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.data.pipeline import prepare_images
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.cnn.efficientnet import EFFICIENTNET_PARAMS
from thyroid_tpu_torch.models.from_jax import (load_jax_params,
                                               load_jax_variables,
                                               to_jax_variables)
from thyroid_tpu_torch.models.layers import BatchNorm
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.ops import depthwise_pallas
from thyroid_tpu_torch.ops.image import standardize
from thyroid_tpu_torch.serving.engine import InferenceEngine

B0 = {"name": "efficientnet_b0", "in_channels": 1, "num_classes": 2,
      "img_size": 64}


@pytest.fixture(scope="module")
def b0():
    """(JAX b0 at full width, variables with the running statistics of a
    train-mode forward, a 64² batch, JAX's jitted float32 eval logits)."""
    model, variables = jax_cnn(B0)
    rs = np.random.RandomState(3)
    variables = jax_train_stats(model, variables, jnp.asarray(
        rs.randn(4, 64, 64, 1).astype(np.float32)))
    x = rs.randn(3, 64, 64, 1).astype(np.float32)
    logits = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return model, variables, x, np.asarray(logits)


def _port(config, variables):
    model = create_and_init(config, device="cpu")
    load_jax_variables(model, variables)
    return model


@pytest.mark.unit
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batchnorm_matches_flax(train, dtype):
    """flax nn.BatchNorm(momentum 0.9) against layers.BatchNorm on a
    (N, H, W, C) input with a large mean: outputs, and in training the
    updated statistics (float32, biased variance), within 1e-5 (the batch
    statistics' float32 sums in another order, E[x²] − E[x]² cancelling
    against a mean of 3); the bf16 output within one bf16 rounding (2^-8
    relative)."""
    import flax.linen as fnn

    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rs = np.random.RandomState(11)
    x = (rs.randn(6, 5, 7, 24) * 2 + 3).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    v = {"params": {"scale": (1 + 0.1 * rs.randn(24)).astype(np.float32),
                    "bias": (0.1 * rs.randn(24)).astype(np.float32)},
         "batch_stats": {"mean": rs.randn(24).astype(np.float32),
                         "var": (0.5 + rs.rand(24)).astype(np.float32)}}
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, dtype=jdt)
    if train:
        want, upd = bn.apply(v, xj, mutable=["batch_stats"])
    else:
        want, upd = bn.apply(v, xj), None
    port = BatchNorm(24)
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt),
                   train, tdt)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "f32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    stats = to_jax_variables(port)["batch_stats"]
    ref = upd["batch_stats"] if train else v["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if train:    # the statistics moved from the old running ones
        assert np.abs(stats["mean"] - v["batch_stats"]["mean"]).min() > 1e-3


def _shapes(tree, prefix=""):
    return {k: tuple(v.shape) for k, v in flat_tree(tree, prefix).items()}


@pytest.mark.unit
@pytest.mark.parametrize("name", list(EFFICIENTNET_PARAMS))
def test_variable_tree_matches_jax(name):
    """Names, shapes and collections of b0–b3 against JAX's init, traced
    with jax.eval_shape (not run)."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    model = JaxRegistry.create_model({"name": name})
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 1)),
        train=False))
    port = to_jax_variables(ModelRegistry.create_model({"name": name}))
    assert set(port) == {"params", "batch_stats"}
    for col in port:
        want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    shapes[col])[0]}
        assert _shapes(port[col]) == want, col


@pytest.mark.unit
def test_variables_round_trip_and_strict(b0):
    """load_jax_variables and to_jax_variables are exact inverses; loading
    raises on a missing or extra leaf or buffer and on a wrong shape;
    load_jax_params refuses a model with BatchNorm statistics."""
    _, variables, _, _ = b0
    model = _port(B0, variables)
    back = to_jax_variables(model)
    for col in ("params", "batch_stats"):
        got, want = flat_tree(back[col]), flat_tree(variables[col])
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), col
    dw = variables["params"]["mbconv1_1"]["Conv_1"]["kernel"]        # (3, 3, 1, 144)
    np.testing.assert_array_equal(model.mbconv1_1.Conv_1.kernel.detach().numpy(),
                                  dw.transpose(3, 2, 0, 1))
    stats = variables["batch_stats"]
    with pytest.raises(KeyError, match="head_bn.mean"):
        load_jax_variables(model, {"params": variables["params"],
                                   "batch_stats": {k: v for k, v in stats.items()
                                                   if k != "head_bn"}})
    with pytest.raises(KeyError, match="extra"):
        load_jax_variables(model, {**variables, "batch_stats": dict(
            stats, extra={"mean": np.zeros(3, np.float32)})})
    with pytest.raises(ValueError, match="stem_bn.var"):
        load_jax_variables(model, {**variables, "batch_stats": dict(
            stats, stem_bn={"mean": stats["stem_bn"]["mean"],
                            "var": np.ones(5, np.float32)})})
    with pytest.raises(KeyError, match="mean"):
        load_jax_params(model, variables["params"])


@pytest.mark.unit
def test_b0_eval_logits_match_jax(b0):
    """Full-width b0 at 64², float32, non-trivial statistics: logits within
    1e-4 relative of JAX's; the dw_pallas_conv (plain version on the CPU)
    and dw_shift_conv paths give the same logits."""
    _, variables, x, want = b0
    assert np.ptp(want[:, 0]) > 1e-2          # not a vacuous comparison
    for extra in ({}, {"dw_pallas_conv": True}, {"dw_shift_conv": True}):
        model = _port(dict(B0, **extra), variables)
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=str(extra))


@pytest.mark.unit
def test_engine_matches_jax_engine():
    """The narrow efficientnet of tests/torch_parity.py (every block kind)
    served on raw uint16-scale 48² frames by both engines at bucket 4 (3 →
    4 padded): probabilities within 1e-5. The port engine with
    dw_pallas_conv on the CPU counts no kernel launch."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine

    def frames(seed, n):
        return (np.random.RandomState(seed).rand(n, 48, 48, 1) * 65535) \
            .astype(np.float32)

    model, variables = jax_cnn(SMALL_EFFNET)
    # statistics of served inputs: other frames, prepared and standardized
    x = standardize(prepare_images(torch.from_numpy(frames(4, 8)), 32),
                    (0.5,), (0.5,))
    variables = jax_train_stats(model, variables, jnp.asarray(x.numpy()))
    raw = frames(5, 3)
    want = JaxEngine(model_config=SMALL_EFFNET, buckets=(4,),
                     variables=variables).predict(raw)
    depthwise_pallas.depthwise_conv2d_pallas.launches = 0
    port = InferenceEngine(dict(SMALL_EFFNET, dw_pallas_conv=True),
                           variables=variables, buckets=(4,), device="cpu")
    got = port.predict(raw)
    assert got.shape == (3, 2) and np.abs(got - want).max() < 1e-5, (got, want)
    assert np.ptp(want[:, 0]) > 1e-4
    assert depthwise_pallas.depthwise_conv2d_pallas.launches == 0


@pytest.mark.unit
def test_serving_size_and_unported_options():
    """A b3 config without img_size is served at 224, as the JAX engine
    serves it (cfg img_size or 224), not at b3's resolution 300; the
    capture forward records the feature map ("features"); int8 serving
    builds (a mode other than int8 raises, as in JAX); a mesh that is not
    a device mesh raises a TypeError naming the mesh."""
    b3 = {"name": "efficientnet_b3", "in_channels": 1, "num_classes": 2}
    engine = InferenceEngine(b3, device="cpu")
    assert engine.img_size == engine.model.img_size == 224
    assert ModelRegistry.create_model(dict(b3, img_size=300)).img_size == 300
    with torch.no_grad():
        _, inter = engine.model(torch.zeros(1, 32, 32, 1), capture=True)
    assert list(inter) == ["features"] and inter["features"].shape == (1, 1, 1, 1536)
    assert InferenceEngine(b3, quantize="int8", device="cpu").quantize == "int8"
    with pytest.raises(ValueError, match="int8"):
        InferenceEngine(b3, quantize="int4", device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        InferenceEngine(b3, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(b3, params={}, variables={}, device="cpu")
