"""Port serving engine (thyroid_tpu_torch.serving) against the JAX engine on
the same weights and raw frames, on the CPU."""
import numpy as np
import pytest
import torch

from tests.torch_parity import SMALL_SWIN, jax_swin, one_torch_thread  # noqa: F401
from thyroid_tpu_torch.ops import attention, percentile, token_fused
from thyroid_tpu_torch.serving.engine import InferenceEngine

COUNTED = (percentile.fused_percentile_normalize, token_fused.fused_ln_matmul,
           token_fused.fused_ln_mlp_residual,
           attention.fused_swin_block_attention)


@pytest.fixture(scope="module")
def params():
    return jax_swin(SMALL_SWIN)[1]


@pytest.mark.unit
def test_engine_matches_jax_engine(params):
    """Bucket padding (3 → 4) and chunking past the largest bucket
    (6 → 4 + 2→4) on raw uint16-scale frames. atol 1e-5 on probabilities:
    the port's float32 forward agrees with JAX's to that bound."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine

    raw = (np.random.RandomState(5).rand(6, 80, 80, 1) * 65535) \
        .astype(np.float32)
    jax_engine = JaxEngine(model_config=SMALL_SWIN, buckets=(1, 4),
                           variables={"params": params})
    port = InferenceEngine(SMALL_SWIN, params=params, buckets=(1, 4),
                           device="cpu")
    assert port.bucket_for(3) == 4 and port.bucket_for(9) == 4
    for n in (3, 6):
        want = jax_engine.predict(raw[:n])
        got = port.predict(raw[:n])
        assert got.shape == (n, 2) and got.dtype == np.float32
        assert np.abs(got - want).max() < 1e-5, (got, want)
    # padding rows do not leak into the answered rows
    np.testing.assert_allclose(port.predict(raw[:1]), port.predict(raw[:4])[:1],
                               atol=1e-6)
    assert np.ptp(want[:, 0]) > 1e-4       # not a vacuous comparison


@pytest.mark.unit
def test_cpu_tensors_never_launch_kernels(params):
    for fn in COUNTED:
        fn.launches = 0
    port = InferenceEngine(SMALL_SWIN, params=params, buckets=(2,),
                           device="cpu")
    port.warmup()
    probs = port.predict(np.random.RandomState(6).rand(3, 64, 64) * 65535)
    assert probs.shape == (3, 2) and np.isfinite(probs).all()
    assert [fn.launches for fn in COUNTED] == [0, 0, 0, 0]


@pytest.mark.unit
def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA; with no card the engine raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(SMALL_SWIN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(SMALL_SWIN, device="cuda")
    with pytest.raises(ValueError):
        InferenceEngine(None, device="cpu")


# ------------------------------------------- checkpoints and engine options

# a narrow float32 resnet18 on prepared 32² frames (JAX's own engine cases,
# tests/unit/test_serving.py, at width 16)
NARROW_RESNET = {"name": "resnet18", "width": 16, "img_size": 32,
                 "in_channels": 1, "num_classes": 2}


def save_port_checkpoint(path, config, variables, metadata=True):
    """A port checkpoint (training/checkpoint.py save_checkpoint) of the
    model `config` builds, filled with the JAX `variables`."""
    from types import SimpleNamespace

    from thyroid_tpu_torch.models.base import create_and_init
    from thyroid_tpu_torch.models.from_jax import (batch_stats, jax_layout,
                                                   load_jax_variables)
    from thyroid_tpu_torch.training.checkpoint import save_checkpoint

    model = create_and_init(config, device="cpu")
    load_jax_variables(model, variables)
    state = SimpleNamespace(params=dict(model.named_parameters()),
                            batch_stats=batch_stats(model),
                            layout=jax_layout(model), step=3)
    return save_checkpoint(path, state, {"model_config": config} if metadata else None)


@pytest.fixture(scope="module")
def resnet_variables():
    from tests.torch_parity import jax_cnn

    return jax_cnn(NARROW_RESNET)[1]


def prepared_frames(n: int = 4, side: int = 32, seed: int = 11) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, side, side, 1).astype(np.float32)


@pytest.mark.unit
def test_checkpoint_engine_matches_jax(resnet_variables, tmp_path):
    """`checkpoint=` restores a port checkpoint and takes its
    metadata["model_config"]; its probabilities equal JAX's engine on the
    same weights and prepared frames (raw_inputs=False) within 1e-5."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine

    ck = save_port_checkpoint(tmp_path / "ck", NARROW_RESNET, resnet_variables)
    port = InferenceEngine(checkpoint=str(ck), device="cpu", buckets=(4,),
                           raw_inputs=False)
    assert port.model_config == NARROW_RESNET and not port.raw_inputs
    port.warmup()                     # img_size² frames, no preparation
    frames = prepared_frames()
    want = JaxEngine(model_config=NARROW_RESNET, variables=resnet_variables,
                     buckets=(4,), raw_inputs=False).predict(frames)
    got = port.predict(frames)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.ptp(want[:, 0]) > 1e-4


@pytest.mark.unit
def test_checkpoint_without_metadata(resnet_variables, tmp_path):
    """A checkpoint without model_config metadata raises JAX's ValueError
    unless the config is passed; then it serves the stored weights."""
    ck = save_port_checkpoint(tmp_path / "bare", NARROW_RESNET, resnet_variables,
                              metadata=False)
    with pytest.raises(ValueError, match="no model_config"):
        InferenceEngine(checkpoint=str(ck), device="cpu")
    with pytest.raises(ValueError, match="need model_config or checkpoint"):
        InferenceEngine(device="cpu")
    engine = InferenceEngine(NARROW_RESNET, checkpoint=str(ck), device="cpu",
                             buckets=(4,), raw_inputs=False)
    fresh = InferenceEngine(NARROW_RESNET, variables=resnet_variables,
                            device="cpu", buckets=(4,), raw_inputs=False)
    frames = prepared_frames()
    np.testing.assert_array_equal(engine.predict(frames), fresh.predict(frames))


@pytest.mark.unit
@pytest.mark.parametrize("case", ["mean/std override", "3-channel ImageNet default"])
def test_normalisation_matches_jax(resnet_variables, case):
    """`mean`/`std` overrides, and a 3-channel model's ImageNet statistics
    on gray frames repeated to RGB, as JAX's engine: the same stats and
    probabilities within 1e-5 on prepared frames."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine
    from tests.torch_parity import jax_cnn

    if case == "mean/std override":
        config, variables = NARROW_RESNET, resnet_variables
        kw = {"mean": (0.4,), "std": (0.3,)}
    else:
        config = dict(NARROW_RESNET, in_channels=3)
        variables, kw = jax_cnn(config)[1], {}
    jax_engine = JaxEngine(model_config=config, variables=variables,
                           buckets=(4,), raw_inputs=False, **kw)
    port = InferenceEngine(config, variables=variables, device="cpu",
                           buckets=(4,), raw_inputs=False, **kw)
    assert (port.mean, port.std) == (tuple(jax_engine.mean), tuple(jax_engine.std))
    frames = prepared_frames(seed=12)
    got = port.predict(frames)
    np.testing.assert_allclose(got, jax_engine.predict(frames), atol=1e-5, rtol=0)
    if case == "mean/std override":
        default = InferenceEngine(config, variables=variables, device="cpu",
                                  buckets=(4,), raw_inputs=False).predict(frames)
        assert np.abs(got - default).max() > 1e-4


@pytest.mark.unit
def test_engine_refusals():
    """JAX's errors for an unknown quantize mode; a mesh that is not a
    device mesh raises a TypeError naming the mesh (serving on a device
    mesh runs in tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="quantize must be None or 'int8'"):
        InferenceEngine(NARROW_RESNET, device="cpu", quantize="fp4")
    with pytest.raises(TypeError, match="mesh"):
        InferenceEngine(NARROW_RESNET, device="cpu", mesh=object())
