"""Port serving engine (thyroid_tpu_torch.serving) against the JAX engine on
the same weights and raw frames, on the CPU."""
import numpy as np
import pytest
import torch

from tests.torch_parity import SMALL_SWIN, jax_swin
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
