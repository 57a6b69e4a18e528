"""`pretrained` / `pretrained_path` in the port: the JAX package's search
for a local torch checkpoint (find_pretrained_file, held against JAX's),
a NotImplementedError when it finds one (the importers are not ported),
and JAX's warning and seeded weights when it finds none, through
create_and_init, InferenceEngine and Trainer."""
import logging

import pytest

from tests.torch_parity import SMALL_SWIN, one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import to_jax_params
from thyroid_tpu_torch.models.import_torch import find_pretrained_file
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.serving.engine import InferenceEngine
from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
from thyroid_tpu_torch.training.engine import Trainer

PRETRAINED = dict(SMALL_SWIN, pretrained=True)


@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    """$THYROID_PRETRAINED_DIR holding an empty swin_tiny.pth; the working
    directory an empty one (no ./weights)."""
    d = tmp_path / "pretrained"
    d.mkdir()
    (d / "swin_tiny.pth").write_bytes(b"")
    monkeypatch.setenv("THYROID_PRETRAINED_DIR", str(d))
    monkeypatch.chdir(tmp_path)
    return d


@pytest.mark.unit
def test_find_pretrained_file_matches_jax(weights_dir, tmp_path):
    from thyroid_tpu.models.import_torch import find_pretrained_file as jax_find

    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / "swin_small.ckpt").write_bytes(b"")
    for args in (("swin_tiny",), ("swin_small",), ("swin_base",),
                 ("swin_tiny", str(weights_dir / "swin_tiny.pth")),
                 ("swin_tiny", str(tmp_path / "missing.pth"))):
        assert find_pretrained_file(*args) == jax_find(*args), args
    assert find_pretrained_file("swin_tiny") == str(weights_dir / "swin_tiny.pth")


@pytest.mark.unit
def test_found_checkpoint_raises(weights_dir, tmp_path):
    """A file found → NotImplementedError naming the ROADMAP item and the
    file, from create_and_init, InferenceEngine and Trainer alike; weights
    carried in take its place, as in the JAX engine."""
    found = str(weights_dir / "swin_tiny.pth")
    for build in (lambda: create_and_init(PRETRAINED, device="cpu"),
                  lambda: InferenceEngine(PRETRAINED, device="cpu"),
                  lambda: Trainer(ModelRegistry.create_model(PRETRAINED),
                                  PRETRAINED, TRAINING_VIT, TRAINER_DEFAULT,
                                  output_dir=tmp_path / "run", device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="Warm start from local torch checkpoints") as err:
            build()
        assert found in str(err.value)
    with pytest.raises(NotImplementedError, match="missing.pth|swin_tiny.pth"):
        create_and_init(dict(SMALL_SWIN, pretrained_path=found), device="cpu")
    params = to_jax_params(create_and_init(SMALL_SWIN, device="cpu"))
    InferenceEngine(PRETRAINED, params=params, device="cpu")
    Trainer(ModelRegistry.create_model(PRETRAINED), PRETRAINED, TRAINING_VIT,
            TRAINER_DEFAULT, output_dir=tmp_path / "run", params=params,
            device="cpu")


@pytest.mark.unit
def test_missing_checkpoint_warns_and_goes_on(weights_dir, tmp_path, caplog):
    """No file found → JAX's warning, and the seeded weights, which equal
    the same config's without `pretrained`."""
    cfg = dict(PRETRAINED, name="swin_small", depths=(2, 2))
    with caplog.at_level(logging.WARNING):
        model = create_and_init(cfg, device="cpu")
        Trainer(ModelRegistry.create_model(cfg), cfg, TRAINING_VIT,
                TRAINER_DEFAULT, output_dir=tmp_path / "run", device="cpu")
    warned = [r for r in caplog.records if "no local checkpoint" in r.getMessage()]
    assert len(warned) == 2 and "swin_small" in warned[0].getMessage()
    plain = create_and_init(dict(cfg, pretrained=False), device="cpu")
    for (n, p), q in zip(model.named_parameters(), plain.parameters()):
        assert p.equal(q), n
    missing = dict(SMALL_SWIN, pretrained_path=str(tmp_path / "missing.pth"))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        create_and_init(missing, device="cpu")
    assert any("no local checkpoint" in r.getMessage() for r in caplog.records)
