"""`pretrained` / `pretrained_path` in the port: the JAX package's search
for a local torch checkpoint (find_pretrained_file, held against JAX's),
a warm start from the file it finds, and JAX's warning and seeded weights
when it finds none, through create_and_init, InferenceEngine and Trainer;
weights carried in win over the file. The importers themselves are held
against JAX's in tests/test_torch_import_torch.py."""
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import SMALL_SWIN, flat_tree, one_torch_thread  # noqa: F401
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import to_jax_params, to_jax_variables
from thyroid_tpu_torch.models.import_torch import (find_pretrained_file,
                                                   import_swin, merge_imported)
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


@pytest.fixture
def timm_file(tmp_path_factory):
    """(state_dict, path) of a seeded timm-named Swin checkpoint of
    SMALL_SWIN's widths with ImageNet's shape: 3 input channels, 1000
    classes."""
    from tests.unit.test_import_torch_families import TimmSwin

    gen = torch.Generator().manual_seed(23)
    torch.manual_seed(23)
    sd = TimmSwin(img=64, dim=32, depths=(2, 2), heads=(1, 2), ws=4,
                  classes=1000, in_ch=3).state_dict()
    # norms off their unit scales and zero biases, so that no leaf of the
    # file equals the seeded init by chance
    sd = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
          if v.is_floating_point() else v for k, v in sd.items()}
    path = tmp_path_factory.mktemp("timm") / "swin_tiny.pth"
    torch.save(sd, path)
    return sd, str(path)


def _entry_points(cfg, tmp_path):
    """{entry point: a function making the model it warm-starts}."""
    def trainer():
        return Trainer(ModelRegistry.create_model(cfg), cfg,
                       dict(TRAINING_VIT, ema_decay=0.999), TRAINER_DEFAULT,
                       output_dir=tmp_path / "run", device="cpu")

    return {"create_and_init": lambda: create_and_init(cfg, device="cpu"),
            "InferenceEngine": lambda: InferenceEngine(cfg, device="cpu").model,
            "Trainer": trainer}


@pytest.mark.unit
@pytest.mark.parametrize("entry", ("create_and_init", "InferenceEngine", "Trainer"))
@pytest.mark.parametrize("source", ("THYROID_PRETRAINED_DIR", "pretrained_path"))
def test_entry_points_warm_start(entry, source, timm_file, tmp_path, monkeypatch,
                                 caplog):
    """create_and_init, InferenceEngine and Trainer each warm-start from a
    file found in $THYROID_PRETRAINED_DIR or named by pretrained_path: the
    model's tree is the seeded init merged with import_swin's tree of the
    file (gray-averaged patch embedding, 1000-class head skipped), and the
    Trainer builds its EMA shadow from the warm-started weights."""
    sd, path = timm_file
    monkeypatch.chdir(tmp_path)
    if source == "pretrained_path":
        monkeypatch.delenv("THYROID_PRETRAINED_DIR", raising=False)
        cfg = dict(SMALL_SWIN, pretrained_path=path)
    else:
        monkeypatch.setenv("THYROID_PRETRAINED_DIR", str(Path(path).parent))
        cfg = PRETRAINED
    with caplog.at_level(logging.INFO):
        built = _entry_points(cfg, tmp_path)[entry]()
    assert any(f"warm-started swin_tiny from {path}" in r.getMessage()
               for r in caplog.records)
    model = built.model if entry == "Trainer" else built
    seed = built.cfg.seed if entry == "Trainer" else 0
    seeded = to_jax_variables(create_and_init(SMALL_SWIN, seed=seed, device="cpu"))
    want = flat_tree(merge_imported(seeded, import_swin(sd, 1, 2)))
    got = flat_tree(to_jax_variables(model))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    if entry == "Trainer":
        for n, p in model.named_parameters():
            assert built.state.ema_params[n].equal(p), n


@pytest.mark.unit
def test_imported_leaves_equal_file_and_seeded_untouched(timm_file, tmp_path):
    """Each imported leaf equals the file's tensor after its conversion
    (patch embedding OIHW → HWIO averaged over RGB, linears transposed,
    tables and norms as they are); every leaf the file does not cover (the
    2-class head) keeps the seeded init bit for bit."""
    sd, path = timm_file
    cfg = dict(SMALL_SWIN, pretrained_path=path)
    got = flat_tree(to_jax_variables(create_and_init(cfg, device="cpu", seed=3)))
    seeded = flat_tree(to_jax_variables(create_and_init(SMALL_SWIN, device="cpu",
                                                        seed=3)))
    sdn = {k: v.numpy() for k, v in sd.items()}
    pe = sdn["patch_embed.proj.weight"].transpose(2, 3, 1, 0)
    assert np.array_equal(got["params.patch_embed.kernel"],
                          pe.mean(axis=2, keepdims=True))
    file_leaves = {"params.patch_embed.bias": sdn["patch_embed.proj.bias"],
                   "params.patch_norm.scale": sdn["patch_embed.norm.weight"],
                   "params.norm.bias": sdn["norm.bias"]}
    for i, depth in enumerate((2, 2)):
        for j in range(depth):
            src, dst = f"layers.{i}.blocks.{j}", f"params.stage_{i}.block_{j}"
            file_leaves.update({
                f"{dst}.attn.qkv.kernel": sdn[f"{src}.attn.qkv.weight"].T,
                f"{dst}.attn.proj.bias": sdn[f"{src}.attn.proj.bias"],
                f"{dst}.attn.relative_position_bias_table":
                    sdn[f"{src}.attn.relative_position_bias_table"],
                f"{dst}.mlp.Dense_0.kernel": sdn[f"{src}.mlp.fc1.weight"].T,
                f"{dst}.mlp.Dense_1.kernel": sdn[f"{src}.mlp.fc2.weight"].T,
                f"{dst}.norm2.scale": sdn[f"{src}.norm2.weight"]})
    file_leaves["params.stage_0.downsample.reduction.kernel"] = \
        sdn["layers.0.downsample.reduction.weight"].T
    for k, v in file_leaves.items():
        assert np.array_equal(got[k], v), k
        assert not np.array_equal(seeded[k], v), k
    imported = {f"params.{k}" for k in flat_tree(import_swin(sd, 1, 2)["params"])}
    assert set(file_leaves) < imported
    untouched = set(got) - imported
    assert untouched == {"params.head.kernel", "params.head.bias"}
    for k in untouched:
        assert np.array_equal(got[k], seeded[k]), k


@pytest.mark.unit
def test_carried_in_weights_win_over_file(timm_file, tmp_path, monkeypatch):
    """Weights carried in take the file's place, as in the JAX engine:
    InferenceEngine(params=…), Trainer(params=…) and
    create_and_init(pretrained=False) never read the file."""
    sd, path = timm_file
    monkeypatch.setenv("THYROID_PRETRAINED_DIR", str(Path(path).parent))
    monkeypatch.chdir(tmp_path)
    params = to_jax_params(create_and_init(SMALL_SWIN, device="cpu", seed=5))
    want = flat_tree(params)
    models = {
        "InferenceEngine": InferenceEngine(PRETRAINED, params=params,
                                           device="cpu").model,
        "Trainer": Trainer(ModelRegistry.create_model(PRETRAINED), PRETRAINED,
                           TRAINING_VIT, TRAINER_DEFAULT,
                           output_dir=tmp_path / "run", params=params,
                           device="cpu").model}
    for what, model in models.items():
        got = flat_tree(to_jax_params(model))
        for k in want:
            assert np.array_equal(got[k], want[k]), (what, k)
    plain = flat_tree(to_jax_params(create_and_init(PRETRAINED, device="cpu",
                                                    pretrained=False)))
    seeded = flat_tree(to_jax_params(create_and_init(SMALL_SWIN, device="cpu")))
    for k in seeded:
        assert np.array_equal(plain[k], seeded[k]), k


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
