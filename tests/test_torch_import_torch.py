"""The port's warm-start importer (thyroid_tpu_torch/models/import_torch.py)
against the JAX package's (thyroid_tpu/models/import_torch.py) on the same
seeded state_dicts: the timm- and torchvision-named torch modules of
tests/unit/test_import_torch*.py and tests/unit/test_import_named.py, their
tensors moved off their init by a seeded draw. Nothing is downloaded.

Every importer's tree equals JAX's leaf for leaf, but the interpolated
pos-embed: the port resizes it with cv2's INTER_CUBIC rules written out in
numpy, which stays within POS_EMBED_RTOL of max|grid| of cv2 (float32
sums in another order; cv2 5.0 itself raises past 128 channels, so the
real widths are held against cv2 applied in chunks of 128 channels). The
forward cases hold a port model warm-started from a file against JAX's
create_and_init warm-started from the same file, within the golden tests'
tolerances; JAX's init is replaced by the port's seeded tree (flax's
unjitted init is slow on a CPU, and the by-order import needs its
creation order, which jit loses), so the leaves the file does not cover
are the same on both sides.
"""
import collections
import copy
import functools
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import thyroid_tpu.models.base as jax_base
from tests.torch_parity import flat_tree, one_torch_thread  # noqa: F401
from tests.unit.test_import_named import C4InceptionV4
from tests.unit.test_import_torch import TimmViT, TorchResNet18
from tests.unit.test_import_torch_families import (TimmEffNet, TimmSwin,
                                                   TorchDenseNet, TvInceptionV3)
from thyroid_tpu.models import import_torch as ref
from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry
from thyroid_tpu_torch.models import import_torch as port
from thyroid_tpu_torch.models.base import create_and_init
from thyroid_tpu_torch.models.from_jax import to_jax_variables
from thyroid_tpu_torch.models.registry import ModelRegistry

# the port's pos-embed resize against cv2's INTER_CUBIC, relative to
# max|grid|: a few float32 roundings (the two sum in other orders)
POS_EMBED_RTOL = 1e-6
# the golden logit tests' tolerances (tests/test_torch_{resnet,vit}.py)
GOLDEN_ATOL, GOLDEN_RTOL = 2e-3, 1e-3


def perturbed(sd, seed: int):
    """Every float tensor of `sd` moved by 0.1 of its own spread (0.1 where
    it is constant: norm scales, biases, running statistics) from a seeded
    draw; running variances stay positive."""
    gen = torch.Generator().manual_seed(seed)
    out = collections.OrderedDict()
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = v
            continue
        spread = float(v.std()) if v.numel() > 1 else 0.0
        noise = torch.randn(v.shape, generator=gen) * (spread or 1.0) * 0.1
        out[k] = (v + noise).abs() if k.endswith("running_var") else v + noise
    return out


def with_dist(vit: torch.nn.Module):
    """A timm DeiT's state_dict from a timm ViT: a distillation token after
    the class token (pos-embed one token longer) and a second head."""
    sd = collections.OrderedDict()
    for k, v in vit.state_dict().items():
        if k == "pos_embed":
            v = torch.cat([v[:, :1], 0.02 * torch.randn(1, 1, v.shape[-1]),
                           v[:, 1:]], dim=1)
        sd[k] = v
        if k == "cls_token":
            sd["dist_token"] = 0.02 * torch.randn_like(v)
    sd["head_dist.weight"] = 0.02 * torch.randn_like(sd["head.weight"])
    sd["head_dist.bias"] = torch.zeros_like(sd["head.bias"])
    return sd


def reference_native(sd):
    """A Swin state_dict in the reference's own naming (bare-conv
    patch_embed, patch_norm_layer, Sequential MLP mlp.0 / mlp.3) with its
    medical extras: per-block contrast scales and quality gates, the
    merges' quality weights, the uncertainty head and the dead
    cls_token / pos_embed."""
    gen = torch.Generator().manual_seed(7)
    out = collections.OrderedDict(
        cls_token=torch.randn(1, 1, 16, generator=gen),
        pos_embed=torch.randn(1, 65, 16, generator=gen))
    for k, v in sd.items():
        parts = k.split(".")
        if k.startswith("patch_embed.proj."):
            k = "patch_embed." + parts[-1]
        elif k.startswith("patch_embed.norm."):
            k = "patch_norm_layer." + parts[-1]
        k = k.replace(".mlp.fc1.", ".mlp.0.").replace(".mlp.fc2.", ".mlp.3.")
        out[k] = v
        if k.endswith("attn.relative_position_bias_table"):
            attn = k.rsplit(".", 1)[0]
            out[f"{attn}.contrast_scale"] = 1 + 0.5 * torch.randn(
                v.shape[1], generator=gen)
            out[f"{attn}.quality_gate.0.weight"] = torch.randn(4, 16, generator=gen)
        if k.endswith("downsample.norm.bias"):
            out[k.replace("norm.bias", "quality_weight.0.weight")] = \
                torch.randn(4, 4, generator=gen)
    out["uncertainty_head.0.weight"] = torch.randn(16, 32, generator=gen)
    out["uncertainty_head.0.bias"] = torch.randn(16, generator=gen)
    out["uncertainty_head.3.weight"] = torch.randn(1, 16, generator=gen)
    out["uncertainty_head.3.bias"] = torch.randn(1, generator=gen)
    return out


def _timm_vit():
    torch.manual_seed(11)
    return TimmViT(img=64, patch=16, dim=32, depth=2, heads=2, classes=1000)


MIMICS = {
    "resnet": lambda: TorchResNet18(num_classes=1000),
    "swin": lambda: TimmSwin(classes=1000),
    "vit": _timm_vit,
    "densenet": lambda: TorchDenseNet(classes=1000),
    "efficientnet": lambda: TimmEffNet(classes=1000),
    "inception_v3": lambda: TvInceptionV3(classes=1000),
    "inception_v4": lambda: C4InceptionV4(classes=1000),
}


@functools.lru_cache(maxsize=None)
def state_dict(family: str):
    """The seeded, perturbed state_dict of `family`'s torch module (1000
    classes, 3 input channels)."""
    torch.manual_seed(len(family))
    if family == "swin_reference":
        return reference_native(state_dict("swin"))
    if family == "deit":
        torch.manual_seed(12)
        return perturbed(with_dist(_timm_vit()), 12)
    return perturbed(MIMICS[family]().state_dict(), len(family))


def assert_same_tree(got, want):
    got, want = flat_tree(got), flat_tree(want)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


# family, importer, its arguments
IMPORTERS = [
    (family, name, kw)
    for family, name in (("resnet", "import_resnet"), ("swin", "import_swin"),
                         ("swin_reference", "import_swin_reference"),
                         ("vit", "import_vit"), ("densenet", "import_densenet"),
                         ("efficientnet", "import_efficientnet"),
                         ("inception_v3", "import_inception_v3"),
                         ("inception_v4", "import_inception_v4"))
    for kw in ({"in_channels": 1, "num_classes": 2},
               {"in_channels": 3, "num_classes": 1000})
] + [("vit", "import_vit", {"in_channels": 1, "num_classes": 1000,
                            "target_tokens": 17}),
     ("deit", "import_vit", {"in_channels": 1, "num_classes": 2,
                             "distillation": True}),
     ("deit", "import_vit", {"in_channels": 3, "num_classes": 1000,
                             "target_tokens": 18, "distillation": True})]


@pytest.mark.unit
@pytest.mark.parametrize("family,name,kw", IMPORTERS,
                         ids=[f"{f}-{n}-{'-'.join(map(str, k.values()))}"
                              for f, n, k in IMPORTERS])
def test_importer_tree_equals_jax(family, name, kw):
    """Each name-based importer: the port's tree equals JAX's, key order,
    dtypes and values, gray-averaged or not, head imported or skipped."""
    sd = state_dict(family)
    want = getattr(ref, name)(sd, **kw)
    assert_same_tree(getattr(port, name)(sd, **kw), want)
    if kw["num_classes"] == 2:
        assert all(h not in want["params"]
                   for h in ("fc", "head", "head_dist", "classifier"))


@pytest.mark.unit
def test_deit_pos_embed_resized_like_jax():
    """import_vit of a 16-patch DeiT into a 36-patch model: every leaf but
    the pos-embed equal to JAX's, the two prefix tokens equal, the grid
    within POS_EMBED_RTOL of JAX's cv2 resize."""
    sd = state_dict("deit")
    kw = dict(in_channels=1, num_classes=2, target_tokens=38, distillation=True)
    got, want = port.import_vit(sd, **kw), ref.import_vit(sd, **kw)
    pe, pe_want = got["params"].pop("pos_embed"), want["params"].pop("pos_embed")
    assert_same_tree(got, want)
    assert pe.shape == pe_want.shape == (1, 38, 32) and pe.dtype == np.float32
    assert np.array_equal(pe[:, :2], pe_want[:, :2])
    np.testing.assert_allclose(pe[:, 2:], pe_want[:, 2:], rtol=0,
                               atol=POS_EMBED_RTOL * np.abs(pe_want).max())


def cv2_chunked(grid: np.ndarray, side: int) -> np.ndarray:
    """cv2's INTER_CUBIC over at most 128 channels at a time (cv2 5.0
    raises past 128); cv2 resizes each channel on its own."""
    import cv2

    parts = [cv2.resize(np.ascontiguousarray(grid[..., i:i + 128]), (side, side),
                        interpolation=cv2.INTER_CUBIC).reshape(side, side, -1)
             for i in range(0, grid.shape[-1], 128)]
    return np.concatenate(parts, axis=-1)


@pytest.mark.unit
@pytest.mark.parametrize("dim,prefix,side_old,side_new",
                         [(64, 1, 14, 16), (64, 2, 14, 5), (192, 1, 14, 16),
                          (384, 2, 14, 16), (384, 1, 24, 14)])
def test_interpolate_pos_embed(dim, prefix, side_old, side_new):
    """interpolate_pos_embed against JAX's at D = 64 (its cv2 call works
    there) and against cv2 in chunks at ViT-S and DeiT-S widths and ViT-Ti's
    192, where JAX's own call raises; growing and shrinking grids."""
    rs = np.random.RandomState(dim + side_new)
    pe = (0.02 * rs.randn(1, prefix + side_old ** 2, dim)).astype(np.float32)
    target = prefix + side_new ** 2
    got = port.interpolate_pos_embed(pe, target, prefix)
    if dim <= 128:
        want = ref.interpolate_pos_embed(pe, target, prefix)
    else:
        grid = cv2_chunked(pe[0, prefix:].reshape(side_old, side_old, dim), side_new)
        want = np.concatenate([pe[:, :prefix], grid.reshape(1, -1, dim)], axis=1)
    assert got.shape == want.shape == (1, target, dim) and got.dtype == want.dtype
    assert np.array_equal(got[:, :prefix], pe[:, :prefix])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=POS_EMBED_RTOL * np.abs(pe).max())
    assert np.array_equal(port.interpolate_pos_embed(pe, pe.shape[1], prefix), pe)
    with pytest.raises(ValueError, match="not square"):
        port.interpolate_pos_embed(pe[:, :-1], target, prefix)


# ------------------------------------------------------ order-based import

@functools.lru_cache(maxsize=None)
def jax_order(cfg_items):
    """(the JAX model's variables as nested {key: shape} in flax's creation
    order, JAX's _flax_slots over them), traced by jax.eval_shape (the
    slots are taken inside the trace: jit's output sorts dict keys)."""
    cfg = dict(cfg_items)
    model = JaxRegistry.create_model(cfg)
    seen = {}

    def shapes(tree):
        return {k: shapes(v) if hasattr(v, "items") else tuple(v.shape)
                for k, v in tree.items()}

    def init():
        v = unfreeze(model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, cfg["img_size"], cfg["img_size"], cfg["in_channels"])),
            train=False))
        seen["tree"] = shapes(v)
        seen["slots"] = ref._flax_slots(v["params"], v.get("batch_stats"))
        return v

    jax.eval_shape(init)
    return seen["tree"], seen["slots"]


def in_order(order, values):
    """`values` (a nested tree) rebuilt in the key order of `order`."""
    return {k: in_order(o, values[k]) if isinstance(o, dict) else values[k]
            for k, o in order.items()}


def _key(cfg):
    return tuple(sorted(cfg.items()))


# family → the narrow (or full-width, small-side) config its mimic fits
FORWARD = {
    "resnet": {"name": "resnet18", "img_size": 32},
    "swin": {"name": "swin_tiny", "img_size": 32, "embed_dim": 16,
             "depths": (2, 2), "num_heads": (2, 2), "window_size": 4,
             "drop_path_rate": 0.0},
    "vit": {"name": "vit_tiny", "img_size": 64, "patch_size": 16,
            "embed_dim": 32, "depth": 2, "num_heads": 2,
            "drop_path_rate": 0.0, "token_kernels": False},
    "densenet": {"name": "densenet121", "img_size": 32, "growth_rate": 8,
                 "block_config": (2, 2), "num_init_features": 16},
    "efficientnet": {"name": "efficientnet_b0", "img_size": 32,
                     "drop_path_rate": 0.0},
    "inception_v3": {"name": "inception_v3", "img_size": 75},
    "inception_v4": {"name": "inception_v4", "img_size": 75},
}
FORWARD["swin_reference"] = FORWARD["swin"]
FORWARD["deit"] = dict(FORWARD["vit"], name="deit_tiny", img_size=96)
BY_ORDER = ("densenet", "efficientnet", "inception_v3", "inception_v4")


def forward_config(family: str, **over):
    return dict(FORWARD[family], in_channels=1, num_classes=2, dtype="f32",
                dropout_rate=0.0, **over)


@functools.lru_cache(maxsize=None)
def seeded_tree(family: str):
    """The port's seeded variables of the family's forward config: the
    tree and its order as flax creates them (test_slot_order_equals_jax)."""
    return to_jax_variables(create_and_init(forward_config(family), device="cpu"))


# the forward configs of every CNN family (their traces are shared with the
# by-order cases) and two registry models at full width
SLOT_MODELS = {family: forward_config(family) for family in ("resnet",) + BY_ORDER}
SLOT_MODELS.update({
    "resnet50": forward_config("resnet", name="resnet50"),
    "efficientnet_b0-dw_pallas_conv": forward_config("efficientnet",
                                                     dw_pallas_conv=True)})


@pytest.mark.unit
@pytest.mark.parametrize("model", list(SLOT_MODELS))
def test_slot_order_equals_jax(model):
    """The typed slots of the port's tree (to_jax_variables, in
    named_parameters() order) equal JAX's over flax's creation-ordered
    tree: kinds, paths and biases, in order."""
    cfg = SLOT_MODELS[model]
    _, want = jax_order(_key(cfg))
    v = to_jax_variables(ModelRegistry.create_model(cfg))
    assert port._flax_slots(v["params"], v.get("batch_stats")) == want
    assert len(want) > 20


@pytest.mark.unit
@pytest.mark.parametrize("family", BY_ORDER)
def test_by_order_import_equals_jax(family):
    """import_cnn_by_order (the fallback for rewritten checkpoints): the
    port over its own tree against JAX's over the same values in flax's
    creation order, on a state_dict renamed so that no name-based map
    applies; then import_for_model's dispatch to it."""
    cfg = forward_config(family)
    order, _ = jax_order(_key(cfg))
    mine = seeded_tree(family)
    theirs = in_order(order, mine)
    sd = collections.OrderedDict(
        (f"m.{i}.{k.rsplit('.', 1)[-1]}", v)
        for i, (k, v) in enumerate(state_dict(family).items()))
    try:
        want = ref.import_cnn_by_order(sd, theirs, 1, 2)
    except ValueError as e:       # JAX's fallback refuses this mimic's order
        with pytest.raises(ValueError, match=re.escape(str(e))):
            port.import_cnn_by_order(sd, mine, 1, 2)
        return
    got = port.import_cnn_by_order(sd, mine, 1, 2)
    g, w = flat_tree(got), flat_tree(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert_same_tree(port.import_for_model(cfg["name"], sd, mine, 1, 2), got)


# ------------------------------------------------- merge, load, dispatch

@pytest.mark.unit
def test_merge_imported_like_jax():
    """merge_imported: the imported leaves over the seeded tree, the
    skipped head kept, equal to JAX's merge; JAX's ValueError on a shape
    mismatch; a leaf the fresh tree lacks kept as JAX keeps it."""
    seeded = seeded_tree("resnet")
    imported = port.import_resnet(state_dict("resnet"), 1, 2)
    got = port.merge_imported(seeded, imported)
    assert_same_tree(got, ref.merge_imported(seeded, imported))
    assert np.array_equal(got["params"]["fc"]["kernel"],
                          seeded["params"]["fc"]["kernel"])
    assert np.array_equal(got["params"]["conv1"]["kernel"],
                          imported["params"]["conv1"]["kernel"])
    bad = {"params": {"fc": {"bias": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError) as want:
        ref.merge_imported(seeded, bad)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        port.merge_imported(seeded, bad)
    extra = {"params": {"fc": {"extra": np.ones(2, np.float32)},
                        "head2": {"kernel": np.ones((2, 2), np.float32)}}}
    got = port.merge_imported(seeded, extra)
    want = ref.merge_imported(seeded, extra)
    assert np.array_equal(got["params"]["fc"]["extra"], want["params"]["fc"]["extra"])
    assert got["params"]["head2"].dtype == want["params"]["head2"].dtype == object
    kept, dropped = port._fitted(got, seeded)
    assert dropped == ["params/fc/extra", "params/head2"]
    assert_same_tree(kept, seeded)


@pytest.mark.unit
def test_load_torch_checkpoint_unwraps_envelopes(tmp_path):
    """A Lightning envelope with model.model. and model. prefixes, and a
    bare state_dict: the same keys and tensors as JAX's loader."""
    rs = torch.Generator().manual_seed(3)
    t = [torch.randn(2, 3, generator=rs) for _ in range(3)]
    blob = {"state_dict": collections.OrderedDict(
        [("model.model.conv.weight", t[0]), ("model.fc.bias", t[1]),
         ("head.weight", t[2])]), "epoch": 4, "hparams": {"lr": 1e-3}}
    for i, what in enumerate((blob, blob["state_dict"])):
        path = tmp_path / f"c{i}.ckpt"
        torch.save(what, path)
        got, want = port.load_torch_checkpoint(str(path)), ref.load_torch_checkpoint(str(path))
        assert list(got) == list(want) == ["conv.weight", "fc.bias", "head.weight"]
        for k in want:
            assert got[k].equal(want[k]), k


@pytest.mark.unit
def test_import_for_model_unknown_family():
    with pytest.raises(ValueError) as want:
        ref.import_for_model("mobilenet_v2", {}, {})
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        port.import_for_model("mobilenet_v2", {}, {})


# ------------------------------------------------------- warm-started forward

def arrays_only(tree):
    """`tree` without its object leaves: JAX's merge_imported turns a
    subtree the fresh tree lacks (a reference-native Swin's uncertainty head
    on a model without one) into a 0-d object array, which flax's eager
    apply ignores like any extra leaf but jit cannot take. The extra array
    leaves (its contrast scales) stay in."""
    return {k: arrays_only(v) if hasattr(v, "items") else v
            for k, v in tree.items()
            if hasattr(v, "items") or np.asarray(v).dtype != object}



@pytest.mark.unit
@pytest.mark.parametrize("family", list(FORWARD))
def test_warm_started_forward_matches_jax(family, tmp_path, monkeypatch, caplog):
    """A port model warm-started from a file (in a Lightning envelope with
    the reference's prefixes) against JAX's create_and_init warm-started
    from the same file: every leaf equal (the interpolated pos-embed within
    POS_EMBED_RTOL), the leaves JAX keeps and the port's model has no place
    for (a reference-native Swin's extras on a plain Swin) dropped with a
    debug line naming them, and the logits within the golden tolerances."""
    path = tmp_path / f"{FORWARD[family]['name']}.ckpt"
    torch.save({"state_dict": {f"model.{k}": v
                               for k, v in state_dict(family).items()}}, path)
    cfg = forward_config(family, pretrained_path=str(path))
    seeded = seeded_tree(family)
    monkeypatch.setattr(jax_base, "init_model",
                        lambda *a, **k: copy.deepcopy(seeded))
    jm, jv = jax_base.create_and_init(cfg, jax.random.PRNGKey(0))
    with caplog.at_level(logging.DEBUG, logger=port.__name__):
        model = create_and_init(cfg, device="cpu")
    got, want = flat_tree(to_jax_variables(model)), flat_tree(jv)
    dropped = sorted(set(want) - set(got))
    assert set(got) <= set(want)
    if family == "swin_reference":
        assert "params.uncertainty_1" in dropped and any(
            k.endswith("attn.contrast_scale") for k in dropped)
        line = [r.getMessage() for r in caplog.records if "dropped" in r.getMessage()]
        assert len(line) == 1 and "uncertainty_1" in line[0]
    else:
        assert not dropped
    for k, w in got.items():
        if k == "params.pos_embed" and family == "deit":
            np.testing.assert_allclose(w, want[k], rtol=0,
                                       atol=POS_EMBED_RTOL * np.abs(want[k]).max())
        else:
            assert np.array_equal(w, want[k]), k
    pe = seeded["params"].get("pos_embed")
    from_file = set(got) & set(flat_tree(port.import_for_model(
        cfg["name"], port.load_torch_checkpoint(str(path)), seeded, 1, 2,
        None if pe is None else pe.shape[1])))
    init = flat_tree(seeded)
    assert from_file and not any(np.array_equal(got[k], init[k]) for k in from_file)
    assert all(np.array_equal(got[k], init[k]) for k in set(got) - from_file)
    side = cfg["img_size"]
    x = np.random.RandomState(5).rand(2, side, side, 1).astype(np.float32)
    logits = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        arrays_only(jv), jnp.asarray(x)))
    with torch.no_grad():
        mine = model(torch.from_numpy(x)).numpy()
    assert np.isfinite(logits).all() and np.ptp(logits) > 0
    np.testing.assert_allclose(mine, logits, atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL)
