"""Port corpus splits and synthetic corpus (thyroid_tpu_torch.data.stratify,
.corpus, .synthetic) against scikit-learn and the JAX package, on the CPU.

Indices must be equal exactly: data/stratify.py makes scikit-learn's draws
on the same np.random.RandomState stream. The committed split files are
fixed points. Corpus pixels are compared exactly (the port's PNG writer
against cv2's)."""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import StratifiedKFold
from sklearn.model_selection import train_test_split as sk_train_test_split

from thyroid_tpu.data import corpus as jcorpus
from thyroid_tpu.data import synthetic as jsynthetic
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.data import corpus, stratify, synthetic
from thyroid_tpu_torch.data.imageio import decode_image

ROOT = Path(__file__).resolve().parents[1]


@st.composite
def label_vectors(draw):
    """2-3 classes, 8-500 labels, unbalanced, a seed 0-1000."""
    n = draw(st.integers(8, 500))
    n_classes = draw(st.integers(2, 3))
    weights = draw(st.lists(st.floats(0.05, 1.0), min_size=n_classes,
                            max_size=n_classes))
    seed = draw(st.integers(0, 1000))
    p = np.asarray(weights) / np.sum(weights)
    labels = np.random.RandomState(seed).choice(n_classes, n, p=p)
    return labels, seed


def _outcome(fn):
    """(result, None) or (None, the ValueError's type)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(), None
    except ValueError as e:
        return None, type(e)


@pytest.mark.unit
@settings(max_examples=60, deadline=None)
@given(label_vectors(), st.integers(2, 7))
def test_stratified_kfold_matches_sklearn(case, k):
    labels, seed = case
    want, werr = _outcome(lambda: [t for _, t in StratifiedKFold(
        k, shuffle=True, random_state=seed).split(np.arange(len(labels)), labels)])
    got, gerr = _outcome(lambda: stratify.stratified_kfold_test_folds(labels, k, seed))
    assert werr == gerr
    if want is not None:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.unit
@settings(max_examples=60, deadline=None)
@given(label_vectors(), st.floats(0.02, 0.6), st.booleans())
def test_train_test_split_matches_sklearn(case, test_size, stratified):
    labels, seed = case
    idx = np.arange(len(labels)) * 3
    strat = labels if stratified else None
    want, werr = _outcome(lambda: sk_train_test_split(
        idx, test_size=test_size, random_state=seed, stratify=strat))
    got, gerr = _outcome(lambda: stratify.train_test_split(
        idx, test_size=test_size, random_state=seed, stratify=strat))
    assert werr == gerr
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.unit
@pytest.mark.parametrize("labels,kwargs", [
    ([0, 0, 0, 1], {"test_size": 0.5}),          # a class of 1 member
    ([0, 1] * 4, {"test_size": 0.1}),            # fewer test rows than classes
    ([0, 1] * 4, {"test_size": 1.5}),
    ([0, 1] * 4, {"test_size": 8}),
    ([0, 1] * 4, {"test_size": 0.5, "train_size": 0.7}),
], ids=["singleton", "small-test", "fraction", "count", "sum"])
def test_split_errors_match_sklearn(labels, kwargs):
    labels = np.asarray(labels)
    with pytest.raises(ValueError):
        sk_train_test_split(np.arange(len(labels)), stratify=labels,
                            random_state=0, **kwargs)
    with pytest.raises(ValueError):
        stratify.train_test_split(np.arange(len(labels)), stratify=labels,
                                  random_state=0, **kwargs)


@pytest.mark.unit
@pytest.mark.parametrize("labels,k", [([0, 1] * 4, 1), ([0] * 3 + [1] * 3, 7),
                                      ([0.5, 1.5] * 4, 2), ([0, 1] * 4, 2.0)],
                         ids=["k1", "k-above-n", "continuous", "float-k"])
def test_kfold_errors_match_sklearn(labels, k):
    with pytest.raises(ValueError):
        list(StratifiedKFold(k, shuffle=True, random_state=0).split(
            np.zeros(len(labels)), labels))
    with pytest.raises(ValueError):
        stratify.stratified_kfold_test_folds(labels, k, 0)


@pytest.mark.unit
@pytest.mark.parametrize("labels,ratios,seed", [
    ([0] * 225 + [1] * 225, (0.15, 0.15), 42),
    ([0] * 30 + [1] * 11 + [2] * 7, (0.2, 0.25), 3),
    ([1] * 20, (0.15, 0.15), 5),
    ([], (0.15, 0.15), 0),
    ([0, 1] * 10, (0.0, 1.0), 9),
], ids=["corpus", "three-class", "one-class", "empty", "default-ratios"])
def test_generate_splits_matches_jax(labels, ratios, seed):
    labels = np.asarray(labels, dtype=np.int32)
    got = corpus.generate_splits(labels, *ratios, random_seed=seed)
    want = jcorpus.generate_splits(labels, *ratios, random_seed=seed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.unit
@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("stratified", [True, False])
def test_rotating_fold_indices_match_jax(k, stratified):
    """k = 2 leaves no training fold: both raise."""
    labels = np.random.RandomState(k).randint(0, 2, 61)
    if k == 2:
        for fn in (corpus.rotating_fold_indices, jcorpus.rotating_fold_indices):
            with pytest.raises(ValueError):
                fn(labels, k, seed=7, stratified=stratified)
        return
    got = corpus.rotating_fold_indices(labels, k, seed=7, stratified=stratified)
    want = jcorpus.rotating_fold_indices(labels, k, seed=7, stratified=stratified)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.unit
@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_kfold_split_files_match_jax(k, tmp_path):
    labels = np.asarray([0] * 40 + [1] * 23)
    got = corpus.generate_kfold_splits(labels, k, tmp_path / "port", 11, "f_")
    want = jcorpus.generate_kfold_splits(labels, k, tmp_path / "jax", 11, "f_")
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert g.read_text() == w.read_text()


@pytest.mark.unit
@pytest.mark.parametrize("n,split_dir", [(450, "splits"),
                                         (16, "splits_synthetic_tiny")])
def test_committed_fold_files_reproduced(n, split_dir, tmp_path):
    """data/splits/split_fold_{1,2}.json (450 frames, 169/56/225 a fold)
    and data/splits_synthetic_tiny/split_fold_{1,2}.json (16 frames)."""
    labels = np.asarray([0] * (n // 2) + [1] * (n // 2))
    corpus.generate_kfold_splits(labels, 2, tmp_path)
    for fold in (1, 2):
        name = f"split_fold_{fold}.json"
        got = json.loads((tmp_path / name).read_text())
        assert got == json.loads((ROOT / "data" / split_dir / name).read_text())
        if n == 450:
            assert [len(got[s]) for s in ("train", "val", "test")] == [169, 56, 225]


@pytest.mark.unit
def test_committed_split_info_reproduced(tmp_path):
    labels = np.asarray([0] * 225 + [1] * 225)
    splits = corpus.resolve_split(labels, tmp_path)
    assert json.loads((tmp_path / "split_info.json").read_text()) == \
        json.loads((ROOT / "data" / "splits" / "split_info.json").read_text())
    assert [len(splits[s]) for s in ("train", "val", "test")] == [324, 58, 68]


def _touch_corpus(root: Path) -> None:
    for cls, names in (("normal", ["a_2.png", "b.tif", "x_10.tiff", "c.jpg"]),
                       ("cancerous", ["z_1.png", "y_3.jpeg", "readme.txt"])):
        (root / cls).mkdir(parents=True)
        for name in names:
            (root / cls / name).write_bytes(b"")


@pytest.mark.unit
def test_scan_and_resolve_match_jax(tmp_path):
    _touch_corpus(tmp_path / "c")
    got, want = corpus.scan_corpus(tmp_path / "c"), jcorpus.scan_corpus(tmp_path / "c")
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32
    labels = np.asarray([0, 1] * 12)
    for kw in ({}, {"fold": 2}, {"split_file": tmp_path / "s" / "split_fold_1.json"}):
        jcorpus.generate_kfold_splits(labels, 3, tmp_path / "s")
        g = corpus.resolve_split(labels, tmp_path / "s", **kw)
        w = jcorpus.resolve_split(labels, tmp_path / "s", **kw)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == np.int64
    corpus.save_split_info(g, tmp_path / "p" / "info.json", 24)
    jcorpus.save_split_info(w, tmp_path / "j" / "info.json", 24)
    assert (tmp_path / "p" / "info.json").read_text() == \
        (tmp_path / "j" / "info.json").read_text()


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.unit
def test_generate_corpus_matches_jax(tmp_path):
    """16 frames of 64²: the same files, _meta.json and pixels (the port's
    PNG bytes are its own); a parameter change wipes and regenerates on
    both sides, an unchanged call keeps the files."""
    kw = {"n_images": 16, "size": 64, "seed": 3}
    assert synthetic.generate_corpus(tmp_path / "p", **kw) == \
        jsynthetic.generate_corpus(tmp_path / "j", **kw) == (8, 8)
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert (tmp_path / "p" / "_meta.json").read_text() == \
        (tmp_path / "j" / "_meta.json").read_text()
    for rel in _files(tmp_path / "p"):
        if rel.endswith(".png"):
            np.testing.assert_array_equal(decode_image(tmp_path / "p" / rel),
                                          decode_image(tmp_path / "j" / rel))
    first = tmp_path / "p" / "normal" / "normal_0000.png"
    stamp = first.stat().st_mtime_ns
    synthetic.generate_corpus(tmp_path / "p", **kw)
    assert first.stat().st_mtime_ns == stamp
    kw.update(n_images=5, difficulty=0.5)
    assert synthetic.generate_corpus(tmp_path / "p", **kw) == \
        jsynthetic.generate_corpus(tmp_path / "j", **kw) == (3, 2)
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    for rel in _files(tmp_path / "p"):
        if rel.endswith(".png"):
            np.testing.assert_array_equal(decode_image(tmp_path / "p" / rel),
                                          decode_image(tmp_path / "j" / rel))
