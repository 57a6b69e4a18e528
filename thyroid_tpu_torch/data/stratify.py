"""scikit-learn's shuffled splitters in numpy, draw for draw.

The JAX package takes its split indices from `StratifiedKFold(shuffle=True)`
and `train_test_split` (stratified or not). scikit-learn is not installed
where the port runs, and the committed split files must come out the same,
so these functions make the same calls on the same
`np.random.RandomState` stream, in the same order, as scikit-learn 1.x
does (`model_selection/_split.py`: `StratifiedKFold._make_test_folds`,
`StratifiedShuffleSplit._iter_indices`, `ShuffleSplit._iter_indices`,
`_validate_shuffle_split`; `utils/extmath.py: _approximate_mode`), and
raise ValueError where it raises. `tests/test_torch_corpus.py` holds them
equal to scikit-learn.
"""
from __future__ import annotations

import numbers
import warnings
from math import ceil, floor
from typing import List, Optional, Tuple

import numpy as np


def _check_labels(y) -> np.ndarray:
    """1-D labels of a binary or multiclass target (scikit-learn's
    `type_of_target` accepts nothing else for stratification)."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y.ravel()
    if y.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {y.shape}")
    if y.dtype.kind == "f" and np.any(y != y.astype(np.int64)):
        raise ValueError("Supported target types are: ('binary', "
                         "'multiclass'). Got 'continuous' instead.")
    return y


def stratified_kfold_test_folds(y, n_splits: int,
                                random_state: Optional[int]) -> List[np.ndarray]:
    """The test indices of each fold of
    `StratifiedKFold(n_splits, shuffle=True, random_state).split(X, y)`,
    ascending within a fold."""
    if not isinstance(n_splits, numbers.Integral):
        raise ValueError("The number of folds must be of Integral type. "
                         f"{n_splits} of type {type(n_splits)} was passed.")
    n_splits = int(n_splits)
    if n_splits <= 1:
        raise ValueError("k-fold cross-validation requires at least one "
                         "train/test split by setting n_splits=2 or more, "
                         f"got n_splits={n_splits}.")
    y = _check_labels(y)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of samples: "
                         f"n_samples={len(y)}.")
    rng = np.random.RandomState(random_state)
    # classes numbered by first appearance
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    if n_splits > np.min(y_counts):
        warnings.warn(f"The least populated class in y has only "
                      f"{np.min(y_counts)} members, which is less than "
                      f"n_splits={n_splits}.", UserWarning)
    # round robin over the sorted classes: the count of each class per fold
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits],
                                         minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    return [indices[test_folds == i] for i in range(n_splits)]


def validate_shuffle_split(n_samples: int, test_size, train_size=None,
                           default_test_size=None) -> Tuple[int, int]:
    """(n_train, n_test): a float size is a fraction (test rounded up,
    train down), an int a count; the missing one takes the rest."""
    if test_size is None and train_size is None:
        test_size = default_test_size
    test_kind = np.asarray(test_size).dtype.kind
    train_kind = np.asarray(train_size).dtype.kind
    if (test_kind == "i" and (test_size >= n_samples or test_size <= 0)) or \
            (test_kind == "f" and (test_size <= 0 or test_size >= 1)):
        raise ValueError(f"test_size={test_size} should be either positive "
                         f"and smaller than the number of samples "
                         f"{n_samples} or a float in the (0, 1) range")
    if (train_kind == "i" and (train_size >= n_samples or train_size <= 0)) or \
            (train_kind == "f" and (train_size <= 0 or train_size >= 1)):
        raise ValueError(f"train_size={train_size} should be either positive "
                         f"and smaller than the number of samples "
                         f"{n_samples} or a float in the (0, 1) range")
    if train_size is not None and train_kind not in ("i", "f"):
        raise ValueError(f"Invalid value for train_size: {train_size}")
    if test_size is not None and test_kind not in ("i", "f"):
        raise ValueError(f"Invalid value for test_size: {test_size}")
    if train_kind == "f" and test_kind == "f" and train_size + test_size > 1:
        raise ValueError(f"The sum of test_size and train_size = "
                         f"{train_size + test_size}, should be in the (0, 1) "
                         "range. Reduce test_size and/or train_size.")
    if test_kind == "f":
        n_test = ceil(test_size * n_samples)
    elif test_kind == "i":
        n_test = float(test_size)
    if train_kind == "f":
        n_train = floor(train_size * n_samples)
    elif train_kind == "i":
        n_train = float(train_size)
    if train_size is None:
        n_train = n_samples - n_test
    elif test_size is None:
        n_test = n_samples - n_train
    if n_train + n_test > n_samples:
        raise ValueError(f"The sum of train_size and test_size = "
                         f"{int(n_train + n_test)}, should be smaller than "
                         f"the number of samples {n_samples}. Reduce "
                         "test_size and/or train_size.")
    n_train, n_test = int(n_train), int(n_test)
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} "
                         f"and train_size={train_size}, the resulting train "
                         "set will be empty. Adjust any of the "
                         "aforementioned parameters.")
    return n_train, n_test


def approximate_mode(class_counts: np.ndarray, n_draws: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """Per-class draw counts near the mode of the multivariate
    hypergeometric; the largest remainders get the leftover draws, ties
    broken by `rng.choice` (which advances the stream)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle_split(y: np.ndarray, n_train: int, n_test: int,
                              rng: np.random.RandomState):
    """The first split of StratifiedShuffleSplit → (train, test) positions."""
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 "
                         "member, which is too few. The minimum number of "
                         "groups for any class cannot be less than 2. "
                         "Classes with too few members are: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    n_i = approximate_mode(class_counts, n_train, rng)
    t_i = approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(n_classes):
        permutation = rng.permutation(class_counts[i])
        perm_indices = class_indices[i].take(permutation, mode="clip")
        train.extend(perm_indices[:n_i[i]])
        test.extend(perm_indices[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(indices, test_size=None, train_size=None,
                     random_state: Optional[int] = None,
                     stratify=None) -> Tuple[np.ndarray, np.ndarray]:
    """`sklearn.model_selection.train_test_split(indices, ...)` with
    shuffling: (indices[train], indices[test]), stratified by `stratify`
    when given (StratifiedShuffleSplit), else ShuffleSplit's permutation."""
    indices = np.asarray(indices)
    n_samples = len(indices)
    n_train, n_test = validate_shuffle_split(n_samples, test_size, train_size,
                                             default_test_size=0.25)
    # the splitter validates the integer sizes again
    n_train, n_test = validate_shuffle_split(n_samples, n_test, n_train)
    rng = np.random.RandomState(random_state)
    if stratify is not None:
        y = _check_labels(stratify)
        if len(y) != n_samples:
            raise ValueError("Found input variables with inconsistent numbers "
                             f"of samples: [{n_samples}, {len(y)}]")
        train, test = _stratified_shuffle_split(y, n_train, n_test, rng)
    else:
        permutation = rng.permutation(n_samples)
        test = permutation[:n_test]
        train = permutation[n_test:n_test + n_train]
    return indices[train], indices[test]
