"""A model of the multi-way bisection of the statistics kernel
(thyroid_tpu_torch/csrc/percentile.cu, stats_quantile_kernel), held bit-equal
to the one-step bisection of `per_image_quantile_fast`, in the port and in
the JAX package. This is the check of the kernel's walk that runs without
a card.

What the model repeats of the kernel, in float32 where the kernel rounds:
- a pass settles s = min(m, steps left) bisection steps: the 2^s - 1
  candidates are the midpoints fl(fl(a + b) * 0.5) of the brackets below
  (lo, hi), each computed along its path from the root; where they are not
  ascending (a NaN, a sum past FLT_MAX) the pass settles one step;
- each element's bin (the first candidate >= v, 2^s - 1 for none) is
  estimated from the value (round((v - lo) * scale - 1/2) by the float
  spacing of 1 above 2^23, clamped to [0, k]), checked against its two
  bounds, and searched for where the estimate missed; after the first pass
  an element <= lo is bin 0 and one > hi bin k at once;
- count(v <= candidate j) is the prefix sum of the bins; the walk takes
  the one-step rule float32(count) <= float32(q (n - 1)) at each node.
Every comparison is exact, so the quantile must equal the one-step loop's
bit for bit; the tests compare the bits (NaN equal to NaN).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from thyroid_tpu.ops import image as jimg
from thyroid_tpu_torch.ops import image as timg

F32 = np.float32


def _mid(a, b):
    with np.errstate(all="ignore"):
        return F32(F32(a + b) * F32(0.5))


def _candidate(lo, hi, s, j):
    """In-order candidate j of the s-step tree below (lo, hi)."""
    node = (1 << (s - 1)) - 1
    for d in range(s):
        mid = _mid(lo, hi)
        if j == node:
            return mid
        step = 1 << (s - 2 - d)
        if j > node:
            lo, node = mid, node + step
        else:
            hi, node = mid, node - step
    raise AssertionError("not reached")


def _bins(v, cand, lo, hi, k, first):
    """The kernel's bin of every element: estimate, check, search."""
    with np.errstate(all="ignore"):
        scale = F32(F32(k + 1) / F32(hi - lo)) if hi > lo else F32(0)
        d = (v - lo).astype(F32)
        t = (d.astype(np.float64) * np.float64(scale) + 8388607.5).astype(F32)
    est = t.view(np.int32).astype(np.int64) - 0x4B000000
    e = np.clip(est, 0, k)
    assert (e >= 0).all() and (e <= k).all()
    ext = np.concatenate([[-np.inf], cand, [np.inf]]).astype(F32)
    with np.errstate(invalid="ignore"):
        ok = (v > ext[e]) & (v <= ext[e + 1])
        miss = ~ok
        while True:  # while (e > 0 && v <= cand[e - 1]) --e
            step = miss & (e > 0)
            step[step] = v[step] <= cand[e[step] - 1]
            if not step.any():
                break
            e[step] -= 1
        while True:  # while (e < k && !(v <= cand[e])) ++e
            step = miss & (e < k)
            step[step] = ~(v[step] <= cand[e[step]])
            if not step.any():
                break
            e[step] += 1
    inside = k > 0 and lo <= cand[0] and cand[-1] <= hi
    if not first and inside:
        with np.errstate(invalid="ignore"):
            e = np.where(v <= lo, 0, np.where(v > hi, k, e))
    return e


def multiway_quantile(flat, q, iters, m):
    """The kernel's quantile of one image (1-D float32) with m steps a pass."""
    n = flat.size
    target = F32(q * (n - 1))
    # the starting bracket as the port takes it (torch's amin and amax:
    # which zero an image of -0 and +0 starts from is theirs)
    t = torch.from_numpy(flat)
    lo, hi = F32(t.amin().item()), F32(t.amax().item())
    done, first = 0, True
    while done < iters:
        s = min(m, iters - done)
        k = (1 << s) - 1
        cand = np.array([_candidate(lo, hi, s, j) for j in range(k)], F32)
        with np.errstate(invalid="ignore"):
            ascending = bool((cand[1:] >= cand[:-1]).all())
        if not ascending:
            s, k = 1, 1
            cand = np.array([_mid(lo, hi)], F32)
        e = _bins(flat, cand, lo, hi, k, first)
        # against a plain search: the first candidate >= v
        with np.errstate(invalid="ignore"):
            want = np.array([np.argmax(x <= cand) if (x <= cand).any() else k
                             for x in flat]) if flat.size <= 512 else None
        if want is not None:
            np.testing.assert_array_equal(e, want)
        counts = np.cumsum(np.bincount(e, minlength=k + 1))[:k]
        node = (1 << (s - 1)) - 1
        for d in range(s):
            mid = _mid(lo, hi)
            step = 1 << (s - 2 - d) if d + 1 < s else 0
            if F32(counts[node]) <= target:
                lo, node = mid, node + step
            else:
                hi, node = mid, node - step
        done += s
        first = False
    return _mid(lo, hi)


def _port(x, q, iters):
    return timg.per_image_quantile_fast(torch.from_numpy(x), q, iters) \
        .reshape(-1).numpy()


def _jax(x, q, iters):
    return np.asarray(jimg.per_image_quantile_fast(jnp.asarray(x), q, iters)) \
        .reshape(-1)


def _model(x, q, iters, m):
    return np.array([multiway_quantile(img.reshape(-1), q, iters, m)
                     for img in x], F32)


def _same_bits(a, b):
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    both_nan = np.isnan(a) & np.isnan(b)
    return bool(((a.view(np.int32) == b.view(np.int32)) | both_nan).all())


def _image(kind, rng, shape):
    if kind == "uint16":
        return np.floor(rng.random(shape) * 65536).astype(F32)
    if kind == "ties":
        return rng.integers(0, 7, shape).astype(F32) * F32(1000)
    if kind == "constant":
        return np.full(shape, 4321.0, F32)
    if kind == "two":
        return np.where(rng.random(shape) < 0.9, F32(17), F32(60000))
    if kind == "binades":
        return (rng.choice([-1.0, 1.0], shape)
                * np.exp2(rng.uniform(-60, 60, shape))).astype(F32)
    if kind == "negative":
        return (rng.standard_normal(shape) * 100 - 500).astype(F32)
    if kind == "infinite":  # the brackets reach a NaN midpoint
        x = rng.standard_normal(shape).astype(F32)
        x[:, 0, 0, 0], x[:, 0, 1, 0] = -np.inf, np.inf
        return x
    raise ValueError(kind)


KINDS = ["uint16", "ties", "constant", "two", "binades", "negative", "infinite"]


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_multiway_matches_one_step(kind, m):
    """Numpy-seeded images: the model of the kernel's walk gives the
    bits of the port's and JAX's per_image_quantile_fast, at 22 steps
    (the pipeline's), and at 7 and 23 (not multiples of m)."""
    rng = np.random.default_rng(KINDS.index(kind) * 10 + m)
    x = _image(kind, rng, (2, 37, 29, 1))
    for iters in (7, 22, 23):
        got = _model(x, 0.999, iters, m)
        assert _same_bits(got, _port(x, 0.999, iters)), (kind, m, iters)
        assert _same_bits(got, _jax(x, 0.999, iters)), (kind, m, iters)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.999, 1.0])
def test_multiway_quantiles_of_a_frame(q):
    """A 256x256 uint16-scale frame (2^16 pixels) at several quantiles,
    m = 8 as the kernel takes it."""
    rng = np.random.default_rng(5)
    x = np.floor(rng.random((1, 256, 256, 1)) ** 3 * 65536).astype(F32)
    got = _model(x, q, 22, 8)
    assert _same_bits(got, _port(x, q, 22))
    assert _same_bits(got, _jax(x, q, 22))


def _drawn_image(draw):
    n = draw(st.integers(1, 1 << 16))
    kind = draw(st.sampled_from(["values", "ties", "constant", "two"]))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31 - 1)))
    if kind == "values":
        lo_exp = draw(st.integers(-40, 30))
        span = draw(st.integers(0, 40))
        x = (rng.choice([-1.0, 1.0], n) * np.exp2(rng.uniform(lo_exp, lo_exp + span, n)))
    elif kind == "ties":
        x = rng.integers(-3, 4, n) * draw(st.sampled_from([1.0, 0.1, 1e-30, 3e37]))
    elif kind == "constant":
        x = np.full(n, draw(st.floats(-2.0 ** 100, 2.0 ** 100, width=32)))
    else:
        a, b = draw(st.floats(-1e6, 1e6, width=32)), draw(st.floats(-1e6, 1e6, width=32))
        x = np.where(rng.random(n) < draw(st.floats(0, 1)), a, b)
    return x.astype(F32).reshape(1, n, 1, 1)


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(st.data())
def test_multiway_walk_hypothesis(data):
    """Drawn images (ties, one or two values, values across many binades,
    negative values, up to 2^16 pixels), steps 1..25 and m in {1, 4, 8}:
    the model's quantile has the port's bits."""
    x = _drawn_image(data.draw)
    iters = data.draw(st.integers(1, 25))
    m = data.draw(st.sampled_from([1, 4, 8]))
    q = data.draw(st.sampled_from([0.0, 0.01, 0.5, 0.999, 1.0]))
    assert _same_bits(_model(x, q, iters, m), _port(x, q, iters))
