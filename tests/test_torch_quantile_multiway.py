"""A model of the multi-way bisection of the statistics kernel and of the
percentile kernel (thyroid_tpu_torch/csrc/percentile.cu, stats_quantile_kernel
and percentile_normalize_kernel), held bit-equal to the one-step bisection
of `per_image_quantile_fast`, in the port and in the JAX package, and for
the percentile kernel its clipped and scaled output to
`percentile_normalize_plain` and to JAX's `fused_percentile_normalize` in
interpret mode. This is the check of the kernels' walks that runs without
a card.

What the model repeats of the kernel, in float32 where the kernel rounds:
- a pass settles s = min(m, steps left) bisection steps: the 2^s - 1
  candidates are the midpoints fl(fl(a + b) * 0.5) of the brackets below
  (lo, hi), each computed along its path from the root; where they are not
  ascending (a NaN, a sum past FLT_MAX) the pass settles one step;
- each element's bin (the first candidate >= v, 2^s - 1 for none) is
  estimated from the value (round((v - lo) * scale - 1/2) by the float
  spacing of 1 above 2^23, clamped to [0, k]), checked against its two
  bounds, and bisected for where the estimate missed; after the first pass
  an element <= lo is bin 0 and one > hi bin k at once;
- count(v <= candidate j) is the prefix sum of the bins; the pass's steps
  settle at once where float32(count) <= float32(q (n - 1)) turns false
  (the interval the one-step walk down the tree ends in);
- the percentile kernel walks two brackets (the 1st and the 99th
  percentile), each settling its own steps: a pass in which they hold the
  same bits (the first, from [min, max]) bins once for both, every other
  pass bins each element in each bracket's candidates; after the first
  pass it keeps the values inside a bracket still settling in a list and
  counts the others at or below each lo, and a later pass whose
  candidates lie in its brackets bins the list alone, which the model
  holds equal to binning every element.
Every comparison is exact, so the quantile must equal the one-step loop's
bit for bit; the tests compare the bits (NaN equal to NaN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from thyroid_tpu.ops import image as jimg
from thyroid_tpu.ops import percentile as jperc
from thyroid_tpu_torch.ops import image as timg
from thyroid_tpu_torch.ops import percentile as tperc

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
        # where the estimate missed, the first candidate >= v by bisection
        a = np.zeros_like(e)
        z = np.full_like(e, k)
        while True:
            go = ~ok & (a < z)
            if not go.any():
                break
            m = (a + z) >> 1
            below = np.zeros_like(go)
            below[go] = v[go] <= cand[m[go]]
            z = np.where(go & below, m, z)
            a = np.where(go & ~below, m + 1, a)
        e = np.where(ok, e, a)
    inside = k > 0 and lo <= cand[0] and cand[-1] <= hi
    if not first and inside:
        with np.errstate(invalid="ignore"):
            e = np.where(v <= lo, 0, np.where(v > hi, k, e))
    return e


def _pass_candidates(lo, hi, s):
    """(s, k, candidates) of one bracket's pass; one step where the
    candidates are not ascending."""
    k = (1 << s) - 1
    cand = np.array([_candidate(lo, hi, s, j) for j in range(k)], F32)
    with np.errstate(invalid="ignore"):
        ascending = bool((cand[1:] >= cand[:-1]).all())
    if not ascending:
        return 1, 1, np.array([_mid(lo, hi)], F32)
    return s, k, cand


def _counts(flat, cand, lo, hi, k, first):
    """count(v <= candidate j) for every j: the prefix sums of the bins."""
    e = _bins(flat, cand, lo, hi, k, first)
    # against a plain search: the first candidate >= v
    with np.errstate(invalid="ignore"):
        want = np.array([np.argmax(x <= cand) if (x <= cand).any() else k
                         for x in flat]) if flat.size <= 512 else None
    if want is not None:
        np.testing.assert_array_equal(e, want)
    return np.cumsum(np.bincount(e, minlength=k + 1))[:k]


def _settle(lo, hi, cand, counts, target):
    """The pass's s steps at once: the counts ascend, so the one-step walk
    down the tree ends in the interval where float32(count) <= target turns
    false; the kernels find it as the one pair of neighbours (j - 1, j),
    j in [0, k], that holds and fails (outside the candidates: holds left,
    fails right), and take (cand[j - 1], cand[j]) with the bracket's own
    ends past them."""
    k = len(cand)
    holds = [True] + [F32(c) <= target for c in counts] + [False]
    flips = [j for j in range(k + 1) if holds[j] and not holds[j + 1]]
    assert len(flips) == 1, "the counts ascend"
    j = flips[0]
    return (cand[j - 1] if j > 0 else lo), (cand[j] if j < k else hi)


def _bits(v):
    return int(np.asarray(v, F32).view(np.int32))


def multiway_brackets(flat, qs, iters, m):
    """The kernels' final brackets' midpoints of one image (1-D float32),
    one bracket per quantile in qs, m steps a pass: the statistics kernel
    takes one quantile, the percentile kernel two. Each bracket settles its
    own steps; a pass where two brackets hold the same bits and steps bins
    once for both (the percentile kernel's first pass, and every pass of an
    image whose two quantiles walk alike). Returns the midpoints and the
    number of passes in which the brackets were binned together."""
    n = flat.size
    targets = [F32(q * (n - 1)) for q in qs]
    # the starting bracket as the port takes it (torch's amin and amax:
    # which zero an image of -0 and +0 starts from is theirs)
    t = torch.from_numpy(flat)
    start = (F32(t.amin().item()), F32(t.amax().item()))
    br = [list(start) + [0] for _ in qs]     # lo, hi, steps done
    first, shared, listed = True, 0, None
    while any(b[2] < iters for b in br):
        plan = [_pass_candidates(b[0], b[1], min(m, iters - b[2]))
                if b[2] < iters else (0, 0, None) for b in br]
        same = len(br) == 2 and plan[0][1] > 0 and plan[0][0] == plan[1][0] \
            and [_bits(v) for v in br[0][:2]] == [_bits(v) for v in br[1][:2]]
        shared += same
        counts = []
        for i, (b, (s, k, cand)) in enumerate(zip(br, plan)):
            if k == 0:
                counts.append(None)
            elif i == 1 and same:
                counts.append(counts[0])
            else:
                counts.append(_counts(flat, cand, b[0], b[1], k, first))
                inside = k > 0 and b[0] <= cand[0] and cand[-1] <= b[1]
                if listed is not None and inside:
                    # the percentile kernel's later passes bin the list alone
                    got = _counts(flat[listed], cand, b[0], b[1], k, False) + base[i]
                    np.testing.assert_array_equal(got, counts[-1])
        for b, (s, _, cand), c, target in zip(br, plan, counts, targets):
            if s:
                b[0], b[1] = _settle(b[0], b[1], cand, c, target)
                b[2] += s
        if first and len(br) == 2:  # the list: the values inside a bracket still settling
            with np.errstate(invalid="ignore"):
                listed = np.zeros(flat.shape, bool)
                for b in br:
                    if b[2] < iters:
                        listed |= (flat > b[0]) & (flat <= b[1])
                base = [int(((flat <= b[0]) & ~listed).sum()) for b in br]
        first = False
    return [_mid(b[0], b[1]) for b in br], shared


def multiway_quantile(flat, q, iters, m):
    """The statistics kernel's quantile of one image (1-D float32)."""
    return multiway_brackets(flat, (q,), iters, m)[0][0]


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


# ---------------------------------------------------------------- the percentile kernel

EPS = F32(1e-8)
PERCENTILES = (1.0, 99.0)


def _model_normalize(x, iters, m, percentiles=PERCENTILES):
    """The percentile kernel's output of x (B, H, W, 1) float32 with m
    steps a pass: the two brackets' midpoints, clip and scale in float32;
    and the midpoints and shared passes of each image."""
    qs = (percentiles[0] / 100.0, percentiles[1] / 100.0)
    out = np.empty_like(x)
    p_lo, p_hi, shared = [], [], []
    for i, img in enumerate(x):
        (lo, hi), sh = multiway_brackets(img.reshape(-1), qs, iters, m)
        with np.errstate(all="ignore"):
            y = np.minimum(np.maximum(img, lo), hi)
            out[i] = (y - lo) / (hi - lo + EPS)
        p_lo.append(lo)
        p_hi.append(hi)
        shared.append(sh)
    return out, np.array(p_lo, F32), np.array(p_hi, F32), shared


def _port_normalize(x, iters, percentiles=PERCENTILES):
    return tperc.percentile_normalize_plain(torch.from_numpy(x), percentiles,
                                            iters).numpy()


_jax_normalize = jax.jit(
    lambda x, iters, percentiles: jperc.fused_percentile_normalize(
        x, percentiles, iters, interpret=True),
    static_argnums=(1, 2))


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_two_bracket_walk_matches_one_step(kind, m):
    """The percentile kernel's model on numpy-seeded images: both brackets
    have the bits of the port's and JAX's one-step quantiles, and the
    clipped, scaled output the bits of percentile_normalize_plain and of
    JAX's fused_percentile_normalize, at 7, 22 and 23 steps."""
    rng = np.random.default_rng(100 + KINDS.index(kind) * 10 + m)
    x = _image(kind, rng, (2, 37, 29, 1))
    for iters in (7, 22, 23):
        got, p_lo, p_hi, _ = _model_normalize(x, iters, m)
        assert _same_bits(p_lo, _port(x, 0.01, iters)), (kind, m, iters)
        assert _same_bits(p_hi, _port(x, 0.99, iters)), (kind, m, iters)
        assert _same_bits(p_hi, _jax(x, 0.99, iters)), (kind, m, iters)
        assert _same_bits(got, _port_normalize(x, iters)), (kind, m, iters)
        assert _same_bits(got, np.asarray(_jax_normalize(jnp.asarray(x), iters,
                                                         PERCENTILES))), (kind, m, iters)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_bracket_walk_shared_brackets(dtype):
    """A two-valued image whose 1st and 99th percentiles walk alike (0.5%
    of the pixels 17, the rest 60000): the brackets keep the same bits, so
    every pass (8 + 8 + 6 steps) bins once for both; the output has the
    port's and JAX's bits, in float32 and rounded to bf16."""
    rng = np.random.default_rng(3)
    x = np.where(rng.random((2, 40, 40, 1)) < 0.005, F32(17), F32(60000))
    x[:, 0, 0, 0] = 17
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    got, p_lo, p_hi, shared = _model_normalize(x, 22, 8)
    assert shared == [3, 3] and _same_bits(p_lo, p_hi)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = tperc.percentile_normalize_plain(xt, PERCENTILES, 22)
    got_t = torch.from_numpy(got).to(want.dtype)
    assert torch.equal(got_t, want)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jy = np.asarray(_jax_normalize(jx, 22, PERCENTILES).astype(jnp.float32))
    assert _same_bits(got_t.float().numpy(), jy)


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(st.data())
def test_two_bracket_walk_hypothesis(data):
    """Drawn images, steps 1..25, m in {1, 4, 8} and percentile pairs (the
    served 1/99, the extremes, one shared quantile): the model's output has
    the bits of percentile_normalize_plain."""
    x = _drawn_image(data.draw)
    iters = data.draw(st.integers(1, 25))
    m = data.draw(st.sampled_from([1, 4, 8]))
    pct = data.draw(st.sampled_from([(1.0, 99.0), (0.0, 100.0), (50.0, 50.0),
                                     (2.0, 98.0)]))
    got = _model_normalize(x, iters, m, pct)[0]
    assert _same_bits(got, _port_normalize(x, iters, pct))
