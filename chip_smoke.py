#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (thyroid_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its lines before the final one:
1. build: compile every kernel of thyroid_tpu_torch/csrc with nvcc for
   sm_90a (one nvcc per source, in parallel) and print the card's name and
   power limit as nvidia-smi reports them;
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   same inputs, at every shape the swin_tiny forward gives it at batch 32,
   in float32 (TF32 off for matmuls and convolutions) and in bfloat16;
3. slice: InferenceEngine serves swin_tiny (bf16, full width and depth,
   seeded and perturbed weights) on raw 512x512 frames; the launch counters
   must move by 1, 15, 12 and 12 per forward, and the probabilities must
   agree with the same engine on the CPU in float32;
4. times: each kernel's median time per forward at bucket 32 beside its
   bound, its plain version and a library yardstick, and end-to-end
   images/s of predict at buckets 32 and 128.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits nonzero
before that line is printed. Needs one CUDA card; exits nonzero without one.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
                  torch.float32: 67e12}     # float32 outside the tensor cores
BATCH = 32                     # bucket the kernels are checked and timed at
SWIN_TINY = {"name": "swin_tiny", "in_channels": 1, "num_classes": 2,
             "dtype": "bf16"}
# relative tolerance of kernel vs plain on the card, against max(1, max|plain|):
# f32 covers summation order over up to 3072 terms and rsqrtf/expf/erff vs
# PyTorch's; bf16 covers one rounding flip of a bf16 output (2^-8 relative)
RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
PERCENTILE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8}
# engine probabilities vs the CPU float32 engine on the same weights
PROB_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------- shapes


def swin_tiny_shapes(batch: int):
    """Every (kernel, shape) the swin_tiny forward launches at `batch`,
    with its count per forward."""
    embed, depths, heads, res, ws = 96, (2, 2, 6, 2), (3, 6, 12, 24), 56, 7
    lnmm, mlp, attn = {}, {}, {}
    for i, depth in enumerate(depths):
        c, r = embed * 2 ** i, res // 2 ** i
        t = batch * r * r
        lnmm[(t, c, 3 * c, True)] = lnmm.get((t, c, 3 * c, True), 0) + depth
        mlp[(t, c, 4 * c)] = mlp.get((t, c, 4 * c), 0) + depth
        w = min(ws, r)
        for j in range(depth):
            shift = 0 if (j % 2 == 0 or r <= ws) else ws // 2
            key = (batch, r, c, heads[i], w, shift)
            attn[key] = attn.get(key, 0) + 1
        if i < len(depths) - 1:
            key = (batch * (r // 2) ** 2, 4 * c, 2 * c, False)
            lnmm[key] = lnmm.get(key, 0) + 1
    return {"percentile": {(batch, 224 * 224): 1}, "ln_matmul": lnmm,
            "ln_mlp_residual": mlp, "swin_block_attention": attn}


# ---------------------------------------------------------------- inputs


def make_inputs(kernel: str, shape, dtype, gen):
    """Seeded inputs of one kernel case, on the card, like the JAX tests'."""
    from thyroid_tpu_torch.models.vit.swin import shift_attention_mask

    def rn(*s, scale=1.0, dt=torch.float32):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dt)

    if kernel == "percentile":
        b, n = shape
        return (torch.rand(b, 224, 224, 1, generator=gen, device="cuda")
                * 65535).to(dtype),
    if kernel == "ln_matmul":
        t, c, o, has_bias = shape
        return (rn(t, c, dt=dtype), 1 + rn(c, scale=0.1), rn(c, scale=0.1),
                rn(c, o, scale=c ** -0.5, dt=dtype),
                rn(o, scale=0.1) if has_bias else None)
    if kernel == "ln_mlp_residual":
        t, c, h = shape
        return (rn(t, c, dt=dtype), 1 + rn(c, scale=0.1), rn(c, scale=0.1),
                rn(c, h, scale=c ** -0.5, dt=dtype), rn(h, scale=0.1),
                rn(h, c, scale=h ** -0.5, dt=dtype), rn(c, scale=0.1))
    b, r, c, heads, ws, shift = shape
    mask = shift_attention_mask(r, r, ws, shift)
    return (rn(b, r, r, 3, c, dt=dtype), rn(b, r, r, c, dt=dtype),
            rn(c, c, scale=0.05, dt=dtype), rn(c, scale=0.1),
            rn(heads, ws * ws, ws * ws, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)


def kernel_fns(kernel: str, shape):
    """(wrapper, plain version) of a kernel, as functions of its inputs."""
    from thyroid_tpu_torch.ops import attention, percentile, token_fused

    if kernel == "percentile":
        return percentile.fused_percentile_normalize, \
            percentile.percentile_normalize_plain
    if kernel == "ln_matmul":
        return token_fused.fused_ln_matmul, token_fused.ln_matmul_plain
    if kernel == "ln_mlp_residual":
        return token_fused.fused_ln_mlp_residual, \
            token_fused.ln_mlp_residual_plain
    _, _, c, heads, ws, _ = shape
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    return (lambda *a: attention.fused_swin_block_attention(*a, **kw),
            lambda *a: attention.swin_block_attention_plain(*a, **kw))


def library_fn(kernel: str, shape, args):
    """One PyTorch library composition of the same function, for timing
    only (the port never calls it), or None where there is none."""
    import torch.nn.functional as F

    if kernel == "percentile":
        return None
    if kernel == "ln_matmul":
        x, g, b, w, wb = args
        wt, gd, bd = w.t().contiguous(), g.to(x.dtype), b.to(x.dtype)
        wbd = wb.to(x.dtype) if wb is not None else None
        return lambda: F.linear(F.layer_norm(x, (x.shape[-1],), gd, bd, 1e-5),
                                wt, wbd)
    if kernel == "ln_mlp_residual":
        x, g, b, w1, b1, w2, b2 = args
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        gd, bd, b1d, b2d = (v.to(x.dtype) for v in (g, b, b1, b2))
        return lambda: x + F.linear(F.gelu(F.linear(
            F.layer_norm(x, (x.shape[-1],), gd, bd, 1e-5), w1t, b1d)), w2t, b2d)
    qkv, xres, wp, bp, bias, mask = args
    bsz, r, _, _, c = qkv.shape
    _, _, _, heads, ws, _ = shape
    n, nw, dh = ws * ws, (r // ws) ** 2, c // heads
    attn_mask = bias[None].expand(nw, heads, n, n) if mask is None \
        else bias[None] + mask[:, None]
    attn_mask = attn_mask.to(qkv.dtype)[None].expand(bsz, nw, heads, n, n) \
        .reshape(bsz * nw, heads, n, n).contiguous()
    wpt, bpd = wp.t().contiguous(), bp.to(qkv.dtype)

    def run():
        win = qkv.reshape(bsz, r // ws, ws, r // ws, ws, 3, heads, dh) \
            .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, bsz * nw, heads, n, dh)
        o = F.scaled_dot_product_attention(win[0], win[1], win[2],
                                           attn_mask=attn_mask,
                                           scale=dh ** -0.5)
        o = o.reshape(bsz, r // ws, r // ws, heads, ws, ws, dh) \
            .permute(0, 1, 4, 2, 5, 3, 6).reshape(bsz, r, r, c)
        return xres + F.linear(o, wpt, bpd)

    return run


def work(kernel: str, shape, dtype):
    """(bytes, operations, peak operations/s) of one call: each input read
    once and each output written once; the products' multiply-adds at the
    tensor-core rate of the input type, or the percentile's float32
    compares and arithmetic (2 for min/max, 2 per bisection step, 4 for
    clip and scale, per pixel) at the float32 rate."""
    s = torch.tensor([], dtype=dtype).element_size()
    if kernel == "percentile":
        b, n = shape
        return 2 * b * n * s, b * n * (2 + 2 * 22 + 4), \
            PEAK_OPS_PER_S[torch.float32]
    peak = PEAK_OPS_PER_S[dtype]
    if kernel == "ln_matmul":
        t, c, o, has_bias = shape
        return (t * c + c * o + t * o) * s + (2 * c + o * has_bias) * 4, \
            2 * t * c * o, peak
    if kernel == "ln_mlp_residual":
        t, c, h = shape
        return (2 * t * c + 2 * c * h) * s + (3 * c + h) * 4, 4 * t * c * h, \
            peak
    b, r, c, heads, ws, shift = shape
    n, nw = ws * ws, (r // ws) ** 2
    tokens = b * r * r
    nbytes = (tokens * 5 * c + c * c) * s + (c + heads * n * n
                                             + (nw * n * n if shift else 0)) * 4
    return nbytes, b * nw * 4 * n * n * c + 2 * tokens * c * c, peak


# ---------------------------------------------------------------- phases


def phase_build() -> str:
    from thyroid_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    return card


def phase_kernels(shapes) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] float32 checks run with torch.backends.cuda.matmul."
        "allow_tf32 = False and torch.backends.cudnn.allow_tf32 = False")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, cases in shapes.items():
            for shape in cases:
                args = make_inputs(kernel, shape, dtype, gen)
                fused, plain = kernel_fns(kernel, shape)
                got = fused(*args).float()
                want = plain(*args).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if kernel == "percentile":
                    tol = PERCENTILE_TOL[dtype]
                else:
                    tol = RTOL[dtype] * max(1.0, want.abs().max().item())
                ok = bool(np.isfinite(err)) and err <= tol \
                    and bool(torch.isfinite(got).all())
                log(f"[kernels] {kernel} {str(dtype)[6:]} {shape}: "
                    f"max_abs_err {err:.3e} tol {tol:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append((kernel, str(dtype), shape, err))
                del args, got, want
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")


def perturbed_params(config, seed: int = 0):
    """Seeded swin_tiny weights as a JAX parameter tree, each leaf bumped
    by 0.01·sin(0.7·i) so that logits of a random init are not flat."""
    from thyroid_tpu_torch.models.base import create_and_init
    from thyroid_tpu_torch.models.from_jax import to_jax_params

    model = create_and_init(config, seed=seed, device="cpu")

    def bump(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = bump(v)
            else:
                wave = np.sin(np.arange(v.size, dtype=np.float32) * 0.7)
                out[k] = v + 0.01 * wave.reshape(v.shape).astype(np.float32)
        return out

    return bump(to_jax_params(model))


def counters():
    from thyroid_tpu_torch.ops import attention, percentile, token_fused

    return {"percentile": percentile.fused_percentile_normalize,
            "ln_matmul": token_fused.fused_ln_matmul,
            "ln_mlp_residual": token_fused.fused_ln_mlp_residual,
            "swin_block_attention": attention.fused_swin_block_attention}


def phase_slice(params):
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(SWIN_TINY, params=params)
    engine.warmup()
    rs = np.random.RandomState(0)
    sizes = (1, 8, 32, 40, 136)   # 40 pads into bucket 128; 136 = 128 + 8
    frames = {n: (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
              for n in sizes}
    for fn in counters().values():
        fn.launches = 0
    probs = {n: engine.predict(frames[n]) for n in sizes}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    forwards = sum(-(-n // engine.buckets[-1]) for n in sizes)
    per_forward = {"percentile": 1, "ln_matmul": 15, "ln_mlp_residual": 12,
                   "swin_block_attention": 12}
    log(f"[slice] swin_tiny bf16 served N={sizes} in {forwards} forwards; "
        f"launches {launches}")
    for k, per in per_forward.items():
        if launches[k] != per * forwards:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} x {forwards} forwards")
    for n, p in probs.items():
        if p.shape != (n, 2) or not np.isfinite(p).all() \
                or np.abs(p.sum(-1) - 1).max() > 1e-3:
            raise AssertionError(f"N={n}: bad probabilities {p.shape}")
    # agreement: the CPU float32 engine on the same weights and frames
    cpu = InferenceEngine(dict(SWIN_TINY, dtype="f32"), params=params,
                          device="cpu").predict(frames[8])
    gpu32 = InferenceEngine(dict(SWIN_TINY, dtype="f32"),
                            params=params).predict(frames[8])
    spread = float(cpu[:, 0].max() - cpu[:, 0].min())
    for name, got, tol in (("cuda f32", gpu32, PROB_TOL[torch.float32]),
                           ("cuda bf16", probs[8], PROB_TOL[torch.bfloat16])):
        err = float(np.abs(got - cpu).max())
        log(f"[slice] N=8 probabilities, {name} vs cpu f32: max_abs_err "
            f"{err:.3e} tol {tol:.0e} (spread of p0 over the batch {spread:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name} probabilities disagree with the CPU")
    return engine, launches


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_times(shapes, engine, launches):
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype = torch.bfloat16
    names = {"percentile": "ops/percentile.py:183",
             "ln_matmul": "ops/token_fused.py:172",
             "ln_mlp_residual": "ops/token_fused.py:379",
             "swin_block_attention": "ops/attention.py:417"}
    sources = {"percentile": "percentile.cu", "ln_matmul": "ln_matmul.cu",
               "ln_mlp_residual": "ln_mlp.cu",
               "swin_block_attention": "swin_attention.cu"}
    entries = []
    for kernel, cases in shapes.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0}
        has_lib = True
        for shape, count in cases.items():
            args = make_inputs(kernel, shape, dtype, gen)
            fused, plain = kernel_fns(kernel, shape)
            ms = median_ms(lambda: fused(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=5, warm=1)
            lib = library_fn(kernel, shape, args)
            lib_ms = median_ms(lib) if lib is not None else None
            err = (fused(*args).float() - plain(*args).float()).abs().max().item()
            nbytes, ops, peak = work(kernel, shape, dtype)
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / peak * 1e3
            log(f"[times] {kernel} bf16 {shape} x{count}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * max(t_bytes, t_ops)
            tot["bytes_ms"] += count * t_bytes
            tot["ops_ms"] += count * t_ops
            tot["err"] = max(tot["err"], err)
            if lib_ms is None:
                has_lib = False
            else:
                tot["library_ms"] += count * lib_ms
            del args
        entries.append({
            "name": f"fused_{kernel}" if kernel != "percentile"
            else "fused_percentile_normalize",
            "route": "cuda",
            "source": f"thyroid_tpu_torch/csrc/{sources[kernel]}",
            "replaces": f"thyroid_tpu/{names[kernel]}",
            "launches": launches[kernel],
            "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            "library_ms": tot["library_ms"] if has_lib else None})
        log(f"[times] {entries[-1]['name']} per forward at bucket {BATCH}: "
            f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms)")

    rs = np.random.RandomState(1)
    for n in (32, 128):
        frames = (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
        engine.predict(frames)
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.predict(frames)
            secs.append(time.perf_counter() - t0)
        med = statistics.median(secs)
        log(f"[times] predict bucket {n}: median {med * 1e3:.2f} ms over 5, "
            f"{n / med:.1f} images/s (raw 512x512 frames from host memory)")
    return entries


def phase_profile(engine, n: int = BATCH, top: int = 12) -> None:
    """Where the time of one predict call at bucket `n` goes: device time
    by kernel name from torch.profiler, and the device's busy share of the
    call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = (np.random.RandomState(2).rand(n, 512, 512, 1) * 65535) \
        .astype(np.float32)
    engine.predict(frames)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(frames)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us == 0:
        log("[profile] torch.profiler recorded no device time: not measured")
        return
    log(f"[profile] predict bucket {n}: wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"idle {100 * (1 - busy_us / wall_us):.1f}%")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy_us:5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = phase_build()
    shapes = swin_tiny_shapes(BATCH)
    phase_kernels(shapes)
    params = perturbed_params(SWIN_TINY)
    engine, launches = phase_slice(params)
    entries = phase_times(shapes, engine, launches)
    phase_profile(engine)
    log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
