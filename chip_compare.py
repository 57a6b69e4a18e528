#!/usr/bin/env python3
"""Same-call comparison of kernels between source trees on one card.

    python3 chip_compare.py PARENT_TREE [--smokes DIR] [--ablate] [--phases]
                            [--predict-pairs N] [--kernels all|k1|k8|k12|k15]

PARENT_TREE is another checkout of this repository (for example a `git
archive` of the parent commit unpacked under `build/`). The trees are
measured in turns, parent, this tree, this tree, parent, each in a fresh
process that puts the tree first on `sys.path` (so `thyroid_tpu_torch` and
its kernels, built into the tree's own `build/`, are the tree's) and loads
this tree's `chip_smoke.py` by path for its inputs, hashes and timers. Each
process prints one `RESULT {...}` line: per kernel the device time of one
call (`chip_smoke.device_ms`: CUDA-graph replays between CUDA events) and
the CUDA-event time of one call (`median_ms`), and the SHA-256 of the
outputs (`percentile_hashes`, `output_hashes` on the quality chunk,
`ln_attention_hashes`):
- kernel 1 (`fused_percentile_normalize`) on `percentile_batch` at buckets
  32 and 128, float32 and bf16, and at bucket 32 in float32 with 0, 8 and
  16 bisection steps (no counting pass, one, two);
- kernel 7 (`fused_swin_ln_attention`, bf16) summed over a swin_tiny
  forward's 12 blocks at batch 32;
- row 8 (`fused_window_attention`) in bf16 and float32 at swin_tiny's four
  block shapes, summed over a forward, and at swin_large's stage 4, beside
  SDPA on the same bf16 inputs; the SHA-256 of its outputs
  (`window_hashes`) and of kernels 4-7's at swin_tiny's block shapes
  (`swin_attention_hashes`, `ln_attention_hashes`);
- kernels 12-16 on the 32-frame quality chunk (`quality_frames`), 14 at
  both grids, 16 on `dual_fused_case`'s flags.

With --smokes DIR, first each tree's own `chip_smoke.py` runs in the same
turns, its output into DIR/smoke_<turn>_<tree>.log, its exit code and
seconds into the summary.

With --kernels k1, k8, k12 or k15 the four runs measure that kernel
alone (k8: row 8 and the hashes of kernels 4-7), and --ablate cuts only
it.

With --ablate, builds of this tree with one part of kernel 1, 8, 12 or 15
cut or changed (ABLATIONS: a copy of the package under
`build/ablate/<name>/` with one source edited; only that source is
rebuilt) are measured after the four runs, between two runs of this tree.
A cut that drops work gives wrong output: its time is all it shows.

With --phases, a build of kernel 1 with a clock64() stamp at the end of
each phase (STAMPS) reports each phase's cycles on the served batch.

With --predict-pairs N, N pairs of processes, one a tree, in alternating
order (parent first, then this tree first), time InferenceEngine.predict
(predict_times) for the end-to-end comparison.

Needs one CUDA card; the last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# row 8's side table in shared memory at a 72-float pitch (window_tc.cuh's
# kLdK), loaded by the whole CTA, in place of each thread's 32 registers
K8_TABLE_SMEM = [
    ("constexpr int tc_smem_bytes() { return 1024 + kStages * 3 * kTcTile; }",
     "constexpr int kLdT = 72;\n"
     "constexpr int tc_smem_bytes() { return 1024 + kStages * 3 * kTcTile + 64 * kLdT * 4; }"),
    ("  const int row0 = 16 * warp;\n",
     "  const int row0 = 16 * warp;\n"
     "  float* Ts = reinterpret_cast<float*>(smem_raw + (base - raw) + kStages * 3 * kTcTile);\n"),
    ("#pragma unroll\n"
     "      for (int j = 0; j < 8; ++j)\n"
     "#pragma unroll\n"
     "        for (int i = 0; i < 2; ++i)\n"
     "#pragma unroll\n"
     "          for (int e = 0; e < 2; ++e)\n"
     "            tab[4 * j + 2 * i + e] = table_at(bh, mw, n, row0 + g + 8 * i, 8 * j + 2 * t + e);\n",
     "      for (int i = tid; i < 64 * 64; i += kTcThreads)\n"
     "        Ts[(i / 64) * kLdT + i % 64] = table_at(bh, mw, n, i / 64, i % 64);\n"
     "      __syncthreads();\n"),
    ("        s[x] = __fmul_rn(s[x], scale) + tab[x];\n"
     "        s[x + 1] = __fmul_rn(s[x + 1], scale) + tab[x + 1];\n",
     "        const float2 side =\n"
     "            *reinterpret_cast<const float2*>(Ts + (row0 + g + 8 * i) * kLdT + 8 * j + 2 * t);\n"
     "        s[x] = __fmul_rn(s[x], scale) + side.x;\n"
     "        s[x + 1] = __fmul_rn(s[x + 1], scale) + side.y;\n"),
]

# row 8's products on window_tc.cuh's TF32 mma.sync core (kernel 5's
# staged probs and pv) on the same ring and the shared-memory table, in
# place of the two wgmma products
K8_TF32_CORE = K8_TABLE_SMEM + [
    ('#include "wgmma.cuh"\n', '#include "wgmma.cuh"\n#include "window_tc.cuh"\n'),
    ("    // S = Q K^T, D / 16 steps; both tiles K-major\n", """\
    {
      const auto at = [&](uint32_t tile, int r, int c) {
        return reinterpret_cast<const bf16*>(smem_raw + (tile - raw) + wg::swz(r, c / 8) +
                                             (c % 8) * 2);
      };
      float qf[DH / 8][4];
#pragma unroll
      for (int kc = 0; kc < DH / 8; ++kc)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 qv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(at(st, row0 + g + 8 * i, 8 * kc + 2 * t)));
          qf[kc][2 * i] = qv.x * scale;
          qf[kc][2 * i + 1] = qv.y * scale;
        }
      float p[8][4], of[DH / 8][4];
      wintc::probs<DH, true>(
          qf,
          [&](int key, int d) {
            return __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(at(st + kTcTile, key, d)));
          },
          n, row0, [&](int r, int key) { return Ts[r * kLdT + key]; }, p);
      wintc::pv<DH>(
          p, [&](int key, int d) { return __bfloat162float(*at(st + 2 * kTcTile, key, d)); }, n,
          of);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + g + 8 * i;
        if (r >= n) continue;
#pragma unroll
        for (int dt = 0; dt < DH / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(dst + r * DH + 8 * dt + 2 * t) =
              __floats2bfloat162_rn(of[dt][2 * i], of[dt][2 * i + 1]);
      }
      continue;
    }
    // S = Q K^T, D / 16 steps; both tiles K-major
"""),
]

# (name, source, [(text, replacement)]): each cut of the redesigned kernels
ABLATIONS = (
    ("k1_four_ctas", "percentile.cu",
     [("constexpr int kPnMaxCluster = 8;", "constexpr int kPnMaxCluster = 4;")]),
    ("k1_waves_ignored", "percentile.cu",
     [("(p.staged == best->staged && waves < best_waves)", "false")]),
    ("k1_one_cta", "percentile.cu",
     [("for (int c = kPnMaxCluster; c >= 1; c /= 2)", "for (int c = 1; c >= 1; c /= 2)")]),
    ("k1_streamed", "percentile.cu",
     [("PnPlan p{c, 0, whole && slice <= kPnMaxStage, 0};", "PnPlan p{c, 0, false, 0};")]),
    ("k1_unshared", "percentile.cu",
     [("const bool same = br[0].s == br[1].s", "const bool same = false && br[0].s == br[1].s")]),
    ("k1_no_list", "percentile.cu",
     [("listed = pn_compact(sh, pn_stage, xi, first, count, staged, br, iters);",
       "listed = false;")]),
    ("k1_no_stores", "percentile.cu",
     [("out[j] = pack_unit<T>(v);", "if (v[0] == 12345.0f) out[j] = pack_unit<T>(v);")]),
    ("k12_one_at_a_time", "percentile.cu",
     [("      const float v[4] = {u.x, u.y, u.z, u.w};\n"
       "      count_values<!kFirst>(v, br, scale, cut, sh.cand[0], sh.bnd[0], wh, below);",
       "      const float v0[1] = {u.x}, v1[1] = {u.y}, v2[1] = {u.z}, v3[1] = {u.w};\n"
       "      count_values<!kFirst>(v0, br, scale, cut, sh.cand[0], sh.bnd[0], wh, below);\n"
       "      count_values<!kFirst>(v1, br, scale, cut, sh.cand[0], sh.bnd[0], wh, below);\n"
       "      count_values<!kFirst>(v2, br, scale, cut, sh.cand[0], sh.bnd[0], wh, below);\n"
       "      count_values<!kFirst>(v3, br, scale, cut, sh.cand[0], sh.bnd[0], wh, below);")]),
    ("k15_no_prefetch", "clahe.cu",
     [("cp.async.wait_group 1;", "cp.async.wait_group 0;")]),
    ("k15_scalar", "clahe.cu", [("a.vec = a.w % 4 == 0 &&", "a.vec = false &&")]),
    ("k15_one_block_sm", "clahe.cu",
     [("static_cast<long long>(std::max(per_sm, 1)) * kSMs", "static_cast<long long>(kSMs)")]),
    ("k15_no_lut_copies", "clahe.cu",
     [("for (int i = threadIdx.x; i < n16; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);",
       "(void)src;\n    (void)dst;\n    (void)n16;")]),
    ("k8_table_smem", "window_attention.cu", K8_TABLE_SMEM),
    ("k8_three_stages", "window_attention.cu",
     [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    ("k8_three_ctas", "window_attention.cu",
     [("constexpr int kMinCtas = 4;", "constexpr int kMinCtas = 3;")]),
    ("k8_tf32_core", "window_attention.cu", K8_TF32_CORE),
)

# kernel 1 with a clock64() stamp by thread 0 of every CTA at each phase's
# end: a build that only times (PHASES names the gaps between stamps)
STAMPS = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_stamp[1 << 16];\n"
     "__device__ __forceinline__ void stamp(int i) {\n"
     "  if (threadIdx.x != 0) return;\n"
     "  g_stamp[blockIdx.x * 64 + i] = clock64();\n"
     "  unsigned long long t;\n"
     "  unsigned sm;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "  if (i == 0) g_stamp[blockIdx.x * 64 + 60] = t;\n"
     "  if (i == 41) g_stamp[blockIdx.x * 64 + 61] = t;\n"
     "  g_stamp[blockIdx.x * 64 + 62] = sm;\n}\n"
     "TT_EXPORT int tt_stamps(void* out, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamp, static_cast<size_t>(n) * 8));\n"
     "}\n"),
    ("  T* yi = y + static_cast<size_t>(img) * n;\n",
     "  T* yi = y + static_cast<size_t>(img) * n;\n  stamp(0);\n"),
    ("  block_stats<false>(mn, mx, unused, sh.red_a, sh.red_b, nullptr);\n",
     "  block_stats<false>(mn, mx, unused, sh.red_a, sh.red_b, nullptr);\n  stamp(1);\n"),
    ("  Bracket br[2] = {{sh.gmn, sh.gmx, 0, 0, 0}, {sh.gmn, sh.gmx, 0, 0, 0}};\n",
     "  stamp(2);\n  int st = 3;\n  Bracket br[2] = {{sh.gmn, sh.gmx, 0, 0, 0}, {sh.gmn, sh.gmx, 0, 0, 0}};\n"),
    ("    set_candidates<2>(br, iters, sh.cand, sh.bnd);\n",
     "    set_candidates<2>(br, iters, sh.cand, sh.bnd);\n    stamp(st++);\n"),
    ("      pn_count<false>(sh, pn_stage, xi, first, count, staged, br, same, list);\n"
     "    __syncthreads();\n",
     "      pn_count<false>(sh, pn_stage, xi, first, count, staged, br, same, list);\n"
     "    __syncthreads();\n    stamp(st++);\n"),
    ("    cluster.sync();\n    if (j < k) {  // the cluster's counts, ranks in order\n      const int src",
     "    cluster.sync();\n    stamp(st++);\n    if (j < k) {  // the cluster's counts, ranks in order\n"
     "      const int src"),
    ("    prefix<2>(sh.cnt, br, sh.wscan);\n", "    prefix<2>(sh.cnt, br, sh.wscan);\n    stamp(st++);\n"),
    ("    settle<2>(br, sh.cnt, sh.cand, targets, sh.flip);\n",
     "    settle<2>(br, sh.cnt, sh.cand, targets, sh.flip);\n    stamp(st++);\n"),
    ("yi[i] = from_f32<T>(scaled(to_f32(xi[i])));\n  }\n",
     "yi[i] = from_f32<T>(scaled(to_f32(xi[i])));\n  }\n  stamp(40);\n"),
    ("  cluster.sync();  // peers may still read this CTA's counts\n}\n\nstruct PnPlan",
     "  cluster.sync();  // peers may still read this CTA's counts\n  stamp(41);\n}\n\nstruct PnPlan"),
)
PHASES = ["stage, min and max", "cluster extremes"] + [
    f"pass {p} {what}" for p in (1, 2, 3)
    for what in ("list + candidates" if p == 2 else "candidates", "count", "sum + cluster.sync",
                 "remote reads + prefix", "settle")] \
    + ["clip, scale, store", "final cluster.sync"]


def phases() -> dict:
    """Kernel 1's stamps (the STAMPS build, first on sys.path) on
    percentile_batch(32, ...) in float32 and bf16: per phase the median and
    the largest gap in cycles over the CTAs."""
    import ctypes
    import importlib.util

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from thyroid_tpu_torch.ops import _build, percentile

    read = _build.function("percentile", "tt_stamps", [ctypes.c_void_p, ctypes.c_int])
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = cs.percentile_batch(32, dt)
        ctas = 32 * percentile.percentile_normalize_launch(x)["cluster"]
        for _ in range(2):
            percentile.fused_percentile_normalize(x)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (ctas * 64))()
        _build.check("percentile", read(buf, ctas * 64), "tt_stamps")
        t = np.array(buf, dtype=np.int64).reshape(ctas, 64)
        marks = [0, 1, 2] + list(range(3, 18)) + [40, 41]
        gaps = np.diff(t[:, marks], axis=1)
        csize = ctas // 32
        start, end, sm = t[:, 60], t[:, 61], t[:, 62]
        skew = (start.reshape(32, csize).max(1) - start.reshape(32, csize).min(1))
        worst = int(np.argmax(end.reshape(32, csize).max(1) - start.min()))
        shared_sm = sum(len(set(sm[c * csize:(c + 1) * csize])) < csize for c in range(32))
        out[str(dt)[6:]] = {"total cycles": [int(np.median(t[:, 41] - t[:, 0])),
                                             int((t[:, 41] - t[:, 0]).max())],
                            **{name: [int(np.median(g)), int(g.max())]
                               for name, g in zip(PHASES, gaps.T)},
                            "cluster start skew ns": [int(np.median(skew)), int(skew.max())],
                            "CTA start ns after the first": sorted(int(v) for v in start - start.min())[::max(1, ctas // 16)],
                            "last cluster": worst,
                            "its CTAs' start ns": [int(v) for v in start[worst * csize:(worst + 1) * csize] - start.min()],
                            "its CTAs' end ns": [int(v) for v in end[worst * csize:(worst + 1) * csize] - start.min()],
                            "its CTAs' gaps": gaps[worst * csize:(worst + 1) * csize].tolist(),
                            "clusters with two CTAs on one SM": shared_sm}
    return out


def predict_times() -> dict:
    """Wall time of InferenceEngine.predict (swin_tiny bf16, the smoke's
    seeded weights) on raw 512x512 frames, with and without the quality
    pipeline, at buckets 32 and 128: the median of 9 calls after 2, in ms."""
    import importlib.util
    import statistics as stats
    import time as clock

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    params = cs.perturbed_params(cs.SWIN_TINY)
    frames = cs.quality_frames()
    out = {}
    for quality in (False, True):
        engine = InferenceEngine(cs.SWIN_TINY, params=params, quality=quality)
        engine.warmup()
        for n in (32, 128):
            x = np.tile(frames, (n // len(frames), 1, 1))[..., None]
            secs = []
            for i in range(11):
                t0 = clock.perf_counter()
                engine.predict(x)
                torch.cuda.synchronize()
                if i >= 2:
                    secs.append((clock.perf_counter() - t0) * 1e3)
            out[f"predict quality={quality} bucket {n}"] = stats.median(secs)
        del engine
    return out


def measure_window(cs, timed, out) -> None:
    """Row 8 (fused_window_attention) in bf16 and float32 at each of
    window_shapes() and summed over a swin_tiny forward at batch 32, SDPA
    on the same bf16 inputs, and the SHA-256 of row 8's outputs and of
    kernels 4-7's at swin_tiny's block shapes."""
    import torch

    from thyroid_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(8)
    counts = cs.swin_tiny_shapes(cs.BATCH)["swin_block_attention"]
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        whats = ("window_attention", "sdpa") if dt == torch.bfloat16 else ("window_attention",)
        for shape in cs.window_shapes():
            args = cs.window_inputs(shape, dt, gen)
            timed(f"window_attention {name} {shape}",
                  lambda args=args: attention.fused_window_attention(*args))
            if "sdpa" in whats:
                timed(f"sdpa {name} {shape}", cs.window_library(args))
        for what in whats:
            out["ms"][f"{what} {name} per forward"] = sum(
                count * out["ms"][f"{what} {name} {shape}"] for shape, count in counts.items())
    out["sha256"].update(cs.window_hashes())
    out["sha256"].update(cs.swin_attention_hashes())
    out["sha256"].update(cs.ln_attention_hashes())


def measure(kernels: str) -> dict:
    """The measurements of the tree first on sys.path (run in its process):
    `kernels` is "all", "k1", "k8", "k12" or "k15"."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from thyroid_tpu_torch.ops import clahe, percentile, stencil

    out = {"tree": str(Path(percentile.__file__).resolve().parents[2]), "ms": {}, "events_ms": {},
           "sha256": {}}

    def timed(name, fn):
        fn()
        out["ms"][name] = cs.device_ms(fn)
        out["events_ms"][name] = cs.median_ms(fn)

    if kernels in ("all", "k1"):
        for b, dt in cs.PERCENTILE_CASES:
            x = cs.percentile_batch(b, dt)
            timed(f"percentile {str(dt)[6:]} b{b}", lambda x=x: percentile.fused_percentile_normalize(x))
        x = cs.percentile_batch(32, torch.float32)
        for iters in (0, 8, 16):  # the staging, extremes and output; one and two counting passes
            timed(f"percentile float32 b32 iters {iters}",
                  lambda iters=iters: percentile.fused_percentile_normalize(x, iters=iters))
        out["sha256"].update(cs.percentile_hashes())
    if kernels == "k12":
        chunk = torch.from_numpy(cs.quality_frames()[..., None]).cuda()
        timed("stats_quantile", lambda: percentile.fused_stats_quantile(chunk, 0.999))
        out["sha256"].update(cs.output_hashes(chunk))
    if kernels in ("all", "k15"):
        frames = cs.quality_frames()
        chunk = torch.from_numpy(frames[..., None]).cuda()
        x8c, luts, luts_c, luts_f, sel = cs.clahe_inputs(chunk)
        timed("apply_luts_dual", lambda: clahe.apply_luts_dual(x8c, luts_c, luts_f, sel,
                                                               (16, 16), (32, 32)))
        for g, lut in luts.items():
            timed(f"apply_luts {g[0]}x{g[1]}", lambda g=g, lut=lut: clahe.apply_luts(x8c, lut, g))
        xd, use_coarse, apply = cs.dual_fused_case(frames)
        img, lo, span, x8 = clahe._to_8bit(xd)
        lc, lf = clahe._dual_luts(x8, **cs.DUAL_GRIDS)
        kargs = (x8, img.contiguous(), lc, lf, use_coarse, apply, lo.reshape(-1),
                 span.reshape(-1), cs.DUAL_GRIDS["grid_coarse"], cs.DUAL_GRIDS["grid_fine"])
        timed("apply_luts_dual_fused", lambda: clahe.apply_luts_dual_fused(*kargs))
        if kernels == "all":
            timed("stats_quantile", lambda: percentile.fused_stats_quantile(chunk, 0.999))
            q = percentile.stats_quantile_plain(chunk, 0.999)["quantile"]
            x8s = torch.floor(torch.minimum(torch.clamp(chunk, min=0.0),
                                            q.reshape(-1, 1, 1, 1)) / 256.0)
            timed("median_bilateral", lambda: stencil.fused_median_bilateral(x8s))
        out["sha256"].update(cs.output_hashes(chunk))
    if kernels in ("all", "k8"):
        measure_window(cs, timed, out)
    if kernels == "all":
        gen = torch.Generator(device="cuda").manual_seed(5)
        total = 0.0
        for shape, count in cs.swin_tiny_shapes(cs.BATCH)["swin_block_attention"].items():
            args = cs.ln_attention_inputs(shape, torch.bfloat16, gen)
            fused = cs.remaining_fns("swin_ln_attention", shape)[0]
            total += count * cs.device_ms(lambda: fused(*args))
        out["ms"]["swin_ln_attention per forward"] = total
        out["sha256"].update(cs.ln_attention_hashes())
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip()
    return out


def run_tree(tree: Path, kernels: str) -> dict:
    """measure(kernels) (or phases() for "phases") in a fresh process with
    `tree` first on sys.path."""
    call = {"phases": "phases()", "predict": "predict_times()"}.get(kernels,
                                                                   f"measure({kernels!r})")
    # this file by path: a parent tree may hold a chip_compare.py of its own
    code = (f"import sys, json, importlib.util; sys.path.insert(0, {str(tree)!r}); "
            f"spec = importlib.util.spec_from_file_location('chip_compare', "
            f"{str(HERE / 'chip_compare.py')!r}); "
            f"chip_compare = importlib.util.module_from_spec(spec); "
            f"spec.loader.exec_module(chip_compare); "
            f"print('RESULT ' + json.dumps(chip_compare.{call}), flush=True)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(tree), timeout=1800)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"measurement in {tree} failed (exit {proc.returncode})")
    result = json.loads(lines[-1][len("RESULT "):])
    print(f"[compare] {tree.name}: {json.dumps(result)}", flush=True)
    return result


def ablation_tree(name: str, source: str, edits) -> Path:
    """A copy of this tree's package with `source` edited, its other
    kernels' libraries copied from this tree's build (same hashes)."""
    root = HERE / "build" / "ablate" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "thyroid_tpu_torch", root / "thyroid_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / "thyroid_tpu_torch" / "csrc" / source
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation {name}: {old!r} is not in {source} once")
        text = text.replace(old, new)
    src.write_text(text)
    built = HERE / "build" / "thyroid_tpu_torch"
    (root / "build" / "thyroid_tpu_torch").mkdir(parents=True)
    for lib in built.glob("lib*.so"):
        if not lib.name.startswith(f"lib{Path(source).stem}-"):
            shutil.copy2(lib, root / "build" / "thyroid_tpu_torch" / lib.name)
    return root


def run_smoke(tree: Path, log: Path) -> dict:
    """The tree's own chip_smoke.py, its output into log."""
    start = time.perf_counter()
    with open(log, "w") as sink:
        code = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tree), stdout=sink,
                              stderr=subprocess.STDOUT, timeout=1800).returncode
    result = {"log": str(log), "exit": code, "seconds": time.perf_counter() - start}
    print(f"[compare] smoke of {tree.name}: {json.dumps(result)}", flush=True)
    return result


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--smokes", type=Path, default=None)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--predict-pairs", type=int, default=0)
    ap.add_argument("--kernels", default="all", choices=("all", "k1", "k8", "k12", "k15"),
                    help="what the four turns measure, and with --ablate whose cuts")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    parent = opt.parent.resolve()
    turns = ((parent, "parent"), (HERE, "change"), (HERE, "change"), (parent, "parent"))
    summary = {"trees": [name for _, name in turns]}
    if opt.smokes is not None:
        opt.smokes.mkdir(parents=True, exist_ok=True)
        summary["smokes"] = [run_smoke(tree, opt.smokes.resolve() / f"smoke_{i}_{name}.log")
                             for i, (tree, name) in enumerate(turns)]
    runs = [run_tree(tree, opt.kernels) for tree, _ in turns]
    summary.update({"card": runs[0]["card"],
                    "ms": {k: [r["ms"].get(k) for r in runs] for k in runs[1]["ms"]},
                    "events_ms": {k: [r["events_ms"].get(k) for r in runs]
                                  for k in runs[1]["events_ms"]},
                    "sha256_equal": {k: len({r["sha256"].get(k) for r in runs}) == 1
                                     for k in runs[1]["sha256"]}})
    if opt.predict_pairs:
        # pairs in alternating order: parent first, then this tree first
        order = [t for i in range(opt.predict_pairs)
                 for t in ((parent, "parent"), (HERE, "change"))[::1 if i % 2 == 0 else -1]]
        timed = [(name, run_tree(tree, "predict")) for tree, name in order]
        summary["predict_ms"] = {
            k: {side: [r[k] for n, r in timed if n == side] for side in ("parent", "change")}
            for k in timed[0][1]}
    if opt.phases:
        summary["phases"] = run_tree(ablation_tree("k1_stamps", "percentile.cu", STAMPS), "phases")
    if opt.ablate:
        # per kernel: this tree, each cut, this tree again
        summary["ablations"] = {}
        for group in ("k1", "k8", "k12", "k15"):
            if opt.kernels not in ("all", group):
                continue
            cuts = [(name, source, edits) for name, source, edits in ABLATIONS
                    if name.split("_")[0] == group]
            first = run_tree(HERE, group)
            results = [(name, run_tree(ablation_tree(name, source, edits), group))
                       for name, source, edits in cuts]
            last = run_tree(HERE, group)
            for name, cut in results:
                summary["ablations"][name] = {
                    k: {"change": statistics.mean([first["ms"][k], last["ms"][k]]),
                        "cut": cut["ms"][k]} for k in cut["ms"]}
                summary["ablations"][name]["sha256_equal"] = cut["sha256"] == first["sha256"]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
