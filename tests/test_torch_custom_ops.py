"""The port's kernel entry points as `thyroid_tpu_torch::` ops, on the CPU:
`torch.library.opcheck` of each op on small inputs (its schema, its fake
implementation against the plain version, its autograd registration and
its compiled dispatch with dynamic shapes), each public wrapper on meta
tensors returning what the fake gives, every op with its CPU, CUDA and
fake implementations, and no wrapper choosing a path by the device."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.ops import (attention, clahe, depthwise_pallas,
                                   percentile, stencil, token_fused)

ROOT = Path(__file__).resolve().parents[1]
OPS = {
    "percentile_normalize": percentile._percentile_op,
    "stats_quantile": percentile._stats_op,
    "ln_matmul": token_fused._ln_matmul_op,
    "ln_mlp": token_fused._ln_mlp_op,
    "ln_matmul_bwd": token_fused._ln_matmul_bwd_op,
    "ln_mlp_bwd_dx": token_fused._ln_mlp_bwd_dx_op,
    "ln_mlp_bwd_dw": token_fused._ln_mlp_bwd_dw_op,
    "ln_mlp_bwd": token_fused._ln_mlp_bwd_op,
    "window_attention": attention._window_op,
    "swin_attention": attention._swin_fwd_op,
    "swin_attention_bwd": attention._swin_bwd_op,
    "swin_block_attention": attention._block_op,
    "swin_ln_attention": attention._ln_attention_op,
    "median_bilateral": stencil._stencil_op,
    "apply_luts": clahe._single_op,
    "apply_luts_dual": clahe._dual_op,
    "apply_luts_dual_fused": clahe._fused_op,
    "depthwise_conv2d": depthwise_pallas._dw_op,
}
# every kernel of PERF.md's table: 17 ops, and kernels 10 + 11 in one for
# the train step's backward
assert len(OPS) == 18


def _inputs(seed: int = 0):
    """Named small CPU tensors that every op below takes."""
    rs = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * scale)
                                .astype(np.float32))

    def ints(*shape, hi=256):
        return torch.from_numpy(rs.randint(0, hi, shape).astype(np.float32))

    heads, ws = 2, 4
    n = ws * ws
    mask = torch.from_numpy(np.where(rs.rand(4, n, n) < 0.2, -100.0, 0.0)
                            .astype(np.float32))
    return {
        "img": torch.from_numpy((rs.rand(2, 16, 16, 1) * 65535).astype(np.float32)),
        "x": t(6, 8), "g": 1 + t(8, scale=0.1), "b": t(8, scale=0.1),
        "w": t(8, 12, scale=0.3), "wb": t(12, scale=0.1),
        "w1": t(8, 32, scale=0.3), "b1": t(32, scale=0.1),
        "w2": t(32, 8, scale=0.2), "b2": t(8, scale=0.1),
        "dy12": t(6, 12), "dy8": t(6, 8),
        "q": t(8, heads, n, 4), "k": t(8, heads, n, 4), "v": t(8, heads, n, 4),
        "bias": t(heads, n, n, scale=0.5), "mask": mask,
        "qkv": t(1, 8, 8, 3, 8), "dout": t(1, 8, 8, 8), "res": t(1, 8, 8, 8),
        "proj": t(8, 8, scale=0.3), "pbias": t(8, scale=0.1),
        "stream": t(1, 8, 8, 8), "qkvw": t(8, 24, scale=0.3),
        "qkvb": t(24, scale=0.1),
        "x8": ints(2, 12, 12, 1), "bins": ints(2, 16, 16),
        "luts_c": ints(2, 2, 2, 256), "luts_f": ints(2, 4, 4, 256),
        "coarse": torch.tensor([True, False]), "apply": torch.tensor([False, True]),
        "frames": ints(2, 16, 16, hi=65536), "lo": ints(2, hi=100),
        "span": ints(2, hi=60000),
        "dwx": t(2, 6, 6, 4), "dww": t(4, 1, 3, 3, scale=0.3),
    }


def op_args(name: str, a):
    """(args) of op `name` from the tensors `a`."""
    scale = 0.5
    return {
        "percentile_normalize": (a["img"], 1.0, 99.0, 22, 1e-8),
        "stats_quantile": (a["img"], 0.999, 22),
        "ln_matmul": (a["x"], a["g"], a["b"], a["w"], a["wb"], 1e-5),
        "ln_mlp": (a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"], a["b2"],
                   1e-5, True),
        "ln_matmul_bwd": (a["x"], a["g"], a["w"], a["dy12"], 1e-5),
        "ln_mlp_bwd_dx": (a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"],
                          a["dy8"], True, 1e-5),
        "ln_mlp_bwd_dw": (a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"],
                          a["dy8"], 1e-5),
        "ln_mlp_bwd": (a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"],
                       a["dy8"], False, 1e-5),
        "window_attention": (a["q"], a["k"], a["v"], a["bias"], a["mask"][:2],
                             scale),
        "swin_attention": (a["qkv"], a["bias"], a["mask"], 4, 2, scale),
        "swin_attention_bwd": (a["qkv"], a["dout"], a["bias"], a["mask"], 4, 2,
                               scale),
        "swin_block_attention": (a["qkv"], a["res"], a["proj"], a["pbias"],
                                 a["bias"], a["mask"], 4, 2, scale),
        "swin_ln_attention": (a["stream"], a["g"], a["b"], a["qkvw"], a["qkvb"],
                              a["bias"], a["mask"], 4, 2, scale, 1e-5),
        "median_bilateral": (a["x8"], 5, 50.0, 50.0),
        "apply_luts": (a["bins"], a["luts_f"], [4, 4]),
        "apply_luts_dual": (a["bins"], a["luts_c"], a["luts_f"], a["coarse"],
                            [2, 2], [4, 4]),
        "apply_luts_dual_fused": (a["bins"], a["frames"], a["luts_c"],
                                  a["luts_f"], a["coarse"], a["apply"],
                                  a["lo"], a["span"], [2, 2], [4, 4]),
        "depthwise_conv2d": (a["dwx"], a["dww"]),
    }[name]


@pytest.mark.unit
@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck(name):
    """All four of opcheck's default checks: test_schema,
    test_autograd_registration (the first input requires grad; an op has
    no derivative of its own, so its outputs must not require one),
    test_faketensor and test_aot_dispatch_dynamic."""
    args = list(op_args(name, _inputs()))
    args[0] = args[0].clone().requires_grad_()
    out = torch.library.opcheck(OPS[name], tuple(args))
    assert set(out.values()) == {"SUCCESS"}, out


def _wrapper_calls(a):
    """(name, call) of each public wrapper on the tensors `a`."""
    kw = dict(window_size=4, num_heads=2)
    return {
        "fused_percentile_normalize": lambda: percentile.fused_percentile_normalize(a["img"]),
        "fused_stats_quantile": lambda: percentile.fused_stats_quantile(a["img"], 0.999),
        "fused_ln_matmul": lambda: token_fused.fused_ln_matmul(
            a["x"].reshape(2, 3, 8), a["g"], a["b"], a["w"], a["wb"]),
        "fused_ln_mlp_residual": lambda: token_fused.fused_ln_mlp_residual(
            a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"], a["b2"]),
        "fused_ln_mlp": lambda: token_fused.fused_ln_mlp(
            a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"], a["b2"]),
        "fused_ln_matmul_bwd": lambda: token_fused.fused_ln_matmul_bwd(
            a["x"], a["g"], a["w"], a["dy12"]),
        "fused_ln_mlp_bwd_dx": lambda: token_fused.fused_ln_mlp_bwd_dx(
            a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"], a["dy8"],
            residual=True),
        "fused_ln_mlp_bwd_dw": lambda: token_fused.fused_ln_mlp_bwd_dw(
            a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"], a["dy8"]),
        "ln_mlp_bwd": lambda: token_fused.ln_mlp_bwd(
            a["x"], a["g"], a["b"], a["w1"], a["b1"], a["w2"], a["dy8"],
            residual=False),
        "fused_window_attention": lambda: attention.fused_window_attention(
            a["q"], a["k"], a["v"], a["bias"], a["mask"][:2]),
        "fused_swin_attention": lambda: attention.fused_swin_attention(
            a["qkv"], a["bias"], a["mask"], **kw),
        "fused_swin_attention_bwd": lambda: attention.fused_swin_attention_bwd(
            a["qkv"], a["dout"], a["bias"], a["mask"], scale=0.5, **kw),
        "fused_swin_block_attention": lambda: attention.fused_swin_block_attention(
            a["qkv"], a["res"], a["proj"], a["pbias"], a["bias"], a["mask"], **kw),
        "fused_swin_ln_attention": lambda: attention.fused_swin_ln_attention(
            a["stream"], a["g"], a["b"], a["qkvw"], a["qkvb"], a["bias"],
            a["mask"], **kw),
        "fused_median_bilateral": lambda: stencil.fused_median_bilateral(a["x8"]),
        "apply_luts": lambda: clahe.apply_luts(a["bins"], a["luts_f"], (4, 4)),
        "apply_luts_dual": lambda: clahe.apply_luts_dual(
            a["bins"], a["luts_c"], a["luts_f"], a["coarse"], (2, 2), (4, 4)),
        "apply_luts_dual_fused": lambda: clahe.apply_luts_dual_fused(
            a["bins"], a["frames"], a["luts_c"], a["luts_f"], a["coarse"],
            a["apply"], a["lo"], a["span"], (2, 2), (4, 4)),
        "depthwise_conv2d_pallas": lambda: depthwise_pallas.depthwise_conv2d_pallas(
            a["dwx"], a["dww"]),
    }


def _leaves(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.unit
@pytest.mark.parametrize("name", sorted(_wrapper_calls(_inputs())))
def test_wrapper_on_meta_tensors(name):
    """Each public wrapper on meta tensors returns the fake result: the
    CPU result's shapes, dtypes and strides, no data and no launch."""
    a = _inputs()
    want = _leaves(_wrapper_calls(a)[name]())
    meta = {k: v.to("meta") for k, v in a.items()}
    before = launch_counts()
    got = _leaves(_wrapper_calls(meta)[name]())
    assert launch_counts() == before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype, w.stride())


def launch_counts():
    fns = (percentile.fused_percentile_normalize, percentile.fused_stats_quantile,
           token_fused.fused_ln_matmul, token_fused.fused_ln_mlp_residual,
           token_fused.fused_ln_mlp, token_fused.fused_ln_matmul_bwd,
           token_fused.fused_ln_mlp_bwd_dx, token_fused.fused_ln_mlp_bwd_dw,
           attention.fused_window_attention, attention.fused_swin_block_attention,
           attention.fused_swin_ln_attention, stencil.fused_median_bilateral,
           clahe.apply_luts, clahe.apply_luts_dual, clahe.apply_luts_dual_fused,
           depthwise_pallas.depthwise_conv2d_pallas)
    return ([f.launches for f in fns] + [attention.fused_swin_attention.launches,
                                         attention.fused_swin_attention.bwd_launches])


@pytest.mark.unit
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_has_cpu_cuda_and_fake(name):
    """`thyroid_tpu_torch::<name>` carries a CPU, a CUDA and a fake (Meta)
    kernel, and autograd falls through it; a CPU call launches nothing."""
    qual = f"thyroid_tpu_torch::{name}"
    assert OPS[name].name() == qual
    for key in ("CPU", "CUDA", "Meta", "Autograd"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), key
    before = launch_counts()
    OPS[name](*op_args(name, _inputs()))
    assert launch_counts() == before


@pytest.mark.unit
def test_no_wrapper_selects_by_device():
    """Only the dispatcher chooses between a kernel and its plain version:
    no module of ops/ tests a tensor's device type, and a device that is
    neither the CPU nor CUDA still raises."""
    for path in sorted((ROOT / "thyroid_tpu_torch" / "ops").glob("*.py")):
        src = path.read_text()
        assert not re.search(r"device\.type|\.is_cuda\b|\.is_cpu\b", src), path
    a = _inputs()
    with pytest.raises(NotImplementedError):
        OPS["percentile_normalize"](
            a["img"].to_sparse(), 1.0, 99.0, 22, 1e-8)
