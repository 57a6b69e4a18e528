"""How far float32 can hold densenet121's norm0.scale gradient, on the CPU.

The stem's output reaches the loss only through train-mode BatchNorms, so
the loss does not change when norm0's scale s and bias b grow together,
and ∂L/∂s = Σ g·x̂ over every stem position is a sum whose terms cancel.
This prints, for the port's densenet121 (float32, chip_smoke.py's bumped
initial weights, a batch drawn as chip_smoke.py's zoo_step draws it):

- the cancellation Σ|g·x̂| / |Σ g·x̂| per channel (median and largest);
- |s·∂L/∂s + b·∂L/∂b| / (|s·∂L/∂s| + |b·∂L/∂b|);
- the float32 gradient against the float64 sum of its own terms;
- every leaf's gradient from a step on `--threads` CPU threads against
  one on a single thread, on the first step's ReLU decisions and
  max-pool choices: the five furthest apart.

    python scripts/torch_grad_condition.py --side 224 --batch 2
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from thyroid_tpu_torch.models.base import create_and_init  # noqa: E402
from thyroid_tpu_torch.models.cnn import densenet  # noqa: E402
from thyroid_tpu_torch.models.from_jax import to_jax_variables  # noqa: E402


def step(cfg, variables, batch, threads: int, **decisions):
    """chip_smoke's CPU step, with norm0's output and its gradient."""
    torch.set_num_threads(threads)
    seen = {}

    def hook(mod, args, out):
        seen["y"] = out
        out.register_hook(lambda g: seen.__setitem__("g", g))

    forward = densenet.DenseNet.forward

    def watched(self, *args, **kw):
        handle = self.norm0.register_forward_hook(hook)
        try:
            return forward(self, *args, **kw)
        finally:
            handle.remove()

    densenet.DenseNet.forward = watched
    try:
        with cs.step_decisions(**decisions):
            out = cs.effnet_step(cfg, variables, batch, "cpu")
    finally:
        densenet.DenseNet.forward = forward
    return out, seen["y"].detach().double(), seen["g"].double()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=224)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    cfg = cs.zoo_config("densenet121", "f32", dropout_rate=0.0,
                        drop_path_rate=0.0, img_size=args.side)
    init = to_jax_variables(create_and_init(cfg, seed=0, device="cpu"))
    variables = {"params": cs.bump(init["params"]),
                 "batch_stats": init["batch_stats"]}
    rs = np.random.RandomState(28)
    batch = (rs.randn(args.batch, args.side, args.side, 1).astype(np.float32),
             (np.arange(args.batch) % 2).astype(np.int64),
             np.ones(args.batch, np.float32))
    record = []
    first, y, g = step(cfg, variables, batch, args.threads, record=record)
    norm0 = variables["params"]["norm0"]
    s = torch.from_numpy(np.asarray(norm0["scale"])).double()
    b = torch.from_numpy(np.asarray(norm0["bias"])).double()
    terms = (g * (y - b) / s).flatten(0, 2)
    exact = terms.sum(0)
    cancel = terms.abs().sum(0) / exact.abs()
    gs, gb = first[1]["norm0.scale"].double(), first[1]["norm0.bias"].double()
    print(f"densenet121 f32, batch {args.batch} at {args.side}x{args.side}")
    print(f"norm0.scale: sum|t| / |sum t| per channel median "
          f"{float(cancel.median()):.4e}, largest {float(cancel.max()):.4e}")
    print(f"|s·dL/ds + b·dL/db| / (|s·dL/ds| + |b·dL/db|) "
          f"{float((s * gs + b * gb).norm() / ((s * gs).norm() + (b * gb).norm())):.4e}")
    print(f"float32 dL/ds against the float64 sum of its terms "
          f"{float((gs - exact).norm() / exact.norm()):.4e}")
    flips = []
    again = step(cfg, variables, batch, 1, impose=record, flips=flips)[0]
    leaves = {n: float((first[1][n] - v).norm() / v.norm())
              for n, v in again[1].items() if float(v.norm()) > 0}
    print(f"{args.threads} threads against 1 on the first step's decisions "
          f"({sum(f for f, _ in flips)} the other way): |grad diff| / |grad| "
          f"{cs.step_agreement(first[:2], again[:2])[1]:.4e}")
    for n in sorted(leaves, key=leaves.get)[-5:]:
        print(f"  {n} {leaves[n]:.4e}")


if __name__ == "__main__":
    main()
