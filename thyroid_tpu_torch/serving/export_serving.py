"""Export a model to a serving bundle (counterpart of
scripts/export_serving.py).

The bundle (manifest, one weights file, one torch.export program per batch
bucket) serves without the model code: serving/export.py.

Usage:
  python -m thyroid_tpu_torch.serving.export_serving --checkpoint runs/.../best.ckpt --out bundle/
  python -m thyroid_tpu_torch.serving.export_serving --model swin_tiny --out bundle/ \\
      --buckets 1 8 32 [--quality] [--preprocessed]
Beside the script's arguments, `--device` (the card unless "cpu" is given):
the device the programs are traced on; a bundle serves on either.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thyroid_tpu_torch.serving.export_serving",
        description="Export a model to a torch.export serving bundle")
    p.add_argument("--checkpoint", default=None,
                   help="port checkpoint (uses its model_config)")
    p.add_argument("--model", default=None,
                   help="model name for a fresh-init export (no checkpoint)")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--out", required=True, help="output bundle directory")
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32, 128])
    p.add_argument("--quality", action="store_true",
                   help="include the quality-aware preprocess in the graph")
    p.add_argument("--preprocessed", action="store_true",
                   help="inputs are already img_size squares (skip the "
                        "raw 512-square preprocess)")
    p.add_argument("--device", default=None,
                   help='"cpu" for the CPU; the CUDA card otherwise')
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = parser()
    args = p.parse_args(argv)
    if (args.checkpoint is None) == (args.model is None):
        p.error("pass exactly one of --checkpoint / --model")

    from .engine import InferenceEngine
    from .export import export_engine

    mcfg = None
    if args.model is not None:
        mcfg = {"name": args.model, "img_size": args.img_size,
                "in_channels": 1, "num_classes": 2}
    engine = InferenceEngine(
        model_config=mcfg, checkpoint=args.checkpoint, buckets=args.buckets,
        quality=args.quality, raw_inputs=not args.preprocessed,
        device=args.device)
    manifest = export_engine(engine, args.out, buckets=args.buckets)
    print(json.dumps({"out": args.out, "buckets": manifest["buckets"],
                      "artifacts": len(manifest["artifacts"])}))


if __name__ == "__main__":
    main()
