"""Serving export: one `torch.export` program per batch bucket (counterpart
of thyroid_tpu/serving/export.py).

A serving engine exports to a self-describing bundle:

    out_dir/
      manifest.json   model and preprocessing metadata, the artifacts
      weights.pt      the model's parameters and buffers, name → tensor,
                      shared by every bucket
      bucket_<B>.pt2  the torch.export program of batch bucket B

Each bucket program is the whole serving program of
`InferenceEngine.program` (raw-frame preparation, quality-aware where the
engine has `quality` → gray→RGB → standardisation → the model, in int8
where the engine quantizes → float32 softmax), traced as a function of
(weights, frames), so that the programs hold no weights of their own. The
kernels appear in it as `thyroid_tpu_torch::` ops, which the dispatcher
sends to the CUDA kernel or to the plain version by the tensors' device:
`load_exported(out_dir)` serves a bundle with `ops/` and this module alone
(no model registry, model code or config tree), on the card by default or
on the CPU when asked, whichever device exported it.

Where JAX lowers StableHLO per platform and passes its variables in one
params.npz, the port keeps one program per bucket for every device:
`torch.export.passes.move_to_device_pass` moves a program and its
constants to the serving device at load time. Mesh-sharded engines are not
exportable, as in JAX.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

# the ops' definitions, which torch.export.load needs before it reads a program
from ..ops import (attention, clahe, depthwise_pallas, percentile,  # noqa: F401
                   stencil, token_fused)
from ..ops.platform import DeviceLike, resolve_device

FORMAT = "thyroid_tpu_torch.serving.export/v1"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"


class _BucketProgram(torch.nn.Module):
    """engine.program as a function of (weights, frames). The engine is
    held outside the module tree, so that the traced program lifts none of
    the model's tensors."""

    def __init__(self, engine: Any):
        super().__init__()
        self._engine = [engine]

    def forward(self, variables: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        engine = self._engine[0]
        return engine.program(x, lambda t: torch.func.functional_call(
            engine.model, variables, (t,)))


def export_engine(engine: Any, out_dir: str,
                  buckets: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Export an `InferenceEngine`'s bucket programs to `out_dir`, traced on
    the engine's device, and return the manifest. The engine must be
    single-device (mesh=None)."""
    if getattr(engine, "mesh", None) is not None:
        raise ValueError("mesh-sharded engines are not exportable; "
                         "export a single-device engine")
    from .engine import RAW_SIDE

    buckets = tuple(sorted(set(int(b) for b in (buckets or engine.buckets))))
    os.makedirs(out_dir, exist_ok=True)
    # the weights each bucket program takes as its first input
    variables = {k: v.detach() for k, v in (*engine.model.named_parameters(),
                                            *engine.model.named_buffers())}
    program = _BucketProgram(engine)
    side = RAW_SIDE if engine.raw_inputs else engine.img_size
    artifacts: List[Dict[str, Any]] = []
    for b in buckets:
        x = torch.zeros(b, side, side, 1, device=engine.device)
        with torch.no_grad():
            exported = torch.export.export(program, (variables, x), strict=False)
        name = f"bucket_{b}.pt2"
        torch.export.save(exported, os.path.join(out_dir, name))
        artifacts.append({"bucket": b, "file": name,
                          "input_shape": list(x.shape)})
    torch.save({k: v.cpu() for k, v in variables.items()},
               os.path.join(out_dir, _WEIGHTS))
    mcfg = engine.model_config
    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "model_config": dict(mcfg.to_dict() if hasattr(mcfg, "to_dict")
                             else mcfg),
        "buckets": list(buckets),
        "img_size": engine.img_size,
        "in_channels": engine.in_channels,
        "raw_inputs": engine.raw_inputs,
        "quality": engine.quality,
        "mean": list(engine.mean),
        "std": list(engine.std),
        "platforms": ["cpu", "cuda"],
        "artifacts": artifacts,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return manifest


class ExportedEngine:
    """Serving over a bundle's programs, with no model code; thread-safe
    `predict`. Mirrors JAX's ExportedEngine: bucket_for, warmup and a
    predict that pads each chunk with zero frames up to its bucket and cuts
    requests into chunks of the largest bucket."""

    def __init__(self, out_dir: str, device: DeviceLike = None):
        path = os.path.join(out_dir, _MANIFEST)
        manifest = None
        if os.path.isfile(path):
            with open(path) as f:
                manifest = json.load(f)
        if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
            raise ValueError(f"not an export bundle: {out_dir}")
        self.manifest = manifest
        self.device = resolve_device(device)
        self.variables = torch.load(os.path.join(out_dir, _WEIGHTS),
                                    map_location=self.device, weights_only=True)
        self.buckets = tuple(int(b) for b in manifest["buckets"])
        self._fns = {}
        for art in manifest["artifacts"]:
            exported = torch.export.load(os.path.join(out_dir, art["file"]))
            exported = move_to_device_pass(exported, str(self.device))
            self._fns[int(art["bucket"])] = exported.module()
        self._lock = threading.Lock()

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """One bucket's program on frames (B, S, S, 1) on the engine's device."""
        with torch.inference_mode():
            return self._fns[x.shape[0]](self.variables, x)

    def warmup(self) -> None:
        """Run every bucket program once on zero frames."""
        for art in self.manifest["artifacts"]:
            x = torch.zeros(art["input_shape"], device=self.device)
            with self._lock:
                self.run(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images (N, S, S[, 1]) → (N, num_classes) float32 probabilities."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[..., None]
        n = images.shape[0]
        top = self.buckets[-1]
        outs: List[np.ndarray] = []
        for start in range(0, n, top):
            chunk = images[start:start + top]
            m = chunk.shape[0]
            b = self.bucket_for(m)
            if m < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - m, *chunk.shape[1:]), np.float32)])
            x = torch.from_numpy(chunk).to(self.device)
            with self._lock:
                probs = self.run(x)
            outs.append(probs.cpu().numpy()[:m])
        return np.concatenate(outs, axis=0)


def load_exported(out_dir: str, device: DeviceLike = None) -> ExportedEngine:
    """The bundle at `out_dir`, served on `device` (the card by default)."""
    return ExportedEngine(out_dir, device=device)
