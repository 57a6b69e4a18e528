"""HTTP front end of the serving engine (counterpart of scripts/serve.py).

Endpoints:
  GET  /healthz   → {"status": "ok", "model": ..., "buckets": [...]}
  POST /predict   → {"probs": [[p0, p1], ...], "pred": [cls, ...]}
       body: .npy bytes (N, S, S[, 1]) raw frames, or JSON {"images": [...]}
       (Content-Type containing "json"); a single image is coalesced
       with other connections' through the BatchAggregator.
A request that fails answers 400 with the error's text; any other path 404.

Usage:
  python -m thyroid_tpu_torch.serving.server --checkpoint runs/.../best.ckpt [--port 8000]
  python -m thyroid_tpu_torch.serving.server --model swin_tiny [--quality] [--quantize int8]
  python -m thyroid_tpu_torch.serving.server --bundle bundle/   (serving/export.py)
  python -m thyroid_tpu_torch.serving.server --model swin_tiny --data-parallel 2
Beside the script's arguments, `--device` (the card unless "cpu" is
given). `--port 0` takes a free port, which the start line prints.
`--data-parallel N` shards each bucket over N replicas (buckets rounded
up to multiples of N): on the cards in turn (cuda:i mod the cards, so
one card holds both of two), or N times the CPU with `--device cpu`; the
start line names them.
"""
from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

import numpy as np


def build_handler(engine, aggregator, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_name,
                                 "buckets": list(engine.buckets)})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if "json" in self.headers.get("Content-Type", ""):
                    images = np.asarray(json.loads(raw)["images"], np.float32)
                else:
                    images = np.load(io.BytesIO(raw), allow_pickle=False)
                if images.ndim == 2:
                    images = images[None]
                if images.ndim == 3:
                    images = images[..., None]
                if images.shape[0] == 1:
                    probs = aggregator.submit(images[0])[None]
                else:
                    probs = engine.predict(images)
                self._send(200, {
                    "probs": np.asarray(probs, np.float64).round(6).tolist(),
                    "pred": np.argmax(probs, axis=-1).tolist(),
                })
            except Exception as exc:  # the error goes back to the client
                self._send(400, {"error": f"{type(exc).__name__}: {exc}"})

        def log_message(self, fmt, *args):  # no access log
            pass

    return Handler


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thyroid_tpu_torch.serving.server",
        description="Serve a model's class probabilities over HTTP.")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None,
                   help="model name for a fresh (untrained) engine when no "
                        "checkpoint is given: smoke and speed testing")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--buckets", type=int, nargs="*", default=[1, 8, 32, 128])
    p.add_argument("--quality", action="store_true")
    p.add_argument("--preprocessed", action="store_true",
                   help="inputs are already resized+normalized")
    p.add_argument("--max-delay-ms", type=float, default=10.0)
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="serve Dense/Conv contractions in int8 PTQ "
                        "(serving/quantize.py)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard each bucket's batch over N devices "
                        "(buckets round up to multiples of N)")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--bundle", default=None,
                   help="serve an export bundle (python -m "
                        "thyroid_tpu_torch.serving.export_serving); no model "
                        "code runs")
    p.add_argument("--device", default=None,
                   help='"cpu" for the CPU; the CUDA card otherwise')
    return p


def shard_devices(n: int, device: Optional[str]) -> list:
    """The N devices of `--data-parallel N`: the CPU N times with
    `--device cpu`, else the CUDA cards in turn."""
    import torch

    if device is not None and str(device).startswith("cpu"):
        return ["cpu"] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


class Server(ThreadingHTTPServer):
    """A thread per connection, with a listen backlog for many concurrent
    clients: socketserver's default of 5 drops the connects past it, and a
    client retries a dropped connect only after 1 s."""

    request_queue_size = 128
    daemon_threads = True


def build_server(argv: Optional[Sequence[str]] = None
                 ) -> Tuple[Server, object, object]:
    """Parse `argv`, build the engine (warmed up unless --no-warmup), its
    aggregator and the bound, not yet serving, HTTP server →
    (server, engine, aggregator)."""
    from .aggregator import BatchAggregator

    p = parser()
    args = p.parse_args(argv)
    if args.bundle is not None:
        if args.checkpoint or args.model or args.quantize \
                or args.data_parallel > 1:
            p.error("--bundle is exclusive with --checkpoint/--model/"
                    "--quantize/--data-parallel (the bundle froze those "
                    "choices at export time)")
        from .export import load_exported

        engine = load_exported(args.bundle, device=args.device)
        name = f"bundle:{engine.manifest['model_config'].get('name', '?')}"
    else:
        from .engine import InferenceEngine

        mcfg = None
        if args.model:
            mcfg = {"name": args.model, "in_channels": 1, "num_classes": 2,
                    "dtype": "bf16"}
            if args.img_size:
                mcfg["img_size"] = args.img_size
        mesh = None
        if args.data_parallel > 1:
            from ..parallel.mesh import create_mesh

            mesh = create_mesh({"data": args.data_parallel},
                               devices=shard_devices(args.data_parallel,
                                                     args.device))
        engine = InferenceEngine(model_config=mcfg, checkpoint=args.checkpoint,
                                 buckets=args.buckets, quality=args.quality,
                                 raw_inputs=not args.preprocessed,
                                 quantize=args.quantize, device=args.device,
                                 mesh=mesh)
        name = args.model or str(args.checkpoint)
        if mesh is not None:
            name += f" on {[str(d) for d in engine.shard_devices]}"
    if not args.no_warmup:
        print("warming up bucket programs...", flush=True)
        engine.warmup()
    aggregator = BatchAggregator(engine, max_delay_ms=args.max_delay_ms)
    server = Server((args.host, args.port), build_handler(engine, aggregator, name))
    host, port = server.server_address[:2]
    print(f"serving {name} on http://{host}:{port}", flush=True)
    return server, engine, aggregator


def main(argv: Optional[Sequence[str]] = None) -> None:
    server, _, aggregator = build_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        aggregator.close()
        server.server_close()


if __name__ == "__main__":
    main()
