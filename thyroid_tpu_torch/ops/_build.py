"""Build and load the hand-written CUDA kernels (`thyroid_tpu_torch/csrc`).

Each `csrc/<name>.cu` exports a plain C interface and is compiled on its own
by `nvcc` for `sm_90a` into `build/thyroid_tpu_torch/lib<name>-<hash>.so`,
where `<hash>` is taken from the source text, so an edited source is never
served from a stale library. All sources are compiled in parallel, one
`nvcc` process each, the first time any kernel is needed, and loaded with
`ctypes`. Nothing is built at import time: the CPU-only test environment
imports every module of the package.

Each kernel entry is one operator of the `thyroid_tpu_torch` namespace
(`define_op`), with three implementations: the kernel's launch for CUDA
tensors, its plain PyTorch version for CPU tensors and a fake one that
gives the outputs' shapes, dtypes and strides (and runs the kernel's
checks) for meta and fake tensors, which `torch.export` traces. The
dispatcher picks among them by the tensors' device; no wrapper does, and
any other device raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thyroid_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# wall seconds of each source's nvcc in the last build_all, by name
BUILD_SECONDS: Dict[str, float] = {}
NAMESPACE = "thyroid_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine that holds the card")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once. Returns
    {name: compiler log} for the sources compiled by this call (the log
    holds ptxas's register, shared-memory and spill report) and records in
    BUILD_SECONDS each one's seconds from the common start to the end of
    its nvcc (the builds run side by side)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    BUILD_SECONDS.clear()
    procs = {}
    start = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(f".{os.getpid()}.log")
        with open(log, "w") as sink:
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=sink, stderr=subprocess.STDOUT)
        procs[src.stem] = (proc, tmp, out, log)
    while any(proc.poll() is None for proc, *_ in procs.values()):
        for name, (proc, *_rest) in procs.items():
            if name not in BUILD_SECONDS and proc.poll() is not None:
                BUILD_SECONDS[name] = time.perf_counter() - start
        time.sleep(0.05)
    logs, failed = {}, []
    for name, (proc, tmp, out, log) in procs.items():
        BUILD_SECONDS.setdefault(name, time.perf_counter() - start)
        logs[name] = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{logs[name]}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` is (or will be) built."""
    return _target(CSRC / f"{name}.cu")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building all sources first
    if its library does not exist yet."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        target = _target(src)
        if not target.exists():
            build_all()
        lib = ctypes.CDLL(str(target))
        _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes):
    """C entry `symbol` of `csrc/<name>.cu` with its argument types set
    (every pointer and the stream as c_void_p, or ctypes cuts them to 32
    bits). Every entry returns the cudaError_t of its launch, which
    includes a refused shared-memory size."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry of `name`."""
    if status != 0:
        msg = library(name).tt_error_string
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({msg(status).decode()})")


def define_op(schema: str, *, cpu: Callable, cuda: Callable,
              fake: Callable) -> torch._ops.OpOverload:
    """Define `thyroid_tpu_torch::<name>` by its `schema` with the plain
    version `cpu`, the kernel launch `cuda` and the fake implementation
    `fake`, and return its overload, which the wrapper calls. An op has
    no derivative of its own: autograd falls through it, and the plain
    version runs without recording, as the kernel does; the
    differentiable wrappers pair the ops in `torch.autograd.Function`s."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, torch.library.fallthrough_kernel, "Autograd")
    _LIB.impl(name, torch.no_grad()(cpu), "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper: Any, attr: str = "launches") -> None:
    """Add one to `wrapper`'s launch counter under a lock: a mesh
    engine's shards launch from threads at once (serving/engine.py), and
    `+= 1` is a read, an add and a write."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
