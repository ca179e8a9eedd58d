"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. A library is built
at first use into ``build/kernels/`` at the repository root, named by a hash
of its sources and flags, so an edited source is rebuilt and an unchanged
one is reused. ``build_all`` starts one ``nvcc`` per source at once.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but success.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("expert_ffn", "flash_attention", "flash_decode", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The compiler's ``-Xptxas -v`` report (registers, spills, shared memory)
    is kept beside the library as ``<lib>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".so.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    return out


def build_all() -> Dict[str, float]:
    """Build every kernel library in parallel; returns seconds per source."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
        futs = {n: ex.submit(timed, n) for n in SOURCES}
        return {n: f.result() for n, f in futs.items()}


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its C signature (``int`` result),
    set once per loaded library rather than on every call."""
    fn = getattr(load(name), symbol)   # ctypes caches it on the library
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd records through a launch: a kernel writes its
    outputs through ``ctypes``, so autograd would see no edge from them to
    the inputs and every gradient behind them would silently read zero.
    The kernels that training reaches run under an ``autograd.Function``
    (whose forward runs with grad disabled); every other call must too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no gradient; call it under "
                           "torch.no_grad() or through its autograd.Function")


def stream_ptr(t: torch.Tensor) -> int:
    """The current PyTorch stream of ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
