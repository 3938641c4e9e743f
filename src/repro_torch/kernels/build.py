"""Build and load the CUDA kernels of ``csrc/``.

``load_library()`` compiles ``csrc/split_gemm.cu`` with ``nvcc`` for
``sm_90a`` into ``build/repro_torch_kernels/`` at the repository root
on first use, and loads it with ``ctypes``: a plain C interface, so the
build takes seconds and links nothing of PyTorch. The library's file
name carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built when this module is
imported.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds
one where it launches its kernel, and nowhere else, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "split_gemm.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of each entry point: pointers and the stream as void*,
#: extents as int; every entry point returns cudaGetLastError().
SIGNATURES = {
    "fused_hetero_gemm": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P],
    "fused_conv_gemm": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _I,
                        _P, _P, _P],
    "bitserial_gemm": [_P, _I, _I, _P, _I, _I, _P, _P, _P],
    "int4_gemm": [_P, _I, _I, _P, _I, _P, _P, _P],
}

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"split_gemm-{digest}.so"


def report_path() -> Path:
    """nvcc's ``-Xptxas -v`` report (registers, shared memory, spills),
    kept beside the library it describes."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile the kernels if this source has no library yet; return
    the library's path. nvcc's report goes to :func:`report_path`."""
    out = library_path()
    if out.exists() and report_path().exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    report_path().write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_operand(kernel: str, what: str, t, dtype, shape: tuple,
                  device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` — what the kernels take and nothing else."""
    if t.device != device:
        raise ValueError(f"{kernel}: {what} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be contiguous")


def launch(name: str, x, *args) -> None:
    """Launch entry point ``name`` on ``x``'s device and current
    stream, count it, and raise if the launch was refused (the entry
    point's ``cudaGetLastError()`` was not ``cudaSuccess``)."""
    import torch
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
