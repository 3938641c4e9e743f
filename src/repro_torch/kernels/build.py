"""Build and load the CUDA kernels of ``csrc/``.

Each source ``csrc/<name>.cu`` is compiled on its own with ``nvcc`` for
``sm_90a`` into ``build/repro_torch_kernels/`` at the repository root on
first use, and loaded with ``ctypes``: a plain C interface, so a build
takes seconds and links nothing of PyTorch. A library's file name
carries a hash of its source, so an edited source is rebuilt and a
stale library is never loaded; nvcc's ``-Xptxas -v`` report is kept
beside each library. :func:`build_all` starts one nvcc per source, all
at once. Nothing is built when this module is imported.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds
one where it launches its kernel, and nowhere else, so a run can show
that its main path went through the kernels. The count and the first
load of a library take a lock: fleet workers launch from several
threads at once.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: Per source, the C signature of each entry point it defines: pointers
#: and the stream as void*, extents as int, strides as long long; every
#: entry point returns cudaGetLastError().
SOURCES = {
    "fused_split_gemm": {
        "fused_hetero_gemm": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P,
                              _I, _I, _I, _I, _P],
        "fused_conv_gemm": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P,
                            _I, _P, _P, _I, _I, _I, _I, _P],
    },
    "split_gemm": {
        "bitserial_gemm": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P],
        "int4_gemm": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    },
    "depthwise_gemm": {
        "depthwise_conv_gemm": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I,
                                _P, _I, _P, _P, _P],
        "grouped_gemm": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P],
    },
    "flash_attention": {
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            *[_L] * 12, _P, _F, _I, _I, _I, _P],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_dq": [*[_P] * 8, *[_I] * 7, *[_L] * 15, _F, _I,
                                   _I, _P],
        "flash_attention_bwd_dkdv": [*[_P] * 8, *[_I] * 7, *[_L] * 12, _F,
                                     _I, _I, _P],
    },
    "flash_attention_f32": {
        "flash_attention_f32": [*[_P] * 4, *[_I] * 7, *[_L] * 9, _P, _F, _I,
                                _I, _I, _P],
        "flash_attention_f32_bwd_dq": [*[_P] * 8, *[_I] * 7, *[_L] * 15, _F,
                                       _I, _I, _P],
        "flash_attention_f32_bwd_dkdv": [*[_P] * 8, *[_I] * 7, *[_L] * 12,
                                         _F, _I, _I, _P],
    },
}
#: the source that defines each entry point
SOURCE_OF = {name: src for src, entries in SOURCES.items()
             for name in entries}

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def source_path(source: str) -> Path:
    if source not in SOURCES:
        raise KeyError(f"unknown kernel source {source!r}; have "
                       f"{sorted(SOURCES)}")
    return _CSRC / f"{source}.cu"


def library_path(source: str) -> Path:
    digest = hashlib.sha256(source_path(source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source}-{digest}.so"


def report_path(source: str) -> Path:
    """nvcc's ``-Xptxas -v`` report (registers, shared memory, spills),
    kept beside the library it describes."""
    return library_path(source).with_suffix(".log")


def is_built(source: str) -> bool:
    return library_path(source).exists() and report_path(source).exists()


def build_all(sources=tuple(SOURCES)) -> dict[str, Path]:
    """Compile every source in ``sources`` that has no library yet, one
    nvcc each, all started together; return each source's library path.
    nvcc's report goes to :func:`report_path`."""
    todo = [s for s in sources if not is_built(s)]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
    procs = {}
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(s))]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    failed = []
    for s, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source_path(s).name}: nvcc failed "
                          f"({proc.returncode}):\n{err}")
            continue
        report_path(s).write_text(out + err)
        os.replace(tmp, library_path(s))
    if failed:
        raise RuntimeError("\n".join(failed))
    return {s: library_path(s) for s in sources}


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use."""
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build_all((source,))[source]))
            for name, argtypes in SOURCES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return _libs[source]


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
    lib = load_library(SOURCE_OF[name])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    with _count_lock:
        LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
