"""Build and load the port's CUDA kernels.

The kernels under ``mitoflex_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface
(``libmitoflex_kernels.so``) and loaded with ctypes. Each source compiles
in its own ``nvcc`` process, all started together, and one more ``nvcc``
links the objects. The build runs at first use, into
``mitoflex_tpu_torch/_build/``, and runs again when the hash of the sources
or of the commands changes. Importing this module compiles nothing and
needs no ``nvcc``.

Each C entry point launches on the stream it is given, allocates nothing,
and returns the ``cudaError_t`` of its launch; :func:`check` turns a
non-zero one into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libmitoflex_kernels.so"
SOURCES = ("filter.cu", "merge.cu", "sort.cu", "viterbi.cu", "sw.cu", "cyk.cu",
           "genewise.cu")
HEADERS = ("merge_path.cuh", "handoff.cuh", "row_pipeline.cuh")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


class KernelLimitError(RuntimeError):
    """A shape that a kernel cannot run on the card (a band or a model wider
    than it takes). A wrapper raises it instead of taking the plain loop."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already built for the current sources)
last_build_seconds = 0.0


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def compile_command(source: str, obj_path: str) -> List[str]:
    """nvcc command compiling one source of ``csrc/`` to an object."""
    return [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
        "-Xcompiler", "-fPIC", "-o", obj_path, os.path.join(CSRC_DIR, source),
    ]


def link_command(obj_paths: List[str], out_path: str) -> List[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", out_path, *obj_paths]


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    for src in SOURCES:
        h.update(" ".join(compile_command(src, src + ".o")[1:]).encode())
    h.update(" ".join(link_command([], LIB_NAME)[1:]).encode())
    return h.hexdigest()


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands concurrently; raise with the output of every one
    that failed."""
    with ThreadPoolExecutor(len(cmds)) as pool:
        runs = list(pool.map(lambda c: subprocess.run(
            c, capture_output=True, text=True, timeout=600), cmds))
    failed = [f"{c[-1]} ({r.returncode}):\n{r.stdout}\n{r.stderr}"
              for c, r in zip(cmds, runs) if r.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> str:
    """Compile the library unless a build of the current sources exists;
    returns its path. Raises RuntimeError with nvcc's output on failure."""
    global last_build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, LIB_NAME + ".sha256")
    digest = _digest()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                last_build_seconds = 0.0
                return lib_path
    t0 = time.perf_counter()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{src}.{tag}.o") for src in SOURCES]
    tmp = f"{lib_path}.{tag}"
    try:
        _run_all([compile_command(s, o) for s, o in zip(SOURCES, objs)])
        _run_all([link_command(objs, tmp)])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(digest)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.mfx_filter_reads.argtypes = [
                vp, vp, vp, vp, i64, i32, i32, i32, ctypes.c_float, vp, vp, vp,
            ]
            lib.mfx_filter_reads.restype = i32
            lib.mfx_merge_sorted_runs.argtypes = [
                vp, vp, i64, vp, vp, i64, i32, vp, vp, vp,
            ]
            lib.mfx_merge_sorted_runs.restype = i32
            lib.mfx_merge_sorted_runs_onepass.argtypes = [
                vp, vp, i64, vp, vp, i64, i32, i32, vp, vp, vp,
            ]
            lib.mfx_merge_sorted_runs_onepass.restype = i32
            lib.mfx_sort_words2.argtypes = [vp, i64, vp, vp, vp]
            lib.mfx_sort_words2.restype = i32
            # the profile's ten arrays, then (scores) model lengths and count
            # or (scan) the model length; windows, lengths, B, T, Lp, window,
            # the layout (columns a lane, warps a row, rows a block, cluster
            # size), output
            lib.mfx_viterbi_scores.argtypes = [vp] * 10 + [vp, i32, vp, vp] + [i32] * 8 \
                + [vp, vp]
            lib.mfx_viterbi_scores.restype = i32
            lib.mfx_viterbi_scan.argtypes = [vp] * 10 + [i32, vp, vp] + [i32] * 8 + [vp, vp]
            lib.mfx_viterbi_scan.restype = i32
            # warps a row, rows a block, window, scan pass
            lib.mfx_viterbi_smem_bytes.argtypes = [i32] * 4
            lib.mfx_viterbi_smem_bytes.restype = ctypes.c_longlong
            # queries, q_lens, targets, t_lens, matrix, K, B, Lq, Lt, gap open
            # and extend, the layout (columns a lane, warps a pair, cluster
            # size, wide path fields, positions a step), scratch, output,
            # stream
            lib.mfx_sw_align.argtypes = [vp] * 5 + [i32] * 4 + [ctypes.c_float] * 2 \
                + [i32] * 5 + [vp, vp, vp]
            lib.mfx_sw_align.restype = i32
            # queries, q_lens, target codes, t_lens, matrix, K, B, Lq, T, stop
            # code, gap open and extend, frameshift and stop penalties, the
            # layout, scratch, output, stream
            lib.mfx_genewise_align.argtypes = [vp] * 5 + [i32] * 5 \
                + [ctypes.c_float] * 4 + [i32] * 5 + [vp, vp, vp]
            lib.mfx_genewise_align.restype = i32
            # K, warps a pair, wide path fields, positions a step
            for fn in (lib.mfx_sw_smem_bytes, lib.mfx_genewise_smem_bytes):
                fn.argtypes = [i32] * 4
                fn.restype = ctypes.c_longlong
            # step table, its rows, dispatch order, E states, their count,
            # single5, pair5, origins and codes, S, L, W, el_selfsc, deck,
            # output, sync buffer, epoch, stream
            lib.mfx_cyk_banded.argtypes = [vp, i32, vp, vp, i32, vp, vp, vp, i32, i32, i32,
                                           ctypes.c_float, vp, vp, vp, i32, vp]
            lib.mfx_cyk_banded.restype = i32
            for fn in (lib.mfx_merge_max_words, lib.mfx_merge_max_payloads,
                       lib.mfx_sort_tile_rows):
                fn.argtypes = []
                fn.restype = i32
            lib.mfx_merge_tile_rows.argtypes = [i32, i32]
            lib.mfx_merge_tile_rows.restype = i32
            lib.mfx_cuda_error_string.argtypes = [i32]
            lib.mfx_cuda_error_string.restype = ctypes.c_char_p
            # the merge kernels' limits, read once: a ctypes call per launch
            # would cost a microsecond each
            lib.max_words = lib.mfx_merge_max_words()
            lib.max_payloads = lib.mfx_merge_max_payloads()
            _lib = lib
        return _lib


def host_library() -> str:
    """Build the port's native host library (the C++ FASTQ reader, dedup
    set, run merge and graph engines of ``native/``) unless a build of the
    current sources exists; returns its path. The stages build it lazily at
    first use; calling this first keeps the ``g++`` run out of a timed
    stage. Raises when the compiler is missing or fails
    (``native.fastq_native.last_build_seconds`` holds the build's time)."""
    from ..native import fastq_native

    return fastq_native.build()


def launch(dev, fn, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` with the CUDA device
    ``dev`` (a ``torch.device`` with an index) current, on its current
    stream; returns the launch's CUDA error code for :func:`check`.

    A wrapper's host time is most of a short kernel's cost, so this path is
    kept lean: the device guard is entered only when ``dev`` is not current
    already, and the stream handle comes from the raw-stream query (an
    integer, as ctypes wants it) instead of a ``torch.cuda.Stream`` object."""
    if torch.cuda.current_device() == dev.index:
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def check(err: int, what: str) -> None:
    """Raise if a kernel's launch returned a CUDA error."""
    if err != 0:
        msg = library().mfx_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
