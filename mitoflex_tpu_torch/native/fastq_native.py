"""ctypes bindings for the native FASTQ batch reader (fastq_reader.cpp).

The four C++ sources of this directory are compiled by ``g++`` into one
shared library with a plain C interface (``libmitoflex_host.so`` under
``mitoflex_tpu_torch/_build/``) and loaded with ctypes. The build runs at
first use and again when the hash of the sources or of the command
changes; :func:`build` runs it ahead of time. ``available()`` gates all
use; the Python parser in io/fastq.py is the drop-in fallback where no
compiler (or no ``zlib.h``) is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Iterator, List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB_NAME = "libmitoflex_host.so"
SOURCES = ("fastq_reader.cpp", "dedup.cpp", "merge.cpp", "graph.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# seconds the last build took in this process (0.0 when the library was
# already built for the current sources)
last_build_seconds = 0.0


def build_command(out_path: str) -> List[str]:
    """g++ command compiling the sources of this directory to out_path."""
    return [
        os.environ.get("CXX", "g++"), "-O3", "-march=native", "-fPIC", "-shared",
        "-Wall", "-o", out_path, *(os.path.join(_DIR, f) for f in SOURCES), "-lz",
    ]


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(build_command(LIB_NAME)).encode())
    return h.hexdigest()


def build() -> str:
    """Compile the library unless a build of the current sources exists;
    returns its path. Raises when the compiler is missing or fails."""
    global last_build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib_path + ".sha256"
    digest = _digest()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                last_build_seconds = 0.0
                return lib_path
    t0 = time.perf_counter()
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(build_command(tmp), check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    with open(stamp, "w") as f:
        f.write(digest)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            lib = ctypes.CDLL(build())
        except Exception:
            _build_failed = True
            return None
        lib.mfx_fastq_open.restype = ctypes.c_void_p
        lib.mfx_fastq_open.argtypes = [ctypes.c_char_p]
        lib.mfx_fastq_next_batch.restype = ctypes.c_long
        lib.mfx_fastq_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ]
        lib.mfx_fastq_bases_read.restype = ctypes.c_long
        lib.mfx_fastq_bases_read.argtypes = [ctypes.c_void_p]
        lib.mfx_fastq_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_batches(
    path: str, batch_reads: int, max_read_len: int, limit_bases: int = 0
) -> Iterator:
    """Yield ReadBatch objects (same contract as io/fastq.read_batches with
    keep_names=False)."""
    from ..io.fastq import ReadBatch

    lib = _load()
    assert lib is not None
    handle = lib.mfx_fastq_open(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        while True:
            seqs = np.full((batch_reads, max_read_len), 4, dtype=np.int8)
            quals = np.zeros((batch_reads, max_read_len), dtype=np.int8)
            lens = np.zeros(batch_reads, dtype=np.int32)
            n = lib.mfx_fastq_next_batch(
                handle,
                seqs.ctypes.data_as(ctypes.c_void_p),
                quals.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p),
                batch_reads, max_read_len, limit_bases,
            )
            if n <= 0:
                return
            yield ReadBatch(seqs, quals, lens, int(n), None)
            if n < batch_reads:
                return
    finally:
        lib.mfx_fastq_close(handle)
