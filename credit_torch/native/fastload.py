"""ctypes bindings and the at-first-use build of the fastload C++ library
(the port's copy of credit_tpu/native/fastload.py).

Codec ids shared with fastload.cpp: 0 raw, 1 zlib, 2 gzip, 3 zstd.
All entry points release the GIL for the whole batch (ctypes calls into
foreign code drop it), so decode threads and the training step overlap.

The library is compiled with `$CXX` (g++ by default), `-O3 -shared -fPIC
-std=c++17 -pthread ... -lz` (and `-lzstd` where the compiler finds
<zstd.h>), into `build/credit_torch/` at the root of the checkout, never
beside the source. Its name carries a hash of the source, the compiler and
the flags; it is written to a temporary file in that directory and renamed
into place, so concurrent processes never load half a library. A failed
build or load raises RuntimeError with the compiler's output: there is no
fallback to Python behind the caller's back.

`decoded` counts the chunks the pool has decoded in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

CODEC_RAW, CODEC_ZLIB, CODEC_GZIP, CODEC_ZSTD = 0, 1, 2, 3

_CODEC_BY_ID = {None: CODEC_RAW, "zlib": CODEC_ZLIB, "gzip": CODEC_GZIP,
                "zstd": CODEC_ZSTD}

_STATUS_MSG = {1: "read error", 2: "decode error", 3: "size mismatch",
               4: "unsupported codec", 5: "missing"}

SOURCE = Path(__file__).resolve().parent / "fastload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "credit_torch"
CFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
decoded = 0  # chunks decoded by the pool (under _lock)


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _has_zstd(cxx: str) -> bool:
    """Whether `cxx` finds <zstd.h> (one preprocessor run)."""
    try:
        r = subprocess.run([cxx, "-E", "-x", "c++", "-"], input="#include <zstd.h>\n",
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0


def build(src: Path = SOURCE, out_dir: Path = BUILD_DIR) -> Path:
    """Compile `src` into `out_dir` unless a library of the same source,
    compiler and flags is there; returns its path. Raises RuntimeError
    (with the compiler's output) when the compiler is missing or fails."""
    cxx = _compiler()
    flags = list(CFLAGS)
    libs = ["-lz"]
    if _has_zstd(cxx):
        flags.append("-DCREDIT_FL_ZSTD")
        libs.append("-lzstd")
    src = Path(src)
    h = hashlib.sha256(" ".join([cxx, *flags, *libs]).encode())
    h.update(src.read_bytes())
    out_dir = Path(out_dir)
    target = out_dir / f"libfastload_{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        try:
            r = subprocess.run([cxx, *flags, str(src), "-o", tmp, *libs],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"fastload: cannot run the compiler {cxx!r}: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"fastload: {cxx} failed on {src}:\n{r.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent process never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _load() -> ctypes.CDLL:
    """Build (at first use) and dlopen the library."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"fastload: cannot load {path}: {e}") from e
            lib.fl_capabilities.restype = ctypes.c_int32
            lib.fl_capabilities.argtypes = []
            lib.fl_default_threads.restype = ctypes.c_int32
            lib.fl_default_threads.argtypes = []
            lib.fl_decode_batch.restype = ctypes.c_int32
            lib.fl_decode_batch.argtypes = [
                ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
            lib.fl_read_decode_batch.restype = ctypes.c_int32
            lib.fl_read_decode_batch.argtypes = [
                ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
    return _lib


def codec_id(compressor: Optional[dict]) -> Optional[int]:
    """Map a zarr compressor dict to a fastload codec id (None: not one the
    library decodes, zstd included when it was built without zstd; the
    caller uses its Python path)."""
    cid = None if compressor is None else compressor.get("id")
    codec = _CODEC_BY_ID.get(cid)
    if codec == CODEC_ZSTD and not _load().fl_capabilities() & 2:
        return None
    return codec


def default_threads() -> int:
    """The pool's thread count: every hardware thread."""
    return int(_load().fl_default_threads())


def _out_ptrs(outs: Sequence[np.ndarray]):
    n = len(outs)
    dsts = (ctypes.c_void_p * n)()
    dlens = (ctypes.c_int64 * n)()
    for i, o in enumerate(outs):
        if not (o.flags["C_CONTIGUOUS"] and o.flags["WRITEABLE"]):
            raise ValueError(f"fastload: output {i} is not a writeable C-contiguous array")
        dsts[i] = o.ctypes.data_as(ctypes.c_void_p).value
        dlens[i] = o.nbytes
    return dsts, dlens


def _count(n: int) -> None:
    global decoded
    with _lock:
        decoded += n


def decode_batch(raws: Sequence[bytes], codecs: Sequence[int],
                 outs: Sequence[np.ndarray]) -> None:
    """Decompress n in-memory chunks into preallocated C-contiguous arrays.

    Raises RuntimeError naming the first failed item."""
    lib = _load()
    n = len(raws)
    if n == 0:
        return
    # the byte objects stay referenced by `raws` while the C side runs
    srcs = (ctypes.c_void_p * n)()
    slens = (ctypes.c_int64 * n)()
    for i, raw in enumerate(raws):
        srcs[i] = ctypes.cast(ctypes.c_char_p(raw), ctypes.c_void_p).value
        slens[i] = len(raw)
    cods = (ctypes.c_int32 * n)(*codecs)
    dsts, dlens = _out_ptrs(outs)
    status = (ctypes.c_int32 * n)()
    rc = lib.fl_decode_batch(n, srcs, slens, cods, dsts, dlens, 0, status)
    if rc != 0:
        i = rc - 1
        raise RuntimeError(
            f"fastload: chunk {i} failed: "
            f"{_STATUS_MSG.get(status[i], status[i])}")
    _count(n)


def read_decode_batch(paths: Sequence[str], codecs: Sequence[int],
                      outs: Sequence[np.ndarray]) -> np.ndarray:
    """Read+decompress n local files into preallocated arrays.

    Returns a bool mask of which files existed (missing files leave their
    output untouched — pre-fill with the fill value). Raises on hard
    decode/read failures, naming the file."""
    lib = _load()
    n = len(paths)
    found = np.ones(n, dtype=bool)
    if n == 0:
        return found
    cpaths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    cods = (ctypes.c_int32 * n)(*codecs)
    dsts, dlens = _out_ptrs(outs)
    status = (ctypes.c_int32 * n)()
    rc = lib.fl_read_decode_batch(n, cpaths, cods, dsts, dlens, 0, status)
    if rc != 0:
        i = rc - 1
        raise RuntimeError(
            f"fastload: {paths[i]}: "
            f"{_STATUS_MSG.get(status[i], status[i])}")
    for i in range(n):
        if status[i] == 5:
            found[i] = False
    _count(int(found.sum()))
    return found
