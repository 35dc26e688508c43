"""Build the port's CUDA kernels and load them with ctypes.

Every `credit_torch/csrc/*.cu` compiles with its own `nvcc` process (all
started together) for `sm_90a`, and the objects link into one shared library
under `build/credit_torch/` at the root of the checkout. The library's name
carries a hash of the sources and flags, so a changed source builds anew at
first use and an unchanged one loads at once. The sources have a plain C
interface (pointers and the stream as `void*`, sizes as `int`, a
`cudaError_t` returned as `int`), so no PyTorch header is compiled.

Nothing here runs at import: `library()` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "credit_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# dtype codes shared with csrc/common.cuh
F32 = 0
BF16 = 1

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link the library; returns its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libcredit_torch_{digest()}.so"
    if target.exists():
        return target
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        extra = ["-Xptxas", "-v"] if verbose else []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [cc, *CFLAGS, *extra, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = Path(tmp) / target.name
        subprocess.run([cc, *ARCH, "-shared", "-o", str(lib), *map(str, objs)],
                       check=True, capture_output=True, text=True)
        os.replace(lib, target)  # atomic: a concurrent process never sees half a file
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.credit_error_string.argtypes = [ctypes.c_int]
            lib.credit_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry `name` with its argument types set (pointers and the
    stream must be c_void_p, or ctypes cuts them to 32 bits)."""
    fn = getattr(library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = library().credit_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: F32, torch.bfloat16: BF16}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
