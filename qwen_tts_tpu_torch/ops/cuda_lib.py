"""Build and load the port's CUDA kernels: one shared library from `csrc/`.

Every `csrc/*.cu` is compiled by its own `nvcc` process for sm_90a, all at
once, and the objects are linked into one shared library with a plain C
interface, bound with ctypes. The library goes into the git-ignored
`_build/`, named by the hash of every source and header in `csrc/`, so a
changed source rebuilds and an unchanged one loads at once. Nothing is
built when the module is imported: `load_library()` builds at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log: dict[str, str] = {}   # source name -> nvcc's output (ptxas lines)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I4 = ctypes.c_int * 4
_SIGNATURES = {
    "qtts_workspace_bytes": ([_I] * 6, ctypes.c_longlong),
    "qtts_decode_step": ([_P] * 18 + [_I] * 9 + [_F, _P], _I),
    "qtts_attention_workspace_bytes": ([_I] * 4, ctypes.c_longlong),
    "qtts_decode_attention": ([_P] * 7 + [_I] * 7 + [_P], _I),
    "qtts_generate_workspace_bytes": ([_I] * 6, ctypes.c_longlong),
    "qtts_generate": ([_P] * 14 + [_I] + [_P] * 4 + [_I] * 10 + [_F, _I]
                      + [ctypes.POINTER(ctypes.c_int)] * 2 + [_P], _I),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


def _build(so: Path) -> None:
    """One nvcc per source, started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        build_log[src.name] = out
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}{link.stderr}")
    os.replace(tmp, so)


def load_library() -> ctypes.CDLL:
    """Build `csrc/*.cu` into one library (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"qtts_kernels_{_digest()}.so"
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    _lib = lib
    return lib


def int4(values) -> ctypes.Array:
    """Up to four ints as a C int[4] (zero-padded)."""
    vals = list(values)[:4]
    return _I4(*vals, *([0] * (4 - len(vals))))


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel failed with CUDA error {err}")


def check_tensor(kernel: str, name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless `t` has this shape, type and device and is contiguous."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}; the kernel takes {tuple(shape)} {dtype} "
                         f"on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
