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

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
MAX_SECTIONS = 8   # kQttsMaxSections in csrc/decode_layer.cuh
_INTS = ctypes.c_int * (1 + MAX_SECTIONS)   # a position row: cache row + sections

# Weight forms of one matrix (QttsMat::form in csrc/decode_layer.cuh).
FORM_BF16, FORM_INT8, FORM_INT4 = 0, 1, 2


class QttsMat(ctypes.Structure):
    """One layer-stacked weight matrix: csrc/decode_layer.cuh::QttsMat."""
    _fields_ = [("w", _P), ("s", _P), ("form", _I), ("ng", _I)]


class QttsDecoder(ctypes.Structure):
    """A decoder and its KV cache: csrc/decode_layer.cuh::QttsDecoder."""
    _fields_ = ([(n, _P) for n in ("input_norm", "q_norm", "k_norm", "post_norm",
                                   "final_norm")]
                + [(n, QttsMat) for n in ("wqkv", "wo", "w_gate_up", "w_down", "lm_head")]
                + [(n, _P) for n in ("k_cache", "v_cache", "k_scale", "v_scale")]
                + [(n, _I) for n in ("L", "H", "I", "HQ", "KVH", "D", "S", "V")]
                + [("eps", _F)])


_DEC = ctypes.POINTER(QttsDecoder)
_SIGNATURES = {
    "qtts_workspace_bytes": ([_I] * 6, ctypes.c_longlong),
    "qtts_stage_timers_offset": ([], ctypes.c_longlong),
    "qtts_launch_count_offset": ([], ctypes.c_longlong),
    "qtts_launch_info": ([_DEC, _IP], _I),
    "qtts_set_positions": ([_P, _I, _IP, _P], _I),
    "qtts_decode_step": ([_DEC] + [_P] * 4 + [_I, _I, _IP] + [_P] * 4, _I),
    "qtts_decode_attention": ([_P] * 7 + [_I] * 7 + [_LL] * 4 + [_P, _P], _I),
    "qtts_generate": ([_DEC] + [_P] * 5 + [_I, _I, _IP, _P, _P, _I, _P], _I),
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the entry points `lib` has."""
    for name, (args, res) in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def load_library() -> ctypes.CDLL:
    """Build `csrc/*.cu` into one library (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"qtts_kernels_{_digest()}.so"
    if not so.exists():
        _build(so)
    _lib = bind(ctypes.CDLL(str(so)))
    return _lib


def ints(values) -> ctypes.Array:
    """Up to 1 + MAX_SECTIONS ints as a C int array (zero-padded)."""
    vals = [int(v) for v in values]
    if len(vals) > 1 + MAX_SECTIONS:
        raise ValueError(f"at most {1 + MAX_SECTIONS} values: {vals}")
    return _INTS(*vals, *([0] * (1 + MAX_SECTIONS - len(vals))))


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


def check_aligned(kernel: str, *tensors) -> None:
    """Raise unless each tensor (None skipped) starts on a 16-byte boundary,
    as the attention core's TMA copies of cache rows and scales need."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{kernel}: the KV cache and its scales must start on 16-byte "
                         f"boundaries")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
