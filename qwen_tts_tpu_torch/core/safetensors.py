"""A reader and writer of the safetensors format, on torch alone.

The format: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}}`, and an
optional `"__metadata__"` of strings), then the tensors' raw little-endian
bytes, offsets counted from the first byte after the header.

The reader maps the file (copy-on-write, so the tensors it hands out are
writable without touching the file) and builds each tensor with
`torch.frombuffer` over the mapping: nothing is read until a tensor is
used, and bf16 never passes through numpy, which has no bf16. A tensor
keeps the mapping alive. A header whose tensors overlap, run past the
file, or disagree with their shape and dtype is refused with ValueError.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from typing import Mapping

import numpy as np
import torch

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "F16": torch.float16, "BF16": torch.bfloat16,
    "F32": torch.float32, "F64": torch.float64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 << 20


class SafeTensorsFile:
    """One safetensors file, mapped: `keys()`, `shape(name)`, `get(name)`
    (a CPU tensor over the mapping), `metadata`. Use as a context manager
    or keep it: tensors handed out stay valid either way."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            size = f.seek(0, 2)
            if size < 8:
                raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
            f.seek(0)
            (n,) = struct.unpack("<Q", f.read(8))
            if n > min(size - 8, _MAX_HEADER):
                raise ValueError(f"{path}: header of {n} bytes runs past the file ({size})")
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the header is not a JSON object")
        self.path = path
        self.metadata = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self._entries = {}
        spans = []
        for name, e in header.items():
            dtype = DTYPES.get(e.get("dtype"))
            if dtype is None:
                raise ValueError(f"{path}: {name}: unknown dtype {e.get('dtype')!r}")
            shape = tuple(int(s) for s in e["shape"])
            begin, end = (int(x) for x in e["data_offsets"])
            nbytes = math.prod(shape) * dtype.itemsize
            if not 0 <= begin <= end <= size - self._base or end - begin != nbytes:
                raise ValueError(f"{path}: {name}: offsets [{begin}, {end}) do not hold "
                                 f"{shape} {e['dtype']} inside {size - self._base} data bytes")
            self._entries[name] = (dtype, shape, begin, end)
            spans.append((begin, end, name))
        spans.sort()
        for (_b0, e0, a), (b1, _e1, b) in zip(spans, spans[1:]):
            if b1 < e0:
                raise ValueError(f"{path}: tensors {a} and {b} overlap")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def keys(self) -> list[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def shape(self, name: str) -> tuple[int, ...]:
        return self._entries[name][1]

    def get(self, name: str) -> torch.Tensor:
        """The tensor `name` on the CPU, over the file's mapping (copied
        into its own memory only when its bytes are not aligned to its
        element size)."""
        dtype, shape, begin, end = self._entries[name]
        if begin == end:
            return torch.empty(shape, dtype=dtype)
        offset = self._base + begin
        if offset % dtype.itemsize:
            return torch.frombuffer(bytearray(self._map[offset:self._base + end]),
                                    dtype=dtype).reshape(shape)
        count = (end - begin) // dtype.itemsize
        return torch.frombuffer(self._map, dtype=dtype, count=count,
                                offset=offset).reshape(shape)


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a file, by name (CPU tensors over its mapping)."""
    f = SafeTensorsFile(path)
    return {k: f.get(k) for k in f.keys()}


def _as_tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous()
    a = np.ascontiguousarray(t)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write `tensors` (torch tensors on any device, or numpy arrays) to
    `path`, in the order given, the header padded to 8 bytes."""
    flat = {name: _as_tensor(t) for name, t in tensors.items()}
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, t in flat.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in flat.values():
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
