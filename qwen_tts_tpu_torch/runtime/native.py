"""ctypes bindings for the native C audio runtime (csrc/audio_runtime.c).

The port's own copy of `qwen_tts_tpu/runtime/native.py` (the port imports
nothing of the JAX package): `cc -O3 -shared` compiles the port's
`csrc/audio_runtime.c` once into the git-ignored `qwen_tts_tpu_torch/_build/`,
beside the CUDA kernels' library, and ctypes loads it. Host code only:
PCM16 conversion, a PCM ring buffer and a WAV writer. Pure-numpy fallbacks
keep every caller working when no C compiler is available.
`tests/test_torch_isolation.py` holds the code equal to the original's
apart from the source path and the build directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "audio_runtime.c"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            src = _SRC.read_bytes()
            tag = hashlib.sha256(src).hexdigest()[:16]
            cache = Path(__file__).resolve().parent.parent / "_build"
            cache.mkdir(parents=True, exist_ok=True)
            so = cache / f"audio_runtime_{tag}.so"
            if not so.exists():
                cc = os.environ.get("CC", "cc")
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-o", str(so), str(_SRC)],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(str(so))
            lib.f32_to_pcm16.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64]
            lib.ring_create.restype = ctypes.c_void_p
            lib.ring_create.argtypes = [ctypes.c_int64]
            lib.ring_destroy.argtypes = [ctypes.c_void_p]
            lib.ring_size.argtypes = [ctypes.c_void_p]
            lib.ring_size.restype = ctypes.c_int64
            lib.ring_space.argtypes = [ctypes.c_void_p]
            lib.ring_space.restype = ctypes.c_int64
            lib.ring_write.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            lib.ring_write.restype = ctypes.c_int64
            lib.ring_read.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            lib.ring_read.restype = ctypes.c_int64
            lib.write_wav.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int16]
            lib.write_wav.restype = ctypes.c_int
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def native_available() -> bool:
    return _build_lib() is not None


def f32_to_pcm16(audio: np.ndarray) -> bytes:
    """Clip+scale f32 [-1,1] → little-endian int16 bytes."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    lib = _build_lib()
    if lib is None:
        return (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    out = np.empty(audio.shape[0], dtype=np.int16)
    lib.f32_to_pcm16(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        audio.shape[0])
    return out.tobytes()


class PCMRing:
    """Lock-free SPSC ring for PCM bytes (numpy-deque fallback)."""

    def __init__(self, capacity: int = 1 << 20):
        self._lib = _build_lib()
        if self._lib is not None:
            self._r = self._lib.ring_create(capacity)
            if not self._r:
                raise MemoryError("ring_create failed")
        else:
            from collections import deque

            self._q: "deque[bytes]" = deque()
            self._qsize = 0

    def write(self, data: bytes) -> int:
        if self._lib is not None:
            buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            return int(self._lib.ring_write(self._r, buf, len(data)))
        self._q.append(data)
        self._qsize += len(data)
        return len(data)

    def read(self, n: int) -> bytes:
        if self._lib is not None:
            out = (ctypes.c_uint8 * n)()
            got = int(self._lib.ring_read(self._r, out, n))
            return bytes(out[:got])
        chunks = []
        got = 0
        while self._q and got < n:
            c = self._q.popleft()
            take = min(len(c), n - got)
            chunks.append(c[:take])
            if take < len(c):
                self._q.appendleft(c[take:])
            got += take
        self._qsize -= got
        return b"".join(chunks)

    @property
    def size(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_size(self._r))
        return self._qsize

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_r", None):
            self._lib.ring_destroy(self._r)
            self._r = None


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              channels: int = 1) -> None:
    """Write mono PCM16 WAV (native fast path, stdlib-wave fallback)."""
    pcm = np.frombuffer(f32_to_pcm16(audio), dtype=np.int16)
    lib = _build_lib()
    if lib is not None:
        rc = lib.write_wav(path.encode(), pcm.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int16)), len(pcm), sample_rate, channels)
        if rc == 0:
            return
    import wave

    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
