#!/usr/bin/env python3
"""The persistent decode kernel's grid barrier, timed alone on one NVIDIA GPU.

    python3 tools/grid_barrier.py [BLOCKS ...]

Builds `tools/grid_barrier.cu` (a loop of `grid_sync` from
`qwen_tts_tpu_torch/csrc/decode_layer.cuh`, nothing else) into the
git-ignored `qwen_tts_tpu_torch/_build/variants/`, then launches 2,000
barriers in a row on cooperative grids of 256-thread blocks (default 64,
120, 128 and 132 blocks) and prints the time of one barrier (CUDA events,
the best of three runs). Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = 2000


def build():
    from qwen_tts_tpu_torch.ops import cuda_lib

    out = cuda_lib.BUILD_DIR / "variants" / "grid_barrier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.COMPILE_FLAGS, "-shared",
                        f"-I{cuda_lib.CSRC}", "-o", str(out),
                        os.path.join(ROOT, "tools", "grid_barrier.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.qtts_barrier_loop.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.qtts_barrier_loop.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("grid_barrier: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    lib = build()
    bar = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for grid in [int(a) for a in sys.argv[1:]] or [64, 120, 128, 132]:
        best = float("inf")
        for _ in range(4):  # the first run warms up
            torch.cuda.synchronize()
            start.record()
            err = lib.qtts_barrier_loop(bar.data_ptr(), grid, ITERS, stream)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"grid_barrier: launch of {grid} blocks failed ({err})")
            best = min(best, start.elapsed_time(end))
        print(f"grid barrier, {grid} blocks of 256 threads: {best / ITERS * 1e3:.3f} us a "
              f"barrier [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
