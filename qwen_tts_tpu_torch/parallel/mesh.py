"""Device mesh — the port of `qwen_tts_tpu/parallel/mesh.py`.

JAX lays one `Mesh` over the chips of one program and XLA inserts the
collectives. The port runs one process a rank, one rank a card (as
`torchrun --nproc-per-node N` starts them), names the ranks' axes with a
`DeviceMesh`, and joins the ranks with explicit collectives on each axis's
process group: NCCL across cards, gloo on the CPU. Axes:

- ``dp``: data parallel over independent utterances (batch).
- ``tp``: tensor parallel over groups of KV heads and the MLP's
  intermediate columns (`parallel/sharding.py`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class Axis(NamedTuple):
    """This rank's place on one axis of a mesh."""

    index: int          # the rank's coordinate on the axis
    size: int           # the axis's length
    group: object       # the process group of the ranks that differ only on it


def make_mesh(dp: int = 1, tp: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh, axes named ("dp", "tp"), over the initialized world
    (rank r at row r // tp, column r % tp); `tp` defaults to world // dp.
    On "cuda" the rank binds card `LOCAL_RANK` (0 without it) first. A
    process with no world joins the one its launcher describes (`WORLD_SIZE`
    set, as under torchrun), else starts a world of one rank in memory, so
    a single process needs no environment variables. Raises ValueError
    when dp * tp is not the world's size."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "device_type='cpu' for a mesh of CPU ranks")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def axis(mesh: DeviceMesh, name: str) -> Axis:
    """This rank's coordinate, the axis's size and its process group."""
    return Axis(mesh.get_local_rank(name), mesh.size(mesh.mesh_dim_names.index(name)),
                mesh.get_group(name))
