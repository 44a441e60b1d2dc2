"""Run one function on the ranks of a world on this host, one spawned
process a rank, with a hard time limit.

A deployment starts its ranks with `torchrun --nproc-per-node N` (one a
card) and each calls `parallel/mesh.py::make_mesh`. Tests and the chip
smoke start theirs with `run_ranks`, on `torch.multiprocessing`'s
`start_processes`: each child pins torch to one thread, joins a gloo
process group through a file store in a temporary directory (no port;
gloo because NCCL refuses two ranks on one card, and tests have none),
calls `fn(rank, *args)`, leaves the group, and hands its return value back
through a file. When a rank raises, the others are stopped and its
traceback raised; when the world passes `timeout_s` (a collective that
hangs), every child is killed and `run_ranks` raises: a hung rank fails its
caller instead of hanging it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

GRACE_S = 10.0      # after a rank fails, how long the others may take to end on their own


def _rank_main(rank: int, fn, world: int, d: str, local_ranks: list, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_ranks[rank]))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}"), "wb") as f:
        pickle.dump(result, f)


def _read(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def run_ranks(fn, world: int, *args, timeout_s: float = 120.0, local_ranks=None) -> list:
    """`fn(rank, *args)` on ranks 0..world-1, each in a spawned process of
    one gloo process group; their return values in rank order. `fn` and
    `args` are pickled (`fn` by its import path). Rank r sees
    `LOCAL_RANK = local_ranks[r]` (default r), the card `make_mesh` binds.
    Raises RuntimeError when a rank fails and TimeoutError past
    `timeout_s`; every child has ended when it returns or raises."""
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException

    local = list(range(world)) if local_ranks is None else list(local_ranks)
    with tempfile.TemporaryDirectory() as d:
        ctx = tmp.start_processes(_rank_main, args=(fn, world, d, local, args), nprocs=world,
                                  join=False, daemon=True, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0),
                               grace_period=GRACE_S):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ranks of a world of {world} still ran after "
                                       f"{timeout_s} s: killed")
        except ProcessException as e:
            # the others may have failed on its account: every rank's error
            errs = [f"rank {r}: {_read(f)}" for r, f in enumerate(ctx.error_files)
                    if os.path.exists(f)]
            raise RuntimeError(f"ranks of a world of {world} failed:\n"
                               + ("\n".join(errs) or str(e))) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            for f in ctx.error_files:
                if os.path.exists(f):
                    os.unlink(f)
        return [_read(os.path.join(d, f"rank{r}")) for r in range(world)]
