"""Start a world of shard processes and collect what each returns.

    results = spawn_world(fn, ns, backend="gloo", device="cpu")

starts ``ns`` processes by the spawn method (never fork: a parent that
has initialized CUDA cannot fork), joins them into one process group
through a ``FileStore`` in a temporary directory (no TCP port, so
concurrent worlds never race for one), and calls
``fn(axis, *args)`` in each, with ``axis`` the ``MapAxis`` of the whole
world on ``device``: the card unless the caller names another (a
``RuntimeError`` where there is none).  On the card, rank r takes card
``r % cards`` unless ``device`` names one: a world of NCCL processes, each
on a card of its own, or gloo processes sharing cards.  It returns the ranks' return values in rank order,
passed back through pickle files that the children write.

``fn`` must be importable by the children: a module-level function of a
module that they can import.  The children import that module and this
package; they inherit the parent's ``sys.path``.

A CUDA world builds the integrate kernel in the parent first, so that
no two ranks run ``nvcc`` into the same build directory at once.  A rank
that raises or dies fails the world: the others are terminated (they
would wait in their next collective) and ``spawn_world`` raises with the
failed ranks' tracebacks.  So does a world that outlives ``timeout_s``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path


def _child(fn, rank, ns, backend, device, store_path, out_dir, args, threads) -> None:
    import torch
    import torch.distributed as dist

    from .collectives import make_mesh

    out = Path(out_dir)
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            index = rank % torch.cuda.device_count() if dev.index is None else dev.index
            dev = torch.device("cuda", index)
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, ns)
        dist.init_process_group(backend, store=store, rank=rank, world_size=ns,
                                timeout=datetime.timedelta(seconds=600))
        try:
            result = fn(make_mesh(dev), *args)
        finally:
            dist.destroy_process_group()
        with open(out / f"result-{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"error-{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn_world(fn, ns: int, backend: str = "gloo", device="cuda", args=(),
                timeout_s: float = 900.0, threads: int | None = None) -> list:
    """Run ``fn(axis, *args)`` in a world of ``ns`` spawned processes on
    ``backend`` with shards on ``device`` (the card unless the caller
    names another); returns their results in rank order.  ``threads``
    sets each child's ``torch.set_num_threads``."""
    from ..utils.device_info import entry_device

    if ns < 1:
        raise ValueError(f"spawn_world: {ns} processes")
    dev = entry_device(device)
    if dev.type == "cuda":
        from ..ops.cuda.build import load_library

        load_library("integrate")
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        ctx = multiprocessing.get_context("spawn")
        procs = [
            ctx.Process(target=_child, name=f"shard-{r}",
                        args=(fn, r, ns, backend, str(dev), store_path, tmp, tuple(args), threads))
            for r in range(ns)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            msgs = []
            for r in failed:
                err = Path(tmp, f"error-{r}.txt")
                why = err.read_text() if err.exists() else f"exit code {procs[r].exitcode}"
                msgs.append(f"rank {r}: {why}")
            timed_out = time.monotonic() > deadline
            raise RuntimeError(
                f"spawn_world: {len(failed)} of {ns} ranks failed"
                + (f" (the world outlived {timeout_s} s)" if timed_out else "")
                + ":\n" + "\n".join(msgs))
        results = []
        for r in range(ns):
            with open(Path(tmp, f"result-{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
