"""Run one function on every rank of a process group, one process a rank.

`run_ranks(fn, world)` spawns `world` processes (the `spawn` start
method: each imports `fn`'s module afresh, so that module must import
neither JAX nor anything that needs the parent's state), joins them in a
gloo process group over a `file://` store in a fresh directory under
`TMPDIR`, calls `fn(rank, world, *args)` on each and returns the ranks'
results (what `fn` returned, saved with `torch.save`: keep it on the
CPU).  Each rank runs on one torch thread.  A rank that raises writes its
traceback and exits non-zero; the process group's timeout ends the peers
it leaves waiting, and the join has a time limit after which every rank
still running is killed.  Any failure raises `RankFailure` with the tracebacks.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


class RankFailure(RuntimeError):
    pass


def _rank_main(fn, rank: int, world: int, workdir: str, args: tuple,
               timeout_s: float) -> None:
    import torch.distributed as dist

    from lmono_tpu_torch.parallel.mesh import init_process_group

    torch.set_num_threads(1)
    try:
        init_process_group(rank, world, "file://" + os.path.join(workdir, "store"),
                           timeout_s=timeout_s)
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_ranks(fn, world: int, args: tuple = (), timeout_s: float = 300.0) -> list:
    """fn(rank, world, *args) on `world` spawned ranks; returns their
    results in rank order.  timeout_s bounds the whole run and any one
    collective's wait."""
    workdir = tempfile.mkdtemp(prefix="ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, workdir, args, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}"
                          + (" (killed at the time limit)" if r in hung else
                             " before it ran (unpickling its arguments or "
                             "importing fn's module; see its standard error)"))
    if errors:
        raise RankFailure("\n".join(errors))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
