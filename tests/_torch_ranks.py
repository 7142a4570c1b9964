"""Ranks for the port's tensor-parallel tests: ``run_ranks(fn, world,
tmp_path, *args)`` starts ``world`` processes with the spawn method (a
forked child would inherit the parent's threads and, on the card, its
CUDA context), joins them into a gloo group through a ``FileStore``
under ``tmp_path`` (a TCP port could collide between test workers), sets
one intra-op thread in each, calls ``fn(rank, world, *args)`` in each
and returns the ranks' results in rank order.  A rank that raises makes
the call raise with its traceback; ``fn`` must be a module-level
function of an importable module."""
import os
import pickle
import traceback
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.multiprocessing as mp


def _entry(fn, rank, world, tmp, gloo_timeout, args):
    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        from repro_torch.launch.mesh import init_ranks
        init_ranks(rank, world, Path(tmp) / "store", "gloo",
                   timeout_s=gloo_timeout)
        result = ("ok", fn(rank, world, *args))
    except BaseException:
        result = ("err", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, timeout=240, gloo_timeout=90):
    tmp = Path(tmp_path) / f"ranks{os.getpid()}_{id(fn)}_{world}"
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(tmp), gloo_timeout, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r in range(world):
        f = tmp / f"rank{r}.pkl"
        if not f.exists():
            errors.append(f"rank {r}: no result (exit code "
                          f"{procs[r].exitcode})")
            continue
        status, value = pickle.loads(f.read_bytes())
        if status == "err":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if hung:
        errors.append(f"ranks {hung} still running after {timeout} s")
    if errors:
        raise AssertionError("\n".join(errors))
    return results


def stream(req):
    """What the tie rule reads of a request, picklable."""
    return SimpleNamespace(req_id=req.req_id, tokens=list(req.tokens),
                           top_logprobs=list(req.top_logprobs),
                           logprobs=list(req.logprobs),
                           cancelled=req.cancelled)
