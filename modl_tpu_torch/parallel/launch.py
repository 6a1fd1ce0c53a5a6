"""Start a ``torch.distributed`` world of local processes, one per rank.

Counterpart of the virtual-mesh subprocess of ``__graft_entry__.py``:
the mesh tests and ``chip_smoke.py`` run the estimators' SPMD program in
a world started here. Ranks are started with ``torch.multiprocessing``'s
``spawn`` method and meet at a ``file://`` rendezvous in a temporary
directory, so no port is needed. Each rank initialises the default group
(on CUDA: card ``rank % device_count``; the CPU: one thread a rank),
calls ``fn(rank, world_size, *args)`` and destroys the group at the end.

The parent waits for every rank's result. A rank that raises makes the
parent stop the others (which may be waiting in a collective) and raise
the rank's error; so does the timeout, and a rank that dies without a
result. Nothing is left running.
"""
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn", "RankError"]


class RankError(RuntimeError):
    """A rank of a spawned world failed; the message holds its
    traceback."""


def _rank_main(rank, world_size, backend, device, tmp, timeout, results):
    try:
        with open(os.path.join(tmp, 'call.pkl'), 'rb') as f:
            fn, args = pickle.load(f)
        if device == 'cpu':
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
            torch.cuda.init()   # a DeviceMesh then keeps this device
        dist.init_process_group(
            backend, init_method=f'file://{os.path.join(tmp, "rendezvous")}',
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, (time.time(), traceback.format_exc())))
        raise


def _failures(first, results, procs, grace=2.0):
    """The failures reported within ``grace`` seconds of the first, the
    earliest first: a rank that raises makes its peers fail in their
    collectives soon after, and the earliest error is the cause."""
    failed = [first]
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=0.1)
        except queue_mod.Empty:
            if not any(p.is_alive() for p in procs):
                break
            continue
        if not ok:
            failed.append((rank, value))
    return sorted(failed, key=lambda f: f[1][0])


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn, world_size, backend='nccl', device='cuda', timeout=180,
          args=()):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes forming one world; return the ranks' results, in rank
    order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and each
    result comes back pickled. ``backend`` is ``'nccl'`` (the default)
    or ``'gloo'``; ``device`` is where ``fn`` puts its tensors: the card
    ``rank % device_count`` unless the caller asks for ``'cpu'`` (one
    thread a rank, with ``backend='gloo'``). Raises :class:`RankError` with the first failing
    rank's traceback, or when ``timeout`` seconds pass first. On CUDA
    the kernel library is built here first, so that the ranks only load
    it."""
    if device != 'cpu':
        from ..ops import _build
        _build.build()
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        # the call goes by file: a process' own arguments are written to
        # its pipe while it starts, which would start the ranks one by one
        with open(os.path.join(tmp, 'call.pkl'), 'wb') as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, backend, device, tmp,
                                   timeout, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        out = [None] * world_size
        done = 0
        deadline = time.monotonic() + timeout
        try:
            while done < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankError(f'world of {world_size} ranks did not '
                                    f'finish within {timeout} s')
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if not p.is_alive() and p.exitcode != 0]
                    if dead:
                        raise RankError(f'rank {dead[0]} exited with code '
                                        f'{procs[dead[0]].exitcode} and no '
                                        'result') from None
                    continue
                if not ok:
                    failed = _failures((rank, value), results, procs)
                    raise RankError('\n'.join(
                        f'rank {r} of {world_size} failed:\n{v[1]}'
                        for r, v in failed))
                out[rank] = value
                done += 1
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            _stop(procs)
    return out
