"""Multi-process bootstrap and process-sharded host-side sweeps over
``torch.distributed``, one process per card.

The JAX package's multi-controller SPMD (``jax.distributed.initialize`` and
collectives over the mesh) becomes a process group here:

- ``maybe_initialize``: the env-gated bootstrap, run at CLI import time, so
  every stage CLI works unchanged as one rank of a multi-process job;
- ``my_batches``: round-robin assignment of sweep batches to this process,
  so each rank computes a disjoint share of a sweep;
- ``merge_process_rows``: the slim exchange that reassembles the disjoint
  per-rank row fills (each rank ships only the rows it computed).

The row exchange is host data: it runs on a gloo group whatever backend
the default group has (NCCL exchanges only device tensors).
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a rank that never arrives fails the run after this long instead of
# hanging it; the default group's collectives wait as long
INIT_TIMEOUT = datetime.timedelta(minutes=30)


def choose_backend(hosts: Sequence[tuple]) -> str:
    """NCCL when every rank owns a card of its own, else gloo: on the CPU
    (``CST_PLATFORM=cpu`` or no card) or when ranks share a card, which
    NCCL refuses. ``hosts`` holds every rank's (host name, usable cards),
    so every rank decides alike, whatever the layout of ranks on hosts."""
    per_host = collections.Counter(name for name, _ in hosts)
    cards = dict(hosts)
    return "nccl" if all(0 < n <= cards[h] for h, n in per_host.items()) else "gloo"


def _usable_cards() -> int:
    if os.environ.get("CST_PLATFORM") == "cpu" or not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()


_local_rank: Optional[int] = None


def maybe_initialize(timeout: datetime.timedelta = INIT_TIMEOUT) -> Optional[str]:
    """Join the process group the environment names; returns its backend,
    or None when no group is asked for (or one exists already).

    ``CST_COORDINATOR_ADDRESS=<host:port>`` + ``CST_NUM_PROCESSES`` +
    ``CST_PROCESS_ID`` give an explicit ``tcp://`` bootstrap (the CPU tests
    use it); ``CST_AUTO_DISTRIBUTED=1`` defers to ``env://``, torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``. Neither
    set: nothing happens, so the single-process path pays nothing. The
    ranks swap their host names and card counts through the rendezvous
    store first, to pick the backend (``choose_backend``) and this rank's
    place among the ranks of its host (``local_rank``); under NCCL each
    rank takes the card ``local rank % device count``."""
    global _local_rank
    if dist.is_initialized():
        return None
    coord = os.environ.get("CST_COORDINATOR_ADDRESS")
    if coord:
        url = f"tcp://{coord}"
        kw = dict(rank=int(os.environ["CST_PROCESS_ID"]),
                  world_size=int(os.environ["CST_NUM_PROCESSES"]))
    elif os.environ.get("CST_AUTO_DISTRIBUTED"):
        url, kw = "env://", {}
    else:
        return None
    store, rank, world = next(dist.rendezvous(url, timeout=timeout, **kw))
    store.set(f"cst_host/{rank}", json.dumps([socket.gethostname(), _usable_cards()]))
    hosts = [tuple(json.loads(store.get(f"cst_host/{r}"))) for r in range(world)]
    backend = choose_backend(hosts)
    _local_rank = sum(h == hosts[rank][0] for h, _ in hosts[:rank])
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout)
    print(f"[multihost] rank {rank}/{world}: torch.distributed backend {backend}",
          flush=True)
    return backend


def local_rank() -> int:
    """This rank's place among the ranks on its host (its rank before
    ``maybe_initialize`` has run)."""
    return process_index() if _local_rank is None else _local_rank


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def my_batches(n_batches: int) -> range:
    """Round-robin assignment of sweep batches to this process."""
    return range(process_index(), n_batches, process_count())


_ROW_GROUPS: dict = {}


def _row_group():
    """The gloo group of the row exchange: the default group when it is
    gloo, else one built on first use (every rank merges at the same
    points, so every rank builds it there)."""
    if dist.get_backend() == "gloo":
        return None
    if "gloo" not in _ROW_GROUPS:
        _ROW_GROUPS["gloo"] = dist.new_group(backend="gloo")
    return _ROW_GROUPS["gloo"]


def _all_gather_rows(rows: np.ndarray, group) -> np.ndarray:
    """Every rank's ``rows`` (the same shape on each), rank-major."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=group)
    return torch.cat(out).numpy()


def merge_process_rows(
    outs: Sequence[np.ndarray],
    idx_chunks: List[np.ndarray],
    val_chunks: Sequence[List[np.ndarray]],
) -> None:
    """Merge disjoint per-process row fills of ``outs`` across ranks.

    Every process computed values for its own row subset; ship ONLY those
    rows (padded to the largest per-process count so the all-gather has
    uniform shapes; idx -1 marks padding) and scatter them into each rank's
    full arrays. ``outs[k]`` receives ``val_chunks[k]`` at rows
    ``idx_chunks``. In place; a no-op at one process."""
    pc = process_count()
    if pc == 1:
        return
    for out in outs:
        # reshape() on a non-C-contiguous array returns a COPY, so the
        # scatter below would silently write into a temporary and drop
        # every row; fail loudly instead
        if not out.flags.c_contiguous:
            raise ValueError(
                "merge_process_rows requires C-contiguous outputs "
                "(reshape of a non-contiguous array copies, silently "
                "dropping the scattered rows)"
            )
    group = _row_group()
    idx = (np.concatenate(idx_chunks).astype(np.int64) if idx_chunks
           else np.zeros((0,), np.int64))
    n_max = int(_all_gather_rows(np.asarray([len(idx)], np.int64), group).max())
    pad = n_max - len(idx)
    idx = np.concatenate([idx, np.full(pad, -1, np.int64)])
    gi = _all_gather_rows(idx, group)
    mask = gi >= 0
    for out, chunks in zip(outs, val_chunks):
        width = int(np.prod(out.shape[1:], initial=1))
        flat = (np.concatenate(chunks).reshape(len(idx) - pad, width).astype(out.dtype)
                if chunks else np.zeros((0, width), out.dtype))
        flat = np.concatenate([flat, np.zeros((pad, width), out.dtype)])
        gv = _all_gather_rows(flat, group)
        out.reshape(out.shape[0], -1)[gi[mask]] = gv[mask]
