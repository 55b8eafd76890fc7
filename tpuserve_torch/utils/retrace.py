"""The torch half of the retrace witness: the sync guard and the blessed
device-to-host readback (``tpuserve/utils/retrace.py``'s counterpart).

The registry (env check, warmup barrier, ``RetraceViolation``) lives in
``tpuserve_torch.analysis.witness`` so the analysis package imports no
torch; this module is the part that needs it. When the server declares its
warmup barrier under ``TPUSERVE_RETRACE_WITNESS=1``, ``arm_sync_guard``
sets ``torch.cuda.set_sync_debug_mode("error")``: from then on a call that
makes the host wait for the card the implicit way — a stray ``.item()``,
``.cpu()`` into pageable memory, ``float()`` of a CUDA tensor,
``Stream.synchronize()``, a blocking copy from pageable host memory,
``torch.tensor(..., device="cuda")``, ``nonzero`` — raises instead of
silently serializing the pipeline. (The mode is a prototype: on the H100
machine's torch 2.11 it does not flag ``torch.cuda.synchronize()``,
``Event.synchronize()``, a graph capture, ``empty_cache`` or the
profiler's start and stop; ``scripts/torch_sync_guard.py`` lists what it
flags.) Every deliberate readback on the serving path goes through
``host_fetch``: one ``non_blocking`` copy per leaf into pinned host memory
and one wait on a ``torch.cuda.Event``, which the mode does not flag, so
the served path never lifts the guard.

The reference's transfer guard is a context that its ``allow_transfers``
scopes to one thread; torch's debug mode is process-wide. So
``allow_transfers`` is a reference-counted, process-wide window: while one
is open another thread's stray sync passes unflagged too. The windows sit
only where the mode flags a sync made by design: a graph capture after the
barrier (its inputs' pageable copies and its stream's synchronize) and the
staging of a lifecycle candidate (blocking copies of the weights). A
demote's release and a profile capture need none: the mode flags neither
``Event.synchronize()``, ``empty_cache``, a graph's destruction nor the
profiler's start and stop. The witness counts the windows opened
while the guard is armed (``retrace_snapshot()["transfer_windows"]``).

On the CPU nothing here touches a device: the guard arms only in a process
that initialized CUDA.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

from tpuserve_torch.analysis import witness

_mu = threading.Lock()
_armed = False  # the guard is set (and restored after each window)
_depth = 0      # open allow_transfers windows


def _set_mode(mode: str) -> None:
    torch.cuda.set_sync_debug_mode(mode)


def arm_sync_guard() -> bool:
    """Set the sync guard for the rest of the process; returns whether it
    is armed (False with the retrace witness off, or in a process that
    never initialized CUDA: the CPU has nothing to guard)."""
    global _armed
    if not witness.retrace_enabled() or not torch.cuda.is_initialized():
        return False
    with _mu:
        _armed = True
        if _depth == 0:
            _set_mode("error")
    return True


def disarm_sync_guard() -> None:
    """Restore torch's default sync mode (a test or a smoke phase that
    armed the guard in its own process)."""
    global _armed
    with _mu:
        if _armed:
            _armed = False
            _set_mode("default")


def sync_guard_armed() -> bool:
    return _armed


@contextlib.contextmanager
def allow_transfers():
    """A blessed block: the sync guard is lifted while any such block is
    open, process-wide (see the module docstring), and restored when the
    last one closes."""
    global _depth
    with _mu:
        _depth += 1
        if _armed:
            witness.note_transfer_window()
            if _depth == 1:
                _set_mode("default")
    try:
        yield
    finally:
        with _mu:
            _depth -= 1
            if _armed and _depth == 0:
                _set_mode("error")


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def host_fetch(tree: Any) -> Any:
    """THE blessed device-to-host readback: every tensor leaf of ``tree``
    (a tensor, or dicts/lists/tuples of them) as a numpy array the caller
    owns. CUDA leaves are copied with ``non_blocking=True`` into pinned
    host tensors on the calling thread's current stream, and the host waits
    once, on an event recorded after the copies; CPU leaves are copied.
    Runs off the event loop."""
    leaves: list[torch.Tensor] = []
    _map(tree, leaves.append)
    cuda = [t for t in leaves if t.is_cuda]
    if not cuda:
        return _map(tree, lambda t: t.numpy().copy())
    pinned: dict[int, torch.Tensor] = {}
    for t in cuda:
        pinned[id(t)] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) \
            .copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(cuda[0].device))
    done.synchronize()
    return _map(tree, lambda t: pinned[id(t)].numpy() if t.is_cuda
                else t.numpy().copy())
