"""Named lock constructors, copied from ``tpuserve/utils/locks.py``: the
witness indirection point.

Every lock on the serving path is built through these two helpers instead of
bare ``threading.Lock()`` / ``asyncio.Lock()``. In production they return the
raw primitives (zero overhead); with ``TPUSERVE_LOCK_WITNESS=1`` they return
witness wrappers (tpuserve_torch.analysis.witness) that maintain the global
lock-order graph and raise on an inversion or a threading lock held across an
``await``. The ``name`` is the graph node: name the *role* at the creation
site (``"obs.Metrics"``, ``"deferred.spawn"``) so every instance of one role
shares a node and cross-instance inversions are still caught.
"""

from __future__ import annotations

import asyncio
import threading

from tpuserve_torch.analysis import witness


def new_lock(name: str):
    """A threading.Lock, witness-wrapped when TPUSERVE_LOCK_WITNESS=1."""
    if witness.enabled():
        return witness.WitnessLock(name)
    return threading.Lock()


def new_async_lock(name: str):
    """An asyncio.Lock, witness-wrapped when TPUSERVE_LOCK_WITNESS=1."""
    if witness.enabled():
        return witness.WitnessAsyncLock(name)
    return asyncio.Lock()
