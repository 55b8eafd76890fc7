"""Named lock constructors, copied from ``tpuserve/utils/locks.py``.

Every lock on the serving path is built through these two helpers instead of
bare ``threading.Lock()`` / ``asyncio.Lock()``, naming the lock's *role* at
the creation site (``"obs.Metrics"``). The JAX package can swap in lock-order
witness wrappers here; the port has not ported that witness yet, so the
helpers return the raw primitives — the call sites already carry the names
it will need.
"""

from __future__ import annotations

import asyncio
import threading


def new_lock(name: str):
    """A threading.Lock for the role ``name``."""
    del name
    return threading.Lock()


def new_async_lock(name: str):
    """An asyncio.Lock for the role ``name``."""
    del name
    return asyncio.Lock()
