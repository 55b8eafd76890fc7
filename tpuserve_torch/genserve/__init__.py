"""Iteration-level generative serving, ported from ``tpuserve/genserve``.

- :class:`~tpuserve_torch.genserve.model.GenerativeModel` — the family
  contract: ``init_state`` / ``step`` / ``extract`` / ``finalize``
  decompose generation into slot-block device programs.
- :class:`~tpuserve_torch.genserve.arena.SlotArena` — host-side slot ledger
  (never double-hands a slot).
- :class:`~tpuserve_torch.genserve.engine.GenEngine` — the step loop:
  re-forms the active batch every model iteration, retires finished
  sequences immediately, folds queued requests into free slots, evicts
  past-deadline sequences with the fast-504 contract; ``submit_stream``
  hands back a :class:`~tpuserve_torch.genserve.engine.GenStream` of units
  flushed per iteration and ended by exactly one terminal.
- :class:`~tpuserve_torch.genserve.pages.PageLedger` — host-side KV page
  ledger for the paged cache (never double-hands a page), with
  :class:`~tpuserve_torch.genserve.engine.KVPressure` as the
  page-exhaustion admission shed.

- :class:`~tpuserve_torch.genserve.engine.GenEngineGroup` — one engine per
  replica of a replica-mode runtime, least-loaded placement.
"""

from tpuserve_torch.genserve.arena import SlotArena, SlotCorrupted, SlotInfo
from tpuserve_torch.genserve.engine import GenEngine, GenEngineGroup, GenStream, KVPressure
from tpuserve_torch.genserve.model import GenerativeModel
from tpuserve_torch.genserve.pages import PageCorrupted, PageLedger

__all__ = ["GenEngine", "GenEngineGroup", "GenStream", "GenerativeModel", "KVPressure", "PageCorrupted",
           "PageLedger", "SlotArena", "SlotCorrupted", "SlotInfo"]
