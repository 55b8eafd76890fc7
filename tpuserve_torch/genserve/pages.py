"""PageLedger: host-side KV page bookkeeping for the paged generation
engine (PagedAttention / vLLM), copied from ``tpuserve/genserve/pages.py``
(host-only; the same errors).

The paged device state holds one global pool of fixed-size KV pages —
``(pages, layers, page_tokens, heads, head_dim)`` — plus a per-slot block
table of page indices. This ledger is the pool's host-side truth: which
pages are free, which slot owns each handed-out page. Same posture as
SlotArena: a page is never double-handed, and a release by anything that
doesn't hold the page raises instead of corrupting — a double-hand would
let one request's decode writes land inside another request's context.

Page 0 is the SENTINEL and is never handed out. The compiled decode step
redirects writes for finished/free lanes to page 0 (their block-table rows
are zeros), so a retired slot can never scribble into pages the ledger has
already re-handed to a new request. The sentinel's contents are garbage by
design; no live lane ever attends through it.

Event-loop-side only (the engine's step loop owns all mutation), so there
is deliberately no lock to witness.
"""

from __future__ import annotations


class PageCorrupted(RuntimeError):
    """The free-list and the ownership ledger disagree — a double acquire
    or a foreign release. The paged KV pool can no longer be trusted."""


class PageLedger:
    """Fixed pool of KV pages [1, pages) with an ownership ledger.

    ``pages`` counts the sentinel: a ledger built with ``pages=N`` hands
    out at most ``N - 1`` (its ``usable``) real pages, indices 1..N-1.
    The engine reserves a request's FULL page need (prompt + decode
    budget) at fold-in, so a admitted sequence can never hit mid-decode
    page exhaustion — admission is where pressure is applied (Clockwork's
    budgeted-admission frame, PAPERS.md P3).
    """

    SENTINEL = 0

    def __init__(self, pages: int, page_tokens: int) -> None:
        if int(pages) < 2:
            raise ValueError("PageLedger needs >= 2 pages (sentinel + 1)")
        if int(page_tokens) < 1:
            raise ValueError("page_tokens must be >= 1")
        self.pages = int(pages)
        self.page_tokens = int(page_tokens)
        # LIFO free-list, popping from the low end first (1, 2, ...).
        self._free: list[int] = list(range(self.pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}   # slot -> its pages
        self._owner: dict[int, int] = {}         # page -> owning slot
        # Lifetime hand-out count (monotone; feeds /stats).
        self.acquires_total = 0

    @property
    def usable(self) -> int:
        """Allocatable pages (total minus the sentinel)."""
        return self.pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_reserved(self) -> int:
        return len(self._owner)

    def utilization(self) -> float:
        """Reserved fraction of the usable pool in [0, 1]."""
        return self.n_reserved / self.usable if self.usable else 0.0

    def pages_of(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, ()))

    def holds(self, slot: int) -> bool:
        """Whether ``slot`` currently owns pages. The engine's release
        funnel checks this so a slot whose page-acquire itself failed
        mid-admit can still return to the arena without tripping the
        PageCorrupted double-release tripwire."""
        return slot in self._owned

    def acquire(self, slot: int, count: int) -> list[int]:
        """Hand ``count`` free pages to ``slot``; raises PageCorrupted if
        the free-list offers a page the ledger says is already owned, or
        if the slot already holds pages (one reservation per slot
        lifetime), and IndexError when the pool can't cover the count
        (callers gate on n_free)."""
        count = int(count)
        if count < 1:
            raise ValueError("acquire needs count >= 1")
        if slot in self._owned:
            raise PageCorrupted(
                f"slot {slot} already holds pages — double reservation")
        if count > len(self._free):
            raise IndexError(
                f"page pool exhausted: need {count}, free {len(self._free)}")
        out: list[int] = []
        for _ in range(count):
            page = self._free.pop()
            if page in self._owner or page == self.SENTINEL:
                self._free.append(page)
                raise PageCorrupted(
                    f"page {page} is on the free-list AND owned — double-hand")
            self._owner[page] = slot
            out.append(page)
        self._owned[slot] = out
        self.acquires_total += count
        return out

    def release(self, slot: int) -> list[int]:
        """Return ALL of a slot's pages to the free list; raises
        PageCorrupted for a slot holding nothing (foreign or double
        release) or for a page whose owner record disagrees."""
        pages = self._owned.pop(slot, None)
        if pages is None:
            raise PageCorrupted(
                f"release of slot {slot} that holds no pages")
        for page in pages:
            owner = self._owner.pop(page, None)
            if owner != slot:
                raise PageCorrupted(
                    f"page {page} owner ledger says {owner}, released by "
                    f"slot {slot}")
            self._free.append(page)
        return pages

    def release_all(self) -> int:
        """Error-path reset: free every reserved page (the engine
        reinitializes the device state block alongside)."""
        n = 0
        for slot in list(self._owned):
            n += len(self.release(slot))
        return n

    def snapshot(self) -> dict:
        """Compact live-occupancy row for the per-replica /stats block
        — just the pool's current fill, not the full stats()
        geometry dump."""
        return {
            "free": self.n_free,
            "reserved": self.n_reserved,
            "usable": self.usable,
            "utilization": round(self.utilization(), 4),
        }

    def stats(self) -> dict:
        return {
            "pages": self.pages,
            "usable": self.usable,
            "free": self.n_free,
            "reserved": self.n_reserved,
            "page_tokens": self.page_tokens,
            "utilization": round(self.utilization(), 4),
            "acquires_total": self.acquires_total,
        }
