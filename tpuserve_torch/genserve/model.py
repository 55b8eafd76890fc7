"""GenerativeModel: the contract between generative families and the
iteration-level engine, ported from ``tpuserve/genserve/model.py``.

The one-shot ``ServingModel`` contract captures ``forward`` per batch bucket
and runs each batch to completion — a locked batch. Multi-step generative
work breaks that shape: requests need different iteration counts, so a
locked batch runs every lane for its LONGEST member. This contract
decomposes generation into the device programs the engine
(``tpuserve_torch.genserve.engine``) schedules at iteration granularity, all
registered ONCE (``ModelRuntime.register_program``) over a fixed
slot-capacity state block, so slot churn never recaptures:

- ``init_state(module, item)`` — one request's initial per-slot state (the
  prompt prefill). The engine writes it into the slot dim with an indexed
  copy whose slot index is a tensor, so one captured "insert" program
  serves every slot index.
- ``step(module, state)`` — ONE model iteration over the whole slot block,
  updating the block's tensors IN PLACE and returning a small
  host-fetchable out dict that must carry ``"done"`` per slot. Free slots
  hold benign zeros and are stepped along harmlessly.
- ``extract(module, state, slot)`` — the finished slot's device outputs,
  fetched ONLY when that slot retires, so the per-step readback stays small.

Where the reference's programs take the parameter tree and return a new
state (JAX donates the old one), the port's take the parameter slot's module
and update the state block in place: a captured CUDA graph binds the
block's addresses, which stay fixed for the engine's life.

Host-side, ``is_finished`` reads the step's out-block and ``finalize`` turns
one extracted result into the JSON-able response. Decoded request items are
tuples of fixed-shape np arrays carrying EVERY sampling parameter (seed,
temperature, max_new_tokens) — that is what makes generative results
content-addressable: the result cache digests the whole item, so two prompts
differing only in seed never alias (``ModelConfig.cacheable`` opts a family
out).

Streaming: the engine feeds each streamed slot's units (``stream_units``
per iteration, ``stream_final_units`` at retire) to its ``GenStream``; the
HTTP layer encodes them with ``encode_stream_unit`` (SSE by default).
"""

from __future__ import annotations

import abc
import json
from typing import Any

from tpuserve_torch.models.base import ServingModel


class GenerativeModel(ServingModel):
    """A ServingModel that additionally serves through the iteration-level
    engine. Families keep their one-shot ``forward`` (the locked-batch path
    the batcher serves when ``[genserve]`` is off) and add the decomposed
    programs below."""

    # Marker the server keys engine selection on.
    generative = True

    # -- device contract (registered once via runtime.register_program) -------
    @abc.abstractmethod
    def state_signature(self, slots: int) -> dict:
        """``{name: TensorSpec}`` of the whole generative state block: every
        leaf has leading dim ``slots``. Allocated once at engine start
        (zeros) and updated in place by every program — KV caches, token
        buffers, per-slot counters and done flags all live here, so
        steady-state serving allocates nothing."""

    @abc.abstractmethod
    def gen_item_signature(self) -> tuple:
        """TensorSpecs of ONE decoded request item as it crosses to the
        device (no slot dim). Fixed shapes are the contract: prompts pad to
        the prompt bucket, and every sampling parameter rides along as a
        scalar array."""

    @abc.abstractmethod
    def init_state(self, module: Any, item: tuple) -> dict:
        """One request's initial per-slot state — each leaf shaped like the
        state_signature leaf WITHOUT the slot dim; ``item`` holds device
        tensors. The expensive once-per-request work (prompt prefill)."""

    @abc.abstractmethod
    def step(self, module: Any, state: dict) -> dict:
        """One iteration over all slots, updating ``state`` in place ->
        ``out``, the small per-step host fetch, which must contain
        ``"done"``: (slots,) bool — True once a slot's sequence finished.
        Free slots hold zeros; the step must be NaN-safe on them."""

    @abc.abstractmethod
    def extract(self, module: Any, state: dict, slot: Any) -> dict:
        """The finished slot's final device outputs; ``slot`` is a one-element
        int64 tensor (one capture covers every slot). Runs once per
        retirement."""

    def state_partition_specs(self, struct: Any, mesh: Any) -> Any:
        """Per-leaf placement of the state block on a sharded mesh, or None
        to replicate everything (the default, correct for every family).
        The port serves one card, so nothing calls it yet."""
        return None

    # -- host contract --------------------------------------------------------
    def gen_max_steps(self) -> int:
        """Upper bound on iterations any single request can take (the
        engine's runaway guard and the staged canary's loop bound)."""
        raise NotImplementedError

    def is_finished(self, step_out: dict, slot: int) -> bool:
        """Read one slot's finished flag from the fetched step out-block."""
        return bool(step_out["done"][slot])

    @abc.abstractmethod
    def finalize(self, extracted: Any, item: Any) -> Any:
        """Fetched extract() outputs (+ the original decoded item) -> the
        JSON-able response. Host-side, runs on the postproc stage."""

    def result_units(self, result: Any) -> float:
        """Headline output units one finished result carries — tokens for
        text (default 1). Feeds the engine's ``gen_units_total`` counter,
        the numerator of a tokens/s figure."""
        return 1.0

    # -- paged KV contract ----------------------------------------------------
    # Families that answer supports_kv_paging = True swap the dense
    # per-slot state slab for a global pool of fixed-size KV pages plus a
    # per-slot block table, and swap init_state for an incremental
    # prefill_chunk program. The engine keeps the page ledger
    # (tpuserve_torch.genserve.pages.PageLedger) host-side; EVERY page index
    # the captured programs consume is a tensor, so one captured step and
    # prefill serve every page assignment — the same zero-recapture
    # obligation slot indices carry.

    supports_kv_paging = False

    def kv_page_signature(self, slots: int, pages: int,
                          page_tokens: int) -> dict:
        """``{name: TensorSpec}`` of the PAGED state block: the global page
        pool (leading dim ``pages``), the per-slot block table of page
        indices, and the same per-slot scalar lanes the dense signature
        carries. Page 0 is the write-sink sentinel — free/done lanes
        scribble there, live lanes never attend through it."""
        raise NotImplementedError

    def kv_pages_per_slot(self, page_tokens: int) -> int:
        """Host-side: block-table width — pages covering one slot's
        worst-case context (ceil(max_ctx / page_tokens))."""
        raise NotImplementedError

    def pages_needed(self, item: Any, page_tokens: int) -> int:
        """Host-side: pages this request reserves at fold-in — its prompt
        PLUS its full decode budget, so an admitted sequence can never hit
        mid-decode page exhaustion."""
        raise NotImplementedError

    def prompt_tokens(self, item: Any) -> int:
        """Host-side: real (unpadded) prompt length of one decoded item —
        the engine's chunked-prefill cursor bound."""
        raise NotImplementedError

    def kv_prefill_chunk(self, requested: int) -> int:
        """Host-side: the static chunk width the prefill program is built
        with, given the [genserve] prefill_chunk knob (0 = whole prompt in
        one chunk)."""
        raise NotImplementedError

    def prefill_chunk(self, module: Any, state: dict, slot: Any, item: tuple,
                      start: Any, pages: Any, *, chunk: int) -> None:
        """Fold tokens [start, start+chunk) of one prompt into the slot's
        pages, in place; ``slot``, ``start`` and ``pages`` are tensors,
        ``chunk`` is static. The final chunk (start + chunk >= prompt
        length) also samples the first token and arms the lane for decode;
        earlier chunks leave the lane frozen (done=True) so interleaved
        decode steps skip it."""
        raise NotImplementedError

    # -- streaming contract ---------------------------------------------------
    # The engine calls stream_units after EVERY fetched iteration for each
    # slot with an attached stream, and stream_final_units once at retire;
    # the HTTP layer encodes each unit with encode_stream_unit under
    # stream_content_type. Units are plain dicts with a "type" key; a unit
    # carrying "droppable": True may be discarded under the model's
    # stream_policy = "drop" when the client reads slowly (progress and
    # previews are droppable, tokens and terminals never are).

    def stream_units(self, step_out: dict, slot: int, stream: dict) -> list:
        """Newly produced stream units for one slot after one iteration.
        ``stream`` is a per-request mutable dict the model keeps its
        incremental emission state in (e.g. tokens already sent). The
        default streams nothing per iteration (the terminal burst from
        stream_final_units still makes the stream well-formed)."""
        return []

    def stream_wants_preview(self, step_out: dict, slot: int,
                             stream: dict) -> bool:
        """Side-effect-free: should the engine run the (already captured)
        extract program for this slot NOW to build a mid-flight preview
        unit? A preview costs one extract, never a new capture."""
        return False

    def stream_preview_unit(self, extracted: Any, stream: dict) -> dict:
        """Fetched extract() outputs -> one droppable preview unit (and the
        model's chance to note in ``stream`` when it last previewed)."""
        return {"type": "preview", "droppable": True}

    def stream_final_units(self, extracted: Any, result: Any) -> list:
        """Terminal burst for one retired slot, ending in the ``done``
        event every complete stream MUST carry (clients distinguish
        complete from torn by the terminal alone)."""
        return [{"type": "done",
                 "finish_reason": self.stream_finish_reason(result),
                 "usage": self.stream_usage(result)}]

    def stream_finish_reason(self, result: Any) -> str:
        """Why generation ended: "stop" (natural EOS) or "length" (cap)."""
        return "stop"

    def stream_usage(self, result: Any) -> dict:
        """The usage block on the terminal ``done`` event."""
        return {"units": self.result_units(result)}

    def stream_content_type(self) -> str:
        """Wire format for streamed responses: SSE by default; binary
        families answer ``frame.CONTENT_TYPE`` instead."""
        return "text/event-stream"

    def encode_stream_unit(self, unit: dict) -> bytes:
        """One unit -> wire bytes under stream_content_type. The SSE
        default renders ``event: <type>`` + a JSON data line; every key
        except "type" (and the droppable marker) rides in the data."""
        data = {k: v for k, v in unit.items()
                if k not in ("type", "droppable")}
        return (f"event: {unit['type']}\n"
                f"data: {json.dumps(data)}\n\n").encode("utf-8")

    def stream_heartbeat(self) -> bytes:
        """Idle-gap keepalive bytes (an SSE comment by default); empty
        bytes disable heartbeats for the family."""
        return b": hb\n\n"
