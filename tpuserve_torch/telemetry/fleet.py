"""Fleet metric aggregation, ported from ``tpuserve/telemetry/fleet.py``.

The primary router scrapes every live worker and peer router (host agents
have no HTTP surface: their liveness is the primary's own ``host_up``
gauges, and a dead domain's workers show up here as stale sources) and
merges the expositions into ONE fleet view:

- **counters summed** across sources: ``requests_total{model=}`` on
  ``/metrics/fleet`` is exactly the sum of every process's counter;
- **gauges labelled per process**: a gauge is a statement about one process
  (queue depth, worker_up, utilization), so each sample gains a ``proc=``
  label instead of being summed;
- **histograms merged bucket by bucket**: every process shares the same
  bucket bounds (the obs module's constants), so per-``le`` cumulative
  counts and the _sum/_count pair add exactly, and quantiles computed from
  the merged histogram are true fleet quantiles.

Degradation contract: a source that refuses, fails or times out is marked
stale (``fleet_source_up{proc=}`` 0, a ``# STALE`` comment, and a row in
``/stats/fleet``) and the merge proceeds with the survivors. The scrape
endpoints never answer 5xx because a host died: a dead host is data, not
an error.

Everything here is pure text and dict work over the exposition format the
port's ``obs.Metrics.render_prometheus`` renders; exemplar suffixes and
``# EOF`` are stripped on parse and ``# EOF`` is re-emitted on render. The
output is the reference's byte for byte on the same inputs.
"""

from __future__ import annotations

import re

_LINE_RE = re.compile(
    r"^(?P<base>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s#]+)")


def parse_exposition(text: str) -> dict:
    """Parse one /metrics body into ``{"types": {base: kind},
    "samples": [(base, labels_str, value)]}``. Exemplars (anything after
    ``#`` on a sample line) and comments are dropped; unparseable values
    are skipped rather than fatal (a torn scrape loses lines, not the
    merge)."""
    types: dict[str, str] = {}
    samples: list[tuple[str, str, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _LINE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        samples.append((m.group("base"), m.group("labels") or "", value))
    return {"types": types, "samples": samples}


def _hist_base(base: str) -> str | None:
    """The histogram family name for a _bucket/_sum/_count sample."""
    for suffix in ("_bucket", "_sum", "_count"):
        if base.endswith(suffix):
            return base[: -len(suffix)]
    return None


def _strip_le(labels: str) -> tuple[str, str | None]:
    """Split a _bucket label set into (labels-without-le, le value)."""
    parts = [p for p in labels.split(",") if p]
    le = None
    kept = []
    for p in parts:
        if p.startswith("le="):
            le = p[3:].strip('"')
        else:
            kept.append(p)
    return ",".join(kept), le


def _with_proc(labels: str, proc: str) -> str:
    extra = f'proc="{proc}"'
    return f"{labels},{extra}" if labels else extra


def merge_expositions(sources: "list[tuple[str, str | None]]") -> str:
    """Merge ``(proc_label, exposition_text | None)`` sources into one
    fleet exposition. ``None`` text = a stale source: it contributes a
    ``fleet_source_up`` 0 and a ``# STALE`` marker, nothing else."""
    types: dict[str, str] = {}
    counters: dict[tuple[str, str], float] = {}
    gauges: list[tuple[str, str, float]] = []
    # (family, labels-without-le) -> {le -> count}; sums/counts separately.
    hist_buckets: dict[tuple[str, str], dict[str, float]] = {}
    hist_sums: dict[tuple[str, str], float] = {}
    hist_counts: dict[tuple[str, str], float] = {}
    stale: list[str] = []

    for proc, text in sources:
        if text is None:
            stale.append(proc)
            continue
        parsed = parse_exposition(text)
        types.update(parsed["types"])
        src_types = parsed["types"]
        for base, labels, value in parsed["samples"]:
            family = _hist_base(base)
            if family is not None and src_types.get(family) == "histogram":
                key_labels, le = _strip_le(labels)
                if base.endswith("_bucket") and le is not None:
                    hist_buckets.setdefault(
                        (family, key_labels), {}).setdefault(le, 0.0)
                    hist_buckets[(family, key_labels)][le] += value
                elif base.endswith("_sum"):
                    hist_sums[(family, key_labels)] = \
                        hist_sums.get((family, key_labels), 0.0) + value
                elif base.endswith("_count"):
                    hist_counts[(family, key_labels)] = \
                        hist_counts.get((family, key_labels), 0.0) + value
                continue
            kind = src_types.get(base, "counter")
            if kind == "gauge":
                gauges.append((base, _with_proc(labels, proc), value))
            else:
                counters[(base, labels)] = \
                    counters.get((base, labels), 0.0) + value

    def fmt(v: float) -> str:
        return f"{int(v)}" if float(v).is_integer() else f"{v}"

    lines: list[str] = []
    typed: set[str] = set()

    def type_line(base: str, kind: str) -> None:
        if base not in typed:
            typed.add(base)
            lines.append(f"# TYPE {base} {kind}")

    for (base, labels), value in sorted(counters.items()):
        type_line(base, "counter")
        label_str = f"{{{labels}}}" if labels else ""
        lines.append(f"{base}{label_str} {fmt(value)}")
    for base, labels, value in sorted(gauges):
        type_line(base, "gauge")
        lines.append(f"{base}{{{labels}}} {fmt(value)}")
    for (family, labels), buckets in sorted(hist_buckets.items()):
        type_line(family, "histogram")
        sep = "," if labels else ""

        def le_key(le: str) -> float:
            return float("inf") if le == "+Inf" else float(le)

        for le in sorted(buckets, key=le_key):
            lines.append(
                f'{family}_bucket{{{labels}{sep}le="{le}"}} '
                f"{fmt(buckets[le])}")
        lines.append(f"{family}_sum{{{labels}}} "
                     f"{hist_sums.get((family, labels), 0.0)}")
        lines.append(f"{family}_count{{{labels}}} "
                     f"{fmt(hist_counts.get((family, labels), 0.0))}")
    for proc, _ in sources:
        type_line("fleet_source_up", "gauge")
        lines.append(f'fleet_source_up{{proc="{proc}"}} '
                     f"{0 if proc in stale else 1}")
    for proc in stale:
        lines.append(f"# STALE {proc}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def sum_counter(merged_or_text: str, base: str,
                labels: str | None = None) -> float:
    """Sum one counter family (optionally one exact label set) out of an
    exposition body (what a check of the fleet sum reads)."""
    total = 0.0
    for b, ls, v in parse_exposition(merged_or_text)["samples"]:
        if b != base:
            continue
        if labels is not None and ls != labels:
            continue
        total += v
    return total
