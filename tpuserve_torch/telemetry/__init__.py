"""Telemetry plane of the port, mirroring ``tpuserve/telemetry`` without the
router's fleet scrape (``fleet.py``). Fed by the one metric registry the
server owns (``tpuserve_torch.obs.Metrics``):

- ``store``   — bounded per-metric time-series rings and the sampler thread
  that fills them (``GET /stats/history``);
- ``slo``     — the multi-window burn-rate engine over ``[model.slo]``
  objectives (``slo_burn_rate`` gauges, ``GET /alerts``) and the
  device-utilization derivation;
- ``profile`` — on-demand ``torch.profiler`` device traces merged with the
  span ring (``POST /debug/profile``);
- ``events``  — the structured event plane, the admin audit trail and the
  postmortem ledger (``GET /debug/events``, ``/debug/audit``,
  ``/debug/postmortems``).
"""

from tpuserve_torch.telemetry.events import (AuditLog, BlackBoxWriter, EventLog,
                                             PostmortemLog)
from tpuserve_torch.telemetry.profile import CaptureBusy, ProfileCapture
from tpuserve_torch.telemetry.slo import SloEngine, UtilizationDeriver
from tpuserve_torch.telemetry.store import MetricSampler, TimeSeriesStore

__all__ = [
    "AuditLog",
    "BlackBoxWriter",
    "CaptureBusy",
    "EventLog",
    "MetricSampler",
    "PostmortemLog",
    "ProfileCapture",
    "SloEngine",
    "TimeSeriesStore",
    "UtilizationDeriver",
]
