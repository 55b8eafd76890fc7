"""Fleet-level SLO scheduler, ported from ``tpuserve/scheduler/``.

One server fronts many models; without cross-model arbitration one hot
model queue-starves the rest and every model's parameter slots must fit on
the card at once. This package sits between admission (the server's predict
handler and the router tier) and the per-model batchers and engines:

- :class:`FleetScheduler` — predictive admission (shed work that provably
  cannot meet its deadline, in microseconds), priority classes over a
  per-model device-seconds ledger (batch-class sheds first, interactive
  floors hold), and the warm/cold weight-paging state machine (cold models
  boot without parameter slots and stage through the lifecycle on demand).
- :class:`TenantLedger` (``tenants``) — per-tenant rate, quota and fair
  share at the front door.
- :class:`AutopilotLoop` (``autopilot``) — the fleet controller the primary
  router runs.
- :func:`run_fleet_drill` — the isolation drill behind ``python -m
  tpuserve_torch chaos --drill fleet``.
"""

from tpuserve_torch.scheduler.drill import run_fleet_drill  # noqa: F401
from tpuserve_torch.scheduler.fleet import FleetScheduler, Shed  # noqa: F401
