"""Concurrency and trace-discipline analysis, and the runtime witnesses
(``tpuserve/analysis/``'s, pointed at the port).

- ``tpuserve_torch.analysis.astlint`` — AST rule families over the serving
  path (blocking-in-async, lock-order cycles, unguarded cross-thread writes).
- ``tpuserve_torch.analysis.tracelint`` — TPS5xx discipline over captured
  regions (CUDA-graph recapture and host-sync hazards).
- ``tpuserve_torch.analysis.ledgerlint`` — TPS6xx acquire/release escape
  analysis over the four resource ledgers.
- ``tpuserve_torch.analysis.drift`` — docs/config/test drift rules.
- ``tpuserve_torch.analysis.witness`` — TPUSERVE_LOCK_WITNESS=1 lock-order
  and TPUSERVE_RETRACE_WITNESS=1 compile- and capture-stability witnesses.
- ``tpuserve_torch.analysis.cli`` — ``python -m tpuserve_torch lint``, with
  the checked-in baseline at ``tpuserve_torch/analysis/baseline.json``.

Kept import-light on purpose: none of these modules imports torch, so
``python -m tpuserve_torch lint`` runs on a bare Python.
"""
