"""Device ops of the port, mirroring ``tpuserve/ops``.

- ``flash_attention`` — hand-written Hopper kernels beside their plain
  PyTorch versions: K1 (normalized output, replacing
  ``tpuserve/ops/flash_attention.py::_fa_kernel``) and K2
  (``return_stats=True``, replacing ``_fa_kernel_stats``).
- ``ring_attention`` — sequence-parallel attention over a mesh's ``seq``
  axis: K/V blocks rotate around the ranks and each rank folds them into its
  queries' online softmax (local step dense or K2).
- ``ulysses_attention`` — the head all-to-all twin of the ring (local step
  dense or K1).
- ``moe`` — the top-1 Switch FFN (``switch_route``, ``SwitchFFN``) in the
  reference's static-shape formulation, as torch ops (the reference has no
  Pallas kernel there).

As in the JAX package, the functions are re-exported under their modules'
names; ``importlib.import_module("tpuserve_torch.ops.ring_attention")``
reaches the module itself.
"""

from tpuserve_torch.ops.ring_attention import dense_attention, ring_attention  # noqa: F401
from tpuserve_torch.ops.ulysses import ulysses_attention  # noqa: F401
