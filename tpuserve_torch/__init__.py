"""tpuserve_torch: the PyTorch/CUDA port of tpuserve for NVIDIA Hopper.

The package mirrors ``tpuserve/`` module for module, so each file has an
obvious counterpart there; the JAX package stays the reference the port is
tested against. This package imports ``torch`` and never ``jax``, ``flax``
or ``tpuserve``. Entry points (``python -m tpuserve_torch serve``,
``runtime.build_runtime``, ``server.ServerState``) run on the CUDA device
unless the caller asks for the CPU.
"""
