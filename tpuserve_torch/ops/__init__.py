"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``flash_attention``: kernel K1, replacing
``tpuserve/ops/flash_attention.py::_fa_kernel``)."""
