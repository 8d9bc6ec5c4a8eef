"""Hand-written CUDA kernels of the port and their Python wrappers.

- :mod:`tpushare_torch.kernels.build` compiles ``tpushare_torch/csrc/*.cu``
  with ``nvcc`` at first use and loads the libraries with ctypes.
- :mod:`tpushare_torch.kernels.flash` wraps the flash-attention forward
  (``csrc/flash_fwd.cu``), which replaces the TPU kernel
  ``tpushare/workloads/attention.py:_flash_kernel``.
"""
