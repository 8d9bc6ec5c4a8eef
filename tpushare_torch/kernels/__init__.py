"""Hand-written CUDA kernels of the port and their Python wrappers.

- :mod:`tpushare_torch.kernels.build` compiles ``tpushare_torch/csrc/*.cu``
  with ``nvcc`` at first use and loads the libraries with ctypes.
- :mod:`tpushare_torch.kernels.flash` wraps the flash-attention forward
  (``csrc/flash_fwd.cu``), which replaces the TPU kernel
  ``tpushare/workloads/attention.py:_flash_kernel``.
- :mod:`tpushare_torch.kernels.flash_bwd` wraps the flash-attention
  backward (``csrc/flash_bwd.cu``): the dq and dk/dv kernels, which
  replace ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkdv_kernel``.
- :mod:`tpushare_torch.kernels.kv_decode` wraps the decode attention over
  the int8 KV cache (``csrc/kv_decode.cu``), which reads only each row's
  live keys. It replaces no TPU kernel: the reference's decode step is an
  einsum whose int8 convert XLA fuses into the dot.
"""
