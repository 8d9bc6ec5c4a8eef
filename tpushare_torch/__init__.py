"""PyTorch/CUDA port of tpushare's workloads, for NVIDIA Hopper cards.

The JAX package ``tpushare`` stays the reference; this package sits beside
it, imports nothing from it, and keeps the same module names under
``tpushare_torch/workloads/`` so each counterpart is easy to find.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
