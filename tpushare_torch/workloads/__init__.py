"""PyTorch workloads that run under tpushare HBM grants.

- :mod:`~tpushare_torch.workloads.hbm` — grant env to CUDA allocator
  settings.
- :mod:`~tpushare_torch.workloads.attention` — flash attention (CUDA
  kernel on the card, plain blockwise version on the CPU).
- :mod:`~tpushare_torch.workloads.model` — the llama-style decoder with
  int8 weights and the KV-cached serving forward.
- :mod:`~tpushare_torch.workloads.engine` — continuous-batching decode.
- :mod:`~tpushare_torch.workloads.serve` — the int8 serving replica.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. A CUDA request raises
    when CUDA is missing: entry points never carry on quietly on the
    CPU, which the caller must ask for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available; ask for the CPU explicitly (device='cpu', or "
                "--device cpu)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {str(device)!r}: expected cuda or cpu")
    return dev
