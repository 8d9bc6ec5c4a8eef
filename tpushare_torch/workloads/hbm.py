"""Make the device plugin's HBM grant effective inside a PyTorch process.

The scheduler guarantees non-oversubscription at placement time; runtime
enforcement is the allocator's job. Two halves, because CUDA reads some
settings when it initialises and accepts others only afterwards:

    from tpushare_torch.workloads.hbm import (
        apply_hbm_gating, apply_memory_fraction)
    apply_hbm_gating()          # before the first CUDA call
    ...                         # CUDA initialises
    apply_memory_fraction()     # after it

- ``TPU_VISIBLE_CHIPS`` becomes ``CUDA_VISIBLE_DEVICES`` (same indices);
- a fractional grant (limit < chip total) sets
  ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``, so the caching
  allocator grows with demand instead of holding large fixed segments,
  and caps the process at limit/total of the card through
  ``torch.cuda.set_per_process_memory_fraction``.
"""

from __future__ import annotations

import logging
import os
from typing import Callable

from tpushare_torch.contract import (
    ENV_HBM_CHIP_TOTAL, ENV_HBM_LIMIT, ENV_VISIBLE_CHIPS)

log = logging.getLogger("tpushare_torch.workloads.hbm")

ENV_CUDA_VISIBLE = "CUDA_VISIBLE_DEVICES"
ENV_ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"


def grant_fraction(environ: dict[str, str] | None = None) -> float | None:
    """limit/total for a fractional grant, else None."""
    env = os.environ if environ is None else environ
    limit = _to_int(env.get(ENV_HBM_LIMIT))
    total = _to_int(env.get(ENV_HBM_CHIP_TOTAL))
    if limit and total and 0 < limit < total:
        return limit / total
    return None


def apply_hbm_gating(environ: dict[str, str] | None = None) -> dict[str, str]:
    """Before CUDA initialises: derive the CUDA env from the grant env.

    Returns the settings applied. Mutates os.environ (or the supplied
    dict) only where the operator has not set values.
    """
    env = os.environ if environ is None else environ
    applied: dict[str, str] = {}
    if grant_fraction(env) is not None:
        applied[ENV_ALLOC_CONF] = "expandable_segments:True"
    chips = env.get(ENV_VISIBLE_CHIPS)
    if chips:
        applied[ENV_CUDA_VISIBLE] = chips
    applied = {k: v for k, v in applied.items() if k not in env}
    env.update(applied)
    if applied:
        log.info("hbm gating applied: %s", applied)
    return applied


def apply_memory_fraction(environ: dict[str, str] | None = None,
                          set_fraction: Callable[[float], None] | None = None
                          ) -> float | None:
    """After CUDA initialises: cap this process at the grant's fraction
    of the card. ``set_fraction`` defaults to
    ``torch.cuda.set_per_process_memory_fraction`` on the current device.
    Returns the fraction applied, or None for a whole-card grant."""
    fraction = grant_fraction(environ)
    if fraction is None:
        return None
    if set_fraction is None:
        import torch
        set_fraction = torch.cuda.set_per_process_memory_fraction
    set_fraction(fraction)
    log.info("hbm gating: per-process memory fraction %.4f", fraction)
    return fraction


def _to_int(raw: str | None) -> int:
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0
