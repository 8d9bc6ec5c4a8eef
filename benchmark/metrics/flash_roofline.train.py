"""K1, K2 and K3's share of their roofline over the window: the sum of
each launch's least time (``arith.flash_bound`` and
``arith.flash_bwd_bound`` at the launch's shape) over the three kernels'
device time by name in the trace, so each kernel weighs by its time."""

from benchmark.trace import kernel_seconds


def read(rec):
    bounds = rec.get("flash")
    if not bounds or "trace" not in rec:
        return None
    seconds = kernel_seconds(rec["trace"], "flash_fwd", "flash_bwd")
    return sum(bounds) / (seconds * 1e3) * 100 if seconds else None
