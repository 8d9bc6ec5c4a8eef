"""K1's share of its roofline over the window: the sum of each launch's
least time (``arith.flash_bound`` at the launch's shape) over K1's device
time by name in the trace."""

from benchmark.trace import kernel_seconds


def read(rec):
    bounds = rec.get("flash")
    if not bounds or "trace" not in rec:
        return None
    seconds = kernel_seconds(rec["trace"], "flash_fwd")
    return sum(bounds) / (seconds * 1e3) * 100 if seconds else None
