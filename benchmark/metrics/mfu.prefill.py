"""The share of the card's bf16 peak that the window's prefills reached:
their model FLOPs (``arith.prefill_flops`` of each prompt's length) over
their synchronised time at 989 TFLOP/s."""

from benchmark import arith


def read(rec):
    calls = rec.get("prefill")
    if not calls:
        return None
    flops = sum(arith.prefill_flops(rec["model"], n, rec["window"])
                for _, n in calls)
    seconds = sum(ms for ms, _ in calls) / 1e3
    return flops / (seconds * arith.PEAK_BF16_FLOPS) * 100
