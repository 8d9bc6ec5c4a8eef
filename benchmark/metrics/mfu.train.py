"""The share of the card's bf16 peak that the window's training steps
reached: their model FLOPs (``arith.train_step_flops``: 6 per active
weight and token, MoE's top-k experts only, plus attention's visible
pairs) over the window's whole time at 989 TFLOP/s."""

from benchmark import arith


def read(rec):
    if not rec.get("steps"):
        return None
    return (rec["steps"] * rec["flops_per_step"]
            / (rec["window_s"] * arith.PEAK_BF16_FLOPS) * 100)
