"""The share of the card's memory rate that the window's decode steps
reached: the bytes the steps must move (``arith.decode_step_bytes``: the
int8 weights and scales once a step, each active slot's live int8 keys
and values once, the new ones written) over their synchronised time at
3.35 TB/s."""

from benchmark import arith


def read(rec):
    quanta = rec.get("quanta")
    if not quanta:
        return None
    seconds = sum(q[0] for q in quanta) / 1e3
    return sum(q[2] for q in quanta) / (seconds * arith.PEAK_BYTES) * 100
