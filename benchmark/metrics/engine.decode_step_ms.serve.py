"""Milliseconds of ``DecodeEngine.decode_quantum`` (ended by reading its
tokens back) per decode step, over the window's quanta."""


def read(rec):
    quanta = rec.get("quanta")
    if not quanta:
        return None
    return sum(q[0] for q in quanta) / sum(q[1] for q in quanta)
