"""Milliseconds of each AdamW update (``torch.optim.AdamW.step`` in the
port's train step), synchronised before and after, averaged over the
window's steps."""


def read(rec):
    ms = rec.get("optimizer_ms")
    return sum(ms) / len(ms) if ms else None
