"""Milliseconds of ``DecodeEngine.prefill_slot`` (each call ended by a
device synchronisation) per 1000 prompt tokens, over the window's
prefills."""


def read(rec):
    calls = rec.get("prefill")
    if not calls:
        return None
    return sum(ms for ms, _ in calls) / sum(n for _, n in calls) * 1e3
