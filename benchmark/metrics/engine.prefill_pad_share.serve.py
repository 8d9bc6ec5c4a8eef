"""The share of the prefill positions that are padding: the program's
``engine.prefill`` spans, sum(bucket - plen) / sum(bucket), over the traced
window's requests. None where the program records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    calls = [s.attrs for s in last_session() if s.name == "engine.prefill"]
    if not calls:
        return None
    buckets = sum(a["bucket"] for a in calls)
    return (buckets - sum(a["plen"] for a in calls)) / buckets * 100
