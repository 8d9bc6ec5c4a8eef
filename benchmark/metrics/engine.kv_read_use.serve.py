"""The share of the cache positions the decode steps attend that hold a
live key: the program's ``engine.quantum`` spans' ``live_keys`` (over each
step's active lanes, min(position + 1, window)) over the ``keys_read``
of their ``engine.step`` children (rows x the cache's length). None
where the program records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    spans = last_session()
    quanta = {s.id: s for s in spans if s.name == "engine.quantum"}
    read_ = sum(s.attrs["keys_read"] for s in spans
                if s.name == "engine.step" and s.parent in quanta)
    if not read_:
        return None
    return sum(q.attrs["live_keys"] for q in quanta.values()) / read_ * 100
