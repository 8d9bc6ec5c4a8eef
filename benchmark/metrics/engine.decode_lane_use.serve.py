"""The share of the decode lanes computed that emitted a token: the
program's ``engine.quantum`` spans' ``emitted`` over the ``rows`` of
their ``engine.step`` children (every step computes every slot). None
where the program records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    spans = last_session()
    quanta = {s.id: s for s in spans if s.name == "engine.quantum"}
    rows = sum(s.attrs["rows"] for s in spans
               if s.name == "engine.step" and s.parent in quanta)
    if not rows:
        return None
    return sum(q.attrs["emitted"] for q in quanta.values()) / rows * 100
