"""The share of the decode steps that replayed the engine's CUDA graph:
The sum of ``graph`` (1 for a replayed step, 0 for an eager one) over the
program's ``engine.step`` spans under an ``engine.quantum``, over their
count. A step span without ``graph`` (a program that never replays)
counts 0. None where the program records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    spans = last_session()
    quanta = {s.id for s in spans if s.name == "engine.quantum"}
    steps = [s for s in spans
             if s.name == "engine.step" and s.parent in quanta]
    if not steps:
        return None
    return sum(s.attrs.get("graph", 0) for s in steps) / len(steps) * 100
