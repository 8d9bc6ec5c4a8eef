"""Mean milliseconds a request waits in ``serve._EngineFrontend``'s queue,
from its enqueue to the start of its admission into a slot: the
program's ``frontend.queue_wait`` spans over the traced window's
requests (through the drain). None where the program records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    waits = [s.end_ns - s.start_ns for s in last_session()
             if s.name == "frontend.queue_wait"]
    return sum(waits) / len(waits) / 1e6 if waits else None
