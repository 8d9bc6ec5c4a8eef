"""Mean number of requests waiting in the frontend's queue for a slot,
``serve._EngineFrontend.queue_depth`` sampled every 50 ms through the
window."""


def read(rec):
    depth = rec.get("queue_depth")
    return sum(depth) / len(depth) if depth else None
