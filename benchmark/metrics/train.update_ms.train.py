"""Device milliseconds of the update per training step: the program's
``train.update`` spans (CUDA events around the "dp" mean of the
gradients, the optimizer's step and ``zero_grad``), averaged over the
traced window's steps; on a CPU path, whose work is synchronous, the
spans' host time. None where the program records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    ms = [s.device_ms if s.device_ms is not None
          else (s.end_ns - s.start_ns) / 1e6
          for s in last_session() if s.name == "train.update"]
    return sum(ms) / len(ms) if ms else None
