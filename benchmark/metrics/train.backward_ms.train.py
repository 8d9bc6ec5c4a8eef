"""Device milliseconds of the backward pass per training step: the
program's ``train.bwd`` spans (CUDA events at ``loss.backward()``'s
start and end), averaged over the traced window's steps; on a CPU path,
whose work is synchronous, the spans' host time. None where the program
records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    ms = [s.device_ms if s.device_ms is not None
          else (s.end_ns - s.start_ns) / 1e6
          for s in last_session() if s.name == "train.bwd"]
    return sum(ms) / len(ms) if ms else None
