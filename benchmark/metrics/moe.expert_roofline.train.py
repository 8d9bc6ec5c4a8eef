"""The held experts' grouped products' share of their roofline over the
traced window: the program's ``moe.experts`` spans (CUDA events around
the forward's grouped SwiGLU products of one MoE layer), the sum of each
span's least time (``arith_afmoe.expert_bound`` at its ``pairs``,
``experts``, ``d`` and ``f``) over the sum of their device times; on a
CPU path, whose work is synchronous, their host times. None where the
program records no such span."""

from benchmark import arith_afmoe


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    spans = [s for s in last_session() if s.name == "moe.experts"]
    ms = sum(s.device_ms if s.device_ms is not None
             else (s.end_ns - s.start_ns) / 1e6 for s in spans)
    if not ms:
        return None
    bound = sum(arith_afmoe.expert_bound(s.attrs["pairs"], s.attrs["experts"],
                                         s.attrs["d"], s.attrs["f"])["bound_ms"]
                for s in spans)
    return bound / ms * 100
