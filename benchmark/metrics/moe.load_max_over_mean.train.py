"""How unevenly the router loads the experts: the mean over the
program's ``moe.route`` spans (one a layer and forward) of ``max_load``,
the pairs routed to the busiest of all E experts over the mean k T / E
(summed on the device). 1 is an even load. None where the program
records no such counts."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    loads = [s.attrs["max_load"] for s in last_session()
             if s.name == "moe.route" and "max_load" in s.attrs]
    return sum(loads) / len(loads) if loads else None
