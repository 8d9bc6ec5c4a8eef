"""The share of the MoE FFN's capacity slots that hold a token: the
program's ``moe.route`` spans, sum(kept) / sum(slots), where ``slots`` is
the experts x the capacity C and ``kept`` the token-expert pairs that
found a slot (summed on the device). k / E where nothing drops at a
capacity factor of E / k. None where the program records no spans."""


def read(rec):
    try:
        from tpushare_torch.metrics import last_session
    except ImportError:
        return None
    routes = [s.attrs for s in last_session() if s.name == "moe.route"]
    slots = sum(a["slots"] for a in routes)
    return sum(a["kept"] for a in routes) / slots * 100 if slots else None
