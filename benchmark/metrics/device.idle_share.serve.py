"""The share of the traced window in which no operation ran on the
card."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return (1 - tr["busy_s"] / tr["window_s"]) * 100
