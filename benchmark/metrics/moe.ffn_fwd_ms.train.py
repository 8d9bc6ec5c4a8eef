"""Device milliseconds of ``moe.moe_ffn``'s forward calls (CUDA events
around each), per training step of the window."""


def read(rec):
    if not rec.get("moe_ms") or not rec.get("steps"):
        return None
    return rec["moe_ms"] / rec["steps"]
