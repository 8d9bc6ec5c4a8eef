"""The benchmark's yardstick arithmetic: the H100's published peaks, the
least time a kernel could take (its roofline), and the bytes and FLOPs
that a model step must move or compute, all from shapes.

``roofline``, ``flash_bound``, ``flash_bwd_bound`` and ``visible_pairs``
are copies of the same functions in ``chip_smoke.py`` (there they take
torch dtypes; here a dtype is its name, and ``visible_pairs`` is the
closed form of the same count). The decode-byte and model-FLOP counts
are the benchmark's own.
"""

from __future__ import annotations

# published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12     # outside the tensor cores
PEAK_BYTES = 3.35e12

_ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def visible_pairs(S: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that attention over S positions computes:
    query i sees keys [max(0, i - window + 1), i] when causal."""
    if not causal:
        return S * S
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def roofline(flops: float, nbytes: float, dtype) -> dict:
    """The larger of bytes over the memory rate and FLOPs over the peak
    rate of the type."""
    peak = PEAK_FP32_FLOPS if _name(dtype) == "float32" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def flash_bound(B, H, Hkv, S, D, dtype, causal, window) -> dict:
    """The least time for one flash forward: its bytes (q, k, v read
    once, out and lse written once) and its FLOPs (2 products over the
    visible (query, key) pairs only)."""
    flops = 4 * B * H * D * visible_pairs(S, causal, window)
    item = _ITEM[_name(dtype)]
    nbytes = item * (2 * B * H * S * D + 2 * B * Hkv * S * D) + 4 * B * H * S
    return roofline(flops, nbytes, dtype)


def flash_bwd_bound(kernel, B, H, Hkv, S, D, dtype, causal, window) -> dict:
    """The least time for one backward kernel. Both read q, dO, k, v,
    LSE and delta once; dq writes dq and does 3 products (S, dP, dS K)
    over the visible pairs, dk/dv writes dk and dv and does 4 (S, dP,
    P^T dO, dS^T q)."""
    products = 3 if kernel == "dq" else 4
    flops = 2 * products * B * H * D * visible_pairs(S, causal, window)
    item = _ITEM[_name(dtype)]
    q_side, kv_side = B * H * S * D, B * Hkv * S * D
    tensors = (3 * q_side + 2 * kv_side if kernel == "dq"
               else 2 * q_side + 4 * kv_side)
    return roofline(flops, item * tensors + 2 * 4 * B * H * S, dtype)


# -- model arithmetic -----------------------------------------------------------
# ``m`` is a model's sizes: the dict that ``cells.model_sizes`` makes
# from a configuration file (d, f, L, H, Hkv, hd, V, E, k).

def layer_params(m: dict, active: bool = True) -> int:
    """Weights of one layer's products: attention's four projections and
    the FFN (with experts, the ``k`` a token uses when ``active``, else
    all ``E``, plus the router)."""
    d, f, hd = m["d"], m["f"], m["hd"]
    attn = d * m["H"] * hd * 2 + d * m["Hkv"] * hd * 2
    if m["E"]:
        return attn + (m["k"] if active else m["E"]) * 3 * d * f + d * m["E"]
    return attn + 3 * d * f


def attention_flops(m: dict, S: int, window: int | None) -> int:
    """The forward FLOPs of one sequence's attention over all layers:
    the QK and PV products over the visible pairs."""
    return 4 * m["H"] * m["hd"] * visible_pairs(S, True, window) * m["L"]


def prefill_flops(m: dict, plen: int, window: int | None) -> int:
    """Model FLOPs of one prefill of ``plen`` prompt tokens: every
    layer's products on every token, attention over the visible pairs,
    and the output head on the one position whose token is served."""
    return (2 * layer_params(m) * m["L"] * plen + attention_flops(
        m, plen, window) + 2 * m["d"] * m["V"])


def train_step_flops(m: dict, B: int, S: int, window: int | None) -> int:
    """Model FLOPs of one training step on B rows of S positions: 6 per
    active weight and token (forward and backward; MoE counts the top-k
    experts only, never capacity slots), the output head on every token,
    and three times attention's forward over the visible pairs. The input
    embedding is a lookup and counts nothing."""
    weights = layer_params(m) * m["L"] + m["d"] * m["V"]
    return B * (6 * weights * S + 3 * attention_flops(m, S, window))


def decode_step_bytes(m: dict, live: list[int]) -> int:
    """The bytes one decode step must move for the active slots, whose
    cached positions visible to their new query are ``live``: the int8
    weights and their fp32 per-channel scales read once (the layers'
    products and the output head), the bf16 norms and the active slots'
    embedding rows, each slot's live int8 keys and values with their fp32
    per-(token, head) scales read once, and the new ones written. bf16
    copies of the weights or of the cache, which the program may make,
    are not what the step needs and are not counted."""
    d, L, hd, Hkv = m["d"], m["L"], m["hd"], m["Hkv"]
    n = len(live)
    if n == 0:
        return 0
    outs = (m["H"] * hd + 2 * Hkv * hd + d + 2 * m["f"] + d)
    weights = layer_params(m) * L + d * m["V"]
    scales = 4 * (outs * L + m["V"])
    small = 2 * (2 * L * d + d) + 2 * n * d
    per_pos = L * 2 * Hkv * (hd + 4)
    return weights + scales + small + per_pos * (sum(live) + n)
