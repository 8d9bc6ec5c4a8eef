"""The AFMoE cells' yardstick arithmetic, from the sizes of
:func:`benchmark.weights_afmoe.sizes`: a training step's model FLOPs for
``mfu.train``, and the least time of the held experts' grouped products
for ``moe.expert_roofline.train``."""

from __future__ import annotations

from benchmark.arith import roofline, visible_pairs


def attention_params(m: dict) -> int:
    """One layer's attention weights: wq, wgate and wo over the query
    heads, wk and wv over the kv heads (the norms count nothing)."""
    d, hd = m["d"], m["hd"]
    return 3 * d * m["H"] * hd + 2 * d * m["Hkv"] * hd


def active_params(m: dict) -> float:
    """The weights a token's forward multiplies by on this card: every
    layer's attention, the dense layers' FFN, each MoE layer's router,
    shared expert and, on average, the held experts of its k picks
    (k x held / E of them, routing uniform in expectation), and the
    head."""
    d, L, Ld = m["d"], m["L"], m["Ld"]
    moe = (3 * d * m["fs"] + d * m["E"]
           + m["k"] * m["held"] / m["E"] * 3 * d * m["f"])
    return (L * attention_params(m) + Ld * 3 * d * m["fd"]
            + (L - Ld) * moe + d * m["V"])


def attention_flops(m: dict, S: int) -> int:
    """One sequence's attention forward over all layers: the QK and PV
    products over each layer's visible pairs (its window on a sliding
    layer, causal on a full one)."""
    return sum(4 * m["H"] * m["hd"] * visible_pairs(
        S, True, m["window"] if t == "sliding_attention" else None)
        for t in m["types"])


def train_step_flops(m: dict, B: int, S: int) -> float:
    """Model FLOPs of one step on B rows of S positions: 6 per active
    weight and token, and 3 times attention's forward."""
    return B * (6 * active_params(m) * S + 3 * attention_flops(m, S))


def expert_bound(pairs: int, experts: int, d: int, f: int,
                 dtype: str = "bfloat16") -> dict:
    """The least time of the held experts' forward products over
    ``pairs`` gathered rows: 3 products of 2 x pairs x d x f FLOPs, and
    the rows read, the experts' three weights read and the output
    written once."""
    item = 4 if dtype == "float32" else 2
    return roofline(6 * pairs * d * f,
                    item * (2 * pairs * d + 3 * experts * d * f), dtype)
