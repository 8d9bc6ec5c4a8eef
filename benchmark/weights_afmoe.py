"""The AFMoE (Trinity) cells' sizes and weights, drawn from ``--seed`` in
the port's stacked layout: every layer's stacks ``[L, ...]``, the
leading dense layers' FFN ``dense_w*`` ``[L_dense, ...]``, and the MoE
layers' router, held experts, shared expert and router buffers
``[L - L_dense, ...]``. As in :mod:`benchmark.weights`, each stack has a
generator of its own (the run's seed and the stack's name), so one stack
can be drawn again alone, bitwise the same; the training feed is
:func:`benchmark.weights.token_rows` over the vocabulary's slice."""

from __future__ import annotations

import torch

from benchmark.weights import generator

BUFFERS = ("router_bias", "router_load")


def sizes(conf: dict) -> dict:
    """The sizes the driver, the arithmetic and the reference read, from
    a configuration file: ``num_experts`` is the experts held here (the
    first ones), ``published["num_experts"]`` those the router scores."""
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    if not conf["mup_enabled"] or conf["score_func"] != "sigmoid" \
            or not conf["route_norm"]:
        raise ValueError("the AFMoE cells run mup, sigmoid routing and "
                         "route_norm as Trinity publishes them")
    return {"d": d, "L": L, "H": conf["num_attention_heads"],
            "Hkv": conf["num_key_value_heads"], "hd": conf["head_dim"],
            "V": conf["vocab_size"], "types": conf["layer_types"][:L],
            "window": conf["sliding_window"], "theta": conf["rope_theta"],
            "eps": conf["rms_norm_eps"], "fd": conf["intermediate_size"],
            "Ld": min(conf["num_dense_layers"], L),
            "E": conf.get("published", {}).get("num_experts",
                                               conf["num_experts"]),
            "held": conf["num_experts"], "k": conf["num_experts_per_tok"],
            "f": conf["moe_intermediate_size"],
            "fs": conf["moe_intermediate_size"] * conf["num_shared_experts"],
            "route_scale": conf["route_scale"],
            "bias_rate": conf["load_balance_coeff"],
            "embed_scale": d ** 0.5, "dtype": conf["torch_dtype"]}


def stack_shapes(m: dict) -> dict:
    """name -> (shape, fan_in, or "ones" / "zeros", dtype name), in the
    port's order of a layer's leaves."""
    d, L, V, hd, dt = m["d"], m["L"], m["V"], m["hd"], m["dtype"]
    H, Hkv, Ld = m["H"], m["Hkv"], m["Ld"]
    Lm, fd, f, fs, E = L - Ld, m["fd"], m["f"], m["fs"], m["E"]
    out = {"embed": ((V, d), d, dt),
           "attn_norm": ((L, d), "ones", dt),
           "wq": ((L, d, H * hd), d, dt),
           "wk": ((L, d, Hkv * hd), d, dt),
           "wv": ((L, d, Hkv * hd), d, dt),
           "g_q": ((L, hd), "ones", dt),
           "g_k": ((L, hd), "ones", dt),
           "wgate": ((L, d, H * hd), d, dt),
           "wo": ((L, H * hd, d), H * hd, dt),
           "post_attn_norm": ((L, d), "ones", dt),
           "ffn_norm": ((L, d), "ones", dt)}
    if Ld:
        out.update({"dense_w1": ((Ld, d, fd), d, dt),
                    "dense_w3": ((Ld, d, fd), d, dt),
                    "dense_w2": ((Ld, fd, d), fd, dt)})
    if Lm:
        held = m["held"]
        out.update({"wg": ((Lm, d, E), d, "float32"),
                    "w1": ((Lm, held, d, f), d, dt),
                    "w3": ((Lm, held, d, f), d, dt),
                    "w2": ((Lm, held, f, d), f, dt),
                    "shared_w1": ((Lm, d, fs), d, dt),
                    "shared_w3": ((Lm, d, fs), d, dt),
                    "shared_w2": ((Lm, fs, d), fs, dt),
                    "router_bias": ((Lm, E), "zeros", "float32"),
                    "router_load": ((Lm, E), "zeros", "float32")})
    out.update({"post_ffn_norm": ((L, d), "ones", dt),
                "final_norm": ((d,), "ones", dt),
                "lm_head": ((d, V), d, dt)})
    return out


def draw_stack(m: dict, seed: int, name: str, device) -> torch.Tensor:
    shape, fan_in, dt = stack_shapes(m)[name]
    dtype = getattr(torch, dt)
    if fan_in == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if fan_in == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator(seed, name, device),
                    dtype=dtype, device=device)
    return x.mul_(fan_in ** -0.5)


TOP = ("embed", "final_norm", "lm_head")


def draw(m: dict, seed: int, device) -> dict:
    """All weights and buffers, in the port's stacked tree."""
    tree = {"layers": {}}
    for name in stack_shapes(m):
        w = draw_stack(m, seed, name, device)
        if name in TOP:
            tree[name] = w
        else:
            tree["layers"][name] = w
    return {"embed": tree["embed"], "layers": tree["layers"],
            "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}


def layer_of(m: dict, name: str, i: int) -> int | None:
    """Where layer ``i`` lies in stack ``name``: None where the layer has
    no such weight (an MoE stack at a dense layer, or the reverse)."""
    Ld = m["Ld"]
    if name.startswith("dense_"):
        return i if i < Ld else None
    if stack_shapes(m)[name][0][0] != m["L"]:
        return i - Ld if i >= Ld else None
    return i


def change_norms(m: dict, seed: int, current: dict, device) -> dict:
    """{leaf path: float32 norm of (current - as drawn)} for a stacked
    tree ``current``, each stack drawn again alone; the buffers are no
    leaves."""
    out = {}
    for name in stack_shapes(m):
        if name in BUFFERS:
            continue
        p0 = draw_stack(m, seed, name, device)
        if name in TOP:
            out[name] = float((current[name].float() - p0.float()).norm())
            continue
        cur = current["layers"][name]
        for i in range(m["L"]):
            j = layer_of(m, name, i)
            if j is not None:
                out[f"layers.{i}.{name}"] = float(
                    (cur[j].float() - p0[j].float()).norm())
        del p0
    return out
