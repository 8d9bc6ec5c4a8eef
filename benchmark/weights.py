"""The benchmark's inputs drawn from ``--seed``: the model's weights, in
the port's stacked layout (``{"embed", "layers": {name: [L, ...]},
"final_norm", "lm_head"}``), and the training cells' token rows.

Each weight stack has a generator of its own, seeded from the run's seed
and the stack's name, so one stack can be drawn again alone and comes
out bitwise the same: the reference and the checks redraw what they need
after the program's state is freed, instead of keeping a copy. Draws run
on the device in one call a stack, in the type the model is served or
trained in."""

from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))


def stack_shapes(m: dict) -> dict:
    """name -> (shape, fan_in or None for a norm at one, dtype name)."""
    d, f, L, V, hd = m["d"], m["f"], m["L"], m["V"], m["hd"]
    H, Hkv, E = m["H"], m["Hkv"], m["E"]
    dt = m["dtype"]
    out = {"embed": ((V, d), d, dt),
           "attn_norm": ((L, d), None, dt),
           "wq": ((L, d, H * hd), d, dt),
           "wk": ((L, d, Hkv * hd), d, dt),
           "wv": ((L, d, Hkv * hd), d, dt),
           "wo": ((L, H * hd, d), H * hd, dt),
           "ffn_norm": ((L, d), None, dt)}
    if E:
        out.update({"wg": ((L, d, E), d, "float32"),
                    "w1": ((L, E, d, f), d, dt),
                    "w3": ((L, E, d, f), d, dt),
                    "w2": ((L, E, f, d), f, dt)})
    else:
        out.update({"w1": ((L, d, f), d, dt),
                    "w3": ((L, d, f), d, dt),
                    "w2": ((L, f, d), f, dt)})
    out.update({"final_norm": ((d,), None, dt),
                "lm_head": ((d, V), d, dt)})
    return out


def draw_stack(m: dict, seed: int, name: str, device) -> torch.Tensor:
    shape, fan_in, dt = stack_shapes(m)[name]
    dtype = getattr(torch, dt)
    if fan_in is None:
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator(seed, name, device),
                    dtype=dtype, device=device)
    return x.mul_(fan_in ** -0.5)


def draw(m: dict, seed: int, device) -> dict:
    """All weights, in the port's stacked tree."""
    top = ("embed", "final_norm", "lm_head")
    tree = {"layers": {}}
    for name in stack_shapes(m):
        w = draw_stack(m, seed, name, device)
        if name in top:
            tree[name] = w
        else:
            tree["layers"][name] = w
    return {"embed": tree["embed"], "layers": tree["layers"],
            "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}


def token_rows(seed: int, vocab: int, batch: int, seq: int, device):
    """The training feed, without end: batches ``[batch, seq + 1]`` of
    uniform token ids, each step's fresh, drawn in order from one
    generator (so the first n are the same however many follow)."""
    g = generator(seed, "tokens", device)
    while True:
        yield torch.randint(vocab, (batch, seq + 1), generator=g,
                            device=device)
