"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference/``), which is computed
from the benchmark's own inputs after the program's state is freed.

Serving: over a sample of the finished requests drawn from the seed,
with the longest in it, the widest gap by which a served (greedy)
token's logit lies below the reference's best at its position.

Training: over the first steps, which the window's own call and feed
ran before the window, the largest gap of a step's loss; the worst
leaf's gap between the norms of the first gradient as the optimizer got
it; the worst leaf's gap between the norms of the parameters' change
over those steps; and the median leaf's gap of the first gradient
itself, |program - reference| over 65536 positions of each leaf drawn
from the seed. A leaf's gap is measured against
the larger of its own reference norm and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change. And ``routed_row_gap``:
the first gradient's rows of the embedding at the first step's tokens
that occur once in it (each such row is the gradient at one position),
kept where the reference chose the position's experts by a margin in
the upper half in every expert layer (all such rows where the model has
no experts); the median of |program row - reference row| / |reference
row|. At bf16 a token whose router logits nearly tie may take another
expert, which moves every weight's gradient by its whole contribution;
a row of a position routed by a wide margin keeps its own choice of
experts out, and takes in only what other positions' choices send back
through attention. A cell compares the numbers its limits file names;
the others are printed as readings."""

from __future__ import annotations

import random
import statistics

import torch

from benchmark import weights as bench_weights
from benchmark.reference import model as ref


def sample(finished: list, size: int, seed: int) -> list:
    """``size`` of the finished requests (each with ``prompt`` and
    ``tokens``): the longest, and the rest drawn from the seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.tokens),
                                           -r.index))
    rest = [r for r in finished if r is not longest]
    rng = random.Random(int(seed) ^ 0x5EED)
    return [longest] + rng.sample(rest, min(size - 1, len(rest)))


def served_gap(ref_logits: list, served: list) -> float:
    """max over served tokens of (best reference logit - the token's)."""
    gap = 0.0
    for logits, toks in zip(ref_logits, served):
        idx = torch.tensor(toks, device=logits.device)[:, None]
        best = logits.max(dim=-1).values
        gap = max(gap, float((best - logits.gather(1, idx)[:, 0]).max()))
    return gap


def chosen_gap(ref_logits: list, other_logits: list) -> float:
    """The same gap for the tokens that ``other_logits`` put first at
    each position (a control that need not decode)."""
    return served_gap(ref_logits, [o.argmax(dim=-1).tolist()
                                   for o in other_logits])


def serve_precision(traffic: dict) -> ref.Precision:
    """The configuration's serving precision as the reference computes
    it: int8 products and int8 keys and values where the cell has them."""
    return ref.Precision(
        weight_bits=8 if traffic.get("quant") == "int8" else None,
        kv_bits=8 if traffic.get("kv_cache_dtype") == "int8" else None)


def serve_numbers(m: dict, seed: int, traffic: dict, picked: list, device,
                  control: ref.Precision | None = None) -> dict:
    """``{"served_gap"}`` for the picked requests, and with ``control``
    the gap of the control's first choices (``"control_gap"``)."""
    w = bench_weights.draw(m, seed, device)
    seqs = [(r.prompt, r.tokens) for r in picked]
    logits = ref.served_logits(w, m, seqs, serve_precision(traffic), device)
    out = {"served_gap": served_gap(logits, [r.tokens for r in picked])}
    if control is not None:
        other = ref.served_logits(w, m, seqs, control, device)
        out["control_gap"] = chosen_gap(logits, other)
    return out


def change_norms(m: dict, seed: int, current: dict, device) -> dict:
    """{leaf path: float32 norm of (current - as drawn)} for a stacked
    tree ``current``, each stack drawn again alone."""
    out = {}
    for name in bench_weights.stack_shapes(m):
        p0 = bench_weights.draw_stack(m, seed, name, device)
        if name in ("embed", "final_norm", "lm_head"):
            out[name] = float((current[name].float() - p0.float()).norm())
            continue
        cur = current["layers"][name]
        for i in range(m["L"]):
            out[f"layers.{i}.{name}"] = float(
                (cur[i].float() - p0[i].float()).norm())
        del p0
    return out


def leaf_gaps(program: dict, reference: dict, keys=None) -> dict:
    """Each leaf's |program norm - reference norm| over the larger of
    its reference norm and the median leaf's."""
    keys = list(reference) if keys is None else keys
    med = statistics.median(reference[k] for k in reference)
    return {k: abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
            for k in keys}


def _worst(gaps: dict) -> tuple[float, str]:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moving_leaves(ref_grads: dict) -> list:
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= 1e-3 * med]


def train_reference(m: dict, seed: int, traffic: dict, device,
                    prec: ref.Precision = ref.FP32,
                    loss_share: float = 1.0) -> dict:
    """The reference's readings over the cell's checked steps: losses,
    first gradients' norms and the change's norms."""
    w = bench_weights.draw(m, seed, device)
    n = traffic["check"]["steps"]
    feed = bench_weights.token_rows(seed, m["V"], traffic["batch"],
                                    traffic["seq"], device)
    batches = [next(feed) for _ in range(n)]
    grads, samples, out = {}, {}, {}
    pos, ids = once(batches[0][:, :-1])

    def on_grad(t, key, grad):
        if t == 1:
            grads[key] = float(grad.norm())
            samples[key] = grad.reshape(-1)[sample_index(
                grad.numel(), seed, key, grad.device)].cpu()
            if key == "embed":
                out["rows"] = grad[ids].cpu()

    def on_route(margins):
        out["margins"] = margins[pos].cpu()

    opt = ref.AdamW(lr=traffic["learning_rate"])
    losses = ref.train(w, m, batches, opt, prec, on_grad=on_grad,
                       on_route=on_route, loss_share=loss_share)
    del opt
    return {"losses": losses, "grads": grads, "samples": samples,
            "change": change_norms(m, seed, w, device), **out}


def once(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The positions (in ``tokens.reshape(-1)``'s order) whose token occurs
    once in ``tokens``, and those tokens."""
    flat = tokens.reshape(-1)
    counts = torch.bincount(flat)
    pos = torch.nonzero(counts[flat] == 1)[:, 0]
    return pos, flat[pos]


def row_gap(program: torch.Tensor, reference: torch.Tensor,
            margins: torch.Tensor | None) -> float:
    """The median over rows of |program - reference| / |reference|, over
    the rows whose margin is at least the median margin where margins
    are given."""
    rel = (program.float() - reference).norm(dim=1) \
        / reference.norm(dim=1).clamp_min(1e-30)
    if margins is not None:
        rel = rel[margins >= margins.median()]
    return float(rel.median())


SAMPLE = 1 << 16


def sample_index(numel: int, seed: int, key: str, device) -> torch.Tensor:
    """Where a leaf's first gradient is sampled: up to 65536 positions
    drawn from the seed and the leaf's path, the same on both sides."""
    if numel <= SAMPLE:
        return torch.arange(numel, device=device)
    g = bench_weights.generator(seed, "sample/" + key, device)
    return torch.randint(numel, (SAMPLE,), generator=g, device=device)


def sample_gaps(program: dict, reference: dict) -> dict:
    """Each leaf's |program - reference| over the sampled positions of
    its first gradient, as a share of the larger of the reference's
    sampled norm and the median leaf's."""
    norms = {k: float(v.norm()) for k, v in reference.items()}
    med = statistics.median(norms.values())
    return {k: float((program[k] - reference[k]).norm())
            / max(norms[k], med, 1e-30) for k in reference}


def train_numbers(program: dict, reference: dict) -> dict:
    """The numbers compared, from the program's readings and the
    reference's (each ``{"losses", "grads", "samples", "change",
    "rows"}``, the reference's with ``"margins"`` where it routes)."""
    loss_gap = max(abs(a - b) for a, b in zip(program["losses"],
                                              reference["losses"]))
    grad_gap, grad_at = _worst(leaf_gaps(program["grads"],
                                         reference["grads"]))
    moving = moving_leaves(reference["grads"])
    change_gap, change_at = _worst(leaf_gaps(
        program["change"], reference["change"], moving))
    diffs = sample_gaps(program["samples"], reference["samples"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "grad_diff_median": statistics.median(diffs.values()),
            "routed_row_gap": row_gap(program["rows"], reference["rows"],
                                      reference.get("margins")),
            "leaves_left_out": len(reference["grads"]) - len(moving),
            "grad_at": grad_at, "change_at": change_at}
