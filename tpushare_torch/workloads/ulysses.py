"""All-to-all (Ulysses) sequence parallelism: the port of
``tpushare/workloads/ulysses.py``.

The second sequence-parallel scheme beside
:mod:`~tpushare_torch.workloads.ringattention`. Where the ring keeps heads
whole and rotates k/v chunks, this one re-shards once:

    [B, H, S/n, D]  --all_to_all-->  [B, H/n, S, D]

each rank runs ordinary attention over the whole sequence for its head
subset, and a second all-to-all restores the sequence sharding. It needs
``H % n == 0`` and ``H_kv % n == 0``.

As in :mod:`ringattention`, a rank passes its own ``[B, H, S/n, D]``
chunk and gets its chunk of the output. q, k and v travel in one
all-to-all (each rank's tile holds its q heads, then its k and v heads):
the same bytes as the reference's three, one collective and one backward.
``attn="flash"`` runs ``flash_attention`` on the rank's head subset over
the full sequence (K1 forward, K2 and K3 backward on the card, the window
included); ``attn="einsum"`` runs ``attention_reference`` with the GQA
expansion done locally, after the small kv heads crossed the wire.
Differentiable either way: the all-to-all's backward is the inverse
all-to-all.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads import parallel
from tpushare_torch.workloads.attention import (
    attention_reference, flash_attention, validate_gqa_qkv)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "sp", causal: bool = True,
                      attn: str = "einsum",
                      window: int | None = None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``: q is this
    rank's ``[B, H, S/n, D]`` chunk, k and v its ``[B, H_kv, S/n, D]``
    chunks (pass the small kv heads: device d's query-head block needs
    exactly the kv block its all-to-all delivers, since (H/n)/G ==
    H_kv/n); returns this rank's chunk of the output. ``window=W``
    (causal only) is the sliding window, applied unchanged since each
    rank sees the whole sequence."""
    if attn not in ("einsum", "flash"):
        raise ValueError(f"attn must be 'einsum' or 'flash', got {attn!r}")
    if window is not None:
        if not causal:
            raise ValueError("window attention requires causal=True")
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")
    n = parallel.axis_size(mesh, axis)
    B, H, sq, D = q.shape
    if H % n:
        raise ValueError(
            f"{H} heads not divisible by {axis} size {n}; use ring "
            "attention when heads are scarcer than shards")
    Hkv = validate_gqa_qkv(q, k, v)
    if k.shape[2] != sq:
        raise ValueError(
            f"ulysses attention needs equal q/kv lengths, got {sq * n} vs "
            f"{k.shape[2] * n}")
    if Hkv % n:
        raise ValueError(
            f"{Hkv} kv heads not divisible by {axis} size {n}; expand "
            "K/V heads first (or use ring attention) when kv heads are "
            "scarcer than shards")
    h, hk = H // n, Hkv // n
    # one tile per rank: its q heads, then its k and v heads
    tiles = torch.cat([q.reshape(B, n, h, sq, D), k.reshape(B, n, hk, sq, D),
                       v.reshape(B, n, hk, sq, D)], dim=2)
    # heads scatter, sequence gathers: [B, n*(h+2hk), S/n, D] ->
    # [B, h+2hk, S, D]
    full = parallel.all_to_all(tiles.reshape(B, n * (h + 2 * hk), sq, D),
                               mesh, axis, split_dim=1, concat_dim=2)
    qh, kh, vh = full.split([h, hk, hk], dim=1)
    if attn == "flash":
        o = flash_attention(qh, kh, vh, causal=causal, window=window)
    else:
        g = h // hk
        if g > 1:
            kh = kh.repeat_interleave(g, dim=1)
            vh = vh.repeat_interleave(g, dim=1)
        o = attention_reference(qh, kh, vh, causal=causal,
                                window=window).to(q.dtype)
    # restore the sequence sharding: [B, h, S, D] -> [B, H, S/n, D]
    return parallel.all_to_all(o, mesh, axis, split_dim=2, concat_dim=1)
