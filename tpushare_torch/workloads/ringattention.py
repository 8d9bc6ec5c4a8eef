"""Ring attention: the port of ``tpushare/workloads/ringattention.py``.

Exact attention with the sequence sharded over an ``sp`` mesh axis: each
rank holds a ``[B, H, S/n, D]`` chunk of q and ``[B, H_kv, S/n, D]``
chunks of k and v (GQA-native: the small kv heads ride the ring and are
never expanded), and the k/v chunks rotate around the ring
(:func:`~tpushare_torch.workloads.parallel.ppermute`, n-1 hops) while
each visiting chunk is folded into the rank's online-softmax state. No
rank ever holds the whole sequence.

The reference takes the global arrays and shards them in ``shard_map``;
the port runs one process per rank, so :func:`ring_attention` takes this
rank's chunk and returns its chunk of the output. :func:`shard_seq` cuts
a rank's chunk out of a global tensor (with the reference's divisibility
checks), :func:`gather_seq` puts the chunks back together.

Two routes, chosen by where the tensors lie:

- CPU tensors run :func:`_ring_fold`, the reference's fold
  (``_ring_body``, ``_ring_attention_local``) in torch ops: the scale
  folded into q in its storage dtype, fp32 scores, the clamped shift,
  p cast to v's dtype before the PV product, and the three mask classes
  (skip, masked, unmasked). It is the numerics spec, and differentiable.
- CUDA tensors run :class:`_RingFlash`: each visiting chunk's fold is
  one call of the flash forward K1 (``kernels.flash.flash_fwd``: a
  fully visible chunk non-causal, the diagonal chunk causal, a masked
  one not at all), and the per-chunk (O, LSE) pairs merge in fp32 by
  their LSEs. The plain fold's fp32 scores are ``[B, Hkv, G, S/n, S/n]``:
  8 GiB a rank at S = 32768 over 4 ranks with llama-8b's heads, where
  K1 keeps one tile. Under zigzag each of the four half-chunk pairs is
  its own class; K1 reads the half views in place. Its backward runs
  the same schedule through the dq and dk/dv kernels K2 and K3, with
  the merged LSE, and sends each chunk's fp32 dk/dv around the ring
  behind it.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads import parallel
from tpushare_torch.workloads.attention import (
    _bwd_residuals, _online_softmax_step, validate_gqa_qkv)

def _blocks(rank: int, per: int, n: int, zigzag: bool) -> list:
    """``[(row0, rows, block)]``: the pieces of rank ``rank``'s chunk of
    ``per`` rows, each a stretch of the global sequence, and the index of
    that stretch in units of its size: the whole chunk (block ``rank``
    of n) contiguous; two halves (blocks ``rank`` and ``2n-1-rank`` of
    2n) under zigzag."""
    if not zigzag:
        return [(0, per, rank)]
    h = per // 2
    return [(0, h, rank), (h, h, 2 * n - 1 - rank)]


def _chunk_positions(rank: int, per: int, n: int, zigzag: bool,
                     device=None) -> torch.Tensor:
    """Global sequence positions of the rows rank ``rank`` holds:
    [rank*per, (rank+1)*per) contiguous; under zigzag the sequence is cut
    into 2n half-chunks and rank r holds halves r and 2n-1-r, so every
    rank owns one early and one late stretch and causal work balances."""
    return torch.cat([torch.arange(b * rows, (b + 1) * rows, device=device)
                      for _, rows, b in _blocks(rank, per, n, zigzag)])


def zigzag_order(S: int, n: int) -> torch.Tensor:
    """Index permutation taking a sequence from natural order to zigzag
    ring order: cut into 2n half-chunks, rank r's chunk is halves (r,
    2n-1-r). Apply along the sequence axis before :func:`shard_seq` with
    ``zigzag=True``; invert with :func:`zigzag_inverse`."""
    if S % (2 * n):
        raise ValueError(f"seq len {S} not divisible by 2*{n}")
    return torch.cat([_chunk_positions(r, S // n, n, True)
                      for r in range(n)])


def zigzag_inverse(S: int, n: int) -> torch.Tensor:
    """Inverse permutation of :func:`zigzag_order`."""
    fwd = zigzag_order(S, n)
    inv = torch.empty_like(fwd)
    inv[fwd] = torch.arange(S)
    return inv


def shard_seq(x: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """This rank's chunk of a global ``[B, H, S, D]`` tensor along the
    sequence (dim 2) over ``axis`` (a view); S must divide by the axis
    size. For zigzag, permute with :func:`zigzag_order` first."""
    S, n = x.shape[2], parallel.axis_size(mesh, axis)
    if S % n:
        raise ValueError(f"seq len {S} not divisible by {axis} size {n}")
    per = S // n
    return x.narrow(2, parallel.axis_rank(mesh, axis) * per, per)


def gather_seq(x: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """The global tensor from every rank's sequence chunk (dim 2), in
    rank order: an exact all-reduce of zero-filled fp32 buffers (no
    gradient)."""
    n = parallel.axis_size(mesh, axis)
    if n == 1:
        return x
    full = parallel.gather_counts(x.detach().float(), mesh, axis)
    return torch.cat(list(full.unbind(0)), dim=2).to(x.dtype)


def _check(q, k, v, mesh, axis: str, zigzag: bool) -> None:
    n = parallel.axis_size(mesh, axis)
    per = q.shape[2]
    if zigzag and per % 2:
        raise ValueError(f"zigzag needs an even per-rank chunk (S/n = {per})")
    validate_gqa_qkv(q, k, v, extra="the ring moves 1/G of the bytes per "
                                    "hop with the small kv heads")
    if k.shape[2] != per:
        raise ValueError(f"ring attention needs equal q/kv lengths, got "
                         f"{per * n} vs {k.shape[2] * n}")


def _ring(n: int) -> list:
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_fold(q, k, v, mesh, axis: str, causal: bool,
               zigzag: bool) -> torch.Tensor:
    """The reference's fold in torch ops (``_ring_attention_local``):
    this rank's chunk of the output. Differentiable; every hop's backward
    stays in the graph (:func:`parallel.tie`), masked chunks included."""
    n, my = parallel.axis_size(mesh, axis), parallel.axis_rank(mesh, axis)
    B, H, sq, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    # scale folded into q in its storage dtype; grouped so each kv head
    # serves its query group
    qs = (q.float() * (d ** -0.5)).to(q.dtype).float()
    qs = qs.reshape(B, Hkv, G, sq, d)
    q_pos = _chunk_positions(my, sq, n, zigzag, q.device)
    m = torch.full((B, Hkv, G, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, Hkv, G, sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, sq, d), device=q.device)
    kv = torch.stack([k, v])        # the two ride the ring as one message
    for step in range(n):
        src = (my - step) % n
        k_pos = _chunk_positions(src, sq, n, zigzag, q.device)
        kb, vb = kv[0][:, :, None], kv[1][:, :, None]
        # three mask classes: fully masked (skip the fold), fully visible
        # (no mask), the rest (masked)
        if not causal or int(k_pos.max()) <= int(q_pos.min()):
            masked = False
        elif int(k_pos.min()) > int(q_pos.max()):
            masked = None
        else:
            masked = True
        if masked is not None:
            s = torch.matmul(qs, kb.float().transpose(-1, -2))
            if masked:
                mask = k_pos[None, :] <= q_pos[:, None]
                s = s.masked_fill(~mask, float("-inf"))
            m, l, acc = _online_softmax_step(s, vb, m, l, acc)
        if step < n - 1:
            kv = parallel.ppermute(kv, _ring(n), mesh, axis)
    out = (acc / l.clamp_min(1e-30)).reshape(B, H, sq, d).to(q.dtype)
    return parallel.tie(out, kv)


def _merge(acc, lse, o, lse_o):
    """Fold a piece's (O, LSE) into the running fp32 (acc, lse): the
    softmax-weighted mean of the two by their LSEs. A row no piece has
    reached yet has lse -inf and weight 0; the shift is clamped so that
    -inf - -inf never reaches an exp."""
    top = torch.maximum(lse, lse_o)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    a, b = torch.exp(lse - top), torch.exp(lse_o - top)
    total = a + b
    w = torch.where(total > 0, 1 / total, torch.zeros_like(total))
    acc.copy_((acc * a[..., None] + o.float() * b[..., None])
              * w[..., None])
    lse.copy_(torch.where(total > 0, top + torch.log(total),
                          torch.full_like(total, float("-inf"))))


def _pairs(my: int, src: int, sq: int, n: int, causal: bool,
           zigzag: bool) -> list:
    """``[(q0, qrows, k0, krows, diagonal)]``: the pieces of rank
    ``my``'s q chunk and of rank ``src``'s visiting k/v chunk that meet,
    each pair one kernel call. Without ``causal`` the whole chunks,
    non-causal; with it, under zigzag, each pair of a q half and a k half
    is skipped (fully masked), causal (the diagonal) or non-causal (fully
    visible)."""
    halves = zigzag and causal
    return [(q0, qrows, k0, krows, causal and kblock == qblock)
            for k0, krows, kblock in _blocks(src, sq, n, halves)
            for q0, qrows, qblock in _blocks(my, sq, n, halves)
            if not (causal and kblock > qblock)]


def _ring_flash_fwd(q, k, v, mesh, axis: str, causal: bool, zigzag: bool):
    """The card's forward: one flash-forward call (``kernels.flash.
    flash_fwd``: K1 on CUDA tensors, its plain version on CPU ones) per
    visible pair of each visiting chunk, merged by LSE in fp32. Returns
    ``(out in q's dtype, merged LSE fp32 [B, H, S/n])``."""
    from tpushare_torch.kernels import flash

    n, my = parallel.axis_size(mesh, axis), parallel.axis_rank(mesh, axis)
    B, H, sq, d = q.shape
    acc = torch.zeros((B, H, sq, d), device=q.device)
    lse = torch.full((B, H, sq), float("-inf"), device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        kb, vb = kv.unbind(0)
        for q0, qrows, k0, krows, diag in _pairs(my, (my - step) % n, sq, n,
                                                 causal, zigzag):
            o, l = flash.flash_fwd(q.narrow(2, q0, qrows),
                                   kb.narrow(2, k0, krows),
                                   vb.narrow(2, k0, krows), causal=diag)
            _merge(acc.narrow(2, q0, qrows), lse.narrow(2, q0, qrows), o, l)
        if step < n - 1:
            kv = parallel.ppermute(kv, _ring(n), mesh, axis)
    return acc.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    """The card's route with its backward (the reference's ``jax.grad``
    through ``lax.ppermute``). The forward (:func:`_ring_flash_fwd`)
    saves q, k, v, the merged output and the merged LSE. The backward
    runs the forward's schedule again: the k/v chunks ride the ring as
    before, and each visible pair is one call of the dq kernel (K2) and
    one of the dk/dv kernel (K3), both given this rank's merged LSE and
    delta rows, never a chunk's own, under ``_Flash.backward``'s
    conventions (``attention._bwd_residuals``). dq accumulates in fp32
    on this rank; dk and dv accumulate in an fp32 buffer that rides the
    ring with the chunk it belongs to, n-1 hops with it and one more
    home. A masked pair skips its launches, never a hop, so every rank
    posts the same hops in the same order."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, zigzag):
        out, lse = _ring_flash_fwd(q, k, v, mesh, axis, causal, zigzag)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = mesh, axis, causal, zigzag
        return out

    @staticmethod
    @torch.no_grad()
    def backward(ctx, do):
        from tpushare_torch.kernels import flash_bwd

        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, zigzag = ctx.ring
        n, my = parallel.axis_size(mesh, axis), parallel.axis_rank(mesh, axis)
        sq = q.shape[2]
        qs, do, lse, delta = _bwd_residuals(q, out, lse, do.contiguous())
        # the kernels read whole contiguous LSE and delta rows: one copy
        # per zigzag half, none for a contiguous chunk
        rows = {q0: (lse.narrow(2, q0, qrows).contiguous(),
                     delta.narrow(2, q0, qrows).contiguous())
                for q0, qrows, _ in _blocks(my, sq, n, zigzag and causal)}
        dq = torch.zeros(q.shape, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, device=q.device)
        for step in range(n):
            kb, vb = kv.unbind(0)
            for q0, qrows, k0, krows, diag in _pairs(
                    my, (my - step) % n, sq, n, causal, zigzag):
                args = (qs.narrow(2, q0, qrows), kb.narrow(2, k0, krows),
                        vb.narrow(2, k0, krows), do.narrow(2, q0, qrows),
                        *rows[q0])
                dq.narrow(2, q0, qrows).add_(
                    flash_bwd.flash_bwd_dq(*args, diag))
                dk, dv = flash_bwd.flash_bwd_dkdv(*args, diag)
                dkv[0].narrow(2, k0, krows).add_(dk)
                dkv[1].narrow(2, k0, krows).add_(dv)
            if step < n - 1:
                kv = parallel.ppermute(kv, _ring(n), mesh, axis)
            dkv = parallel.ppermute(dkv, _ring(n), mesh, axis)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def _ring_flash(q, k, v, mesh, axis: str, causal: bool,
                zigzag: bool) -> torch.Tensor:
    """The card's route, differentiable (:class:`_RingFlash`)."""
    return _RingFlash.apply(q, k, v, mesh, axis, causal, zigzag)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "sp", causal: bool = True,
                   zigzag: bool = False) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis`` of
    ``mesh`` (None: one rank): q is this rank's ``[B, H, S/n, D]``
    chunk, k and v its ``[B, H_kv, S/n, D]`` chunks (H_kv dividing H),
    in ring order; returns this rank's chunk of the output, in q's
    dtype. Every rank of the axis calls it together.

    ``zigzag=True`` expects the sequence pre-permuted with
    :func:`zigzag_order` (the output comes back in the same order): each
    rank then owns one early and one late stretch, so causal work is
    balanced instead of rank n-1 folding n visible chunks while rank 0
    folds one.

    CPU tensors run the reference's fold (:func:`_ring_fold`); CUDA
    tensors run each chunk through K1, and a gradient through K2 and K3
    (:class:`_RingFlash`). Both routes are differentiable."""
    _check(q, k, v, mesh, axis, zigzag)
    if q.device.type == "cpu":
        return _ring_fold(q, k, v, mesh, axis, causal, zigzag)
    return _ring_flash(q, k, v, mesh, axis, causal, zigzag)
