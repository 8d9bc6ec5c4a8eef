"""Flash attention for the port: API, plain versions and kernel dispatch.

Counterpart of ``tpushare/workloads/attention.py``. Same layouts: q is
``[B, H, S, D]``, k/v ``[B, H_kv, S_kv, D]`` with H_kv dividing H (pass the
small kv heads; they are never expanded). Same validation and the same
``ValueError`` messages, except the reference's 128-multiple tile rule,
which is TPU MXU alignment.

- :func:`flash_attention` validates and runs :func:`_flash_call`, which
  goes through :func:`tpushare_torch.kernels.flash.flash_fwd`: the
  hand-written CUDA kernel for CUDA tensors (K1, or with ``fwd_impl``
  "pipelined" K4, which returns bitwise K1's results),
  :func:`flash_attention_plain` for CPU tensors.
- :func:`flash_attention_plain` is the kernel's plain version: the same
  online-softmax / log-sum-exp recurrence, block by block over the keys,
  in torch ops. The CPU path and the kernel's check on the card use it.
- :func:`attention_reference` is the einsum spec.

Differentiable: with a gradient, :func:`flash_attention` runs through
:class:`_Flash`, whose backward is chosen by ``bwd_impl`` (or
``$TPUSHARE_FLASH_BWD``): "pallas", the default, runs the dq and dk/dv
kernels (:mod:`tpushare_torch.kernels.flash_bwd`; their plain versions
:func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkdv_plain` for CPU
tensors), and "xla" the reference's fp32 escape hatch
:func:`_flash_bwd_xla` in torch ops on either device.
"""

from __future__ import annotations

import os

import torch

MAX_HEAD_DIM = 128
# key block of the plain versions; equal to the kernels' kv tile so both
# apply the online-softmax update at the same block boundaries
BLOCK = 64
# key block of _flash_bwd_xla: the reference's own BLOCK there
XLA_BLOCK = 128

_FLASH_BWD_IMPLS = ("xla", "pallas")
_FLASH_FWD_IMPLS = ("step", "pipelined")


def _resolve_flash_fwd(fwd_impl: str | None) -> str:
    """The forward kernel, resolved like :func:`_resolve_flash_bwd`: the
    argument, else ``$TPUSHARE_FLASH_FWD``, else "step". "step" is K1,
    one kv tile a step; "pipelined" is K4, which computes tile j's
    scores while it consumes tile j-1's, with the same results bitwise.
    """
    if fwd_impl is None:
        fwd_impl = os.environ.get("TPUSHARE_FLASH_FWD", "step")
    if fwd_impl not in _FLASH_FWD_IMPLS:
        raise ValueError(
            f"fwd_impl={fwd_impl!r} (or $TPUSHARE_FLASH_FWD) must be "
            f"one of {_FLASH_FWD_IMPLS}")
    return fwd_impl


def _resolve_flash_bwd(bwd_impl: str | None) -> str:
    """The backward implementation, resolved when :func:`flash_attention`
    runs (outside the graph): the argument, else ``$TPUSHARE_FLASH_BWD``,
    else "pallas". "pallas" is the dq and dk/dv kernel pair (the name is
    the reference's), "xla" the fp32 blockwise escape hatch."""
    if bwd_impl is None:
        bwd_impl = os.environ.get("TPUSHARE_FLASH_BWD", "pallas")
    if bwd_impl not in _FLASH_BWD_IMPLS:
        raise ValueError(
            f"bwd_impl={bwd_impl!r} (or $TPUSHARE_FLASH_BWD) must be one "
            f"of {_FLASH_BWD_IMPLS}")
    return bwd_impl


def validate_gqa_qkv(q, k, v, extra: str = "") -> int:
    """The GQA layout contract: q [B, H, S, D]; k/v [B, H_kv, S_kv, D]
    with H_kv dividing H. Returns H_kv."""
    B, H, S, D = q.shape
    Hkv = k.shape[1] if k.dim() == 4 else -1
    if (k.dim() != 4 or v.shape != k.shape or Hkv <= 0 or H % Hkv
            or tuple(k.shape) != (B, Hkv, k.shape[2], D)):
        raise ValueError(
            f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} "
            "must share batch and head_dim, with kv heads dividing query "
            "heads (GQA-native: pass the SMALL kv heads, do not pre-expand)"
            + (f"; {extra}" if extra else ""))
    return Hkv


def sliding_window_mask(row_pos, col_pos, window: int):
    """Key ``col_pos`` is visible from query ``row_pos`` iff
    ``col_pos >= row_pos - (window - 1)`` (W keys including the
    diagonal). Broadcasts over compatible position tensors."""
    return col_pos >= row_pos - (window - 1)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Plain einsum attention (the behavioural spec). Scores come out of
    the product in q's dtype and are then cast to fp32, as in the
    reference; ``window=W`` needs ``causal``."""
    if window is not None and not causal:
        raise ValueError("window attention requires causal=True")
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (d ** -0.5)
    if causal:
        S = q.shape[2]
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask = mask & sliding_window_mask(pos[:, None], pos[None, :],
                                              window)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _online_softmax_step(s, vb, m, l, acc):
    """One online-softmax update from a masked fp32 score block ``s``
    [.., BQ, BK] and its value block ``vb`` [.., BK, D]; returns the new
    ``(m, l, acc)``. Rows with no visible key yet keep m = -inf; their
    shift is clamped to 0 so exp(-inf - -inf) never makes a NaN."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - shift)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                        torch.zeros_like(m))
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    # p is rounded to the value dtype before the second product
    acc = acc * alpha + torch.matmul(p.to(vb.dtype).float(), vb.float())
    return m_new, l, acc


def _emit(m, l, acc, dtype):
    """Normalise the accumulator; LSE is -inf for rows with no visible
    key (their output is 0)."""
    out = (acc / l.clamp_min(1e-30)).to(dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(m, float("-inf")))
    return out, lse[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          window: int | None = None):
    """Blockwise flash attention in torch ops: the kernel's plain
    version. Returns ``(out [B, H, S, D] in q's dtype, lse [B, H, S]
    fp32)``. The softmax scale is folded into q once (fp32 multiply,
    rounded to q's dtype); scores and the accumulator are fp32."""
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    qs = (q.float() * (D ** -0.5)).to(q.dtype)
    # [B, Hkv, G, S, D]: query head h = hk * G + g reads kv head hk
    qg = qs.float().reshape(B, Hkv, G, S, D)
    m = torch.full((B, Hkv, G, S, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, Hkv, G, S, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    for j0 in range(0, Skv, BLOCK):
        kb = k[:, :, None, j0:j0 + BLOCK]                   # [B,Hkv,1,bk,D]
        vb = v[:, :, None, j0:j0 + BLOCK]
        s = torch.matmul(qg, kb.float().transpose(-1, -2))  # [B,Hkv,G,S,bk]
        if causal:
            cols = torch.arange(j0, j0 + kb.shape[3], device=q.device)[None]
            mask = cols <= rows
            if window is not None:
                mask = mask & sliding_window_mask(rows, cols, window)
            s = s.masked_fill(~mask, float("-inf"))
        m, l, acc = _online_softmax_step(s, vb, m, l, acc)
    out, lse = _emit(m, l, acc, q.dtype)
    return out.reshape(B, H, S, D), lse.reshape(B, H, S)


def _flash_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int | None = None,
                pipelined: bool = False):
    """Run the forward; returns ``(out [B, H, S, D], lse [B, H, S] fp32)``.
    CUDA tensors launch the kernel (K4 with ``pipelined``, else K1), CPU
    tensors run the plain version."""
    from tpushare_torch.kernels.flash import flash_fwd
    return flash_fwd(q, k, v, causal=causal, window=window,
                     pipelined=pipelined)


# -- backward -------------------------------------------------------------------

def _bwd_residuals(q, out, lse, do):
    """The inputs of the backward kernels, made as the reference's
    ``_flash_bwd_pallas`` makes them outside its kernels. Returns ``(qs,
    do, lse, delta)``: q pre-scaled by ``D**-0.5`` in fp32 and rounded to
    its dtype; dO cast to q's dtype; the LSE with -inf clamped to +1e30,
    so P is exactly 0 on rows that see no key (0 would leave P = exp(s),
    which a large score can overflow into a NaN dS); delta =
    rowsum(fp32 dO * fp32 O)."""
    D = q.shape[-1]
    qs = (q.float() * (D ** -0.5)).to(q.dtype)
    do = do.to(q.dtype)
    lse = torch.where(torch.isfinite(lse), lse,
                      torch.full_like(lse, 1e30)).contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    return qs, do, lse, delta


def _bwd_blocks(qs, k, v, do, lse, delta, causal, window):
    """The block math shared by the plain backward versions (the
    reference's ``_bwd_common``), one 64-key block at a time. Yields
    ``(kb, p, ds)``: the block's keys as fp32 ``[B, Hkv, 1, bk, D]``, P
    = exp(s - LSE) in fp32 and dS = P * (dP - delta) rounded to k's dtype
    (held as fp32), both ``[B, Hkv, G, S, bk]``. Query head h = hk * G + g
    reads kv head hk."""
    B, H, S, D = qs.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = qs.float().reshape(B, Hkv, G, S, D)
    dog = do.float().reshape(B, Hkv, G, S, D)
    lse_g = lse.reshape(B, Hkv, G, S, 1)
    delta_g = delta.reshape(B, Hkv, G, S, 1)
    rows = torch.arange(S, device=qs.device)[:, None]
    for j0 in range(0, Skv, BLOCK):
        kb = k[:, :, None, j0:j0 + BLOCK].float()
        vb = v[:, :, None, j0:j0 + BLOCK].float()
        s = torch.matmul(qg, kb.transpose(-1, -2))
        if causal:
            cols = torch.arange(j0, j0 + kb.shape[3], device=qs.device)[None]
            mask = cols <= rows
            if window is not None:
                mask = mask & sliding_window_mask(rows, cols, window)
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.exp(s - lse_g)  # masked entries and clamped rows give 0
        dp = torch.matmul(dog, vb.transpose(-1, -2))
        yield kb, p, (p * (dp - delta_g)).to(k.dtype).float()


def flash_bwd_dq_plain(qs, k, v, do, lse, delta, causal: bool = True,
                       window: int | None = None) -> torch.Tensor:
    """dq of the flash backward in torch ops: the dq kernel's plain
    version, on the inputs :func:`_bwd_residuals` makes. dq leaves the
    block sum rounded to q's dtype, then is scaled in fp32 and rounded
    again, as in the reference."""
    B, H, S, D = qs.shape
    Hkv = k.shape[1]
    acc = torch.zeros((B, Hkv, H // Hkv, S, D), device=qs.device)
    for kb, _, ds in _bwd_blocks(qs, k, v, do, lse, delta, causal, window):
        acc = acc + torch.matmul(ds, kb)
    dq = acc.to(qs.dtype).float() * (D ** -0.5)
    return dq.to(qs.dtype).reshape(B, H, S, D)


def flash_bwd_dkdv_plain(qs, k, v, do, lse, delta, causal: bool = True,
                         window: int | None = None):
    """``(dk, dv)`` of the flash backward in torch ops: the dk/dv
    kernel's plain version. Each kv head sums over its query-head group;
    P is rounded to dO's dtype before the dV product."""
    B, H, S, D = qs.shape
    Hkv = k.shape[1]
    qg = qs.float().reshape(B, Hkv, H // Hkv, S, D)
    dog = do.float().reshape(B, Hkv, H // Hkv, S, D)
    dks, dvs = [], []
    for _, p, ds in _bwd_blocks(qs, k, v, do, lse, delta, causal, window):
        pr = p.to(do.dtype).float().transpose(-1, -2)
        dvs.append(torch.matmul(pr, dog).sum(dim=2))
        dks.append(torch.matmul(ds.transpose(-1, -2), qg).sum(dim=2))
    if not dks:
        return torch.zeros_like(k), torch.zeros_like(v)
    return (torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def _flash_bwd_pallas(q, k, v, out, lse, do, causal: bool,
                      window: int | None = None):
    """The kernel-pair backward (the reference's ``_flash_bwd_pallas``):
    the dq kernel, then the dk/dv kernel, on CUDA tensors; their plain
    versions on CPU tensors. Returns ``(dq, dk, dv)``."""
    from tpushare_torch.kernels.flash_bwd import flash_bwd_dkdv, flash_bwd_dq
    qs, do, lse, delta = _bwd_residuals(q, out, lse, do)
    dq = flash_bwd_dq(qs, k, v, do, lse, delta, causal, window)
    dk, dv = flash_bwd_dkdv(qs, k, v, do, lse, delta, causal, window)
    return dq, dk, dv


def _flash_bwd_xla(causal, res, do, window: int | None = None):
    """Blockwise backward in fp32 torch ops, over 128-key blocks, with
    K/V expanded to the query heads (the reference's ``bwd_impl="xla"``
    escape hatch). ``res`` is ``(q, k, v, out, lse)``. Like the
    reference it multiplies every block, masked ones included, and
    clamps a -inf LSE to 0 (those rows' dO is zero)."""
    q, k, v, out, lse = res
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    kv = k.shape[2]
    scale = D ** -0.5
    qf, dof = q.float(), do.float()
    lse_c = torch.where(torch.isfinite(lse), lse,
                        torch.zeros_like(lse))[..., None]
    qs = qf * scale
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    row = torch.arange(S, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j0 in range(0, kv, XLA_BLOCK):
        kb, vb = kf[:, :, j0:j0 + XLA_BLOCK], vf[:, :, j0:j0 + XLA_BLOCK]
        p = torch.exp(torch.matmul(qs, kb.transpose(-1, -2)) - lse_c)
        if causal:
            col = torch.arange(j0, j0 + kb.shape[2], device=q.device)[None]
            mask = col <= row
            if window is not None:
                mask = mask & sliding_window_mask(row, col, window)
            p = torch.where(mask, p, torch.zeros_like(p))
        dvs.append(torch.matmul(p.transpose(-1, -2), dof))
        ds = p * (torch.matmul(dof, vb.transpose(-1, -2)) - delta)
        dq = dq + torch.matmul(ds, kb) * scale
        dks.append(torch.matmul(ds.transpose(-1, -2), qf) * scale)
    if dks:
        dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    else:
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dk = dk.reshape(B, Hkv, g, kv, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, g, kv, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with its backward (the reference's ``custom_vjp``
    ``_flash``): the forward, K1 or K4 by ``fwd_impl``, saves q, k, v, O
    and the LSE; the backward runs the resolved ``bwd_impl``, the same
    for both forwards."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bwd_impl, fwd_impl):
        out, lse = _flash_call(q, k, v, causal, window,
                               pipelined=fwd_impl == "pipelined")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.bwd_impl = causal, window, bwd_impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.bwd_impl == "pallas":
            grads = _flash_bwd_pallas(q, k, v, out, lse, do, ctx.causal,
                                      ctx.window)
        else:
            grads = _flash_bwd_xla(ctx.causal, (q, k, v, out, lse), do,
                                   window=ctx.window)
        return (*grads, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    interpret: bool | None = None,
                    block_q: int | None = None,
                    block_kv: int | None = None,
                    window: int | None = None,
                    bwd_impl: str | None = None,
                    fwd_impl: str | None = None) -> torch.Tensor:
    """Fused attention over [B, H, S, D] queries; k/v may carry fewer
    (GQA) heads, streamed and never expanded.

    ``window=W`` (causal only): query i sees keys [max(0, i-W+1), i];
    key tiles below the window floor are skipped.

    Differentiable: when q, k or v needs a gradient the call goes
    through :class:`_Flash`. ``bwd_impl`` (or ``$TPUSHARE_FLASH_BWD``):
    "pallas", the default, runs the dq and dk/dv kernels (their plain
    versions on CPU tensors); "xla" the fp32 blockwise backward that
    expands K/V.

    ``fwd_impl`` (or ``$TPUSHARE_FLASH_FWD``): "step", the default, runs
    K1; "pipelined" runs K4, bitwise K1's results with another issue
    order. Both take the same plain version on CPU tensors.

    ``interpret``, ``block_q`` and ``block_kv`` are TPU knobs of the
    reference (interpret mode, tile sizes): accepted and ignored, so
    callers port unchanged.
    """
    del interpret, block_q, block_kv
    bwd_impl = _resolve_flash_bwd(bwd_impl)
    fwd_impl = _resolve_flash_fwd(fwd_impl)
    B, H, S, D = q.shape
    validate_gqa_qkv(q, k, v)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM} unsupported")
    if causal and k.shape[2] != S:
        raise ValueError("causal attention requires matching q/k lengths")
    if window is not None:
        if not causal:
            raise ValueError("window attention requires causal=True")
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, bool(causal), window, bwd_impl,
                            fwd_impl)
    return _flash_call(q, k, v, bool(causal), window,
                       pipelined=fwd_impl == "pipelined")[0]
