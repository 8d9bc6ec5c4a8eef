"""Flash attention for the port: API, plain versions and kernel dispatch.

Counterpart of ``tpushare/workloads/attention.py``. Same layouts: q is
``[B, H, S, D]``, k/v ``[B, H_kv, S_kv, D]`` with H_kv dividing H (pass the
small kv heads; they are never expanded). Same validation and the same
``ValueError`` messages, except the reference's 128-multiple tile rule,
which is TPU MXU alignment.

- :func:`flash_attention` validates and runs :func:`_flash_call`, which
  goes through :func:`tpushare_torch.kernels.flash.flash_fwd`: the
  hand-written CUDA kernel for CUDA tensors, :func:`flash_attention_plain`
  for CPU tensors.
- :func:`flash_attention_plain` is the kernel's plain version: the same
  online-softmax / log-sum-exp recurrence, block by block over the keys,
  in torch ops. The CPU path and the kernel's check on the card use it.
- :func:`attention_reference` is the einsum spec.

Forward only: the backward kernels (``_flash_bwd_dq_kernel``,
``_flash_bwd_dkdv_kernel``) belong to the training slice, ROADMAP.md
Queue 1 item 9.
"""

from __future__ import annotations

import os

import torch

MAX_HEAD_DIM = 128
# key block of the plain version; equal to the kernel's kv tile so both
# apply the online-softmax update at the same block boundaries
BLOCK = 64


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
                causal: bool, window: int | None = None):
    """Run the forward; returns ``(out [B, H, S, D], lse [B, H, S] fp32)``.
    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    from tpushare_torch.kernels.flash import flash_fwd
    return flash_fwd(q, k, v, causal=causal, window=window)


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

    ``interpret``, ``block_q``, ``block_kv`` and ``bwd_impl`` are TPU
    knobs of the reference (interpret mode, tile sizes, backward
    variant): accepted and ignored, so callers port unchanged.
    ``fwd_impl`` (or ``$TPUSHARE_FLASH_FWD``) must be "step"; the
    pipelined forward is not ported yet.
    """
    del interpret, block_q, block_kv, bwd_impl
    fwd_impl = fwd_impl or os.environ.get("TPUSHARE_FLASH_FWD", "step")
    if fwd_impl == "pipelined":
        raise NotImplementedError(
            "TPUSHARE_FLASH_FWD=pipelined: the pipelined forward kernel "
            "is not ported yet (ROADMAP.md Queue 2, K4)")
    if fwd_impl != "step":
        raise ValueError(f"fwd_impl={fwd_impl!r} (or $TPUSHARE_FLASH_FWD) "
                         "must be one of ('step', 'pipelined')")
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
        raise NotImplementedError(
            "flash_attention backward is not ported yet (ROADMAP.md "
            "Queue 1 item 9, kernels K2/K3)")
    return _flash_call(q, k, v, bool(causal), window)[0]
