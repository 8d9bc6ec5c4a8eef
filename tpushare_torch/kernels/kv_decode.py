"""Decode attention straight from the int8 KV cache (``csrc/kv_decode.cu``).

:func:`kv_decode` attends one bf16 decode query per row, q ``[B, nh,
128]``, over one layer of the int8 cache as the model keeps it: k, v
``[B, M, nkv, 128]`` int8 and their per-(token, kv head) scales ks, vs
``[B, M, nkv, 1]`` fp32, read in place, with nh / nkv in :data:`REPS`.
Row b attends its keys ``lo[b] <= m < hi[b]`` (``lo``, ``hi``: int32
``[B]`` on q's device); a row with ``lo >= hi`` gets 0. Returns ``[B, nh
* 128]`` bf16. :func:`takes` says whether a model's decode step fits.

On CPU tensors it runs the plain version, :func:`kv_decode_plain`: the
model's masked einsum attention (``model.cached_attention``) under the
rows' spans. On CUDA tensors it launches the kernel or raises; there is
no fallback from one to the other. The kernel keeps the scores in fp32
from the product on, where the plain version rounds q . k to bf16 first,
as the reference does.

``LAUNCHES`` counts the kernel's launches (never plain-version calls),
so a run can show that its decode steps went through it.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
HEAD_DIM = 128
REPS = (1, 2, 4, 8)
_LIB_NAME = "kv_decode"
_fns: dict = {}
_SMS: dict = {}
# the split kernel's 166 registers a thread fit 3 CTAs of 128 threads an
# SM: a grid of at least one full wave when every row spans the buffer
_CTAS_PER_SM = 3


def takes(dtype: torch.dtype, head_dim: int, reps: int) -> bool:
    """Whether the kernel takes queries of ``dtype`` at ``head_dim`` with
    ``reps`` query heads per kv head."""
    return dtype == torch.bfloat16 and head_dim == HEAD_DIM and reps in REPS


def _lib():
    lib = _fns.get("lib")
    if lib is None:
        from tpushare_torch.kernels import build
        lib = build.load(_LIB_NAME)
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.tpushare_kv_decode.argtypes = (
            [i, i] + [p] * 10 + [i, i, i, i, ctypes.c_float, p])
        lib.tpushare_kv_decode.restype = i
        lib.tpushare_kv_decode_chunk.argtypes = []
        lib.tpushare_kv_decode_chunk.restype = i
        lib.tpushare_kv_decode_error_string.argtypes = [i]
        lib.tpushare_kv_decode_error_string.restype = ctypes.c_char_p
        _fns["lib"] = lib
    return lib


def _splits(device: torch.device, pairs: int, chunks: int) -> int:
    """CTAs a (row, kv head) for a grid of ``pairs`` of them: enough for
    about ``_CTAS_PER_SM`` CTAs on every SM of the card when each row
    spans the buffer's ``chunks``, and no more than those chunks (a CTA
    past its row's chunks exits at once, but holds a place on an SM)."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return max(1, min(chunks, -(-_CTAS_PER_SM * sms // max(pairs, 1))))


def kv_decode_plain(q, k, v, ks, vs, lo, hi) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the model's
    ``cached_attention`` over the whole buffer under the rows' spans, 0
    for an empty span."""
    from tpushare_torch.workloads.model import cached_attention
    pos = torch.arange(k.shape[1], device=q.device)
    mask = (pos >= lo[:, None]) & (pos < hi[:, None])
    out = cached_attention(q[:, None], k, v, ks, vs, mask[:, None])[:, 0]
    return torch.where((hi > lo)[:, None], out, 0).to(q.dtype)


def _check(q, k, v, ks, vs, lo, hi):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: expected [B, nh, hd] and "
                         "[B, M, nkv, hd]")
    B, nh, hd = q.shape
    M, nkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or nkv <= 0 or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)}: batch "
                         "and head_dim must match and kv heads divide "
                         "query heads")
    if not takes(q.dtype, hd, nh // nkv):
        raise ValueError(f"kv_decode takes bf16 q at head_dim {HEAD_DIM} "
                         f"with query heads per kv head in {REPS}, got "
                         f"{q.dtype} at {hd} with {nh // nkv}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"k/v must be int8, got {k.dtype}, {v.dtype}")
    for name, t in (("ks", ks), ("vs", vs)):
        if t.dtype != torch.float32 or t.shape != (B, M, nkv, 1):
            raise ValueError(f"{name} must be fp32 [B, M, nkv, 1], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"{name} must be int32 [B], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("ks", ks), ("vs", vs),
                    ("lo", lo), ("hi", hi)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the cache is read "
                             f"in place), got strides {t.stride()}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the "
                             "kernel reads it 16 bytes at a time)")


def kv_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ks: torch.Tensor, vs: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Decode attention over the rows' spans of an int8 cache layer;
    returns ``[B, nh * 128]`` bf16 (see the module)."""
    global LAUNCHES
    tensors = (q, k, v, ks, vs, lo, hi)
    devices = {t.device for t in tensors}
    q = q.contiguous()
    _check(q, k, v, ks, vs, lo, hi)
    if devices == {torch.device("cpu")}:
        return kv_decode_plain(q, k, v, ks, vs, lo, hi)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"kv_decode takes tensors all on cpu or all on one "
                         f"cuda device, got {sorted(map(str, devices))}")
    lib = _lib()
    B, nh, hd = q.shape
    M, nkv = k.shape[1], k.shape[2]
    reps = nh // nkv
    splits = _splits(q.device, B * nkv,
                     -(-M // lib.tpushare_kv_decode_chunk()))
    part_ml = torch.empty((B, nkv, splits, reps, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, nkv, splits, reps, hd), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, nh * hd), dtype=q.dtype, device=q.device)
    if B == 0 or M == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.tpushare_kv_decode(
        q.device.index or 0, reps, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, M, nkv, splits, hd ** -0.5,
        stream)
    if err:
        msg = (lib.tpushare_kv_decode_error_string(err).decode() if err > 0
               else "unsupported query heads per kv head")
        raise RuntimeError(f"kv_decode launch failed ({err}): {msg}")
    LAUNCHES += 1
    return out
