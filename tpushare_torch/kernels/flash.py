"""Wrappers of the flash-attention forward kernels (``csrc/flash_fwd.cu``).

:func:`flash_fwd` takes the layouts of the reference's ``_flash_call``:
q ``[B, H, S, D]``, k/v ``[B, Hkv, Skv, D]`` with Hkv dividing H, and
returns ``(out [B, H, S, D] in q's dtype, lse [B, H, S] fp32)``. On CPU
tensors it runs the plain blockwise version
(:func:`tpushare_torch.workloads.attention.flash_attention_plain`); on
CUDA tensors it launches the kernel or raises. There is no fallback from
one to the other. ``pipelined=True`` launches K4, the pipelined forward
(``tpushare_flash_fwd_pipelined``), instead of K1: the same function and
bitwise the same results, so its plain version is K1's.

The kernel takes the strides of its inputs, so the ``[B, S, H, D] ->
[B, H, S, D]`` transposed views the model passes are read in place; only
the last dimension must be contiguous. bf16 inputs go to the Hopper
design (TMA loads, wgmma products), which reads q, k and v through TMA
when :func:`tma_eligible` holds for all three and with plain loads in the
same kernel otherwise; fp32 inputs go to the scalar kernels. The outputs
are new contiguous tensors.

``LAUNCHES`` counts K1's launches and ``LAUNCHES_PIPELINED`` K4's (never
plain-version calls), so a run can show which forward its path went
through.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
LAUNCHES_PIPELINED = 0
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB_NAME = "flash_fwd"
_fns: dict = {}


def _entry(name: str):
    """The library's entry ``name``, typed; K1's and K4's share K1's
    argument list."""
    fn = _fns.get(name)
    if fn is None:
        from tpushare_torch.kernels import build
        lib = build.load(_LIB_NAME)
        fn = getattr(lib, name)
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = ([i, i, i, p, p, p, p, p, i, i, i, i, i]
                       + [ll] * 12 + [i, i, ctypes.c_float, i, p])
        fn.restype = i
        lib.tpushare_cuda_error_string.argtypes = [i]
        lib.tpushare_cuda_error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    return fn


def _kernel():
    return _entry("tpushare_flash_fwd")


def _kernel_pipelined():
    return _entry("tpushare_flash_fwd_pipelined")


def _check(q, k, v):
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes fp32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: expected [B,H,S,D] and "
                         "[B,Hkv,Skv,D]")
    B, H, _, D = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != D or Hkv <= 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)}: batch "
                         "and head_dim must match and kv heads divide "
                         "query heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             f"got strides {t.stride()}")


def tma_eligible(t: torch.Tensor) -> bool:
    """Whether the Tensor Memory Accelerator can read ``t`` ([B, H, S,
    D], last dimension contiguous) in place: its first element is 16-byte
    aligned, and every other dimension of size above 1 steps by a positive
    multiple of 16 bytes below 2**40 (a dimension of size 1 is never
    stepped along). The model's transposed ``[B, S, H, D]`` views qualify;
    a view one element into a wider row does not, and the kernels' producer
    then loads it with plain loads instead."""
    if t.data_ptr() % 16:
        return False
    item = t.element_size()
    return all(size == 1 or (0 < stride * item < 2 ** 40
                             and stride * item % 16 == 0)
               for size, stride in zip(t.shape[:-1], t.stride()[:-1]))


_ERRORS = {-1: "unsupported dtype or head_dim",
           -2: "the driver refused a TMA tensor map"}


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int | None = None,
              pipelined: bool = False):
    """Flash-attention forward; returns ``(out, lse)``. Arguments are
    validated by the caller's public API (``flash_attention``); this
    checks what the kernel itself needs. ``pipelined`` picks K4 over K1
    on CUDA tensors; both run the same plain version on CPU tensors."""
    global LAUNCHES, LAUNCHES_PIPELINED
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        from tpushare_torch.workloads.attention import flash_attention_plain
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if devices != {"cuda"}:
        raise ValueError(f"flash_fwd takes tensors all on cpu or all on "
                         f"cuda, got {sorted(devices)}")
    _check(q, k, v)
    fn = _kernel_pipelined() if pipelined else _kernel()
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0:
        return out, lse
    vec = all(tma_eligible(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.device.index or 0, _DTYPE_CODES[q.dtype], D,
             q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, H, Hkv, S, Skv,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3],
             int(bool(causal)), int(window or 0), D ** -0.5, int(vec),
             stream)
    if err:
        from tpushare_torch.kernels import build
        msg = build.load(_LIB_NAME).tpushare_cuda_error_string(err)
        name = "flash_fwd_pipelined" if pipelined else "flash_fwd"
        raise RuntimeError(f"{name} launch failed ({err}): "
                           f"{msg.decode() if err > 0 else _ERRORS.get(err, 'unknown')}")
    if pipelined:
        LAUNCHES_PIPELINED += 1
    else:
        LAUNCHES += 1
    return out, lse
