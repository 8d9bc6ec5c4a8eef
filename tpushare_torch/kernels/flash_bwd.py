"""Wrappers of the flash-attention backward kernels (``csrc/flash_bwd.cu``).

Both take the inputs the reference's ``_flash_bwd_pallas`` hands its two
kernels, as :func:`tpushare_torch.workloads.attention._bwd_residuals`
makes them: ``qs`` (q pre-scaled by ``D**-0.5`` and rounded to its dtype)
and ``do`` (dO in q's dtype), both ``[B, H, S, D]``; k/v ``[B, Hkv, Skv,
D]``; ``lse`` (-inf clamped to +1e30) and ``delta`` ``[B, H, S]`` fp32.

- :func:`flash_bwd_dq` returns dq ``[B, H, S, D]`` in q's dtype, scaled;
- :func:`flash_bwd_dkdv` returns ``(dk, dv)`` ``[B, Hkv, Skv, D]`` in k's
  dtype.

On CPU tensors they run the plain blockwise versions
(``flash_bwd_dq_plain`` and ``flash_bwd_dkdv_plain`` in
:mod:`tpushare_torch.workloads.attention`); on CUDA tensors they launch
the kernel or raise. There is no fallback from one to the other: a
kernel that fails to build, to encode a tensor map or to launch raises.
bf16 goes to the Hopper design (TMA loads, wgmma products), fp32 to the
scalar kernels. The kernels take strides, so the transposed views the
model's gradients arrive as are read in place; only the last dimension
must be contiguous.

``LAUNCHES_DQ`` and ``LAUNCHES_DKDV`` count kernel launches (never
plain-version calls), so a run can show that its path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from tpushare_torch.kernels.flash import (_DTYPE_CODES, _ERRORS, _check,
                                          tma_eligible)

LAUNCHES_DQ = 0
LAUNCHES_DKDV = 0
_LIB_NAME = "flash_bwd"
_NAMES = ("flash_bwd_dq", "flash_bwd_dkdv")
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from tpushare_torch.kernels import build
        lib = build.load(_LIB_NAME)
        fn = lib.tpushare_flash_bwd
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = ([i, i, i, i] + [p] * 8 + [i] * 5 + [ll] * 12
                       + [i, i, ctypes.c_float, i, p])
        fn.restype = i
        lib.tpushare_cuda_error_string.argtypes = [i]
        lib.tpushare_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def _devices(*tensors) -> str:
    devices = {t.device.type for t in tensors}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"flash backward takes tensors all on cpu or all "
                         f"on cuda, got {sorted(devices)}")
    return devices.pop()


def _check_bwd(qs, k, v, do, lse, delta):
    _check(qs, k, v)
    if do.shape != qs.shape or do.dtype != qs.dtype or do.stride(-1) != 1:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} strides "
                         f"{do.stride()}: expected q's shape and dtype and a "
                         "contiguous last dimension")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != qs.shape[:3] or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"contiguous fp32 {tuple(qs.shape[:3])}")


def _launch_args(kernel: int, qs, k, v, do, lse, delta, out0, out1,
                 causal, window) -> tuple:
    """The arguments of ``tpushare_flash_bwd`` in its order, all but the
    stream. bf16 goes to the Hopper kernels, which read q, k, v and dO
    through TMA when :func:`~tpushare_torch.kernels.flash.tma_eligible`
    holds for all four and with plain loads otherwise (a stride-0 dO, a
    view off 16-byte alignment); fp32 to the scalar kernels, whose
    16-byte loads need the same."""
    B, H, S, D = qs.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    vec = all(tma_eligible(t) for t in (qs, k, v, do))
    return (qs.device.index or 0, kernel, _DTYPE_CODES[qs.dtype], D,
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out0.data_ptr(),
            out1.data_ptr() if out1 is not None else None,
            B, H, Hkv, S, Skv,
            *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3],
            int(bool(causal)), int(window or 0), D ** -0.5, int(vec))


def _raise_on(err: int, kernel: int) -> None:
    """Raise, naming the kernel, for a nonzero return of the library."""
    if not err:
        return
    if err > 0:
        from tpushare_torch.kernels import build
        msg = build.load(_LIB_NAME).tpushare_cuda_error_string(err).decode()
    else:
        msg = _ERRORS.get(err, "unknown")
    raise RuntimeError(f"{_NAMES[kernel]} launch failed ({err}): {msg}")


def _launch(kernel: int, qs, k, v, do, lse, delta, out0, out1, causal,
            window):
    args = _launch_args(kernel, qs, k, v, do, lse, delta, out0, out1, causal,
                        window)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    _raise_on(_kernel()(*args, stream), kernel)


def flash_bwd_dq(qs, k, v, do, lse, delta, causal: bool,
                 window: int | None = None) -> torch.Tensor:
    """dq of the flash backward (K2); see the module docstring."""
    global LAUNCHES_DQ
    if _devices(qs, k, v, do, lse, delta) == "cpu":
        from tpushare_torch.workloads.attention import flash_bwd_dq_plain
        return flash_bwd_dq_plain(qs, k, v, do, lse, delta, causal, window)
    _check_bwd(qs, k, v, do, lse, delta)
    dq = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    if qs.shape[2] == 0:
        return dq
    if k.shape[2] == 0:
        return dq.zero_()
    _launch(0, qs, k, v, do, lse, delta, dq, None, causal, window)
    LAUNCHES_DQ += 1
    return dq


def flash_bwd_dkdv(qs, k, v, do, lse, delta, causal: bool,
                   window: int | None = None):
    """``(dk, dv)`` of the flash backward (K3); see the module
    docstring."""
    global LAUNCHES_DKDV
    if _devices(qs, k, v, do, lse, delta) == "cpu":
        from tpushare_torch.workloads.attention import flash_bwd_dkdv_plain
        return flash_bwd_dkdv_plain(qs, k, v, do, lse, delta, causal, window)
    _check_bwd(qs, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if k.shape[2] == 0:
        return dk, dv
    if qs.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    _launch(1, qs, k, v, do, lse, delta, dk, dv, causal, window)
    LAUNCHES_DKDV += 1
    return dk, dv
