"""The flash backward wrapper's host side (tpushare_torch/kernels/
flash_bwd.py) on the CPU: the arguments it composes for the library's
``tpushare_flash_bwd`` (their order, the strides and shapes, the TMA flag
from ``tma_eligible``), and the errors it raises for a nonzero return.
CPU tensors pose as the inputs: composing the arguments reads only
pointers, shapes and strides. The kernels themselves are checked on the
card (tests/test_torch_kernel_cuda.py)."""

import pytest
import torch

from tpushare_torch.kernels import flash_bwd
from tpushare_torch.kernels.flash import HEAD_DIMS

# positions in the argument tuple (the C signature, stream excluded)
KERNEL, DTYPE, HEAD_DIM = 1, 2, 3
PTRS = slice(4, 12)
SHAPE = slice(12, 17)
STRIDES = slice(17, 29)
CAUSAL, WINDOW, SCALE, VEC = 29, 30, 31, 32


def _inputs(B=1, H=8, Hkv=2, S=100, D=64, dtype=torch.bfloat16,
            layout="bhsd"):
    """(qs, k, v, do, lse, delta, dq, dk, dv) shaped as the kernels take
    them; "bshd" makes q, k, v and dO the model's transposed views."""
    def t(b, h, s):
        if layout == "bshd":
            return torch.zeros(b, s, h, D, dtype=dtype).transpose(1, 2)
        return torch.zeros(b, h, s, D, dtype=dtype)
    qs, do = t(B, H, S), t(B, H, S)
    k, v = t(B, Hkv, S), t(B, Hkv, S)
    lse = torch.zeros(B, H, S)
    delta = torch.zeros(B, H, S)
    dq = torch.empty(B, H, S, D, dtype=dtype)
    dk = torch.empty(B, Hkv, S, D, dtype=dtype)
    dv = torch.empty(B, Hkv, S, D, dtype=dtype)
    return qs, k, v, do, lse, delta, dq, dk, dv


def _args(kernel, ins, causal=True, window=None):
    qs, k, v, do, lse, delta, dq, dk, dv = ins
    out0, out1 = (dq, None) if kernel == 0 else (dk, dv)
    return flash_bwd._launch_args(kernel, qs, k, v, do, lse, delta, out0,
                                  out1, causal, window)


def test_argument_count_matches_the_c_signature():
    # ctypes argtypes of tpushare_flash_bwd, less the trailing stream
    ins = _inputs()
    assert len(_args(0, ins)) == 4 + 8 + 5 + 12 + 4


@pytest.mark.parametrize("kernel", [0, 1], ids=["dq", "dkdv"])
def test_pointers_in_the_c_order(kernel):
    qs, k, v, do, lse, delta, dq, dk, dv = ins = _inputs()
    args = _args(kernel, ins)
    assert args[KERNEL] == kernel
    outs = (dq.data_ptr(), None) if kernel == 0 else (dk.data_ptr(),
                                                       dv.data_ptr())
    assert args[PTRS] == (qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          *outs)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_shapes_and_strides_pass_through(layout):
    qs, k, v, do, *_ = ins = _inputs(B=2, H=12, Hkv=4, S=197, D=64,
                                     layout=layout)
    args = _args(1, ins)
    assert args[SHAPE] == (2, 12, 4, 197, 197)
    assert args[STRIDES] == (*qs.stride()[:3], *k.stride()[:3],
                             *v.stride()[:3], *do.stride()[:3])
    assert args[HEAD_DIM] == 64


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_dtype_code_and_scale(dtype, code, D):
    args = _args(0, _inputs(D=D, dtype=dtype))
    assert args[DTYPE] == code and args[HEAD_DIM] == D
    assert args[SCALE] == pytest.approx(D ** -0.5)


@pytest.mark.parametrize("causal,window,want", [(True, None, (1, 0)),
                                                (False, None, (0, 0)),
                                                (True, 200, (1, 200))])
def test_causal_and_window_flags(causal, window, want):
    args = _args(0, _inputs(), causal, window)
    assert (args[CAUSAL], args[WINDOW]) == want


@pytest.mark.parametrize("shape", [(1, 32, 8, 1023, 128),
                                   (32, 12, 12, 197, 64),
                                   (2, 4, 2, 96, 16)],
                         ids=["llama-8b", "vit-b16", "llama-tiny"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_model_views_take_tma(shape, layout):
    B, H, Hkv, S, D = shape
    args = _args(0, _inputs(B, H, Hkv, S, D, layout=layout))
    assert args[VEC] == 1


def _with(ins, i, t):
    ins = list(ins)
    ins[i] = t
    return ins


def test_stride_zero_do_is_refused():
    # autograd may hand a gradient expanded over the heads
    ins = _inputs(H=4, Hkv=2)
    do = torch.zeros(1, 1, 100, 64, dtype=torch.bfloat16).expand(1, 4, 100,
                                                                  64)
    assert do.stride(1) == 0
    assert _args(0, _with(ins, 3, do))[VEC] == 0


@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=["qs", "k", "v", "do"])
def test_one_element_off_alignment_is_refused(which):
    ins = _inputs(H=4, Hkv=4, S=80)
    wide = torch.zeros(1, 4, 80, 65, dtype=torch.bfloat16)[..., 1:]
    assert wide.data_ptr() % 16
    assert _args(1, _with(ins, which, wide))[VEC] == 0


def test_odd_row_stride_is_refused():
    ins = _inputs(H=2, Hkv=2, S=8)
    odd = torch.zeros(1, 2, 8, 66, dtype=torch.bfloat16)[..., :64]
    assert odd.data_ptr() % 16 == 0
    assert _args(0, _with(ins, 2, odd))[VEC] == 0


@pytest.mark.parametrize("kernel,name", [(0, "flash_bwd_dq"),
                                         (1, "flash_bwd_dkdv")])
@pytest.mark.parametrize("err,words", [(-1, "unsupported"),
                                       (-2, "tensor map"),
                                       (-7, "unknown")])
def test_nonzero_return_raises_with_the_kernel_name(kernel, name, err,
                                                    words):
    with pytest.raises(RuntimeError, match=f"{name} launch failed "
                                           rf"\({err}\).*{words}"):
        flash_bwd._raise_on(err, kernel)


def test_zero_return_passes():
    flash_bwd._raise_on(0, 0)
    flash_bwd._raise_on(0, 1)
