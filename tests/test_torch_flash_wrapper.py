"""The flash forward wrapper's TMA rule (tpushare_torch/kernels/flash.py:
tma_eligible) on the CPU: which q/k/v layouts the Hopper kernels read
through the Tensor Memory Accelerator, and which they load with plain
loads instead. The rule is pure arithmetic on pointers and strides, so
CPU tensors check it; the kernels themselves are checked on the card
(tests/test_torch_kernel_cuda.py)."""

import pytest
import torch

from tpushare_torch.kernels.flash import HEAD_DIMS, tma_eligible


def _bshd(B, S, H, D, dtype):
    """The model's [B, S, H, D] projection, viewed as [B, H, S, D]."""
    return torch.zeros(B, S, H, D, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_contiguous_is_tma_eligible(dtype, D):
    assert tma_eligible(torch.zeros(2, 4, 37, D, dtype=dtype))


@pytest.mark.parametrize("shape", [(1, 1023, 32, 128), (1, 1023, 8, 128),
                                   (2, 128, 8, 64), (2, 96, 4, 16)],
                         ids=["llama-8b-q", "llama-8b-kv", "llama-mini",
                              "llama-tiny"])
def test_model_transposed_views_are_tma_eligible(shape):
    t = _bshd(*shape, torch.bfloat16)
    assert not t.is_contiguous()
    assert tma_eligible(t)


def test_vit_views_are_tma_eligible():
    # ViT-B/16: [32, 197, 12, 64] projections; S = 197 is ragged
    t = _bshd(32, 197, 12, 64, torch.bfloat16)
    assert t.stride() == (197 * 12 * 64, 64, 12 * 64, 1)
    assert tma_eligible(t)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_views_one_element_off_alignment_are_not(dtype, layout):
    # the card tests' views: one element into a row of D + 1
    if layout == "bhsd":
        t = torch.zeros(1, 4, 80, 65, dtype=dtype)[..., 1:]
    else:
        t = torch.zeros(2, 150, 4, 65, dtype=dtype)[..., 1:].transpose(1, 2)
    assert t.data_ptr() % 16 and t.stride(-1) == 1
    assert not tma_eligible(t)


def test_aligned_base_with_odd_row_stride_is_not():
    # 16-byte aligned first element, rows 66 elements (132 bytes) apart
    t = torch.zeros(1, 2, 8, 66, dtype=torch.bfloat16)[..., :64]
    assert t.data_ptr() % 16 == 0
    assert not tma_eligible(t)


def test_size_one_dimensions_are_never_stepped_along():
    # B = 1 and one head: their strides do not matter, S's does
    base = torch.zeros(1, 1, 16, 64, dtype=torch.bfloat16)
    odd = base.as_strided((1, 1, 16, 64), (3, 5, 64, 1))
    assert tma_eligible(odd)
    bad = torch.zeros(1, 1, 16 * 65, dtype=torch.bfloat16).as_strided(
        (1, 1, 16, 64), (3, 5, 65, 1))
    assert not tma_eligible(bad)


def test_expanded_heads_are_not():
    # a stride of 0 repeats rows; TMA takes only positive strides
    t = torch.zeros(1, 1, 32, 64, dtype=torch.bfloat16).expand(1, 4, 32, 64)
    assert t.stride(1) == 0
    assert not tma_eligible(t)
