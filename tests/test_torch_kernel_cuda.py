"""The flash-attention forward kernel (tpushare_torch/csrc/flash_fwd.cu)
against its plain version, on a CUDA card. Without one every test skips.

On the card (where JAX, which tests/conftest.py imports, may be absent):

    python -m pytest --noconftest -p no:cacheprovider -m cuda_kernel \
        tests/test_torch_kernel_cuda.py
"""

import pytest
import torch

from tpushare_torch.kernels import flash
from tpushare_torch.workloads.attention import flash_attention_plain

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda_kernel

# both accumulate in fp32; bf16 allows a few output ulps (2**-7 at 1.0)
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the flash kernel runs only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, B, H, Hkv, S, D, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


CASES = [(1, 32, 8, 64, 128, torch.bfloat16, True, None),
         (2, 8, 4, 128, 64, torch.bfloat16, True, None),
         (1, 4, 2, 200, 64, torch.bfloat16, True, None),
         (1, 4, 4, 130, 32, torch.bfloat16, False, None),
         (1, 8, 2, 256, 64, torch.bfloat16, True, 77),
         (1, 4, 2, 150, 128, torch.float32, True, None),
         (2, 4, 2, 96, 16, torch.float32, True, 5)]


@pytest.mark.parametrize("case", CASES, ids=[
    f"B{c[0]}H{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}-{str(c[5])[6:]}"
    f"{'-causal' if c[6] else ''}{f'-w{c[7]}' if c[7] else ''}"
    for c in CASES])
def test_kernel_matches_plain(cuda, case):
    B, H, Hkv, S, D, dtype, causal, window = case
    q, k, v = _qkv(cuda, B, H, Hkv, S, D, dtype)
    before = flash.LAUNCHES
    out, lse = flash.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal, window)
    tol_o, tol_l = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_o
    assert (lse - ref_lse).abs().max().item() <= tol_l


def test_kernel_reads_transposed_views(cuda):
    # the model hands [B, S, H, D] projections transposed to [B, H, S, D]
    B, S, H, Hkv, D = 2, 100, 8, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).bfloat16()
    k = torch.randn(B, S, Hkv, D, generator=gen, device=cuda).bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=gen, device=cuda).bfloat16()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    assert not qt.is_contiguous()
    out, lse = flash.flash_fwd(qt, kt, vt, True)
    ref_out, ref_lse = flash.flash_fwd(qt.contiguous(), kt.contiguous(),
                                       vt.contiguous(), True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernel_reads_rows_off_16_byte_alignment(cuda, dtype):
    # views one element into a wider buffer: the kernel's scalar loads
    B, H, Hkv, S, D = 1, 4, 2, 80, 64
    gen = torch.Generator(device=cuda).manual_seed(2)
    wide = [torch.randn(B, h, S, D + 1, generator=gen, device=cuda).to(dtype)
            for h in (H, Hkv, Hkv)]
    q, k, v = (t[..., 1:] for t in wide)
    assert q.data_ptr() % 16 and q.stride(-1) == 1
    out, lse = flash.flash_fwd(q, k, v, True)
    ref_out, ref_lse = flash_attention_plain(q, k, v, True)
    tol_o, tol_l = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_o
    assert (lse - ref_lse).abs().max().item() <= tol_l
