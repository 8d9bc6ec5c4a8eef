"""The flash-attention kernels (tpushare_torch/csrc/flash_fwd.cu and
flash_bwd.cu) against their plain versions, on a CUDA card, and the
pipelined forward K4 bitwise against K1. Without a card every test
skips.

On the card (where JAX, which tests/conftest.py imports, may be absent):

    python -m pytest --noconftest -p no:cacheprovider -m cuda_kernel \
        tests/test_torch_kernel_cuda.py
"""

import pytest
import torch

from tpushare_torch.kernels import flash, flash_bwd
from tpushare_torch.workloads import attention
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


IDS = [f"B{c[0]}H{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}-{str(c[5])[6:]}"
       f"{'-causal' if c[6] else ''}{f'-w{c[7]}' if c[7] else ''}"
       for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
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


# backward: both sum in fp32 and differ in order; in bf16 a P or dS value
# near a rounding boundary may round the other way, so allow two bf16
# ulps (2**-7) of the largest gradient magnitude, in fp32 1e-5 of it
BWD_REL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}


def _bwd_inputs(dev, B, H, Hkv, S, D, dtype, causal, window, layout=None):
    """The backward kernels' inputs from K1's own output; ``layout``
    "bshd" hands q, k, v and dO over as the model does, [B, S, H, D]
    tensors transposed to [B, H, S, D]."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, H, S, D))
    if layout == "bshd":
        ts = [torch.randn(s[0], s[2], s[1], s[3], generator=gen,
                          device=dev).to(dtype).transpose(1, 2)
              for s in shapes]
    else:
        ts = [torch.randn(s, generator=gen, device=dev).to(dtype)
              for s in shapes]
    q, k, v, do = ts
    out, lse = flash.flash_fwd(q, k, v, causal, window)
    qs, do, lse, delta = attention._bwd_residuals(q, out, lse, do)
    return (qs, k, v, do, lse, delta)


def _bwd(args, causal, window):
    return (flash_bwd.flash_bwd_dq(*args, causal, window),
            *flash_bwd.flash_bwd_dkdv(*args, causal, window))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_kernels_match_plain(cuda, case):
    B, H, Hkv, S, D, dtype, causal, window = case
    args = _bwd_inputs(cuda, B, H, Hkv, S, D, dtype, causal, window)
    before = (flash_bwd.LAUNCHES_DQ, flash_bwd.LAUNCHES_DKDV)
    dq, dk, dv = _bwd(args, causal, window)
    torch.cuda.synchronize()
    assert (flash_bwd.LAUNCHES_DQ, flash_bwd.LAUNCHES_DKDV) == \
        (before[0] + 1, before[1] + 1)
    want = (attention.flash_bwd_dq_plain(*args, causal, window),
            *attention.flash_bwd_dkdv_plain(*args, causal, window))
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        tol = BWD_REL[dtype] * ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol
    # no atomics: a second launch gives bitwise the same gradients
    for got, again in zip((dq, dk, dv), _bwd(args, causal, window)):
        assert torch.equal(got, again)


def test_backward_kernels_read_transposed_views(cuda):
    B, H, Hkv, S, D = 1, 8, 2, 100, 64
    args = _bwd_inputs(cuda, B, H, Hkv, S, D, torch.bfloat16, True, None,
                       layout="bshd")
    assert not args[0].is_contiguous() and not args[3].is_contiguous()
    got = _bwd(args, True, None)
    dense = [t.contiguous() for t in args]
    for a, b in zip(got, _bwd(dense, True, None)):
        assert torch.equal(a, b)


# K4, the pipelined forward: bitwise K1's output and LSE on every shape,
# including ViT-B/16's (S=197, D=64, MHA, non-causal)
PIPE_CASES = CASES + [(2, 12, 12, 197, 64, torch.bfloat16, False, None),
                      (1, 4, 1, 256, 64, torch.bfloat16, True, None),
                      (1, 4, 2, 384, 128, torch.bfloat16, True, 96),
                      (1, 4, 2, 130, 64, torch.float32, False, None)]
PIPE_IDS = [f"B{c[0]}H{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}-{str(c[5])[6:]}"
            f"{'-causal' if c[6] else ''}{f'-w{c[7]}' if c[7] else ''}"
            for c in PIPE_CASES]


@pytest.mark.parametrize("case", PIPE_CASES, ids=PIPE_IDS)
def test_pipelined_is_bitwise_the_step_kernel(cuda, case):
    B, H, Hkv, S, D, dtype, causal, window = case
    q, k, v = _qkv(cuda, B, H, Hkv, S, D, dtype)
    before = (flash.LAUNCHES, flash.LAUNCHES_PIPELINED)
    out, lse = flash.flash_fwd(q, k, v, causal, window, pipelined=True)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.LAUNCHES_PIPELINED) == \
        (before[0], before[1] + 1)
    step_out, step_lse = flash.flash_fwd(q, k, v, causal, window)
    assert torch.equal(out, step_out) and torch.equal(lse, step_lse)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal, window)
    tol_o, tol_l = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_o
    assert (lse - ref_lse).abs().max().item() <= tol_l


bf16 = torch.bfloat16
# the bf16 Hopper kernels' edges: 128-row q tiles of two 64-row
# warpgroups, 64-key kv tiles, TMA boxes past S and Skv; a window of 200
# across tiles; GQA group 8; every head dim (each its own swizzle); a grid
# of 768 CTAs, several waves of one CTA an SM
EDGE_CASES = ([(1, 8, 2, S, 128, bf16, causal, None)
               for S in (1, 63, 65, 127, 129, 257)
               for causal in (True, False)]
              + [(1, 4, 2, 512, 64, bf16, True, 200),
                 (1, 32, 4, 256, 128, bf16, True, None)]
              + [(2, 4, 2, 200, D, bf16, True, None) for D in (16, 32, 64,
                                                               128)]
              + [(16, 12, 12, 197, 64, bf16, False, None)])
EDGE_IDS = [f"B{c[0]}H{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}"
            f"{'-causal' if c[6] else ''}{f'-w{c[7]}' if c[7] else ''}"
            for c in EDGE_CASES]


@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_tile_edges_match_plain_and_pipelined_is_bitwise(cuda, case):
    B, H, Hkv, S, D, dtype, causal, window = case
    q, k, v = _qkv(cuda, B, H, Hkv, S, D, dtype, seed=S)
    out, lse = flash.flash_fwd(q, k, v, causal, window)
    p_out, p_lse = flash.flash_fwd(q, k, v, causal, window, pipelined=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal, window)
    tol_o, tol_l = TOL[dtype]
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_o
    assert (lse - ref_lse).abs().max().item() <= tol_l
    assert torch.equal(p_out, out) and torch.equal(p_lse, lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_pipelined_reads_views_off_16_byte_alignment(cuda, dtype):
    # rows off 16-byte alignment take the synchronous loads, transposed
    # views the strided ones; both bitwise K1
    B, H, Hkv, S, D = 2, 4, 2, 150, 64
    gen = torch.Generator(device=cuda).manual_seed(4)
    wide = [torch.randn(B, S, h, D + 1, generator=gen, device=cuda).to(dtype)
            for h in (H, Hkv, Hkv)]
    bshd = [torch.randn(B, S, h, D, generator=gen, device=cuda).to(dtype)
            for h in (H, Hkv, Hkv)]
    for q, k, v in ((t[..., 1:].transpose(1, 2) for t in wide),
                    (t.transpose(1, 2) for t in bshd)):
        got = flash.flash_fwd(q, k, v, True, pipelined=True)
        want = flash.flash_fwd(q, k, v, True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# the bf16 Hopper backward kernels' edges: dq CTAs of 128 query rows in
# two 64-row warpgroups, dk/dv CTAs of 64 keys walking 64-row q tiles and
# the GQA group, TMA boxes past S and Skv; a window of 200 across tiles;
# GQA group 8; every head dim (each its own swizzle); the ViT-B/16 grid
BWD_EDGE_CASES = ([(1, 8, 2, S, 128, bf16, causal, None)
                   for S in (1, 63, 65, 127, 129, 257)
                   for causal in (True, False)]
                  + [(1, 4, 2, 512, 64, bf16, True, 200),
                     (1, 32, 4, 256, 128, bf16, True, None)]
                  + [(2, 4, 2, 200, D, bf16, True, None)
                     for D in (16, 32, 64, 128)]
                  + [(16, 12, 12, 197, 64, bf16, False, None)])
BWD_EDGE_IDS = [f"B{c[0]}H{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}"
                f"{'-causal' if c[6] else ''}{f'-w{c[7]}' if c[7] else ''}"
                for c in BWD_EDGE_CASES]


# beside BWD_REL, an absolute floor: where a row sees a single key (S = 1)
# dS = P (dP - delta) is exactly 0 in exact arithmetic, and both versions
# return the fp32 rounding of dP - delta (a few ulps of |dP|, about 10,
# so a few 1e-6) times a key
BWD_ABS = 2 ** -16


def _check_bwd(args, causal, window, dtype):
    """Both kernels within BWD_REL (plus BWD_ABS) of their plain versions,
    and bitwise equal over two launches; returns the kernels'
    gradients."""
    got = _bwd(args, causal, window)
    torch.cuda.synchronize()
    want = (attention.flash_bwd_dq_plain(*args, causal, window),
            *attention.flash_bwd_dkdv_plain(*args, causal, window))
    for a, ref in zip(got, want):
        assert a.dtype == dtype and a.shape == ref.shape
        assert torch.isfinite(a).all()
        tol = BWD_REL[dtype] * ref.float().abs().max().item() + BWD_ABS
        assert (a.float() - ref.float()).abs().max().item() <= tol
    for a, again in zip(got, _bwd(args, causal, window)):
        assert torch.equal(a, again)
    return got


@pytest.mark.parametrize("case", BWD_EDGE_CASES, ids=BWD_EDGE_IDS)
def test_backward_tile_edges_match_plain(cuda, case):
    B, H, Hkv, S, D, dtype, causal, window = case
    args = _bwd_inputs(cuda, B, H, Hkv, S, D, dtype, causal, window)
    _check_bwd(args, causal, window, dtype)


@pytest.mark.parametrize("layout", ["off-alignment", "bshd",
                                    "expanded-dO"])
def test_backward_reads_views_as_contiguous(cuda, layout):
    # rows off 16-byte alignment and a stride-0 dO take the plain loads,
    # the model's transposed views TMA over their strides: all bitwise the
    # gradients of contiguous copies, and within BWD_REL of plain
    B, H, Hkv, S, D, causal = 2, 8, 2, 150, 64, True
    args = list(_bwd_inputs(cuda, B, H, Hkv, S, D, bf16, causal, None))
    if layout == "off-alignment":
        for i in range(4):
            wide = torch.zeros(*args[i].shape[:3], D + 1, dtype=bf16,
                               device=cuda)
            wide[..., 1:] = args[i]
            args[i] = wide[..., 1:]
        assert args[0].data_ptr() % 16
    elif layout == "bshd":
        args[:4] = [t.transpose(1, 2).contiguous().transpose(1, 2)
                    for t in args[:4]]
        assert not args[0].is_contiguous()
    else:
        args[3] = args[3][:, :1].expand(B, H, S, D)
        assert args[3].stride(1) == 0
    got = _check_bwd(tuple(args), causal, None, bf16)
    dense = [t.contiguous() for t in args]
    for a, b in zip(got, _bwd(dense, causal, None)):
        assert torch.equal(a, b)


# the dk/dv kernel splits a GQA group of 2, 4 or 8 over a cluster of that
# many CTAs, which sum their partials in a fixed order; other groups (1,
# 3, 16) stay in one CTA
GQA_CASES = [(1, 8, 8, 200, 128, bf16, True, None),
             (1, 8, 4, 200, 128, bf16, True, None),
             (1, 8, 2, 200, 128, bf16, True, None),
             (1, 8, 1, 200, 128, bf16, True, None),
             (2, 8, 2, 320, 64, bf16, True, 100),
             (1, 16, 2, 129, 32, bf16, False, None),
             (1, 6, 2, 100, 64, bf16, True, None),
             (1, 32, 2, 130, 64, bf16, True, None)]
GQA_IDS = [f"G{c[1] // c[2]}-B{c[0]}S{c[3]}D{c[4]}"
           f"{'-causal' if c[6] else ''}{f'-w{c[7]}' if c[7] else ''}"
           for c in GQA_CASES]


@pytest.mark.parametrize("case", GQA_CASES, ids=GQA_IDS)
def test_backward_gqa_groups_match_plain(cuda, case):
    B, H, Hkv, S, D, dtype, causal, window = case
    args = _bwd_inputs(cuda, B, H, Hkv, S, D, dtype, causal, window)
    _check_bwd(args, causal, window, dtype)


# a tensor-parallel rank's heads, as the sharded paths hand them over:
# the llama-8b replica at tp=4 (8 query and 2 kv heads a rank) prefilling,
# the llama-8b trainer at tp=2 (16 and 4), in the model's [B, S, H, D]
# layout transposed to [B, H, S, D]
TP_CASES = [(1, 8, 2, 100, 128, bf16, True, None),
            (1, 8, 2, 450, 128, bf16, True, None),
            (1, 16, 4, 1023, 128, bf16, True, None)]
TP_IDS = [f"H{c[1]}Hkv{c[2]}S{c[3]}" for c in TP_CASES]


def _bshd(dev, B, H, Hkv, S, D, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, S, h, D, generator=gen, device=dev).to(dtype)
            .transpose(1, 2) for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("case", TP_CASES, ids=TP_IDS)
def test_kernels_at_a_tp_ranks_heads_match_plain(cuda, case):
    B, H, Hkv, S, D, dtype, causal, window = case
    q, k, v = _bshd(cuda, B, H, Hkv, S, D, dtype)
    out, lse = flash.flash_fwd(q, k, v, causal, window)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal, window)
    tol_o, tol_l = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_o
    assert (lse - ref_lse).abs().max().item() <= tol_l
    if S == 1023:
        args = _bwd_inputs(cuda, B, H, Hkv, S, D, dtype, causal, window,
                           layout="bshd")
        _check_bwd(args, causal, window, dtype)


@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_route_on_one_rank_matches_the_fold(cuda, zigzag):
    # one rank: the ring is its own chunk, the diagonal (zigzag: two
    # halves, three K1 calls); the card's route against the plain fold
    from tpushare_torch.workloads import ringattention as ra
    q, k, v = _qkv(cuda, 1, 8, 2, 512, 128, torch.bfloat16, seed=5)
    before = flash.LAUNCHES
    with torch.inference_mode():
        got = ra.ring_attention(q, k, v, None, zigzag=zigzag)
        want = ra._ring_fold(q, k, v, None, "sp", True, zigzag)
    torch.cuda.synchronize()
    assert flash.LAUNCHES - before == (3 if zigzag else 1)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_backward_on_one_rank_matches_flash_attention(cuda, zigzag):
    # one rank: the card's route forward and backward through K1, K2 and
    # K3 against _Flash's on the same inputs. The contiguous ring is one
    # diagonal pair, the same launches as _Flash: bitwise. Zigzag splits
    # the chunk into three pairs whose bf16 pieces of dq, dk and dv sum
    # in fp32: within two bf16 roundings of max|grad| (BWD_REL's 2**-7)
    from tpushare_torch.workloads import ringattention as ra
    q, k, v, do = _qkv(cuda, 1, 8, 2, 512, 128, torch.bfloat16, seed=7) + [
        torch.randn(1, 8, 512, 128, device=cuda).to(torch.bfloat16)]
    ring = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_bwd.LAUNCHES_DQ, flash_bwd.LAUNCHES_DKDV)
    ra.ring_attention(*ring, None, zigzag=zigzag).backward(do)
    torch.cuda.synchronize()
    pairs = 3 if zigzag else 1
    assert (flash_bwd.LAUNCHES_DQ - before[0],
            flash_bwd.LAUNCHES_DKDV - before[1]) == (pairs, pairs)
    attention.flash_attention(*ref, causal=True).backward(do)
    for a, b in zip(ring, ref):
        if not zigzag:
            assert torch.equal(a.grad, b.grad)
        scale = b.grad.float().abs().max().item()
        assert (a.grad.float() - b.grad.float()).abs().max().item() <= \
            2 ** -7 * scale


# -- kv_decode (csrc/kv_decode.cu): decode attention over the int8 cache ----

# (B, M, query heads, kv heads, window): the chat cell's decode step
# (Mistral-7B's heads, 32 slots of 4096, window 4096), a rank of the tp=4
# replica (8 and 2 local heads), a window shorter than the buffer (spans
# that start past 0), and GQA groups of 1, 2 and 8; bf16 queries at
# head_dim 128, the only ones the kernel takes
KV_CASES = [(32, 4096, 32, 8, 4096),
            (32, 4096, 8, 2, 4096),
            (8, 1000, 32, 8, 300),
            (4, 520, 8, 8, None),
            (4, 700, 8, 4, None),
            (2, 300, 16, 2, 100)]
KV_IDS = [f"B{c[0]}M{c[1]}H{c[2]}Hkv{c[3]}-w{c[4]}" for c in KV_CASES]
# kernel vs plain, bf16 out: the plain version rounds q . k to bf16 after
# the product (2**-9 of a raw dot) and p * vs to bf16 before the PV
# product, where the kernel keeps both in fp32; a row of one key gives
# out = v * vs, up to ~4, whose bf16 ulp is 2**-6
KV_TOL = 2e-2


def _kv_case(dev, B, M, H, Hkv, window, seed=0):
    """q, one layer of the int8 cache (N(0, 1) keys and values quantised
    as the model stores them) and the spans ``forward_cached`` gives rows
    at random positions, a quarter of them inactive."""
    import dataclasses

    from tpushare_torch.workloads import model

    D = 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k8, ks = model._kv_quant(torch.randn(B, M, Hkv, D, generator=gen,
                                         device=dev))
    v8, vs = model._kv_quant(torch.randn(B, M, Hkv, D, generator=gen,
                                         device=dev))
    pos = torch.randint(0, M, (B,), generator=gen, device=dev)
    pos[0], pos[-1] = 0, M - 1
    active = torch.rand(B, generator=gen, device=dev) >= 0.25
    active[0] = active[-1] = True
    cfg = dataclasses.replace(model.PRESETS["llama-tiny"], n_heads=H,
                              n_kv_heads=Hkv, d_model=H * D,
                              dtype=torch.bfloat16, kv_cache_dtype="int8",
                              attn_window=window)
    lo, hi = model.kv_decode_spans(cfg, {"k": k8[None]}, pos, 1, active)
    return q, k8, v8, ks, vs, lo, hi


@pytest.mark.parametrize("case", KV_CASES, ids=KV_IDS)
def test_kv_decode_matches_plain(cuda, case):
    from tpushare_torch.kernels import kv_decode

    args = _kv_case(cuda, *case)
    before = kv_decode.LAUNCHES
    out = kv_decode.kv_decode(*args)
    torch.cuda.synchronize()
    assert kv_decode.LAUNCHES == before + 1
    ref = kv_decode.kv_decode_plain(*args)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= KV_TOL
    lo, hi = args[-2:]
    assert not out[hi <= lo].any()  # an inactive row reads nothing: 0


# -- the decode step as a CUDA graph (workloads/engine.py) -------------------

# name -> (engine arguments, window): greedy; sampled per request beside
# greedy co-tenants; rolling slots (a ring the einsum attends, no
# kv_decode) sampled by the engine's temperature, top-k and top-p
GRAPH_CASES = {"greedy": ({}, None),
               "per-request": ({"per_request_sampling": True, "seed": 7},
                               None),
               "rolling": ({"rolling": True, "temperature": 0.8,
                            "top_k": 40, "top_p": 0.9, "seed": 3}, 16)}
# (prompt length, budget, per-request temperature), submitted two, one,
# then two at a time between quanta of 3, 1, 4 and 3 steps: slots join
# mid-flight, finish inside a quantum and are taken again
GRAPH_REQUESTS = [(5, 9, 0.0), (37, 4, 0.9), (12, 6, 0.0), (20, 8, 0.7),
                  (3, 7, 0.0)]


def _graph_model(dev, window):
    """A Mistral-shaped model at a small width: bf16, head_dim 128, 4
    query heads a kv head, int8 weights and KV cache, flash prefill."""
    import dataclasses

    from tpushare_torch.workloads import model
    cfg = dataclasses.replace(model.PRESETS["llama-tiny"], d_model=512,
                              n_heads=4, n_kv_heads=1, d_ff=1024,
                              dtype=torch.bfloat16, attn="flash",
                              kv_cache_dtype="int8", attn_window=window)
    with torch.inference_mode():
        params = model.quantize_int8(model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0)))
    return params, cfg


def _graph_schedule(eng, eos: dict, logits: list) -> list:
    """The staggered requests through ``run_quantum``; returns, per
    quantum that decoded, (its emitted block, the logits of its last
    step, the streams it finished). ``eos``: request -> its stop token
    (request ids follow the submissions); ``logits``: the list the
    decode steps' logits are appended to."""
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, eng.cfg.vocab, (n,), generator=gen).tolist()
               for n, _, _ in GRAPH_REQUESTS]
    decode = eng.decode_quantum
    blocks, out = [], []

    def kept(k):
        blocks.append(decode(k).cpu())
        return blocks[-1]

    eng.decode_quantum = kept

    def submit(i):
        n, budget, temp = GRAPH_REQUESTS[i]
        kw = {"temperature": temp} if eng._per_request else {}
        eng.submit(prompts[i], budget, eos_id=eos.get(i), **kw)

    def quantum(k):
        if eng.resident:
            finished = eng.run_quantum(k)
            out.append((blocks[-1], logits[-1].clone(), finished))

    submit(0)
    submit(1)
    quantum(3)
    submit(2)
    quantum(1)
    quantum(4)
    submit(3)
    submit(4)
    while eng.resident:
        quantum(3)
    return out


def _eager(eng):
    """``eng`` with every decode step run by its private eager step."""
    def decode_quantum(k):
        with torch.inference_mode():
            rows = [eng._step() for _ in range(k)]
            return torch.stack(rows + [eng._active.long()])

    eng.decode_quantum = decode_quantum
    return eng


@pytest.mark.parametrize("name", list(GRAPH_CASES))
def test_replayed_decode_steps_are_bitwise_the_eager_step(cuda, monkeypatch,
                                                          name):
    from tpushare_torch.kernels import kv_decode
    from tpushare_torch.workloads import engine as te

    kw, window = GRAPH_CASES[name]
    params, cfg = _graph_model(cuda, window)
    captures = []
    # each decode step's (T = 1) logits as the engine's step sees them: a
    # fresh tensor for an eager step, the graph's own output (which every
    # replay refills) for the captured one
    logits = []
    real_capture, real_forward = te.DecodeEngine._capture, te.forward_cached

    def capture(self):
        captures.append(self)
        return real_capture(self)

    def forward(params, tokens, *a, **kw):
        out, cache = real_forward(params, tokens, *a, **kw)
        if tokens.shape[1] == 1:
            logits.append(out if torch.cuda.is_current_stream_capturing()
                          else out.clone())
        return out, cache

    monkeypatch.setattr(te.DecodeEngine, "_capture", capture)
    monkeypatch.setattr(te, "forward_cached", forward)

    def engine():
        return te.DecodeEngine(params, cfg, max_slots=4, max_len=64,
                               quantum=3, **kw)

    # a request with a stop token stops at the first token of its stream
    # past the second that it had not emitted before
    streams = {}
    for _, _, finished in _graph_schedule(_eager(engine()), {}, logits):
        streams.update(finished)
    eos = {i: next(t for j, t in enumerate(s) if j >= 2 and t not in s[:j])
           for i, s in streams.items()
           if any(t not in s[:j] for j, t in enumerate(s) if j >= 2)}
    assert eos, streams
    want = _graph_schedule(_eager(engine()), eos, logits)

    eng = engine()
    decode, steps = eng.decode_quantum, [0]

    def counted(k):
        steps[0] += k
        return decode(k)

    eng.decode_quantum = counted
    before = kv_decode.LAUNCHES
    got = _graph_schedule(eng, eos, logits)
    torch.cuda.synchronize()
    assert captures == [eng]
    assert kv_decode.LAUNCHES - before == \
        (0 if kw.get("rolling") else cfg.n_layers * steps[0])
    assert len(got) == len(want) >= 4
    for (g_block, g_logits, g_done), (w_block, w_logits, w_done) in \
            zip(got, want):
        assert torch.equal(g_block, w_block)
        # bit for bit (an idle ring slot's row is NaN)
        assert torch.equal(g_logits.view(torch.int32),
                           w_logits.view(torch.int32))
        assert g_done == w_done
    stopped = [i for i, t in eos.items() for _, _, done in got
               if i in done and done[i][-1] == t
               and len(done[i]) < GRAPH_REQUESTS[i][1]]
    assert stopped, (eos, streams)
