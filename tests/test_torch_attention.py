"""Port attention (tpushare_torch/workloads/attention.py) against the JAX
reference (tpushare/workloads/attention.py) on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests
do; the port's side runs the CUDA kernel's plain version, which is what
the kernel wrapper takes for CPU tensors. Inputs are drawn once with
numpy and handed to both.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import attention as ja
from tpushare_torch.workloads import attention as ta

torch.set_num_threads(2)
# The first attention a process computes with torch's CPU kernels has been
# seen to come out about 1e-4 off (in roughly one fresh process of 70,
# the same wrong bits each time), with every later call exact to fp32.
# One small call at import keeps that first call out of the comparisons.
ta.flash_attention_plain(*torch.zeros(3, 1, 1, 8, 16).unbind(0))

# fp32: both sides accumulate in fp32 and differ only in summation order
F32 = dict(atol=1e-5, rtol=1e-5)
# bf16 outputs: one or two bf16 ulps (2**-7 at 1.0) from p values that
# round differently after fp32 sums in another order
BF16 = dict(atol=2e-2, rtol=2e-2)

# (name, B, H, Hkv, S, Skv, D, causal, window)
CASES = [
    ("causal", 1, 4, 4, 128, 128, 64, True, None),
    ("non-causal", 1, 4, 4, 96, 160, 64, False, None),
    ("multiblock", 1, 2, 2, 320, 320, 32, True, None),
    ("ragged", 1, 8, 2, 200, 200, 64, True, None),
    ("gqa", 2, 8, 2, 128, 128, 16, True, None),
    ("window", 1, 8, 2, 256, 256, 64, True, 77),
]


def _qkv(seed, B, H, Hkv, S, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@functools.cache
def _reference(case):
    """Inputs of ``case`` and the reference's interpret-mode
    ``_flash_call`` on them (shared by the tests below)."""
    _, B, H, Hkv, S, Skv, D, causal, window = case
    arrays = _qkv(1, B, H, Hkv, S, Skv, D)
    jo, jl = ja._flash_call(*_jax(*arrays), causal, True, window=window)
    return arrays, _np(jo), _np(jl)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_reference_flash_call(case):
    _, B, H, Hkv, S, Skv, D, causal, window = case
    arrays, jo, jl = _reference(case)
    to, tl = ta.flash_attention_plain(*_torch(*arrays), causal, window)
    assert to.shape == (B, H, S, D) and tl.shape == (B, H, S)
    assert to.dtype == torch.float32 and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_call_matches_reference(case):
    # the port's _flash_call on CPU tensors goes through the kernel
    # wrapper to the plain version
    _, B, H, Hkv, S, Skv, D, causal, window = case
    arrays, jo, jl = _reference(case)
    to, tl = ta._flash_call(*_torch(*arrays), causal, window)
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)


@pytest.mark.parametrize("case", [c for c in CASES if c[4] == c[5]],
                         ids=[c[0] for c in CASES if c[4] == c[5]])
def test_flash_attention_matches_reference_and_spec(case):
    _, B, H, Hkv, S, Skv, D, causal, window = case
    arrays = _qkv(3, B, H, Hkv, S, Skv, D)
    jo = ja.flash_attention(*_jax(*arrays), causal=causal, interpret=True,
                            window=window)
    to = ta.flash_attention(*_torch(*arrays), causal=causal, window=window)
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    # the einsum spec takes expanded heads
    q, k, v = arrays
    g = H // Hkv
    kx, vx = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    jr = ja.attention_reference(*_jax(q, kx, vx), causal=causal,
                                window=window)
    tr = ta.attention_reference(*_torch(q, kx, vx), causal=causal,
                                window=window)
    np.testing.assert_allclose(_np(tr), _np(jr), **F32)
    np.testing.assert_allclose(_np(to), _np(tr), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window", [None, 77], ids=["causal", "window"])
def test_bf16_matches_reference(window):
    arrays = _qkv(4, 1, 8, 2, 192, 192, 64)
    jo, jl = ja._flash_call(*_jax(*arrays, dtype=jnp.bfloat16), True, True,
                            window=window)
    to, tl = ta.flash_attention_plain(
        *_torch(*arrays, dtype=torch.bfloat16), True, window)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **BF16)
    # LSE is fp32 from the fp32 scores of the same bf16 inputs
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)


class _Ref:
    """A stand-in for a Pallas ref around a jax array, so the reference's
    online-softmax helpers run outside a kernel."""

    def __init__(self, a):
        self.a = a

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, val):
        self.a = self.a.at[idx].set(val)


def test_row_without_visible_key():
    # row 0 sees no key in either block, row 1 none in the first block
    # only: LSE -inf and output 0 for row 0, and the guarded m=-inf
    # rescale for row 1 (no public shape reaches these rows)
    rng = np.random.default_rng(5)
    BQ, BK, D = 4, 8, 16
    s1 = rng.standard_normal((BQ, BK), dtype=np.float32)
    s2 = rng.standard_normal((BQ, BK), dtype=np.float32)
    s1[:2] = -np.inf
    s2[0] = -np.inf
    v1 = rng.standard_normal((BK, D), dtype=np.float32)
    v2 = rng.standard_normal((BK, D), dtype=np.float32)

    m, l, acc = (_Ref(jnp.full((BQ, 1), -jnp.inf)), _Ref(jnp.zeros((BQ, 1))),
                 _Ref(jnp.zeros((BQ, D))))
    for s, vb in ((s1, v1), (s2, v2)):
        ja._online_softmax_accum(jnp.asarray(s), jnp.asarray(vb), m, l, acc)
    o_ref = _Ref(jnp.zeros((1, 1, BQ, D)))
    lse_ref = _Ref(jnp.zeros((1, 1, 8, BQ)))
    ja._emit_block(o_ref, lse_ref, m, l, acc)

    tm, tl, tacc = (torch.full((BQ, 1), float("-inf")), torch.zeros(BQ, 1),
                    torch.zeros(BQ, D))
    for s, vb in ((s1, v1), (s2, v2)):
        tm, tl, tacc = ta._online_softmax_step(
            torch.from_numpy(s), torch.from_numpy(vb), tm, tl, tacc)
    out, lse = ta._emit(tm, tl, tacc, torch.float32)

    assert torch.isneginf(lse[0]) and torch.all(out[0] == 0)
    assert torch.isfinite(lse[1:]).all() and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(o_ref.a[0, 0]), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref.a[0, 0, 0]),
                               **F32)


BAD = [
    ("gqa", (1, 6, 8, 16), (1, 4, 8, 16), True, None),
    ("head_dim", (1, 2, 8, 256), (1, 2, 8, 256), True, None),
    ("causal-lengths", (1, 2, 8, 16), (1, 2, 12, 16), True, None),
    ("window-non-causal", (1, 2, 8, 16), (1, 2, 8, 16), False, 4),
    ("window-zero", (1, 2, 8, 16), (1, 2, 8, 16), True, 0),
]


@pytest.mark.parametrize("bad", BAD, ids=[b[0] for b in BAD])
def test_value_errors_match_reference(bad):
    _, qs, ks, causal, window = bad
    with pytest.raises(ValueError) as jerr:
        ja.flash_attention(jnp.zeros(qs), jnp.zeros(ks), jnp.zeros(ks),
                           causal=causal, interpret=True, window=window)
    with pytest.raises(ValueError) as terr:
        ta.flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks),
                           causal=causal, window=window)
    assert str(terr.value) == str(jerr.value)


def test_reference_window_needs_causal():
    q = np.zeros((1, 2, 8, 16), np.float32)
    with pytest.raises(ValueError) as jerr:
        ja.attention_reference(*_jax(q, q, q), causal=False, window=3)
    with pytest.raises(ValueError) as terr:
        ta.attention_reference(*_torch(q, q, q), causal=False, window=3)
    assert str(terr.value) == str(jerr.value)


def test_tpu_knobs_are_ignored_and_pipelined_is_not_ported(monkeypatch):
    arrays = _qkv(6, 1, 2, 2, 64, 64, 16)
    base = ta.flash_attention(*_torch(*arrays))
    knobs = ta.flash_attention(*_torch(*arrays), interpret=True, block_q=128,
                               block_kv=256, bwd_impl="xla", fwd_impl="step")
    assert torch.equal(base, knobs)
    # the pipelined forward (K4) is ported: K1's function, bitwise, so on
    # CPU tensors both take the same plain version
    assert torch.equal(base, ta.flash_attention(*_torch(*arrays),
                                                fwd_impl="pipelined"))
    monkeypatch.setenv("TPUSHARE_FLASH_FWD", "pipelined")
    assert torch.equal(base, ta.flash_attention(*_torch(*arrays)))
    monkeypatch.setenv("TPUSHARE_FLASH_FWD", "bogus")
    with pytest.raises(ValueError, match="fwd_impl"):
        ta.flash_attention(*_torch(*arrays))


def test_sliding_window_mask_matches_reference():
    rows = np.arange(40)[:, None]
    cols = np.arange(40)[None, :]
    for w in (1, 5, 40):
        np.testing.assert_array_equal(
            ta.sliding_window_mask(torch.from_numpy(rows),
                                   torch.from_numpy(cols), w).numpy(),
            np.asarray(ja.sliding_window_mask(jnp.asarray(rows),
                                              jnp.asarray(cols), w)))
