"""The port's pipelined forward (``fwd_impl="pipelined"``, K4 on the card)
against the reference's interpret-mode ``_flash_kernel_pipelined`` on the
CPU, the ``TPUSHARE_FLASH_FWD`` resolution, and its gradients.

On CPU tensors the port's K4 wrapper runs K1's plain version (K4 is K1's
function, bitwise, by contract), so these tests hold that plain version
to the reference's K4 at K4's shapes: causal, non-causal, ragged bf16,
window 96, GQA with one kv head, and ViT-B/16's attention pattern (S=197,
D=64, MHA, non-causal). Inputs are drawn once with numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import attention as ja
from tpushare_torch.kernels import flash
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
# round differently after fp32 sums in another order; the LSE is fp32
# from the same bf16 inputs
BF16 = dict(atol=2e-2, rtol=2e-2)
BF16_LSE = dict(atol=1e-4, rtol=1e-4)

# (name, B, H, Hkv, S, D, dtype, causal, window)
CASES = [
    ("causal", 1, 4, 2, 256, 64, "float32", True, None),
    ("non-causal", 1, 4, 2, 256, 64, "float32", False, None),
    ("ragged-bf16", 1, 4, 2, 300, 64, "bfloat16", True, None),
    ("window-96", 1, 4, 2, 384, 64, "float32", True, 96),
    ("gqa-one-kv-head", 1, 4, 1, 256, 64, "float32", True, None),
    ("vit-pattern", 2, 4, 4, 197, 64, "bfloat16", False, None),
]


def _arrays(B, H, Hkv, S, D, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, D), dtype=np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@functools.cache
def _reference(case):
    """The reference's interpret-mode K4 on ``case``'s inputs."""
    _, B, H, Hkv, S, D, dtype, causal, window = case
    arrays = _arrays(B, H, Hkv, S, D)
    q, k, v = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    jo, jl = ja._flash_call(q, k, v, causal, True, window=window,
                            pipelined=True)
    return arrays, _np(jo), _np(jl)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipelined_matches_reference_pipelined_kernel(case):
    _, B, H, Hkv, S, D, dtype, causal, window = case
    arrays, jo, jl = _reference(case)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in arrays)
    before = (flash.LAUNCHES, flash.LAUNCHES_PIPELINED)
    to, tl = ta._flash_call(q, k, v, causal, window, pipelined=True)
    out = ta.flash_attention(q, k, v, causal=causal, window=window,
                             fwd_impl="pipelined")
    # CPU tensors never count as kernel launches
    assert (flash.LAUNCHES, flash.LAUNCHES_PIPELINED) == before
    assert to.shape == (B, H, S, D) and tl.shape == (B, H, S)
    assert torch.equal(out, to)
    tol, lse_tol = (F32, F32) if dtype == "float32" else (BF16, BF16_LSE)
    np.testing.assert_allclose(_np(to), jo, **tol)
    np.testing.assert_allclose(_np(tl), jl, **lse_tol)
    # the two forwards are one function: bitwise the step forward's
    so, sl = ta._flash_call(q, k, v, causal, window)
    assert torch.equal(to, so) and torch.equal(tl, sl)


def test_fwd_impl_resolution_matches_reference(monkeypatch):
    monkeypatch.delenv("TPUSHARE_FLASH_FWD", raising=False)
    assert ta._resolve_flash_fwd(None) == ja._resolve_flash_fwd(None) \
        == "step"
    assert ta._resolve_flash_fwd("pipelined") == "pipelined"
    monkeypatch.setenv("TPUSHARE_FLASH_FWD", "pipelined")
    assert ta._resolve_flash_fwd(None) == ja._resolve_flash_fwd(None) \
        == "pipelined"
    # the argument wins over the environment
    assert ta._resolve_flash_fwd("step") == "step"
    for bad_env, bad_arg in (("bogus", None), ("pipelined", "fused")):
        monkeypatch.setenv("TPUSHARE_FLASH_FWD", bad_env)
        with pytest.raises(ValueError) as jerr:
            ja._resolve_flash_fwd(bad_arg)
        with pytest.raises(ValueError) as terr:
            ta._resolve_flash_fwd(bad_arg)
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError, match="TPUSHARE_FLASH_FWD"):
            ta.flash_attention(*torch.zeros(3, 1, 2, 8, 16).unbind(0),
                               fwd_impl=bad_arg)


@pytest.mark.parametrize("bwd_impl", ["pallas", "xla"])
def test_pipelined_gradients_are_the_step_gradients(bwd_impl, monkeypatch):
    # the forward variant changes only the forward: the backward, fed the
    # same O and LSE, is the same for both
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 4, 2, 200, 32, 7))
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(
        q.shape, dtype=np.float32))
    grads = {}
    for impl in ("step", "pipelined"):
        monkeypatch.setenv("TPUSHARE_FLASH_FWD", impl)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ta.flash_attention(*leaves, causal=True, bwd_impl=bwd_impl)
        grads[impl] = torch.autograd.grad((out * w).sum(), leaves)
    for a, b in zip(grads["step"], grads["pipelined"]):
        assert torch.equal(a, b)


def test_pipelined_gradients_match_reference():
    arrays = _arrays(1, 4, 2, 130, 32, 9)
    w = np.random.default_rng(10).standard_normal(arrays[0].shape,
                                                  dtype=np.float32)

    def jloss(q, k, v):
        return jnp.sum(ja.flash_attention(q, k, v, causal=True,
                                          fwd_impl="pipelined") * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ta.flash_attention(*leaves, causal=True, fwd_impl="pipelined")
    tgrads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for got, want in zip(tgrads, jgrads):
        # fp32 sums in another order (the reference's interpret mode runs
        # its fp32 blockwise backward, the port the dq/dk/dv plain
        # versions)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
