"""Port flash-attention backward (tpushare_torch/workloads/attention.py
and tpushare_torch/kernels/flash_bwd.py) against the JAX reference on
the CPU.

The reference's two backward kernels run in interpret mode through its
``_flash_bwd_pallas``; the port's side runs their plain versions, which
the kernel wrappers take for CPU tensors. Both sides get the same
numpy-seeded q, k, v and dO and the same (O, LSE) from the reference's
forward, so each test isolates the backward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import attention as ja
from tpushare_torch.kernels import flash_bwd
from tpushare_torch.workloads import attention as ta

torch.set_num_threads(2)
# The first attention a process computes with torch's CPU kernels has been
# seen to come out about 1e-4 off (in roughly one fresh process of 70,
# the same wrong bits each time), with every later call exact to fp32.
# One small call at import keeps that first call out of the comparisons.
ta.flash_attention_plain(*torch.zeros(3, 1, 1, 8, 16).unbind(0))

# fp32: both sides accumulate in fp32 and differ only in summation order;
# 1e-5 of the largest gradient magnitude (measured: a few 1e-7)
F32_REL = 1e-5
# bf16: dS and P are rounded to bf16 before their products on both sides,
# and a value near a rounding boundary may round the other way after fp32
# sums in another order: two bf16 ulps (2**-7 of the magnitude) at the
# largest gradient magnitude
BF16_REL = 2 ** -7

# (name, B, H, Hkv, S, Skv, D, causal, window)
CASES = [
    ("causal", 1, 4, 4, 128, 128, 64, True, None),
    ("non-causal-skv", 1, 4, 4, 96, 160, 64, False, None),
    ("ragged-gqa2", 1, 4, 2, 300, 300, 64, True, None),
    ("gqa4", 1, 8, 2, 128, 128, 32, True, None),
    ("window", 1, 8, 2, 256, 256, 32, True, 77),
]
BF16_CASES = ["ragged-gqa2", "window"]
BY_NAME = {c[0]: c for c in CASES}


def _arrays(seed, B, H, Hkv, S, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32),
            rng.standard_normal((B, H, S, D), dtype=np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, rel):
    want = _np(want)
    tol = rel * np.abs(want).max()
    err = np.abs(_np(got) - want).max()
    assert err <= tol, f"max|d| {err:.3g} > {tol:.3g}"


@functools.cache
def _reference(name, dtype):
    """Inputs of case ``name``, the reference's forward (O, LSE) and its
    interpret-mode kernel pair's (dq, dk, dv) on them, as numpy."""
    _, B, H, Hkv, S, Skv, D, causal, window = BY_NAME[name]
    arrays = _arrays(1, B, H, Hkv, S, Skv, D)
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    q, k, v, do = (jnp.asarray(a, jd) for a in arrays)
    out, lse = ja._flash_call(q, k, v, causal, True, window=window)
    grads = ja._flash_bwd_pallas(q, k, v, out, lse, do, causal, True,
                                 window=window)
    return (arrays, _np(out), _np(lse)), tuple(_np(g) for g in grads)


def _port_inputs(fwd, dtype):
    arrays, out, lse = fwd
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    # copies: the cached reference arrays stay as they are
    q, k, v, do = (torch.tensor(a).to(td) for a in arrays)
    return q, k, v, torch.tensor(out).to(td), torch.tensor(lse), do


PAIR = [(c[0], "fp32") for c in CASES] + [(n, "bf16") for n in BF16_CASES]


@pytest.mark.parametrize("name,dtype", PAIR,
                         ids=[f"{n}-{d}" for n, d in PAIR])
def test_plain_kernels_match_reference_kernels(name, dtype):
    _, B, H, Hkv, S, Skv, D, causal, window = BY_NAME[name]
    fwd, (jdq, jdk, jdv) = _reference(name, dtype)
    q, k, v, out, lse, do = _port_inputs(fwd, dtype)
    before = (flash_bwd.LAUNCHES_DQ, flash_bwd.LAUNCHES_DKDV)
    dq, dk, dv = ta._flash_bwd_pallas(q, k, v, out, lse, do, causal, window)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (flash_bwd.LAUNCHES_DQ, flash_bwd.LAUNCHES_DKDV) == before
    assert dq.shape == (B, H, S, D) and dk.shape == (B, Hkv, Skv, D)
    assert dq.dtype == q.dtype and dk.dtype == dv.dtype == k.dtype
    rel = F32_REL if dtype == "fp32" else BF16_REL
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _assert_close(got, want, rel)


def test_wrappers_on_cpu_are_the_plain_versions():
    fwd, _ = _reference("window", "fp32")
    q, k, v, out, lse, do = _port_inputs(fwd, "fp32")
    res = ta._bwd_residuals(q, out, lse, do)
    dq = flash_bwd.flash_bwd_dq(*res[:1], k, v, *res[1:], True, 77)
    dk, dv = flash_bwd.flash_bwd_dkdv(*res[:1], k, v, *res[1:], True, 77)
    assert torch.equal(dq, ta.flash_bwd_dq_plain(res[0], k, v, *res[1:],
                                                 True, 77))
    pk, pv = ta.flash_bwd_dkdv_plain(res[0], k, v, *res[1:], True, 77)
    assert torch.equal(dk, pk) and torch.equal(dv, pv)
    with pytest.raises(ValueError, match="all on cpu or all on cuda"):
        flash_bwd.flash_bwd_dq(res[0].to("meta"), k, v, *res[1:], True)


def test_residuals_clamp_lse_and_match_reference():
    fwd, _ = _reference("causal", "fp32")
    q, k, v, out, lse, do = _port_inputs(fwd, "fp32")
    lse[0, 1, 3] = float("-inf")
    qs, do_c, lse_c, delta = ta._bwd_residuals(q, out, lse, do)
    assert lse_c[0, 1, 3].item() == np.float32(1e30)
    assert torch.equal(lse_c[0, 0], lse[0, 0])
    np.testing.assert_allclose(
        qs.numpy(), (q.numpy() * 64 ** -0.5).astype(np.float32), rtol=1e-7)
    np.testing.assert_allclose(
        delta.numpy(), (do.numpy() * out.numpy()).sum(-1), rtol=1e-5,
        atol=1e-5)


XLA = ["causal", "non-causal-skv", "ragged-gqa2", "window"]


@pytest.mark.parametrize("name", XLA)
def test_xla_backward_matches_reference(name):
    _, B, H, Hkv, S, Skv, D, causal, window = BY_NAME[name]
    (arrays, out, lse), _ = _reference(name, "fp32")
    jres = tuple(jnp.asarray(a) for a in (*arrays[:3], out, lse))
    jgrads = ja._flash_bwd_xla(causal, jres, jnp.asarray(arrays[3]),
                               window=window)
    q, k, v, tout, tlse, do = _port_inputs((arrays, out, lse), "fp32")
    tgrads = ta._flash_bwd_xla(causal, (q, k, v, tout, tlse), do,
                               window=window)
    for got, want in zip(tgrads, jgrads):
        assert got.shape == want.shape
        _assert_close(got, want, F32_REL)


AUTOGRAD = [(n, impl) for n in ("gqa4", "non-causal-skv", "window")
            for impl in ("pallas", "xla")]


@functools.cache
def _jax_vjp(name):
    """dq, dk, dv of the reference's public flash_attention (interpret
    mode, its custom VJP) for the cotangent dO of case ``name``."""
    _, B, H, Hkv, S, Skv, D, causal, window = BY_NAME[name]
    q, k, v, do = (jnp.asarray(a) for a in _arrays(2, B, H, Hkv, S, Skv, D))
    _, vjp = jax.vjp(lambda q, k, v: ja.flash_attention(
        q, k, v, causal=causal, interpret=True, window=window), q, k, v)
    return tuple(_np(g) for g in vjp(do))


@pytest.mark.parametrize("name,impl", AUTOGRAD,
                         ids=[f"{n}-{i}" for n, i in AUTOGRAD])
def test_autograd_matches_reference_vjp(name, impl):
    _, B, H, Hkv, S, Skv, D, causal, window = BY_NAME[name]
    q, k, v, do = (torch.from_numpy(a).requires_grad_(i < 3)
                   for i, a in enumerate(_arrays(2, B, H, Hkv, S, Skv, D)))
    out = ta.flash_attention(q, k, v, causal=causal, window=window,
                             bwd_impl=impl)
    out.backward(do)
    for got, want in zip((q.grad, k.grad, v.grad), _jax_vjp(name)):
        _assert_close(got, want, F32_REL)


def test_flash_bwd_env_resolution(monkeypatch):
    _, B, H, Hkv, S, Skv, D, causal, window = BY_NAME["gqa4"]
    arrays = _arrays(3, B, H, Hkv, S, Skv, D)

    def grads(**kw):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
        ta.flash_attention(q, k, v, **kw).backward(torch.from_numpy(
            arrays[3]))
        return q.grad, k.grad, v.grad

    def expected(which):
        q, k, v, do = (torch.from_numpy(a) for a in arrays)
        out, lse = ta._flash_call(q, k, v, True)
        if which == "xla":
            return ta._flash_bwd_xla(True, (q, k, v, out, lse), do)
        return ta._flash_bwd_pallas(q, k, v, out, lse, do, True)

    monkeypatch.delenv("TPUSHARE_FLASH_BWD", raising=False)
    assert ta._resolve_flash_bwd(None) == "pallas"
    for got, want in zip(grads(), expected("pallas")):
        assert torch.equal(got, want)
    monkeypatch.setenv("TPUSHARE_FLASH_BWD", "xla")
    assert ta._resolve_flash_bwd(None) == "xla"
    for got, want in zip(grads(), expected("xla")):
        assert torch.equal(got, want)
    # the argument wins over the env
    for got, want in zip(grads(bwd_impl="pallas"), expected("pallas")):
        assert torch.equal(got, want)
    monkeypatch.setenv("TPUSHARE_FLASH_BWD", "bogus")
    with pytest.raises(ValueError) as terr:
        ta.flash_attention(*(torch.from_numpy(a) for a in arrays[:3]))
    with pytest.raises(ValueError) as jerr:
        ja._resolve_flash_bwd(None)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="bwd_impl='triton'"):
        ta._resolve_flash_bwd("triton")


def test_no_grad_forward_is_unchanged():
    q, k, v, _ = (torch.from_numpy(a)
                  for a in _arrays(4, 1, 2, 2, 16, 16, 16))
    q.requires_grad_(True)
    with torch.no_grad():
        base = ta.flash_attention(q, k, v)
        assert base.grad_fn is None
    out = ta.flash_attention(q, k, v)
    assert out.grad_fn is not None and torch.equal(out.detach(), base)
