"""Port model (tpushare_torch/workloads/model.py) against the JAX
reference (tpushare/workloads/model.py) on the CPU, at llama-tiny size.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``, so both sides start from bitwise the same
numbers. The flash backend runs the reference's Pallas kernel in
interpret mode and the port's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import model as jm
from tpushare_torch.workloads import attention as ta
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads.convert import params_from_numpy

torch.set_num_threads(2)
# The first attention a process computes with torch's CPU kernels has been
# seen to come out about 1e-4 off (in roughly one fresh process of 70,
# the same wrong bits each time), with every later call exact to fp32.
# One small call at import keeps that first call out of the comparisons.
ta.flash_attention_plain(*torch.zeros(3, 1, 1, 8, 16).unbind(0))

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the same math in another summation order
F32 = dict(atol=1e-4, rtol=1e-4)
# bf16: the two frameworks round intermediate activations at different
# places; after two layers the logits (|logit| up to about 5) move by a
# bf16 ulp or two of 2**-5
BF16 = dict(atol=0.1, rtol=0.02)


def _cfgs(dtype="fp32", **kw):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jm.PRESETS["llama-tiny"], dtype=jd, **kw),
            dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=td, **kw))


# the reference's functions jitted whole: one compile a configuration
# instead of one a primitive, which keeps these tests cheap
_jax_forward = jax.jit(jm.forward, static_argnums=2)
_jax_forward_cached = jax.jit(jm.forward_cached, static_argnums=(3, 4))
_jax_greedy = jax.jit(jm.greedy_decode_kv, static_argnums=(2, 3, 4))


def _params(jcfg, quant=False, seed=0):
    pj = jm.init_params(jcfg, jax.random.key(seed))
    if quant:
        pj = jm.quantize_int8(pj)
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


FORWARD = [(d, q, a) for d, q in (("fp32", False), ("bf16", False),
                                  ("bf16", True))
           for a in ("einsum", "flash")]


@pytest.mark.parametrize("dtype,quant,attn", FORWARD,
                         ids=[f"{d}-{'int8' if q else 'plain'}-{a}"
                              for d, q, a in FORWARD])
def test_forward_logits_match_reference(dtype, quant, attn):
    jcfg, tcfg = _cfgs(dtype, attn=attn)
    pj, pt = _params(jcfg, quant)
    tok = _tokens(1, 2, 40)
    lj = _jax_forward(pj, jnp.asarray(tok, jnp.int32), jcfg)
    lt = tm.forward(pt, torch.from_numpy(tok), tcfg)
    assert lt.shape == (2, 40, 256) and lt.dtype == torch.float32
    np.testing.assert_allclose(_np(lt), _np(lj),
                               **(F32 if dtype == "fp32" else BF16))


def test_forward_with_aux_is_zero_for_dense():
    jcfg, tcfg = _cfgs()
    _, pt = _params(jcfg)
    logits, aux = tm.forward_with_aux(pt, torch.from_numpy(_tokens(2, 1, 9)),
                                      tcfg)
    assert logits.shape == (1, 9, 256) and float(aux) == 0.0


def test_quantize_int8_is_bitwise_the_reference():
    jcfg, _ = _cfgs("bf16")
    pj, pt = _params(jcfg)
    qj = jax.tree.map(np.asarray, jm.quantize_int8(pj))
    qt = tm.quantize_int8(pt)
    for name in tm.QUANT_KEYS:
        assert qt["layers"][name]["int8"].dtype == torch.int8
        np.testing.assert_array_equal(qt["layers"][name]["int8"].numpy(),
                                      qj["layers"][name]["int8"])
        np.testing.assert_array_equal(qt["layers"][name]["scale"].numpy(),
                                      qj["layers"][name]["scale"])
    np.testing.assert_array_equal(qt["lm_head"]["int8"].numpy(),
                                  qj["lm_head"]["int8"])
    np.testing.assert_array_equal(qt["lm_head"]["scale"].numpy(),
                                  qj["lm_head"]["scale"])
    assert qt["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_building_blocks_match_reference(dtype):
    jd, td = DTYPES[dtype]
    tol = F32 if dtype == "fp32" else dict(atol=2e-2, rtol=2e-2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    g = rng.standard_normal((16,), dtype=np.float32)
    pos = np.tile(np.arange(3, 10), (2, 1))
    np.testing.assert_allclose(
        _np(tm._rope(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                     500000.0)),
        _np(jm._rope(jnp.asarray(x, jd), jnp.asarray(pos), 500000.0)), **tol)
    np.testing.assert_allclose(
        _np(tm._rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(g).to(td))),
        _np(jm._rmsnorm(jnp.asarray(x, jd), jnp.asarray(g, jd))), **tol)
    w = rng.standard_normal((16, 24), dtype=np.float32)
    wj = jm._q(jnp.asarray(w, jd))
    wt = tm._q(torch.from_numpy(w).to(td))
    np.testing.assert_allclose(
        _np(tm._matmul(torch.from_numpy(x).to(td), wt)),
        _np(jm._matmul(jnp.asarray(x, jd), wj)), **tol)


def test_init_params_has_the_reference_layout():
    jcfg, tcfg = _cfgs("bf16")
    pj = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.key(0)))
    pt = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    for path, leaf in flat_j:
        node = pt
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.bfloat16, path
    assert torch.equal(pt["final_norm"], torch.ones(64, dtype=torch.bfloat16))
    # N(0, 1/fan_in): the embedding's std is about 64 ** -0.5
    assert abs(pt["embed"].float().std().item() - 0.125) < 0.01
    again = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert torch.equal(pt["layers"]["w2"], again["layers"]["w2"])


# the einsum prefill of an int8 cache is the decode steps' code path
@pytest.mark.parametrize("attn,kv", [("einsum", "model"), ("flash", "model"),
                                     ("flash", "int8")])
def test_forward_cached_prefill_and_decode_match_reference(attn, kv):
    jcfg, tcfg = _cfgs("bf16", attn=attn, kv_cache_dtype=kv)
    pj, pt = _params(jcfg, quant=True)
    tok = _tokens(4, 2, 14)
    cj = jm.init_kv_cache(jcfg, 2, 16)
    ct = tm.init_kv_cache(tcfg, 2, 16)
    lj, cj = _jax_forward_cached(pj, jnp.asarray(tok[:, :12], jnp.int32),
                                 cj, 0, jcfg)
    lt, ct = tm.forward_cached(pt, torch.from_numpy(tok[:, :12]), ct, 0, tcfg)
    np.testing.assert_allclose(_np(lt), _np(lj), **BF16)
    for pos in range(12, 14):
        lj, cj = _jax_forward_cached(
            pj, jnp.asarray(tok[:, pos:pos + 1], jnp.int32), cj, pos, jcfg)
        lt, ct = tm.forward_cached(pt, torch.from_numpy(tok[:, pos:pos + 1]),
                                   ct, pos, tcfg)
        np.testing.assert_allclose(_np(lt), _np(lj), **BF16)
    if kv == "int8":
        assert ct["k"].dtype == torch.int8 and ct["ks"].shape == \
            (2, 2, 16, 2, 1)


GREEDY = [("einsum", None, False), ("flash", None, False),
          ("einsum", 4, False), ("flash", 5, True)]


@pytest.mark.parametrize("attn,window,rolling", GREEDY,
                         ids=["einsum", "flash", "window", "rolling"])
def test_greedy_decode_kv_tokens_equal_reference(attn, window, rolling):
    jcfg, tcfg = _cfgs(attn=attn, attn_window=window)
    pj, pt = _params(jcfg)
    prompt = _tokens(5, 2, 9)
    gj = _jax_greedy(pj, jnp.asarray(prompt, jnp.int32), 12, jcfg, rolling)
    gt = tm.greedy_decode_kv(pt, torch.from_numpy(prompt), 12, tcfg,
                             rolling=rolling)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_greedy_decode_equals_cached_decode():
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    _, pt = _params(jcfg)
    prompt = torch.from_numpy(_tokens(6, 2, 6))
    assert torch.equal(tm.greedy_decode(pt, prompt, 7, tcfg),
                       tm.greedy_decode_kv(pt, prompt, 7, tcfg))


def test_contract_errors():
    jcfg, tcfg = _cfgs(attn="flash")
    _, pt = _params(jcfg)
    x = torch.zeros(1, 4, 64)
    lp = tm._layer(pt, 0)
    with pytest.raises(ValueError, match="default causal mask"):
        tm.decoder_layer(x, lp, torch.arange(4)[None], tcfg,
                         mask=torch.ones(4, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="rolling cache requires"):
        tm.init_kv_cache(tcfg, 1, 8, rolling=True)
    wcfg = dataclasses.replace(tcfg, attn_window=4)
    ring = tm.init_kv_cache(wcfg, 1, 6, rolling=True)
    with pytest.raises(ValueError, match="overwrites keys"):
        tm.forward_cached(pt, torch.zeros(1, 5, dtype=torch.long), ring, 3,
                          wcfg)
    with pytest.raises(ValueError, match="outside the 8-slot cache"):
        tm.forward_cached(pt, torch.zeros(1, 5, dtype=torch.long),
                          tm.init_kv_cache(tcfg, 1, 8), 4, tcfg)
