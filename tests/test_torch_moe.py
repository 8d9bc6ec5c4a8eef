"""The port's mixture-of-experts FFN (tpushare_torch/workloads/moe.py) and
the llama-moe-tiny model built on it, against the JAX reference
(tpushare/workloads/moe.py, model.py) on the CPU.

Inputs come from numpy seeds; weights from the reference's init, carried
across with ``params_from_numpy``, so both sides start from bitwise the
same numbers. Routing (the dispatch tensor: which token takes which
expert slot) is asserted equal before any float comparison, so a near-tie
that flipped an argmax is told apart from a wrong port. The flash backend
runs the reference's Pallas kernel in interpret mode and the port's plain
version.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import model as jm
from tpushare.workloads import moe as jmoe
from tpushare_torch.workloads import attention as ta
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import moe as tmoe
from tpushare_torch.workloads.convert import params_from_numpy

torch.set_num_threads(2)
# The first attention a process computes with torch's CPU kernels has been
# seen to come out about 1e-4 off (in roughly one fresh process of 70),
# with every later call exact to fp32; one call at import keeps it out of
# the comparisons.
ta.flash_attention_plain(*torch.zeros(3, 1, 1, 8, 16).unbind(0))

# fp32 layer outputs and gradients: the same math in another summation
# order (measured: a few 1e-7)
F32 = dict(atol=1e-5, rtol=1e-5)
# bf16 layer outputs, relative to the largest reference output: the two
# frameworks round the SwiGLU's intermediates at different places, which
# moves an output by a bf16 ulp or two (2**-7 of its magnitude)
BF16_REL = 2 ** -5
# llama-moe-tiny fp32 logits, loss and gradients (as tests/test_torch_train.py)
MODEL = dict(atol=1e-5, rtol=1e-4)
# parameters after two AdamW steps (as tests/test_torch_train.py): single
# elements whose gradient is within round-off of 0 may differ by part of
# a step; the bulk agrees to round-off
PARAM_MAX = 1e-4
PARAM_MEAN = 1e-7

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


# the reference's functions jitted whole: one compile a configuration
# instead of one dispatch a primitive
_jax_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)
_jax_route = jax.jit(jmoe._route, static_argnums=(1, 2))


def _cfgs(dtype="fp32", **kw):
    jd, td = DTYPES[dtype]
    base = dict(d_model=16, d_ff=32, n_experts=4, top_k=2,
                capacity_factor=1.25)
    base.update(kw)
    return (jmoe.MoEConfig(dtype=jd, **base),
            tmoe.MoEConfig(dtype=td, **base))


def _params(jcfg, seed=0):
    pj = jmoe.init_moe_params(jcfg, jax.random.key(seed))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _dispatch(params, x, cfg, route):
    """The dispatch tensor a layer's routing gives: ``route`` is either
    package's ``_route``."""
    xt = x.reshape(-1, x.shape[-1])
    if isinstance(x, torch.Tensor):
        return _np(route(xt.float() @ params["wg"], cfg.top_k,
                         cfg.capacity(xt.shape[0]))[0])
    return _np(route(xt.astype(jnp.float32) @ params["wg"], cfg.top_k,
                     cfg.capacity(xt.shape[0]))[0])


def _same_routing(pj, pt, x, jcfg, tcfg):
    dj = _dispatch(pj, jnp.asarray(x, jcfg.dtype), jcfg, _jax_route)
    dt = _dispatch(pt, torch.from_numpy(x).to(tcfg.dtype), tcfg, tmoe._route)
    np.testing.assert_array_equal(dt, dj)
    return dj


@pytest.mark.parametrize("factor", [1e-9, 1.25, 2.0, 4.0, 8.0])
def test_capacity_matches_reference(factor):
    for experts, k in ((4, 2), (8, 2), (8, 1), (3, 2)):
        jc, tc = _cfgs(n_experts=experts, top_k=k, capacity_factor=factor)
        got = [tc.capacity(t) for t in range(1, 2050)]
        assert got == [jc.capacity(t) for t in range(1, 2050)]
        assert min(got) >= 1


ROUTE = [(2, 0.5), (2, 4.0), (1, 0.5), (1, 4.0)]


@pytest.mark.parametrize("top_k,factor", ROUTE,
                         ids=[f"top{k}-{'drops' if f < 1 else 'dropless'}"
                              for k, f in ROUTE])
def test_route_matches_reference(top_k, factor):
    E, T = 4, 48
    logits = _x(1, T, E) * 2
    C = _cfgs(top_k=top_k, capacity_factor=factor)[1].capacity(T)
    dj, cj, aj = _jax_route(jnp.asarray(logits), top_k, C)
    dt, ct, at = tmoe._route(torch.from_numpy(logits), top_k, C)
    np.testing.assert_array_equal(_np(dt), _np(dj))
    # every slot holds at most one token, every token at most top_k slots
    assert _np(dt).sum(axis=0).max() <= 1 and _np(dt).sum(axis=(1, 2)).max() \
        <= top_k
    kept = _np(dt).sum()
    assert (kept < T * top_k) if factor < 1 else (kept == T * top_k)
    np.testing.assert_allclose(_np(ct), _np(cj), **F32)
    np.testing.assert_allclose(float(at), float(aj), **F32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_ffn_with_drops_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype, capacity_factor=0.75)
    pj, pt = _params(jcfg, seed=2)
    x = _x(3, 40, 16)
    dispatch = _same_routing(pj, pt, x, jcfg, tcfg)
    assert dispatch.sum() < 40 * 2    # the capacity path drops tokens
    yj, aj = _jax_moe_ffn(pj, jnp.asarray(x, jcfg.dtype), jcfg)
    yt, at = tmoe.moe_ffn(pt, torch.from_numpy(x).to(tcfg.dtype), tcfg)
    assert yt.dtype == tcfg.dtype and at.dtype == torch.float32
    if dtype == "fp32":
        np.testing.assert_allclose(_np(yt), _np(yj), **F32)
    else:
        scale = np.abs(_np(yj)).max()
        assert np.abs(_np(yt) - _np(yj)).max() <= BF16_REL * scale
    np.testing.assert_allclose(float(at), float(aj), **F32)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_equals_the_dense_spec_when_nothing_drops(top_k):
    # capacity_factor E/k: every expert can hold every token
    jcfg, tcfg = _cfgs(top_k=top_k, capacity_factor=4.0 / top_k)
    pj, pt = _params(jcfg, seed=4)
    x = _x(5, 32, 16)
    dispatch = _same_routing(pj, pt, x, jcfg, tcfg)
    assert dispatch.sum() == 32 * top_k
    xt = torch.from_numpy(x)
    yt, _ = tmoe.moe_ffn(pt, xt, tcfg)
    spec = tmoe.moe_ffn_reference(pt, xt, tcfg)
    np.testing.assert_allclose(_np(yt), _np(spec), **F32)
    np.testing.assert_allclose(
        _np(spec), _np(jmoe.moe_ffn_reference(pj, jnp.asarray(x), jcfg)),
        **F32)
    np.testing.assert_allclose(
        _np(yt), _np(_jax_moe_ffn(pj, jnp.asarray(x), jcfg)[0]), **F32)


def test_capacity_one_drops_all_but_one_token_per_expert():
    jcfg, tcfg = _cfgs(d_model=8, d_ff=16, n_experts=2, top_k=1,
                       capacity_factor=1e-9)
    assert tcfg.capacity(64) == 1
    pj, pt = _params(jcfg, seed=5)
    x = _x(6, 64, 8)
    _same_routing(pj, pt, x, jcfg, tcfg)
    yt, _ = tmoe.moe_ffn(pt, torch.from_numpy(x), tcfg)
    assert int((yt.abs() > 0).any(dim=-1).sum()) <= tcfg.n_experts
    np.testing.assert_allclose(
        _np(yt), _np(_jax_moe_ffn(pj, jnp.asarray(x), jcfg)[0]), **F32)
    load = tmoe.expert_load(pt, torch.from_numpy(x), tcfg)
    assert int(load.sum()) == 64


def test_leading_dims_flatten_into_one_call():
    jcfg, tcfg = _cfgs(d_model=8, d_ff=16, capacity_factor=1.0)
    pj, pt = _params(jcfg, seed=7)
    x = _x(8, 2, 6, 8)
    _same_routing(pj, pt, x, jcfg, tcfg)
    yt, at = tmoe.moe_ffn(pt, torch.from_numpy(x), tcfg)
    assert yt.shape == (2, 6, 8)
    flat, aflat = tmoe.moe_ffn(pt, torch.from_numpy(x.reshape(12, 8)), tcfg)
    assert torch.equal(yt.reshape(12, 8), flat) and torch.equal(at, aflat)
    np.testing.assert_allclose(
        _np(yt), _np(_jax_moe_ffn(pj, jnp.asarray(x), jcfg)[0]), **F32)


@pytest.mark.parametrize("factor", [0.75, 2.0], ids=["drops", "dropless"])
def test_gradients_match_jax_grad(factor):
    jcfg, tcfg = _cfgs(capacity_factor=factor)
    pj, pt = _params(jcfg, seed=9)
    x = _x(10, 24, 16)
    _same_routing(pj, pt, x, jcfg, tcfg)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jcfg)
        return jnp.sum(y * y) + 0.01 * aux

    gj, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pj,
                                                       jnp.asarray(x))
    leaves = {n: w.clone().requires_grad_() for n, w in pt.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_ffn(leaves, xt, tcfg)
    ((y * y).sum() + 0.01 * aux).backward()
    for name in ("wg", "w1", "w3", "w2"):
        g = leaves[name].grad
        assert g is not None and g.abs().max() > 0, name
        np.testing.assert_allclose(_np(g), _np(gj[name]), **F32,
                                   err_msg=name)
    np.testing.assert_allclose(_np(xt.grad), _np(gxj), **F32)


def test_aux_gradient_flows_through_the_router_probabilities_only():
    # the aux term alone: its gradient reaches wg (through P_e), never
    # the experts, and matches the reference's
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    pj, pt = _params(jcfg, seed=11)
    x = _x(12, 20, 16)
    gj = jax.jit(jax.grad(
        lambda p: jmoe.moe_ffn(p, jnp.asarray(x), jcfg)[1]))(pj)
    leaves = {n: w.clone().requires_grad_() for n, w in pt.items()}
    tmoe.moe_ffn(leaves, torch.from_numpy(x), tcfg)[1].backward()
    np.testing.assert_allclose(_np(leaves["wg"].grad), _np(gj["wg"]), **F32)
    for name in ("w1", "w3", "w2"):
        assert leaves[name].grad is None or not leaves[name].grad.any()


def test_expert_load_matches_reference():
    jcfg, tcfg = _cfgs(n_experts=8)
    pj, pt = _params(jcfg, seed=13)
    x = _x(14, 3, 50, 16)
    lt = tmoe.expert_load(pt, torch.from_numpy(x), tcfg)
    assert lt.dtype == torch.int32 and int(lt.sum()) == 150
    np.testing.assert_array_equal(
        lt.numpy(), np.asarray(jmoe.expert_load(pj, jnp.asarray(x), jcfg)))


def test_init_moe_params_draws_in_the_documented_order():
    _, tcfg = _cfgs("bf16", n_experts=3)
    p = tmoe.init_moe_params(tcfg, torch.Generator().manual_seed(3),
                             lead=(2,))
    gen = torch.Generator().manual_seed(3)
    want = {}
    for name, shape, fan_in in (("wg", (2, 16, 3), 16),
                                ("w1", (2, 3, 16, 32), 16),
                                ("w3", (2, 3, 16, 32), 16),
                                ("w2", (2, 3, 32, 16), 32)):
        want[name] = torch.randn(shape, generator=gen) * fan_in ** -0.5
    assert p["wg"].dtype == torch.float32 and torch.equal(p["wg"], want["wg"])
    for name in ("w1", "w3", "w2"):
        assert p[name].dtype == torch.bfloat16
        assert torch.equal(p[name], want[name].to(torch.bfloat16)), name


# -- llama-moe-tiny -----------------------------------------------------------

ATTN = ["einsum", "flash"]


def _model_cfgs(attn="einsum", dtype="fp32"):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jm.PRESETS["llama-moe-tiny"], dtype=jd,
                                attn=attn),
            dataclasses.replace(tm.PRESETS["llama-moe-tiny"], dtype=td,
                                attn=attn))


def _model_params(jcfg):
    pj = jm.init_params(jcfg, jax.random.key(0))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _tokens(seed=1, B=2, S=33):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


def _pairs(pt, pj):
    """(port tensor, reference array) for every parameter; the port's
    per-layer leaves against the reference's stacked layers."""
    pj = jax.tree.map(np.asarray, pj)
    for name in ("embed", "final_norm", "lm_head"):
        yield pt[name], pj[name]
    for i, lp in enumerate(pt["layers"]):
        for name, w in lp.items():
            yield w, pj["layers"][name][i]


_jax_forward_with_aux = jax.jit(jm.forward_with_aux, static_argnums=2)


@pytest.mark.parametrize("attn", ATTN)
def test_forward_with_aux_matches_reference(attn):
    jcfg, tcfg = _model_cfgs(attn)
    pj, pt = _model_params(jcfg)
    tok = _tokens()
    lj, aj = _jax_forward_with_aux(pj, jnp.asarray(tok, jnp.int32), jcfg)
    lt, at = tm.forward_with_aux(pt, torch.from_numpy(tok), tcfg)
    assert lt.shape == (2, 33, 256) and at.dtype == torch.float32
    assert float(at) >= 1.0 - 1e-5     # the Switch aux is >= 1
    np.testing.assert_allclose(_np(lt), _np(lj), **MODEL)
    np.testing.assert_allclose(float(at), float(aj), **MODEL)


@functools.cache
def _jax_value_and_grad(attn):
    jcfg, _ = _model_cfgs(attn)
    fn = jax.jit(jax.value_and_grad(functools.partial(jm.loss_fn, cfg=jcfg)))
    return fn(_model_params(jcfg)[0], jnp.asarray(_tokens(), jnp.int32))


@pytest.mark.parametrize("attn", ATTN)
def test_loss_and_grads_match_reference(attn):
    jcfg, tcfg = _model_cfgs(attn)
    lj, gj = _jax_value_and_grad(attn)
    pt = tm.train_params(_model_params(jcfg)[1])
    lt = tm.loss_fn(pt, torch.from_numpy(_tokens()), tcfg)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), **MODEL)
    grads = {"embed": pt["embed"].grad, "final_norm": pt["final_norm"].grad,
             "lm_head": pt["lm_head"].grad,
             "layers": [{n: w.grad for n, w in lp.items()}
                        for lp in pt["layers"]]}
    n = 0
    for got, want in _pairs(grads, gj):
        assert got is not None and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **MODEL)
        n += 1
    # embed, final_norm, lm_head; per layer two norms, wq/wk/wv/wo, wg and
    # three expert stacks
    assert n == 3 + 2 * 10


@pytest.mark.parametrize("attn", ATTN)
def test_two_adamw_steps_match_reference(attn):
    jcfg, tcfg = _model_cfgs(attn)
    tok = _tokens()
    pj, stacked = _model_params(jcfg)
    pt = tm.train_params(stacked)
    tx, step = jm.make_train_step(jcfg)
    ttx, tstep = tm.make_train_step(tcfg)
    sj, st = jax.jit(step), tx.init(pj)
    opt = ttx.init(pt)
    for _ in range(2):
        pj, st, lj = sj(pj, st, jnp.asarray(tok, jnp.int32))
        pt, opt, lt = tstep(pt, opt, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.item(), float(lj), **MODEL)
    errs = np.concatenate([np.abs(got.detach().numpy() - want).ravel()
                           for got, want in _pairs(pt, pj)])
    assert errs.max() <= PARAM_MAX and errs.mean() <= PARAM_MEAN
    assert torch.equal(stacked["layers"]["w1"][1], pt["layers"][1]["w1"])


def test_adamw_state_follows_each_parameter_dtype():
    # bf16 model: the router stays fp32 and so do its moments
    _, tcfg = _model_cfgs(dtype="bf16")
    pt = tm.train_params(tm.init_params(tcfg,
                                        torch.Generator().manual_seed(0)))
    tx, step = tm.make_train_step(tcfg)
    opt = tx.init(pt)
    before = pt["layers"][0]["wg"].clone()
    pt, opt, loss = step(pt, opt, torch.from_numpy(_tokens(2, 1, 17)))
    assert np.isfinite(loss.item())
    for lp in pt["layers"]:
        assert lp["wg"].dtype == torch.float32
        assert lp["w1"].dtype == torch.bfloat16
        for name, w in lp.items():
            state = opt.state[w]
            assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
                == w.dtype, name
    assert not torch.equal(before, pt["layers"][0]["wg"])


_jax_greedy = jax.jit(jm.greedy_decode_kv, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("attn", ATTN)
def test_greedy_decode_kv_equals_greedy_decode_and_reference(attn):
    # the shipped preset's capacity (E/k) is dropless, so the uncached
    # path's re-routing of the whole buffer routes alike
    jcfg, tcfg = _model_cfgs(attn)
    assert tcfg.moe_capacity_factor >= tcfg.moe_experts / tcfg.moe_top_k
    pj, pt = _model_params(jcfg)
    prompt = _tokens(3, 2, 8)
    kv = tm.greedy_decode_kv(pt, torch.from_numpy(prompt), 6, tcfg)
    assert torch.equal(kv, tm.greedy_decode(pt, torch.from_numpy(prompt), 6,
                                            tcfg))
    ref = _jax_greedy(pj, jnp.asarray(prompt, jnp.int32), 6, jcfg, False)
    np.testing.assert_array_equal(kv.numpy(), np.asarray(ref))


def test_quantize_int8_keeps_expert_stacks_and_router():
    jcfg, tcfg = _model_cfgs(dtype="bf16")
    pj, pt = _model_params(jcfg)
    qj = jax.tree.map(np.asarray, jm.quantize_int8(pj))
    qt = tm.quantize_int8(pt)
    for name in ("w1", "w3", "w2", "wg"):
        assert isinstance(qt["layers"][name], torch.Tensor), name
        assert qt["layers"][name] is pt["layers"][name]
        assert not isinstance(qj["layers"][name], dict)
    assert qt["layers"]["wg"].dtype == torch.float32
    assert qt["layers"]["w1"].shape == (2, 4, 64, 128)
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(qt["layers"][name]["int8"].numpy(),
                                      qj["layers"][name]["int8"])
    # the quantised MoE model runs
    with torch.inference_mode():
        logits = tm.forward(qt, torch.from_numpy(_tokens(4, 1, 9)), tcfg)
    assert torch.isfinite(logits).all()


def test_init_params_moe_draw_order_and_layout():
    _, tcfg = _model_cfgs(dtype="bf16")
    pt = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    pj = jax.tree.map(np.asarray, jm.init_params(_model_cfgs(dtype="bf16")[0],
                                                 jax.random.key(0)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        node = pt
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    # embed, wq, wk, wv, wo, the MoE stacks (wg, w1, w3, w2), lm_head
    gen = torch.Generator().manual_seed(0)
    L, d, v, E, f = 2, 64, 256, 4, 128

    def w(*shape, fan_in):
        # each [R, C] matrix of the stack in turn, row-major
        *lead, R, C = shape
        mats = [torch.randn((R, C), generator=gen) * fan_in ** -0.5
                for _ in range(math.prod(lead))]
        return torch.stack(mats).reshape(shape)

    want = {"embed": w(v, d, fan_in=d).bfloat16()}
    for name, cols in (("wq", 64), ("wk", 32), ("wv", 32)):
        want[name] = w(L, d, cols, fan_in=d).bfloat16()
    want["wo"] = w(L, 64, d, fan_in=64).bfloat16()
    want["wg"] = w(L, d, E, fan_in=d)
    want["w1"] = w(L, E, d, f, fan_in=d).bfloat16()
    want["w3"] = w(L, E, d, f, fan_in=d).bfloat16()
    want["w2"] = w(L, E, f, d, fan_in=f).bfloat16()
    want["lm_head"] = w(d, v, fan_in=d).bfloat16()
    for name, t in want.items():
        got = pt[name] if name in ("embed", "lm_head") else pt["layers"][name]
        assert torch.equal(got, t), name
