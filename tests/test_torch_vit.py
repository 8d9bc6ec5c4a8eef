"""The port's ViT (tpushare_torch/workloads/vit.py) against the JAX
reference (tpushare/workloads/vit.py) on the CPU, at vit-tiny size.

Weights come from the reference's ``init_vit_params`` and are carried
across with ``params_from_numpy``; images and labels are numpy-seeded.
With ``attn="flash"`` the reference runs its Pallas kernel in interpret
mode (and, under a gradient, its fp32 blockwise backward) and the port
the kernels' plain versions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import vit as jv
from tpushare_torch.workloads import attention as ta
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import vit as tv
from tpushare_torch.workloads.convert import params_from_numpy

torch.set_num_threads(2)
# The first attention a process computes with torch's CPU kernels has been
# seen to come out about 1e-4 off (in roughly one fresh process of 70,
# the same wrong bits each time), with every later call exact to fp32.
# One small call at import keeps that first call out of the comparisons.
ta.flash_attention_plain(*torch.zeros(3, 1, 1, 8, 16).unbind(0))

ATTN = ["einsum", "flash"]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32 logits: the same fp32 math in another summation order
F32 = dict(atol=1e-4, rtol=1e-4)
# bf16 logits: the frameworks round the activations (matmul outputs,
# GELU, residual adds) at different places; over 2 layers that moves
# logits of magnitude ~1 by a bf16 ulp or two (2**-7..2**-6)
BF16 = dict(atol=5e-2, rtol=2e-2)
# loss after a step: the same fp32 math in another summation order
GRAD = dict(atol=1e-5, rtol=1e-4)
# parameters after AdamW steps, as tests/test_torch_train.py holds the
# llama trainer: single elements whose gradient is within round-off of 0
# may step by a fraction of the learning rate the other way; the bulk
# must agree to round-off, which the mean bounds
PARAM_MAX = 1e-4
PARAM_MEAN = 1e-7


def _cfgs(dtype="fp32", attn="einsum"):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jv.PRESETS_VIT["vit-tiny"], dtype=jd,
                                attn=attn),
            dataclasses.replace(tv.PRESETS_VIT["vit-tiny"], dtype=td,
                                attn=attn))


@functools.cache
def _jax_params(dtype):
    return jv.init_vit_params(_cfgs(dtype)[0], jax.random.key(0))


def _port_params(dtype):
    return params_from_numpy(jax.tree.map(np.asarray, _jax_params(dtype)))


def _images(B=2):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((B, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, (B,)))


def test_presets_match_reference():
    assert set(tv.PRESETS_VIT) == set(jv.PRESETS_VIT)
    for name, jcfg in jv.PRESETS_VIT.items():
        tcfg = tv.PRESETS_VIT[name]
        jf = {k: v for k, v in dataclasses.asdict(jcfg).items()
              if k != "dtype"}
        tf = {k: v for k, v in dataclasses.asdict(tcfg).items()
              if k != "dtype"}
        assert tf == jf
        assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        assert (tcfg.seq, tcfg.head_dim, tcfg.n_patches) == \
            (jcfg.seq, jcfg.head_dim, jcfg.n_patches)
    b16 = tv.PRESETS_VIT["vit-b16"]
    assert (b16.seq, b16.head_dim, b16.n_heads) == (197, 64, 12)


def test_patchify_is_exact():
    images, _ = _images()
    cfg = tv.PRESETS_VIT["vit-tiny"]
    got = tv.patchify(torch.from_numpy(images), cfg)
    want = np.asarray(jv.patchify(jnp.asarray(images),
                                  jv.PRESETS_VIT["vit-tiny"]))
    assert got.shape == (2, 16, 192)
    np.testing.assert_array_equal(got.numpy(), want)


def test_params_carry_across_bitwise():
    pj = jax.tree.map(np.asarray, _jax_params("bf16"))
    pt = _port_params("bf16")
    assert pt["patch_embed"].dtype == torch.bfloat16
    assert pt["pos_embed"].dtype == torch.float32
    for name in ("patch_embed", "pos_embed", "cls_token", "head"):
        np.testing.assert_array_equal(pt[name].float().numpy(),
                                      pj[name].astype(np.float32))
    assert set(pt["layers"]) == set(pj["layers"])
    for name in pj["layers"]:
        np.testing.assert_array_equal(pt["layers"][name].float().numpy(),
                                      pj["layers"][name].astype(np.float32))


def test_init_matches_reference_layout():
    _, tcfg = _cfgs("bf16")
    pt = tv.init_vit_params(tcfg, torch.Generator().manual_seed(0))
    pj = jax.tree.map(np.asarray, _jax_params("bf16"))
    flat_t = dict(_flat(pt))
    flat_j = dict(_flat(pj))
    assert set(flat_t) == set(flat_j)
    for name, a in flat_j.items():
        t = flat_t[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix, tree


FORWARD = [(d, a) for d in ("fp32", "bf16") for a in ATTN]


@pytest.mark.parametrize("dtype,attn", FORWARD,
                         ids=[f"{d}-{a}" for d, a in FORWARD])
def test_logits_match_reference(dtype, attn):
    jcfg, tcfg = _cfgs(dtype, attn)
    images, _ = _images()
    lj = jax.jit(lambda p, x: jv.vit_forward(p, x, jcfg))(
        _jax_params(dtype), jnp.asarray(images))
    with torch.no_grad():
        lt = tv.vit_forward(_port_params(dtype), torch.from_numpy(images),
                            tcfg)
    assert lt.shape == (2, 10) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               **(F32 if dtype == "fp32" else BF16))


def _pairs(pt, pj):
    """(port tensor, reference array) for every parameter; the port's
    per-layer leaves against the reference's stacked layers."""
    pj = jax.tree.map(np.asarray, pj)
    for name, w in pt.items():
        if name != "layers":
            yield w, pj[name]
    for i, lp in enumerate(pt["layers"]):
        for name, w in lp.items():
            yield w, pj["layers"][name][i]


@pytest.mark.parametrize("attn", ATTN)
def test_two_adamw_steps_match_reference(attn):
    jcfg, tcfg = _cfgs("fp32", attn)
    images, labels = _images()
    pj = _jax_params("fp32")
    stacked = _port_params("fp32")
    pt = tm.train_params(stacked)
    tx, step = jv.make_vit_train_step(jcfg)
    ttx, tstep = tv.make_vit_train_step(tcfg)
    sj, st = jax.jit(step), tx.init(pj)
    opt = ttx.init(pt)
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8
    assert group["betas"] == (0.9, 0.999) and group["lr"] == 1e-3
    x_j, y_j = jnp.asarray(images), jnp.asarray(labels, jnp.int32)
    x_t, y_t = torch.from_numpy(images), torch.from_numpy(labels)
    for _ in range(2):
        pj, st, lj = sj(pj, st, x_j, y_j)
        pt, opt, lt = tstep(pt, opt, x_t, y_t)
        np.testing.assert_allclose(lt.item(), float(lj), **GRAD)
        errs = np.concatenate([np.abs(got.detach().numpy() - want).ravel()
                               for got, want in _pairs(pt, pj)])
        assert errs.max() <= PARAM_MAX and errs.mean() <= PARAM_MEAN
    # the steps landed in the stacked tree; gradients are freed
    assert torch.equal(stacked["layers"]["w1"][1], pt["layers"][1]["w1"])
    assert all(w.grad is None for w in tm.param_leaves(pt))


def test_train_params_are_views_with_gradients():
    _, tcfg = _cfgs("bf16")
    stacked = tv.init_vit_params(tcfg, torch.Generator().manual_seed(0))
    pt = tm.train_params(stacked)
    leaves = tm.param_leaves(pt)
    assert len(leaves) == 6 + tcfg.n_layers * len(stacked["layers"])
    assert list(pt) == list(stacked)
    assert all(w.is_leaf and w.requires_grad for w in leaves)
    w2 = pt["layers"][1]["w2"]
    assert w2.untyped_storage().data_ptr() == \
        stacked["layers"]["w2"].untyped_storage().data_ptr()
    assert not stacked["layers"]["w2"].requires_grad
    # the family-agnostic AdamW takes the tree as it is
    opt = tm.AdamW(1e-3).init(pt)
    assert len(opt.param_groups[0]["params"]) == len(leaves)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert np.abs(exact.numpy() - want).max() > 1e-4
