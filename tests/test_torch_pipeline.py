"""The port's GPipe pipeline (tpushare_torch/workloads/pipeline.py) against
the JAX package's (tpushare/workloads/pipeline.py) on the CPU.

The counterparts of tests/test_pipeline.py: dense parity at 2 and 4
stages (more microbatches than stages at 4), MoE while routing is
dropless, the gradients against the JAX package's sequential ones, the
pipelined train step's losses against the JAX package's, and the
refusals. The JAX package's weights (fp32 where the point is parity)
go to the port with ``params_from_numpy``; the port runs in one world of
4 gloo ranks for the file (tests/torch_ranks.py:pipeline_checks; 2 stages
are the (2, 2) mesh's "pp" axis, 4 the whole world).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpushare.workloads import model as jm
from tpushare.workloads import pipeline as jpp
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import parallel
from tpushare_torch.workloads import pipeline as tpp
from tpushare_torch.workloads.convert import params_from_numpy
from tpushare_torch.workloads.parallel import P

import torch_ranks

torch.set_num_threads(2)

# fp32 logits, losses and aux: the same math in another summation order
# (the microbatches' products have other shapes than the whole batch's)
F32 = dict(atol=1e-5, rtol=1e-4)
# fp32 gradients: summed over the microbatches in another order
GRAD = dict(atol=1e-6, rtol=1e-4)
# bf16 pipelined logits against the port's own sequential forward: the
# same layers on fewer rows a product (tests/test_pipeline.py:37)
BF16 = dict(atol=1e-4, rtol=1e-4)
LR = 1e-2
# parameters after three AdamW steps at lr 1e-2: an element moves by
# about lr a step whatever its gradient's size, so one whose gradient is
# within round-off of 0 may turn the other way (2 lr a step); the bulk
# agrees to round-off
PARAM_MAX = 6 * LR
PARAM_MEAN = 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("pp",))


def _tokens(batch, seq=12, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq))


def _cfg(preset, dtype=jnp.float32, **kw):
    return dataclasses.replace(jm.PRESETS[preset], dtype=dtype, **kw)


FORWARD = [
    # name, preset, stages, batch, microbatches, n_layers, seed
    ("two_stages", "llama-tiny", 2, 4, None, None, 3),
    ("four_stages_more_microbatches", "llama-tiny", 4, 8, 8, 4, 5),
    ("moe_dropless", "llama-moe-tiny", 2, 4, None, None, 7),
]


@pytest.fixture(scope="module")
def world():
    cases, ref = [], {}
    for name, preset, n, batch, M, layers, seed in FORWARD:
        extra = {"n_layers": layers} if layers else {}
        cfg = _cfg(preset, **extra)
        params = jm.init_params(cfg, jax.random.key(seed))
        tokens = _tokens(batch, seed=seed)
        logits, aux = jpp.pipelined_forward_with_aux(
            params, jnp.asarray(tokens), cfg, _jmesh(n), M)
        want, _ = jm.forward_with_aux(params, jnp.asarray(tokens), cfg)
        ref[name] = {"logits": np.asarray(logits), "aux": float(aux),
                     "sequential": np.asarray(want)}
        cases.append({"name": name, "kind": "forward", "preset": preset,
                      "dtype": "fp32", "n": n, "params": _np(params),
                      "tokens": tokens, "microbatches": M, "cfg": extra})
    # bf16 (the preset's dtype) against the port's own sequential forward
    cfg16 = jm.PRESETS["llama-tiny"]
    p16 = _np(jm.init_params(cfg16, jax.random.key(11)))
    cases.append({"name": "bf16", "kind": "forward", "preset": "llama-tiny",
                  "dtype": "bf16", "n": 2, "params": p16,
                  "tokens": _tokens(4, seed=11)})
    ref["bf16"] = {"params": p16, "tokens": _tokens(4, seed=11)}
    # gradients of the next-token loss against the sequential ones
    cfg = _cfg("llama-tiny")
    params = jm.init_params(cfg, jax.random.key(0))
    tokens = _tokens(4, seed=7)
    loss, grads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jnp.asarray(tokens), cfg))(params)
    ref["grad"] = {"loss": float(loss), "grads": _leaf_dict(_np(grads))}
    cases.append({"name": "grad", "kind": "grad", "preset": "llama-tiny",
                  "dtype": "fp32", "n": 2, "params": _np(params),
                  "tokens": tokens})
    # the pipelined train step, three steps at lr 1e-2
    tokens = _tokens(4, seed=9)
    tx, step = jpp.make_pipelined_train_step(cfg, _jmesh(2),
                                             learning_rate=LR)
    jp, opt, losses = params, tx.init(params), []
    step = jax.jit(step)
    for _ in range(3):
        jp, opt, loss = step(jp, opt, jnp.asarray(tokens))
        losses.append(float(loss))
    ref["train"] = {"losses": losses, "params": _leaf_dict(_np(jp))}
    cases.append({"name": "train", "kind": "train", "preset": "llama-tiny",
                  "dtype": "fp32", "n": 2, "params": _np(params),
                  "tokens": tokens, "lr": LR, "steps": 3})
    ranks = parallel.run_ranks(torch_ranks.pipeline_checks, 4,
                               {"cases": cases}, timeout=300)
    return ranks, ref


def _leaf_dict(pj: dict) -> dict:
    """The reference's stacked tree by the port's trainable leaf paths."""
    out = {name: np.asarray(w) for name, w in pj.items() if name != "layers"}
    for name, w in pj["layers"].items():
        for i in range(w.shape[0]):
            out[f"layers.{i}.{name}"] = np.asarray(w[i])
    return out


def _stage(rank, n):
    """The "pp" coordinate of ``rank`` in the test world's meshes."""
    return rank % n


@pytest.mark.parametrize("case", FORWARD, ids=[c[0] for c in FORWARD])
def test_forward_matches_the_reference(world, case):
    ranks, ref = world
    name = case[0]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["logits"], ref[name]["logits"], **F32)
        np.testing.assert_allclose(got["logits"], ref[name]["sequential"],
                                   **F32)
        np.testing.assert_allclose(got["aux"], ref[name]["aux"], **F32)
        if case[1] == "llama-moe-tiny":
            # the aux is a mean of per-microbatch load-balance terms
            assert got["aux"] > 0
        else:
            assert got["aux"] == 0


def test_bf16_pipeline_matches_the_sequential_forward(world):
    ranks, ref = world
    cfg = tm.PRESETS["llama-tiny"]
    params = params_from_numpy(ref["bf16"]["params"])
    with torch.no_grad():
        want = tm.forward(params, torch.as_tensor(ref["bf16"]["tokens"]),
                          cfg).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["bf16"]["logits"], want, **BF16)


def test_gradients_match_sequential(world):
    ranks, ref = world
    want = ref["grad"]["grads"]
    for rank, r in enumerate(ranks):
        got = r["grad"]
        np.testing.assert_allclose(got["loss"], ref["grad"]["loss"], **F32)
        stage = _stage(rank, 2)
        # a rank holds the gradients of its stage's layers and of the
        # leaves every rank uses, the embedding's summed over "pp"
        assert set(got["grads"]) == {
            "embed", "final_norm", "lm_head",
            *(n for n in want if n.startswith(f"layers.{stage}."))}
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, want[name], err_msg=name, **GRAD)


def test_pipelined_train_step_matches_the_reference(world):
    ranks, ref = world
    want = ref["train"]
    for rank, r in enumerate(ranks):
        got = r["train"]
        np.testing.assert_allclose(got["losses"], want["losses"], **F32)
        assert got["losses"][-1] < got["losses"][0]
        stage = got["stage"]
        assert stage == _stage(rank, 2)
        # a stage's tree: its own layer, renumbered from 0
        for name, w in got["params"].items():
            ref_name = name
            if name.startswith("layers."):
                _, i, leaf = name.split(".")
                ref_name = f"layers.{stage + int(i)}.{leaf}"
            d = np.abs(w - want["params"][ref_name])
            assert d.max() <= PARAM_MAX and d.mean() <= PARAM_MEAN, (
                name, d.max(), d.mean())


class _Mesh:
    """What the pipeline reads of a DeviceMesh: a "pp" axis of n ranks."""

    def __init__(self, n, rank=0):
        self.mesh_dim_names, self.n, self.rank = ("pp",), n, rank

    def size(self, i=0):
        return self.n

    def get_local_rank(self, name):
        return self.rank


def test_rejects_indivisible_layers_and_batch():
    cfg = tm.PRESETS["llama-tiny"]      # 2 layers
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="layers"):
        tpp.pipelined_forward(params, torch.as_tensor(_tokens(4)), cfg,
                              _Mesh(3))    # 2 % 3
    with pytest.raises(ValueError, match="microbatches"):
        tpp.pipelined_forward(params, torch.as_tensor(_tokens(3)), cfg,
                              _Mesh(2))    # batch 3 % 2 microbatches


def test_stage_specs_and_a_stages_tree():
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"], n_layers=4)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = jm.init_params(_cfg("llama-tiny", n_layers=4),
                             jax.random.key(0))
    specs = tpp.stage_layer_specs(params)
    jspecs = jpp.stage_layer_specs(jparams)
    assert set(specs) == set(jspecs)
    for name, spec in specs.items():
        # the layer axis over "pp", every other dim replicated
        assert tuple(jspecs[name]) == ("pp",)
        assert spec == P("pp", *([None] * (params["layers"][name].dim()
                                           - 1)))
    stage = tpp.stage_params(params, cfg, _Mesh(2, rank=1))
    for name, w in stage["layers"].items():
        assert torch.equal(w, params["layers"][name][2:4])
    assert stage["embed"] is params["embed"]
    with pytest.raises(ValueError, match="neither"):
        tpp._stage_layers(stage, cfg, _Mesh(4), "pp")
