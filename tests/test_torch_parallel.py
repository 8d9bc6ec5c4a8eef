"""The port's data, tensor and expert parallelism
(tpushare_torch/workloads/parallel.py and the sharded halves of model.py,
moe.py and vit.py) against the JAX package on its 8-device CPU mesh.

The in-process tests hold the spec trees, ``compose_mesh_devices``, the
placements and the piecewise draw. The sharded computations run in one
world of 8 gloo ranks for the whole file (``run_ranks`` over
tests/torch_ranks.py:parallel_checks), on the JAX package's inputs, and
each is held against the JAX package's result on the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import model as jm
from tpushare.workloads import moe as jmoe
from tpushare.workloads import serve as jserve
from tpushare.workloads import vit as jv
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import moe as tmoe
from tpushare_torch.workloads import parallel, serve
from tpushare_torch.workloads import vit as tv
from tpushare_torch.workloads.parallel import P

import torch_ranks

torch.set_num_threads(2)

LR = 3e-4
# loss: the same fp32 math, summed over the ranks in another order
LOSS = dict(atol=1e-5, rtol=1e-4)
# parameters after one AdamW step: an element moves by about lr x g/|g|;
# where |g| is within round-off of 0 the sign is round-off's, so single
# elements may differ by up to 2 lr; the bulk agrees to round-off
PARAM_MAX = 2 * LR
PARAM_MEAN = 1e-6
# fp32 forwards: another summation order over the ranks
F32 = 1e-4
# bf16 logits (the int8 forward): bf16 rounding of the row-parallel partial
# sums and of torch's and XLA's products, a few bf16 ulps of |logit| < 4
BF16 = 0.1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_dict(pj: dict) -> dict:
    """The reference's stacked tree by the port's trainable leaf paths."""
    out = {}
    for name, w in pj.items():
        if name != "layers":
            out[name] = np.asarray(w)
    for name, w in pj["layers"].items():
        for i in range(w.shape[0]):
            out[f"layers.{i}.{name}"] = np.asarray(w[i])
    return out


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


# -- the spec trees and the mesh order ----------------------------------------

@pytest.mark.parametrize("preset", ["llama-tiny", "llama-moe-tiny",
                                    "llama-8b"])
def test_param_and_quant_specs_match_the_reference(preset):
    jspecs = jm.param_specs(jm.PRESETS[preset])
    tspecs = tm.param_specs(tm.PRESETS[preset])

    def same(a, b):
        assert isinstance(b, P) and tuple(a) == tuple(b), (a, b)

    jax.tree.map(same, jspecs, tspecs,
                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jq, tq = jm.quant_specs(jspecs), tm.quant_specs(tspecs)
    jax.tree.map(same, jq, tq,
                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert tuple(tm.batch_spec()) == tuple(jm.batch_spec())


def test_moe_and_vit_specs_match_the_reference():
    for name, spec in jmoe.moe_param_specs().items():
        assert tuple(tmoe.moe_param_specs()[name]) == tuple(spec)
    jspecs = jv.vit_param_specs(jv.PRESETS_VIT["vit-tiny"])
    tspecs = tv.vit_param_specs(tv.PRESETS_VIT["vit-tiny"])
    jax.tree.map(lambda a, b: tuple(a) == tuple(b) or pytest.fail(name),
                 jspecs, tspecs,
                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert tspecs["layers"]["wo"] == P(None, "tp", None)


# the inputs of tests/test_topo_properties.py:316-350
COMPOSE = [(list("abcdefgh"), "2x4", (1, 4, 2)),
           (list("abcd"), "2x2", (1, 2, 2)),
           (list("abcd"), "2x2", (1, 4)),
           (list("abcd"), None, (1, 4)),
           (list("abcd"), "3x3", (1, 2, 2)),
           (list("abcdefgh"), "1x8", (1, 4, 2)),
           (list("abcdefgh"), "4x2", (1, 8)),
           (list("abcdefgh"), "2x2x2", (1, 2, 2, 2)),
           (list("abcdefgh"), "bogus", (1, 8)),
           (list("abc"), "2x2", (1, 4))]


@pytest.mark.parametrize("devices,box,shape", COMPOSE)
def test_compose_mesh_devices_matches_the_reference(devices, box, shape):
    assert serve.compose_mesh_devices(devices, box, shape) == \
        jserve.compose_mesh_devices(devices, box, shape)


def test_tp_layout_gives_moe_presets_an_ep_axis():
    # the reference's rule: ep is the largest divisor of tp that divides
    # the experts, the rest stays tp
    assert serve.tp_layout(tm.PRESETS["llama-tiny"], 4) == (
        (1, 4), ("dp", "tp"))
    assert serve.tp_layout(tm.PRESETS["llama-moe-tiny"], 8) == (
        (1, 2, 4), ("dp", "tp", "ep"))
    assert serve.tp_layout(tm.PRESETS["llama-moe-tiny"], 6) == (
        (1, 3, 2), ("dp", "tp", "ep"))


# -- placements, ranks and the piecewise draw ---------------------------------

class _Mesh:
    """What the spec helpers read of a DeviceMesh, at given coordinates."""

    def __init__(self, names, shape, coords):
        self.mesh_dim_names = names
        self._shape, self._coords = shape, coords

    def size(self, i):
        return self._shape[i]

    def get_local_rank(self, name):
        return self._coords[self.mesh_dim_names.index(name)]


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(("dp", "tp", "ep"), (1, 2, 2), (0, 1, 1))
    assert parallel.placements(P(None, "ep", None), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert parallel.placements(P("dp", "tp"), mesh) == [
        Shard(0), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="lacks"):
        parallel.placements(P("sp"), mesh)
    t = torch.arange(24).reshape(2, 3, 4)
    assert torch.equal(parallel.local_shard(t, P(None, None, "tp"), mesh),
                       t[:, :, 2:])
    with pytest.raises(ValueError, match="does not divide"):
        parallel.local_shard(t, P(None, "tp", None), mesh)
    assert repr(P(None, "tp")) == "P(None, 'tp')"


def test_transport_rule(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert parallel.transport("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert parallel.transport("cuda", 4) == "nccl"
    # ranks that share a card: NCCL refuses them
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.transport("cuda", 4) == "gloo"
    assert parallel.most_square(8) == (2, 4)
    assert parallel.most_square(7) == (1, 7)


def test_transport_rule_counts_one_hosts_ranks(monkeypatch):
    # a gang of 2 hosts x 4 cards: world 8, 4 ranks on each host, a card
    # each, so NCCL; the world alone against the host's 4 cards would
    # have picked gloo
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert parallel.transport("cuda", 8, local_world=4) == "nccl"
    assert parallel.transport("cuda", 8) == "gloo"
    # torchrun's count of the ranks on this host
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert parallel.transport("cuda", 8) == "nccl"
    # two members sharing one host's 4 cards with 4 ranks each: gloo
    assert parallel.transport("cuda", 8, local_world=8) == "gloo"
    # each host's ranks take its cards in order
    assert [parallel.rank_device("cuda", r, 4).index
            for r in range(8)] == [0, 1, 2, 3, 0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.rank_device("cuda", 5, 8) == torch.device("cuda", 0)
    assert parallel.rank_device("cpu", 5) == torch.device("cpu")


DRAWS = [((3, 8, 12), P(None, None, "tp"), True),     # column-parallel
         ((3, 12, 8), P(None, "tp", None), True),     # row-parallel
         ((2, 4, 6, 5), P(None, "ep", None, None), False),
         ((6, 10), P(None, "tp"), True),               # lm_head
         ((6, 10), None, False)]


@pytest.mark.parametrize("shape,spec,quant", DRAWS)
@pytest.mark.parametrize("rows", [1, 5, 1000])
def test_draw_keeps_the_shard_of_one_draw(shape, spec, quant, rows,
                                          monkeypatch):
    # with pieces of one row, of a few rows and of whole matrices, every
    # rank's shard is its slice of the one-card draw of the same seed, and
    # its amax the whole weight's per-output-channel maximum
    monkeypatch.setattr(parallel, "DRAW_CHUNK", rows * shape[-1])
    want, _ = parallel.draw(shape, torch.Generator().manual_seed(3), 0.5,
                            torch.bfloat16)
    full = want.float().abs().amax(dim=-2, keepdim=True)
    _, whole = parallel.draw(shape, torch.Generator().manual_seed(3), 0.5,
                             torch.bfloat16, amax=True)
    assert torch.equal(whole, full)
    for tp, ep in ((0, 0), (0, 1), (1, 0), (1, 1)):
        mesh = _Mesh(("dp", "tp", "ep"), (1, 2, 2), (0, tp, ep))
        own, amax = parallel.draw(shape, torch.Generator().manual_seed(3),
                                  0.5, torch.bfloat16, spec,
                                  mesh if spec else None, amax=quant)
        if spec is not None:
            assert torch.equal(own, parallel.local_shard(want, spec, mesh))
        else:
            assert torch.equal(own, want)
        if quant:
            want_amax = full
            if spec is not None:
                want_amax = parallel.local_shard(
                    full, P(*spec[:-2], None, spec[-1]), mesh)
            assert torch.equal(amax, want_amax)
        else:
            assert amax is None


def test_draw_is_fixed_pieces(monkeypatch):
    # a [L, R, C] draw is L consecutive [R, C] draws from one generator
    gen = torch.Generator().manual_seed(5)
    got, _ = parallel.draw((3, 8, 6), gen, 0.25, torch.bfloat16)
    ref = torch.Generator().manual_seed(5)
    want = torch.stack([(torch.randn((8, 6), generator=ref) * 0.25)
                        .to(torch.bfloat16) for _ in range(3)])
    assert torch.equal(got, want)
    assert torch.equal(torch.randn(4, generator=gen),
                       torch.randn(4, generator=ref))
    # a matrix over DRAW_CHUNK is its blocks of DRAW_CHUNK // C whole rows,
    # drawn in order, the last one short
    monkeypatch.setattr(parallel, "DRAW_CHUNK", 3 * 6 + 2)
    got, _ = parallel.draw((8, 6), torch.Generator().manual_seed(6), 1.0,
                           torch.float32)
    ref = torch.Generator().manual_seed(6)
    want = torch.cat([torch.randn((n, 6), generator=ref) for n in (3, 3, 2)])
    assert torch.equal(got, want)
    # wider than a piece: one row a block
    monkeypatch.setattr(parallel, "DRAW_CHUNK", 4)
    got, _ = parallel.draw((2, 6), torch.Generator().manual_seed(7), 1.0,
                           torch.float32)
    ref = torch.Generator().manual_seed(7)
    want = torch.cat([torch.randn((1, 6), generator=ref) for _ in range(2)])
    assert torch.equal(got, want)


def test_quantized_shard_equals_the_shard_of_the_quantized_weight():
    # a row-parallel weight's scale reduces over the sharded dim: its
    # shard is quantized with the whole weight's maximum
    mesh = _Mesh(("dp", "tp"), (1, 2), (0, 1))
    gen = torch.Generator().manual_seed(4)
    spec = P(None, "tp", None)
    own, amax = parallel.draw((2, 8, 6), gen, 0.3, torch.bfloat16, spec,
                              mesh, amax=True)
    got = tm._q_with(own, amax)
    whole, _ = parallel.draw((2, 8, 6), torch.Generator().manual_seed(4),
                             0.3, torch.bfloat16)
    want = tm.quantize_int8({"embed": whole, "final_norm": whole,
                             "lm_head": whole[0], "layers": {"wo": whole}})
    want = want["layers"]["wo"]
    assert torch.equal(got["int8"],
                       parallel.local_shard(want["int8"], spec, mesh))
    assert torch.equal(got["scale"], want["scale"])


def test_init_params_without_a_generator_allocates_the_same_tree():
    cfg = tm.PRESETS["llama-moe-tiny"]
    drawn = tm.init_params(cfg, torch.Generator().manual_seed(0))
    empty = tm.init_params(cfg, None, device="cpu")
    parallel.tree_map(
        lambda a, b: (a.shape == b.shape and a.dtype == b.dtype)
        or pytest.fail("tree differs"), drawn, empty)


# -- the sharded computations against the JAX package -------------------------

@pytest.fixture(scope="module")
def world():
    """One world of 8 gloo ranks for the file, on the JAX package's inputs;
    returns (each rank's results, the JAX package's numbers)."""
    ref, data = {}, {}

    # dp x tp llama-tiny fp32, one step on the global batch
    jcfg = dataclasses.replace(jm.PRESETS["llama-tiny"], dtype=jnp.float32)
    pj = jm.init_params(jcfg, jax.random.key(0))
    tokens = _tokens((8, 16), 5)
    tx, step = jm.make_train_step(jcfg)
    p2, _, loss = jax.jit(step)(pj, tx.init(pj), jnp.asarray(tokens))
    data["dense"] = {"params": _np(pj), "tokens": tokens,
                     "updated": _leaf_dict(_np(p2))}
    ref["dense_loss"] = float(loss)

    # the int8 forward of the bf16 preset (tests/test_workloads.py:106)
    j16 = jm.PRESETS["llama-tiny"]
    p16 = jm.init_params(j16, jax.random.key(0))
    z = np.zeros((1, 8), np.int64)
    logits = jm.forward(jm.quantize_int8(p16), jnp.asarray(z), j16)
    data["int8"] = {"params": _np(p16), "tokens": z,
                    "logits": np.asarray(logits, np.float32)}

    # moe_ffn with the experts over "ep" and the tokens over "dp"
    mcfg = jmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4, top_k=2,
                          capacity_factor=4.0, dtype=jnp.float32)
    mp = jmoe.init_moe_params(mcfg, jax.random.key(7))
    x = np.random.default_rng(8).standard_normal((64, 16), np.float32)
    y, aux = jmoe.moe_ffn(mp, jnp.asarray(x), mcfg)
    data["moe_ffn"] = {"params": _np(mp), "x": x, "y": np.asarray(y)}
    ref["moe_aux"] = float(aux)

    # llama-moe-tiny on dp x tp x ep at capacity factor 1.0: tokens drop,
    # and the slots are the global batch's
    ecfg = dataclasses.replace(jm.PRESETS["llama-moe-tiny"],
                               dtype=jnp.float32, moe_capacity_factor=1.0)
    pe = jm.init_params(ecfg, jax.random.key(0))
    etokens = _tokens((4, 16), 9)
    etx, estep = jm.make_train_step(ecfg)
    pe2, _, eloss = jax.jit(estep)(pe, etx.init(pe), jnp.asarray(etokens))
    data["moe_step"] = {"params": _np(pe), "tokens": etokens,
                        "updated": _leaf_dict(_np(pe2)),
                        "capacity_factor": 1.0}
    ref["moe_loss"] = float(eloss)

    # the ViT forward
    vcfg = dataclasses.replace(jv.PRESETS_VIT["vit-tiny"], dtype=jnp.float32)
    pv = jv.init_vit_params(vcfg, jax.random.key(0))
    images = np.random.default_rng(6).standard_normal((4, 32, 32, 3),
                                                      np.float32)
    vl = jv.vit_forward(pv, jnp.asarray(images), vcfg)
    data["vit"] = {"params": _np(pv), "images": images,
                   "logits": np.asarray(vl)}

    ranks = parallel.run_ranks(torch_ranks.parallel_checks, 8, data,
                               timeout=300)
    return ranks, ref


def test_dp_tp_train_step_matches_the_reference(world):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r["dense"]["loss"], ref["dense_loss"],
                                   **LOSS)
        assert r["dense"]["max"] <= PARAM_MAX
        assert r["dense"]["mean"] <= PARAM_MEAN
        # the parameters keep their tp placement through the update
        assert r["dense"]["wq"] == (None, "tp")


def test_sharded_int8_forward_matches_the_reference(world):
    # tp=8 over llama-tiny's 4 heads: each head's columns split over two
    # ranks, which gather wq, wk and wv and keep their own columns
    ranks, _ = world
    for r in ranks:
        assert r["int8"]["finite"]
        assert r["int8"]["max"] <= BF16
        # int8 weights and their scales shard together (quant_specs)
        assert r["int8"]["scale_wq"] == (None, None, "tp")
        assert r["int8"]["scale_wo"] == (None, None, None)


def test_ep_moe_ffn_matches_the_unsharded_call(world):
    ranks, ref = world
    for r in ranks:
        assert r["moe_ffn"]["y"] <= F32
        np.testing.assert_allclose(r["moe_ffn"]["aux"], ref["moe_aux"],
                                   rtol=1e-5)
        assert r["moe_ffn"]["w1"] == ("ep", None, None)


def test_ep_moe_train_step_matches_the_reference(world):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r["moe_step"]["loss"], ref["moe_loss"],
                                   **LOSS)
        assert r["moe_step"]["max"] <= PARAM_MAX
        assert r["moe_step"]["mean"] <= PARAM_MEAN
        assert r["moe_step"]["w1"] == ("ep", None, None)


def test_vit_dp_tp_forward_matches_the_reference(world):
    ranks, _ = world
    for r in ranks:
        assert r["vit"]["max"] <= F32


def test_init_params_on_a_mesh_keeps_the_shards_of_one_draw(world):
    ranks, _ = world
    for r in ranks:
        assert r["init_int8=False"] and r["init_int8=True"]


def _tp_peer(rank, step):
    """The global rank ``step`` places along "tp" from ``rank`` on the
    (2, 4) mesh (rows of 4 ranks)."""
    return rank // 4 * 4 + (rank % 4 + step) % 4


@pytest.mark.parametrize("perm", ["ring", "chain"])
def test_ppermute_and_its_backward_match_numpy(world, perm):
    ranks, _ = world
    for r, res in enumerate(ranks):
        y, grad = res["p2p"][perm]
        tp = r % 4
        src, dst = _tp_peer(r, -1), _tp_peer(r, 1)
        want_y = (np.arange(6.0) + 100 * src).reshape(2, 3)
        want_g = np.full((2, 3), dst + 1.0)
        if perm == "chain":
            # no source for the first, no target for the last
            want_y = want_y if tp > 0 else np.zeros((2, 3))
            want_g = want_g if tp < 3 else np.zeros((2, 3))
        np.testing.assert_array_equal(y, want_y)
        np.testing.assert_array_equal(grad, want_g)


def test_all_to_all_and_its_backward_match_numpy(world):
    ranks, _ = world
    for r, res in enumerate(ranks):
        got, grad = res["p2p"]["all_to_all"]
        tp, row = r % 4, r // 4 * 4
        a = {s: np.arange(48.0).reshape(2, 8, 3) + 1000 * (row + s)
             for s in range(4)}
        # tile tp of each source rank along dim 1, concatenated on dim 2
        want = np.concatenate([a[s][:, 2 * tp:2 * tp + 2] for s in range(4)],
                              axis=2)
        np.testing.assert_array_equal(got, want)
        # the backward: the inverse all-to-all of each rank's cotangent
        cot = {t: np.arange(48.0).reshape(2, 2, 12) * (row + t + 1)
               for t in range(4)}
        want_g = np.concatenate([cot[t][:, :, 3 * tp:3 * tp + 3]
                                 for t in range(4)], axis=1)
        np.testing.assert_array_equal(grad, want_g)
