"""The port's ring attention (tpushare_torch/workloads/ringattention.py)
against the JAX package's (tpushare/workloads/ringattention.py) on the CPU.

The counterparts of tests/test_ringattention.py: causal and non-causal,
fp32 at a tight tolerance, a smaller ring, zigzag (round trip, causal,
non-causal, small ring), GQA with the small kv heads on the ring, and the
three refusals. The same numpy inputs go through the JAX package's
``ring_attention`` on its CPU mesh and through the port's over one world of
4 gloo ranks for the file (tests/torch_ranks.py:ring_checks; a ring of 2 is
the (2, 2) mesh's "sp" axis). Besides: the card's route (each visiting
chunk through the flash forward, merged by LSE) run with the plain K1 in
its place, against the fold, with its calls counted; gradients through
the fold against ``jax.grad``; and gradients through the card's route
(the plain K1, K2 and K3 in place of the kernels) against ``jax.grad``,
causal, zigzag and non-causal, with the kernel calls and the ring's hops
of every rank counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpushare.workloads import ringattention as jra
from tpushare.workloads.attention import attention_reference
from tpushare_torch.workloads import parallel
from tpushare_torch.workloads import ringattention as ra

import torch_ranks

torch.set_num_threads(2)

# bf16: the reference tests' tolerance (tests/test_ringattention.py:35)
BF16 = dict(atol=2e-2, rtol=2e-2)
# fp32: the same online-softmax math summed in another order
F32 = dict(atol=1e-5, rtol=1e-5)
# the card's route against the fold in fp32: K1's 64-key blocks and the
# LSE merge sum the same terms in another order
ROUTE_F32 = dict(atol=1e-5, rtol=1e-5)
# in bf16 the route rounds each chunk's output to bf16 before the fp32
# merge, where the fold keeps one fp32 accumulator: an output ulp
# (2**-8 of |out| <= 4) per merged chunk
ROUTE_BF16 = dict(atol=2e-2, rtol=2e-2)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _qkv(seed, B=2, H=4, S=256, D=64, Hkv=None):
    return (_randn(seed, B, H, S, D), _randn(seed + 1, B, Hkv or H, S, D),
            _randn(seed + 2, B, Hkv or H, S, D))


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}

# name, seed, shape (B, H, S, D, Hkv), dtype, causal, zigzag, ring size
CASES = [
    ("causal", 0, (2, 4, 256, 64, None), "bf16", True, False, 4),
    ("non_causal", 3, (2, 4, 128, 64, None), "bf16", False, False, 4),
    ("fp32", 6, (2, 4, 64, 64, None), "fp32", True, False, 4),
    ("small_ring", 9, (2, 4, 96, 64, None), "bf16", True, False, 2),
    ("zigzag_causal", 12, (2, 2, 64, 16, None), "bf16", True, True, 4),
    ("zigzag_non_causal", 15, (1, 2, 48, 8, None), "bf16", False, True, 4),
    ("zigzag_small_ring", 18, (2, 3, 40, 8, None), "bf16", True, True, 2),
    ("gqa_causal", 21, (2, 8, 128, 16, 2), "fp32", True, False, 4),
    ("gqa_non_causal", 21, (2, 8, 128, 16, 2), "fp32", False, False, 4),
    ("gqa_zigzag", 21, (2, 8, 128, 16, 2), "fp32", True, True, 4),
]

# the card's route with the plain K1 against the fold:
# name, seed, shape, dtype, causal, zigzag
ROUTE = [
    ("route_causal", 30, (1, 8, 128, 16, 2), "fp32", True, False),
    ("route_zigzag", 33, (1, 8, 128, 16, 2), "fp32", True, True),
    ("route_non_causal", 36, (1, 8, 128, 16, 2), "fp32", False, False),
    ("route_zigzag_non_causal", 39, (1, 8, 128, 16, 2), "fp32", False,
     True),
    ("route_bf16_zigzag", 42, (2, 4, 256, 64, None), "bf16", True, True),
]


# gradients of the card's route, the plain K1, K2 and K3 in the kernels'
# place, against jax.grad of the reference's ring (fp32, GQA, S = 256
# over 4 ranks): name, seed, causal, zigzag
ROUTE_GRAD = [("route_grad_causal", 60, True, False),
              ("route_grad_zigzag", 63, True, True),
              ("route_grad_non_causal", 66, False, False)]
ROUTE_GRAD_SHAPE = (1, 4, 256, 64, 2)


def _jax_ring(q, k, v, dtype, causal, zigzag, n):
    q, k, v = (jnp.asarray(x).astype(JDT[dtype]) for x in (q, k, v))
    S = q.shape[2]
    mesh = _jmesh(n)
    if not zigzag:
        return jra.ring_attention(q, k, v, mesh, causal=causal)
    perm, inv = jra.zigzag_order(S, n), jra.zigzag_inverse(S, n)
    out = jra.ring_attention(q[:, :, perm], k[:, :, perm], v[:, :, perm],
                             mesh, causal=causal, zigzag=True)
    return out[:, :, inv]


def _expanded_reference(q, k, v, dtype, causal):
    q, k, v = (jnp.asarray(x).astype(JDT[dtype]) for x in (q, k, v))
    g = q.shape[1] // k.shape[1]
    return attention_reference(q, jnp.repeat(k, g, 1), jnp.repeat(v, g, 1),
                               causal=causal)


def _jax_grads(q, k, v, proj, causal, zigzag, n=4):
    """jax.grad of sum(ring_attention(q, k, v) * proj) over (q, k, v), in
    natural order."""
    def loss(q, k, v):
        return jnp.sum(_jax_ring(q, k, v, "fp32", causal, zigzag, n) * proj)

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    return [np.asarray(g) for g in grad(*(jnp.asarray(x) for x in (q, k, v)))]


@pytest.fixture(scope="module")
def world():
    cases, ref = [], {}
    for name, seed, (B, H, S, D, Hkv), dt, causal, zz, n in CASES:
        q, k, v = _qkv(seed, B, H, S, D, Hkv)
        cases.append({"name": name, "q": q, "k": k, "v": v, "dtype": dt,
                      "causal": causal, "zigzag": zz, "n": n})
        ref[name] = {
            "ring": np.asarray(_jax_ring(q, k, v, dt, causal, zz, n),
                               np.float32),
            "exact": np.asarray(_expanded_reference(q, k, v, dt, causal),
                                np.float32)}
    for name, seed, (B, H, S, D, Hkv), dt, causal, zz in ROUTE:
        q, k, v = _qkv(seed, B, H, S, D, Hkv)
        cases.append({"name": name, "q": q, "k": k, "v": v, "dtype": dt,
                      "causal": causal, "zigzag": zz, "n": 4,
                      "route": "flash"})
    # gradients through the fold (fp32, GQA, causal) against jax.grad
    q, k, v = _qkv(50, 1, 4, 32, 8, 2)
    proj = _randn(53, 1, 4, 32, 8)
    cases.append({"name": "grad", "q": q, "k": k, "v": v, "dtype": "fp32",
                  "causal": True, "zigzag": False, "n": 4, "proj": proj})
    ref["grad"] = _jax_grads(q, k, v, proj, True, False)
    B, H, S, D, Hkv = ROUTE_GRAD_SHAPE
    for name, seed, causal, zz in ROUTE_GRAD:
        q, k, v = _qkv(seed, B, H, S, D, Hkv)
        proj = _randn(seed + 3, B, H, S, D)
        cases.append({"name": name, "q": q, "k": k, "v": v,
                      "dtype": "fp32", "causal": causal, "zigzag": zz,
                      "n": 4, "proj": proj, "route": "flash"})
        ref[name] = _jax_grads(q, k, v, proj, causal, zz)
    ranks = parallel.run_ranks(torch_ranks.ring_checks, 4, {"cases": cases},
                               timeout=300)
    return ranks, ref


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ring_matches_the_reference(world, case):
    ranks, ref = world
    name, dt = case[0], case[3]
    tol = F32 if dt == "fp32" else BF16
    for r in ranks:
        got = r[name]
        assert got["dtype"] == str(torch_ranks._DTYPES[dt])
        # the JAX package's ring on the same inputs, and exact attention
        np.testing.assert_allclose(got["out"], ref[name]["ring"], **tol)
        np.testing.assert_allclose(got["out"], ref[name]["exact"], **tol)


@pytest.mark.parametrize("case", ROUTE, ids=[c[0] for c in ROUTE])
def test_card_route_with_the_plain_k1_matches_the_fold(world, case):
    ranks, _ = world
    name, dt, causal, zz = case[0], case[3], case[4], case[5]
    tol = ROUTE_F32 if dt == "fp32" else ROUTE_BF16
    for rank, r in enumerate(ranks):
        got = r[name]
        np.testing.assert_allclose(got["out"], got["fold"], **tol)
        calls = got["calls"]["fwd"]
        n = 4
        if not causal:
            # every visiting chunk whole, non-causal
            assert calls == [False] * n
        elif not zz:
            # the diagonal chunk (causal), then one fully visible chunk
            # from each earlier rank; later ranks' chunks are skipped
            assert calls == [True] + [False] * rank
        else:
            # each step: the q halves' pairs with the k halves that are
            # visible; the own chunk gives two diagonals and one full pair
            assert sorted(calls) == [False] * (2 * n - 1) + [True] * 2


def test_gradients_through_the_fold_match_jax_grad(world):
    ranks, ref = world
    for r in ranks:
        for got, want in zip(r["grad"]["grads"], ref["grad"]):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ROUTE_GRAD, ids=[c[0] for c in ROUTE_GRAD])
def test_card_route_gradients_match_jax_grad(world, case):
    # the card's route with the plain K1-K3: dq, dk, dv gathered against
    # jax.grad of the reference (fp32: the same sums in another order),
    # and its output against the fold's; each visible pair launches K2
    # and K3 once, as K1 in the forward: r + 1 pairs on rank r
    # contiguous, 2n + 1 a rank zigzagged, n a rank non-causal
    ranks, ref = world
    name, _, causal, zz = case
    n = len(ranks)
    for rank, r in enumerate(ranks):
        got = r[name]
        for g, want in zip(got["grads"], ref[name]):
            np.testing.assert_allclose(g, want, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got["out"], got["fold"], **ROUTE_F32)
        pairs = (2 * n + 1 if zz else rank + 1) if causal else n
        calls = got["calls"]
        assert len(calls["fwd"]) == len(calls["dq"]) == len(
            calls["dkdv"]) == pairs
        # the same pairs, diagonal (causal) or fully visible, both ways
        assert sorted(calls["dq"]) == sorted(calls["dkdv"]) == sorted(
            calls["fwd"])


@pytest.mark.parametrize("case", ROUTE_GRAD, ids=[c[0] for c in ROUTE_GRAD])
def test_card_route_posts_the_same_hops_on_every_rank(world, case):
    # masked pairs skip launches, never hops: n - 1 k/v hops forward;
    # backward the k/v chunk again (n - 1 hops) and its fp32 dk/dv
    # buffer every step, the last hop taking it home, on every rank
    ranks, _ = world
    name = case[0]
    n = len(ranks)
    B, H, S, D, Hkv = ROUTE_GRAD_SHAPE
    kv = ([2, B, Hkv, S // n, D], "torch.float32")
    want = [kv] * (n - 1) + [kv, kv] * (n - 1) + [kv]
    for r in ranks:
        got = r[name]
        assert got["fwd_hops"] == n - 1
        assert [tuple(h) for h in got["calls"]["hops"]] == [
            (shape, dt) for shape, dt in want]


@pytest.mark.parametrize("S,n", [(32, 4), (48, 2), (64, 8), (16, 1)])
def test_zigzag_order_matches_the_reference(S, n):
    fwd = ra.zigzag_order(S, n).numpy()
    inv = ra.zigzag_inverse(S, n).numpy()
    np.testing.assert_array_equal(fwd, np.asarray(jra.zigzag_order(S, n)))
    np.testing.assert_array_equal(inv, np.asarray(jra.zigzag_inverse(S, n)))
    x = np.arange(S)
    assert (x[fwd][inv] == x).all()
    if (S, n) == (32, 4):
        # rank 0 holds halves 0 and 2n-1 (positions 0..3 and 28..31)
        assert list(fwd[:8]) == [0, 1, 2, 3, 28, 29, 30, 31]
    with pytest.raises(ValueError, match="not divisible"):
        ra.zigzag_order(2 * n + 1, n)


@pytest.mark.parametrize("zigzag", [False, True])
def test_chunk_positions_match_the_reference(zigzag):
    for r in range(4):
        np.testing.assert_array_equal(
            ra._chunk_positions(r, 8, 4, zigzag).numpy(),
            np.asarray(jra._chunk_positions(r, 8, 4, zigzag)))


class _Mesh:
    """What the checks read of a DeviceMesh: an "sp" axis of n ranks."""

    def __init__(self, n, rank=0):
        self.mesh_dim_names, self.n, self.rank = ("sp",), n, rank

    def size(self, i=0):
        return self.n

    def get_local_rank(self, name):
        return self.rank


def test_ring_rejects_indivisible_seq():
    q, k, v = (torch.as_tensor(x) for x in _qkv(5, S=100))
    with pytest.raises(ValueError, match="not divisible"):
        ra.shard_seq(q, _Mesh(8))
    jq = jnp.asarray(_qkv(5, S=100)[0])
    with pytest.raises(ValueError, match="not divisible"):
        jra.ring_attention(jq, jq, jq, _jmesh(8))


def test_ring_rejects_mismatched_kv():
    q, k, v = (torch.as_tensor(x) for x in _qkv(6, S=16))
    with pytest.raises(ValueError, match="equal q/kv lengths, got 128 vs 64"):
        ra.ring_attention(q, k[:, :, :8], v[:, :, :8], _Mesh(8))


def test_zigzag_rejects_odd_chunk():
    q, k, v = (torch.as_tensor(x) for x in _qkv(13, B=1, H=1, S=3, D=8))
    with pytest.raises(ValueError, match="zigzag"):
        ra.ring_attention(q, k, v, _Mesh(8), causal=True, zigzag=True)


def test_one_rank_ring_is_attention():
    # no mesh: one chunk, the diagonal; both routes are plain attention
    q, k, v = (torch.as_tensor(x) for x in _qkv(60, 1, 4, 64, 16, 2))
    want = np.asarray(_expanded_reference(*(x.numpy() for x in (q, k, v)),
                                          "fp32", True))
    np.testing.assert_allclose(ra.ring_attention(q, k, v, None).numpy(),
                               want, **F32)
    np.testing.assert_allclose(
        ra._ring_flash(q, k, v, None, "sp", True, False).numpy(), want,
        **F32)


def test_merge_guards_rows_no_piece_reached():
    # the running LSE starts at -inf: a merge of -inf with -inf keeps the
    # row at 0 with LSE -inf, and a real piece then takes over exactly
    acc = torch.zeros(1, 1, 2, 4)
    lse = torch.full((1, 1, 2), float("-inf"))
    ra._merge(acc, lse, torch.ones(1, 1, 2, 4),
              torch.full((1, 1, 2), float("-inf")))
    assert torch.equal(acc, torch.zeros_like(acc)) and torch.isinf(lse).all()
    o = torch.randn(1, 1, 2, 4)
    ra._merge(acc, lse, o, torch.tensor([[[0.5, -3.0]]]))
    assert torch.equal(acc, o) and torch.equal(lse,
                                               torch.tensor([[[0.5, -3.0]]]))
