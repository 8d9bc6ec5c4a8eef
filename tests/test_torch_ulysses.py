"""The port's all-to-all (Ulysses) sequence parallelism
(tpushare_torch/workloads/ulysses.py) against the JAX package's
(tpushare/workloads/ulysses.py) on the CPU.

The counterparts of tests/test_ulysses.py: parity at n = 2 and 4, causal
or not; agreement with ring attention; gradients against ``jax.grad``;
the flash path against the einsum one; the sliding window; GQA with the
small kv heads on the wire; both refusals. The same numpy inputs (fp32)
go through the JAX package's ``ulysses_attention`` on its CPU mesh and
through the port's over one world of 4 gloo ranks for the file
(tests/torch_ranks.py:ulysses_checks; n = 2 is the (2, 2) mesh's "sp"
axis). The port's flash path runs the plain K1 forward and the plain K2/K3
backward on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpushare.workloads import ringattention as jra
from tpushare.workloads import ulysses as jul
from tpushare.workloads.attention import attention_reference
from tpushare_torch.workloads import parallel
from tpushare_torch.workloads import ringattention as ra
from tpushare_torch.workloads import ulysses as ul

import torch_ranks

torch.set_num_threads(2)

# fp32 outputs: the same math summed in another order
F32 = dict(atol=1e-5, rtol=1e-5)
# fp32 gradients: the backward sums over the sequence in another order
GRAD = dict(atol=1e-5, rtol=1e-4)
# flash against einsum (tests/test_ulysses.py:112)
FLASH = dict(atol=2e-2, rtol=2e-2)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _qkv(seed, B=2, H=8, S=64, D=16, Hkv=None):
    return (_randn(seed, B, H, S, D), _randn(seed + 1, B, Hkv or H, S, D),
            _randn(seed + 2, B, Hkv or H, S, D))


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _jax(q, k, v, n, causal=True, attn="einsum", window=None):
    return np.asarray(jul.ulysses_attention(
        *(jnp.asarray(x) for x in (q, k, v)), _jmesh(n), causal=causal,
        attn=attn, window=window))


def _exact(q, k, v, causal=True, window=None):
    g = q.shape[1] // k.shape[1]
    return np.asarray(attention_reference(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, 1),
        jnp.repeat(jnp.asarray(v), g, 1), causal=causal, window=window))


PARITY = [(n, causal) for n in (2, 4) for causal in (True, False)]
W = 40


@pytest.fixture(scope="module")
def world():
    cases, ref = [], {}

    def case(name, qkv, n, causal=True, attn="einsum", window=None,
             **extra):
        q, k, v = qkv
        cases.append({"name": name, "q": q, "k": k, "v": v, "n": n,
                      "causal": causal, "attn": attn, "window": window,
                      **extra})

    qkv = _qkv(0)
    for n, causal in PARITY:
        case(f"parity_{n}_{causal}", qkv, n, causal)
        ref[f"parity_{n}_{causal}"] = _jax(*qkv, n, causal)
    # agreement with ring attention
    qkv = _qkv(3)
    case("a2a", qkv, 4)
    case("ring", qkv, 4, ring=True)
    ref["ring"] = np.asarray(jra.ring_attention(
        *(jnp.asarray(x) for x in qkv), _jmesh(4)))
    # gradients, both paths, against jax.grad of the reference's einsum
    # path
    qkv = _qkv(7, B=1, H=4, S=32, D=8)
    proj = _randn(10, 1, 4, 32, 8)
    for attn in ("einsum", "flash"):
        case(f"grad_{attn}", qkv, 4, attn=attn, proj=proj)

    def loss(q, k, v):
        return jnp.sum(jul.ulysses_attention(q, k, v, _jmesh(4)) * proj)

    ref["grad"] = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in qkv))]
    # flash against einsum at S = 128
    qkv = _qkv(9, S=128)
    case("flash", qkv, 4, attn="flash")
    case("einsum", qkv, 4)
    ref["flash"] = _jax(*qkv, 4, attn="flash")
    # the sliding window, both paths
    qkv = _qkv(90, S=128)
    for attn in ("einsum", "flash"):
        case(f"window_{attn}", qkv, 4, attn=attn, window=W)
        ref[f"window_{attn}"] = _jax(*qkv, 4, attn=attn, window=W)
    ref["window"] = _exact(*qkv, window=W)
    # GQA-native: the small kv heads on the wire
    qkv = _qkv(95, H=16, S=128, Hkv=8)
    for attn in ("einsum", "flash"):
        case(f"gqa_{attn}", qkv, 4, attn=attn)
        ref[f"gqa_{attn}"] = _jax(*qkv, 4, attn=attn)
    ref["gqa"] = _exact(*qkv)
    ranks = parallel.run_ranks(torch_ranks.ulysses_checks, 4,
                               {"cases": cases}, timeout=300)
    return ranks, ref


@pytest.mark.parametrize("n,causal", PARITY)
def test_matches_reference(world, n, causal):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r[f"parity_{n}_{causal}"]["out"],
                                   ref[f"parity_{n}_{causal}"], **F32)


def test_agrees_with_ring_attention(world):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r["a2a"]["out"], r["ring"]["out"], **F32)
        np.testing.assert_allclose(r["a2a"]["out"], ref["ring"], **F32)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_gradients_match_jax_grad(world, attn):
    ranks, ref = world
    for r in ranks:
        for got, want in zip(r[f"grad_{attn}"]["grads"], ref["grad"]):
            np.testing.assert_allclose(got, want, **GRAD)


def test_ulysses_flash_matches_einsum_path(world):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r["flash"]["out"], r["einsum"]["out"],
                                   **FLASH)
        np.testing.assert_allclose(r["flash"]["out"], ref["flash"], **F32)
    q, k, v = (torch.as_tensor(x) for x in _qkv(9, S=8))
    with pytest.raises(ValueError, match="attn"):
        ul.ulysses_attention(q, k, v, None, attn="nope")


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_ulysses_window_matches_reference(world, attn):
    ranks, ref = world
    for r in ranks:
        got = r[f"window_{attn}"]["out"]
        np.testing.assert_allclose(got, ref["window"], **F32)
        np.testing.assert_allclose(got, ref[f"window_{attn}"], **F32)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_ulysses_gqa_native_matches_expanded_reference(world, attn):
    ranks, ref = world
    for r in ranks:
        got = r[f"gqa_{attn}"]["out"]
        np.testing.assert_allclose(got, ref["gqa"], **F32)
        np.testing.assert_allclose(got, ref[f"gqa_{attn}"], **F32)


class _Mesh:
    """What the checks read of a DeviceMesh: an "sp" axis of n ranks."""

    def __init__(self, n):
        self.mesh_dim_names, self.n = ("sp",), n

    def size(self, i=0):
        return self.n

    def get_local_rank(self, name):
        return 0


def test_rejects_indivisible_shapes():
    q, k, v = (torch.as_tensor(x) for x in _qkv(0, H=4, S=8))
    with pytest.raises(ValueError, match="heads"):
        ul.ulysses_attention(q, k, v, _Mesh(8))  # 4 heads < 8 shards
    q = torch.as_tensor(_qkv(0, S=60)[0])
    with pytest.raises(ValueError, match="seq len"):
        ra.shard_seq(q, _Mesh(8))
    with pytest.raises(ValueError, match="window"):
        ul.ulysses_attention(q, q, q, _Mesh(1), causal=False, window=4)


def test_ulysses_rejects_scarce_kv_heads():
    q = torch.as_tensor(_randn(96, 1, 8, 8, 16))
    k = torch.as_tensor(_randn(97, 1, 2, 8, 16))   # 2 % 8 != 0
    with pytest.raises(ValueError, match="kv heads not divisible"):
        ul.ulysses_attention(q, k, torch.zeros_like(k), _Mesh(8))
