"""Port decode engine (tpushare_torch/workloads/engine.py) on the CPU.

Against the JAX engine (tpushare/workloads/engine.py): the same fp32
llama-tiny weights, carried across with ``params_from_numpy``, and the same
submissions give the same greedy streams. Within the port: co-tenant
invariance, parity with ``greedy_decode_kv`` and the sampling properties
(the port's counter-keyed generator cannot reproduce JAX's bits, so
sampling is tested by its invariances, not against JAX).
"""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import model as jm
from benchmark import cells
from tpushare.workloads.engine import DecodeEngine as JaxEngine
from tpushare_torch.workloads import engine as te
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads.convert import params_from_numpy
from tpushare_torch.workloads.engine import DecodeEngine

torch.set_num_threads(2)


def _cfgs(dtype="fp32", **kw):
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jm.PRESETS["llama-tiny"], dtype=jd, **kw),
            dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=td, **kw))


def _params(jcfg, quant=False):
    pj = jm.init_params(jcfg, jax.random.key(0))
    if quant:
        pj = jm.quantize_int8(pj)
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


PROMPTS = {"a": [5, 9], "b": [100, 2, 77, 31, 8, 4, 19], "c": [240] * 11}
BUDGETS = {"a": 9, "b": 4, "c": 7}


def _ragged_run(eng):
    """a and b in flight, c joins one quantum later; returns
    {name: tokens}."""
    rids = {k: eng.submit(PROMPTS[k], BUDGETS[k]) for k in ("a", "b")}
    out = dict(eng.run_quantum())
    rids["c"] = eng.submit(PROMPTS["c"], BUDGETS["c"])
    out.update(eng.drain())
    return {k: [int(t) for t in out[r]] for k, r in rids.items()}


ENGINES = [("einsum", {}, False), ("flash", {"attn": "flash"}, False),
           ("int8-weights", {}, True),
           ("rolling", {"attn_window": 4}, False)]


@pytest.mark.parametrize("kw,quant", [e[1:] for e in ENGINES],
                         ids=[e[0] for e in ENGINES])
def test_greedy_streams_equal_the_jax_engine(kw, quant):
    jcfg, tcfg = _cfgs(**kw)
    pj, pt = _params(jcfg, quant)
    rolling = "attn_window" in kw
    M = 16 if rolling else 32
    ref = _ragged_run(JaxEngine(pj, jcfg, max_slots=4, max_len=M,
                                quantum=3, rolling=rolling))
    got = _ragged_run(DecodeEngine(pt, tcfg, max_slots=4, max_len=M,
                                   quantum=3, rolling=rolling))
    assert got == ref
    assert all(len(got[k]) == BUDGETS[k] for k in got)


@pytest.fixture(scope="module")
def serving():
    """bf16, int8 weights, int8 KV cache, flash prefill: the serving
    configuration at llama-tiny size."""
    jcfg, tcfg = _cfgs("bf16", attn="flash", kv_cache_dtype="int8")
    return _params(jcfg, quant=True)[1], tcfg


def test_cotenants_do_not_perturb_each_other(serving):
    params, cfg = serving
    target = [17, 3, 99, 4, 250, 8, 61]
    alone = DecodeEngine(params, cfg, max_slots=4, max_len=64, quantum=4)
    rid = alone.submit(target, 20)
    solo = alone.drain()[rid]
    eng = DecodeEngine(params, cfg, max_slots=4, max_len=64, quantum=4)
    eng.submit([1, 2, 3], 9)
    eng.run_quantum()
    rid = eng.submit(target, 20)
    eng.submit([200] * 30, 25)
    eng.run_quantum(k=3)
    eng.submit([7], 5)
    assert eng.drain()[rid] == solo


def test_solo_request_matches_greedy_decode_kv():
    jcfg, tcfg = _cfgs()
    _, pt = _params(jcfg)
    prompt = [3, 141, 59, 26, 53]
    eng = DecodeEngine(pt, tcfg, max_slots=2, max_len=len(prompt) + 6)
    rid = eng.submit(prompt, max_new=6)
    ref = tm.greedy_decode_kv(pt, torch.tensor([prompt]), 6, tcfg)
    assert eng.drain()[rid] == ref[0, len(prompt):].tolist()


def _stream(params, cfg, prompt, n, cotenants=(), quantum=4, **kw):
    """Tokens of ``prompt`` (submitted first, so request id 0), with
    ``cotenants`` submitted beside it."""
    eng = DecodeEngine(params, cfg, max_slots=4, max_len=64,
                       quantum=quantum, **kw)
    rid = eng.submit(prompt, n)
    for p in cotenants:
        eng.submit(p, 6)
    return eng.drain()[rid]


def test_sampling_is_residency_and_quantum_independent(serving):
    params, cfg = serving
    prompt = [9, 8, 7, 6]
    base = _stream(params, cfg, prompt, 16, temperature=0.9, seed=3)
    assert base == _stream(params, cfg, prompt, 16, [[1, 2], [3] * 20],
                           temperature=0.9, seed=3)
    assert base == _stream(params, cfg, prompt, 16, quantum=1,
                           temperature=0.9, seed=3)
    assert base == _stream(params, cfg, prompt, 16, quantum=7,
                           temperature=0.9, seed=3)
    greedy = _stream(params, cfg, prompt, 16)
    assert base != greedy
    assert base != _stream(params, cfg, prompt, 16, temperature=0.9, seed=4)


def test_top_k_one_and_tiny_top_p_are_greedy(serving):
    params, cfg = serving
    prompt = [40, 41, 42]
    greedy = _stream(params, cfg, prompt, 12)
    assert _stream(params, cfg, prompt, 12, temperature=1.5,
                   top_k=1) == greedy
    assert _stream(params, cfg, prompt, 12, temperature=1.5,
                   top_p=1e-6) == greedy


def test_mixed_greedy_and_sampled_cotenants(serving):
    params, cfg = serving
    sampled_p, greedy_p = [5, 6, 7], [70, 71]
    solo_sampled = _stream(params, cfg, sampled_p, 10,
                           per_request_sampling=True, temperature=1.0,
                           seed=11)
    solo_greedy = _stream(params, cfg, greedy_p, 10)
    eng = DecodeEngine(params, cfg, max_slots=4, max_len=64, quantum=4,
                       per_request_sampling=True, temperature=1.0, seed=11)
    r_s = eng.submit(sampled_p, 10)
    r_g = eng.submit(greedy_p, 10, temperature=0.0)
    out = eng.drain()
    assert out[r_s] == solo_sampled and out[r_g] == solo_greedy
    assert solo_sampled != _stream(params, cfg, sampled_p, 10)


def test_counter_keyed_gumbel_max_follows_softmax():
    # 20000 (request, position) keys over a fixed 8-way distribution:
    # frequencies within 0.015 of softmax (4 standard deviations)
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -1.0, -3.0, 0.3])
    n = 20000
    salt = te._mix32(torch.arange(8) + 0x9E3779B9 & te._M32)
    rkey = torch.tensor([te._request_key(0, r) for r in range(n // 100)])
    rkey = rkey.repeat_interleave(100)
    qpos = torch.arange(100).repeat(n // 100)
    u = te._uniform(rkey, qpos, salt)
    assert (u > 0).all() and (u < 1).all()
    assert abs(u.mean().item() - 0.5) < 0.005
    picks = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    freq = torch.bincount(picks, minlength=8).float() / n
    assert (freq - torch.softmax(logits, 0)).abs().max().item() < 0.015


def test_mix32_is_32_bit_multiplication():
    xs = [0, 1, 0xFFFFFFFF, 0x12345678, 0x9E3779B9]
    for x in xs:
        assert te._mul32(x, 0x846CA68B) == (x * 0x846CA68B) % 2 ** 32
    t = te._mix32(torch.tensor(xs))
    assert t.tolist() == [te._mix32(x) for x in xs]


def test_slots_recycle_eos_and_streaming_hooks():
    jcfg, tcfg = _cfgs()
    _, pt = _params(jcfg)
    eng = DecodeEngine(pt, tcfg, max_slots=2, max_len=32, quantum=4)
    r1 = eng.submit([1, 2], 3)
    r2 = eng.submit([3], 6)
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.submit([4], 2)
    assert eng.peek_tokens(r1) is not None and len(eng.peek_tokens(r1)) == 1
    first = eng.run_quantum()
    assert set(first) == {r1} and eng.last_quantum_tokens[r1] == \
        first[r1][1:]
    assert eng.peek_tokens(r1) is None
    done = eng.drain()
    assert set(done) == {r2} and eng.free_slots == 2 and eng.resident == 0
    full = _stream(pt, tcfg, [7, 7, 3], 5)
    # the engine-wide eos stops at the first token; a per-request eos at
    # the second; budget 1 completes at submit
    eng = DecodeEngine(pt, tcfg, max_slots=2, max_len=32, eos_id=full[0])
    r = eng.submit([7, 7, 3], 5)
    assert eng.free_slots == 2 and eng.drain()[r] == full[:1]
    eng = DecodeEngine(pt, tcfg, max_slots=2, max_len=32, quantum=2)
    r_stop = eng.submit([7, 7, 3], 5, eos_id=full[1])
    r_full = eng.submit([7, 7, 3], 5)
    out = eng.drain()
    assert out[r_stop] == full[:2] and out[r_full] == full
    r_one = eng.submit([7, 7, 3], 1)
    assert eng.free_slots == 2 and eng.drain() == {r_one: full[:1]}


def test_rejections():
    jcfg, tcfg = _cfgs()
    _, pt = _params(jcfg)
    eng = DecodeEngine(pt, tcfg, max_slots=2, max_len=16)
    for args, kw, match in [(([], 3), {}, "empty prompt"),
                            (([1], 0), {}, "max_new"),
                            (([1] * 10, 7), {}, "exceeds max_len"),
                            (([1], 2), {"temperature": 0.5},
                             "per_request_sampling"),
                            (([300], 2), {}, "outside")]:
        with pytest.raises(ValueError, match=match):
            eng.submit(*args, **kw)
    assert eng.free_slots == 2
    with pytest.raises(ValueError, match="temperature > 0"):
        DecodeEngine(pt, tcfg, 2, 16, top_k=3)
    with pytest.raises(ValueError, match="2\\*attn_window"):
        DecodeEngine(pt, dataclasses.replace(tcfg, attn_window=8), 2, 12,
                     rolling=True)
    with pytest.raises(ValueError, match="differs from the parameters"):
        DecodeEngine(pt, tcfg, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="MoE"):
        DecodeEngine(pt, tm.PRESETS["llama-moe-tiny"], 2, 16)


def test_bucket():
    assert [te._bucket(n) for n in (1, 8, 9, 100, 512)] == \
        [8, 8, 16, 128, 512]


# -- the step's slot state in place (what a CUDA graph of the step needs) ----

SLOT_TENSORS = ("_pos", "_last", "_active", "_remaining", "_rkey",
                "_slot_temp", "_slot_topp", "_slot_eos")


def _storage(eng) -> dict:
    out = {n: getattr(eng, n).data_ptr() for n in SLOT_TENSORS}
    out.update({f"cache.{n}": t.data_ptr() for n, t in eng._cache.items()})
    return out


def test_slot_tensors_keep_their_storage(serving):
    # quanta with submits between them, slots freed and taken again: the
    # step writes the slot state in place, never rebinding a tensor
    params, cfg = serving
    eng = DecodeEngine(params, cfg, max_slots=3, max_len=64, quantum=3)
    before = _storage(eng)
    eng.submit([1, 2, 3], 4)
    eng.submit([9] * 12, 7)
    eng.run_quantum()
    eng.submit([5, 6], 9)
    eng.run_quantum(k=2)
    eng.drain()
    eng.submit([4] * 5, 3)
    eng.run_quantum(k=1)
    assert _storage(eng) == before
    assert eng._graph is None  # a CPU engine steps eagerly


def test_load_slot_table_writes_into_the_engines_buffers(serving):
    params, cfg = serving
    src = DecodeEngine(params, cfg, max_slots=4, max_len=64,
                       per_request_sampling=True, eos_id=7)
    src.submit([1, 2, 3], 6, temperature=0.5, top_p=0.8)
    src.submit([8] * 9, 5, eos_id=3)
    src.run_quantum(k=2)
    dst = DecodeEngine(params, cfg, max_slots=4, max_len=64,
                       per_request_sampling=True)
    before = _storage(dst)
    dst.load_slot_table(*src.slot_table())
    assert _storage(dst) == before
    for a, b in zip(dst.slot_table(), src.slot_table()):
        assert torch.equal(a, b)
    assert dst._active.dtype == torch.bool


def test_rolling_engine_samples_beside_slots_without_keys():
    # an idle ring slot that holds no key yet has NaN logits; nucleus
    # sampling over every row keeps that row's floor index in range
    jcfg, tcfg = _cfgs(attn_window=4)
    _, pt = _params(jcfg)
    eng = DecodeEngine(pt, tcfg, max_slots=3, max_len=16, quantum=3,
                       rolling=True, per_request_sampling=True, seed=2)
    rid = eng.submit([5, 9, 4], 6, temperature=0.9, top_p=0.9)
    toks = eng.drain()[rid]
    assert len(toks) == 6 and all(0 <= t < tcfg.vocab for t in toks)


def _traced_steps(fn) -> list:
    from tpushare_torch import metrics
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        fn()
    return metrics.last_session()


def test_cpu_engine_steps_are_eager(serving):
    params, cfg = serving
    eng = DecodeEngine(params, cfg, max_slots=2, max_len=64, quantum=3)
    eng.submit([1, 2, 3], 8)
    spans = _traced_steps(eng.drain)
    steps = [s for s in spans if s.name == "engine.step"]
    assert len(steps) == 9 and {s.attrs["graph"] for s in steps} == {0}
    assert eng._graph is None
    reader = cells.reader("engine.graph_step_share.serve")
    with mock.patch("tpushare_torch.metrics.last_session",
                    return_value=spans):
        assert reader.read({}) == 0


def _span(name, id_, parent=None, **attrs):
    return SimpleNamespace(name=name, id=id_, parent=parent, attrs=attrs)


# handmade spans: two quanta of two steps each, the graph attribute of
# each step (None: the attribute absent), the share the reader gives
GRAPH_SHARES = {"all replayed": ([1, 1, 1, 1], 100.0),
                "none replayed": ([0, 0, 0, 0], 0.0),
                "mixed": ([0, 1, 1, 1], 75.0),
                "no attribute": ([None] * 4, 0.0)}


@pytest.mark.parametrize("name", list(GRAPH_SHARES))
def test_graph_step_share_reader(name):
    graphs, share = GRAPH_SHARES[name]
    spans = [_span("engine.quantum", 0), _span("engine.quantum", 1),
             # a step outside any quantum is not counted
             _span("engine.step", 9, graph=0)]
    for i, g in enumerate(graphs):
        attrs = {"rows": 4} if g is None else {"rows": 4, "graph": g}
        spans.append(_span("engine.step", 10 + i, parent=i // 2, **attrs))
    reader = cells.reader("engine.graph_step_share.serve")
    with mock.patch("tpushare_torch.metrics.last_session",
                    return_value=spans):
        assert reader.read({}) == share
    with mock.patch("tpushare_torch.metrics.last_session",
                    return_value=spans[:3]):
        assert reader.read({}) is None
