"""Continuous batching under tensor parallelism: ``serve --tp 2 --engine``
(tpushare_torch/workloads/serve.py, engine.py) on the CPU, over HTTP.

Sample 5's documented mode (``samples/5-serving.yaml``: ``--engine`` on
the replica of a 4-chip grant) at llama-tiny size: two gloo ranks, rank
0 owning HTTP and the engine's host state, both ranks running every
prefill and decode quantum on their shards. Against the ``--tp 1``
replica of the same seed and the JAX package's ``greedy_decode_kv`` on
the same weights (the reference serves its engine over a sharded mesh,
``tpushare/workloads/serve.py:517-540``): greedy tokens with the int8 KV
cache and with the rolling KV cache, co-tenant invariance, and a pause
in mid-stream.

Sampled streams are held across tp in fp32 (tests/torch_ranks.py:
tp_engine_checks): the same engine protocol, rank 0's ``DecodeEngine``
broadcasting each call (``_TPEngine``) and rank 1 following in
``_rank_loop``, over
the JAX package's fp32 weights. In bf16 the sharded row products round
otherwise than one card's, and a draw whose two best candidates lie
within that rounding goes either way.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import model as jm
from tpushare.workloads.engine import DecodeEngine as JaxEngine
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import parallel, serve
from tpushare_torch.workloads.convert import params_from_numpy
from tpushare_torch.workloads.engine import DecodeEngine

import torch_ranks

torch.set_num_threads(2)

PROMPTS = [[5, 9], [100, 2, 77, 31, 8, 4, 19], [240] * 11, [7, 8],
           [100] * 13, [3, 1, 4, 1, 5, 9, 2, 6]]
STEPS = 6
# four slots for six prompts: two wait in the queue and join mid-flight
BASE = ["--preset", "llama-tiny", "--quant", "int8", "--device", "cpu",
        "--port", "0", "--engine", "--engine-slots", "4",
        "--engine-max-len", "32", "--engine-quantum", "3"]
# name -> the flags of both replicas
CONFIGS = {"int8-kv": ["--kv-cache-dtype", "int8"],
           "rolling-kv": ["--attn-window", "4", "--rolling-kv"]}


class _Replica:
    def __init__(self, argv):
        self.httpd, self.front = serve.build_server(argv)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def post(self, body):
        req = urllib.request.Request(self.url + "/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["tokens"]

    def stream(self, prompt, steps):
        """The NDJSON events of one streamed request, as they arrive."""
        req = urllib.request.Request(self.url + "/generate", data=json.dumps(
            {"tokens": prompt, "steps": steps, "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            for line in r:
                yield json.loads(line)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.front.stop()
        self.front.join(timeout=60)
        self.thread.join(timeout=30)
        assert not self.front._thread.is_alive()
        tp = getattr(self.front.engine, "replica", None)
        assert tp is None or not any(p.is_alive() for p in tp._procs)


def _serve(argv, drive):
    replica = _Replica(argv)
    try:
        return drive(replica)
    finally:
        replica.close()


def _generated(rows):
    return [row[len(p):] for p, row in zip(PROMPTS, rows)]


def _drive(replica):
    """What each test reads of a replica: the six prompts together and
    the first prompt alone."""
    return {"together": replica.post({"tokens": PROMPTS, "steps": STEPS}),
            "alone": replica.post({"tokens": PROMPTS[0], "steps": STEPS})}


@pytest.fixture(scope="module")
def served():
    """Each config at --tp 1 and --tp 2: {(name, tp): readings}."""
    out = {}
    for name, flags in CONFIGS.items():
        for tp in (1, 2):
            out[name, tp] = _serve(BASE + flags + ["--tp", str(tp)], _drive)
    return out


def _jax_greedy(name):
    """The JAX package's greedy_decode_kv on the tp=1 replica's int8
    weights (seed 0 on the CPU), each prompt alone."""
    weights = tm.quantize_int8(tm.init_params(
        tm.PRESETS["llama-tiny"], torch.Generator().manual_seed(0)))
    pj = jax.tree.map(lambda t: jnp.asarray(
        t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
        else jnp.asarray(t.numpy()), weights)
    kw = ({"attn_window": 4} if name == "rolling-kv"
          else {"kv_cache_dtype": "int8"})
    jcfg = dataclasses.replace(jm.PRESETS["llama-tiny"], **kw)
    return [np.asarray(jm.greedy_decode_kv(
        pj, jnp.asarray([p], jnp.int32), STEPS, jcfg,
        rolling=name == "rolling-kv"))[0, len(p):].tolist() for p in PROMPTS]


def _exact_tie(prompt, generated, other):
    """Whether the one-card replica's own logits tie exactly between its
    token and ``other``'s at the first position they differ (int8 KV
    cache, the tp=1 replica's seed-0 weights)."""
    i = next(i for i, (a, b) in enumerate(zip(generated, other)) if a != b)
    weights = tm.quantize_int8(tm.init_params(
        tm.PRESETS["llama-tiny"], torch.Generator().manual_seed(0)))
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"],
                              kv_cache_dtype="int8")
    seq = torch.tensor([prompt + generated[:i]])
    cache = tm.init_kv_cache(cfg, 1, seq.shape[1])
    with torch.inference_mode():
        logits, _ = tm.forward_cached(weights, seq, cache, 0, cfg)
    last = logits[0, -1]
    return bool(last[generated[i]] == last[other[i]] == last.max())


@pytest.mark.parametrize("name", ["int8-kv", "rolling-kv"])
def test_tp2_engine_tokens_equal_tp1_and_the_jax_replica(served, name):
    # greedy: the tp=2 engine serves the JAX package's greedy_decode_kv
    # tokens on the same weights, as the tp=2 replica without the engine
    # does (tests/test_torch_sharded.py), and the tp=1 engine's, except
    # where the tp=1 replica's bf16 logits tie exactly between two
    # tokens (its row products round in another order than tp=2's, so a
    # tie breaks the other way; the JAX replica breaks it as tp=2 does)
    tp1 = _generated(served[name, 1]["together"])
    tp2 = _generated(served[name, 2]["together"])
    assert tp2 == _jax_greedy(name)
    for p, a, b in zip(PROMPTS, tp1, tp2):
        assert a == b or (name == "int8-kv" and _exact_tie(p, a, b)), p
    assert all(len(t) == STEPS for t in tp2)


@pytest.mark.parametrize("name", ["int8-kv", "rolling-kv"])
def test_tp2_engine_is_cotenant_invariant(served, name):
    # a prompt served alone gives bitwise the tokens it gives amid five
    # others, as on one rank
    for tp in (1, 2):
        got = served[name, tp]
        assert got["alone"][0] == got["together"][0]


# fp32 runs of the engine protocol over two ranks: name -> the engine's
# sampling arguments
FP32_RUNS = {"greedy": {},
             "sampled": {"temperature": 0.9, "top_k": 40, "top_p": 0.9,
                         "seed": 5},
             "per-request": {"per_request_sampling": True, "seed": 11}}


@pytest.fixture(scope="module")
def fp32_world():
    jcfg = dataclasses.replace(jm.PRESETS["llama-tiny"], dtype=jnp.float32)
    pj = jm.init_params(jcfg, jax.random.key(0))
    numpy_params = jax.tree.map(np.asarray, pj)
    ranks = parallel.run_ranks(torch_ranks.tp_engine_checks, 2,
                               {"params": numpy_params, "runs": FP32_RUNS},
                               timeout=300)
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=torch.float32)
    one = {name: torch_ranks.engine_streams(
        DecodeEngine(params_from_numpy(numpy_params), cfg, **torch_ranks.
                     FP32_ENGINE, **kw)) for name, kw in FP32_RUNS.items()}
    jax_engine = JaxEngine(pj, jcfg, **torch_ranks.FP32_ENGINE)
    return (ranks[0]["streams"], one, torch_ranks.engine_streams(jax_engine),
            [r["step_graphs"] for r in ranks])


@pytest.mark.parametrize("name", list(FP32_RUNS))
def test_fp32_streams_equal_across_tp(fp32_world, name):
    # greedy, sampled by the engine's temperature, top-k and top-p, and
    # sampled per request beside greedy co-tenants: the tp=2 engine's
    # streams are the one-card engine's (the counter-keyed draws read the
    # full logits every rank gathers)
    tp2, tp1, _, _ = fp32_world
    assert tp2[name] == tp1[name]
    if name != "greedy":
        assert tp2[name] != tp1["greedy"]


def test_fp32_greedy_streams_equal_the_jax_engine(fp32_world):
    tp2, _, jax_streams, _ = fp32_world
    assert tp2["greedy"] == jax_streams


def test_tp_engine_steps_are_eager(fp32_world):
    # the ranks' steps run collectives that cross the host, so an engine
    # on a mesh steps eagerly (here on the CPU; on a card, by its mesh)
    graphs = fp32_world[3]
    assert len(graphs) == 2
    assert all(g and set(g) == {0} for g in graphs), graphs


def test_pause_in_mid_stream_leaves_the_ranks_waiting():
    # the frontend parks rank 0's engine between quanta while the other
    # rank waits on the next header; resumed, the stream goes on to the
    # tokens of an uninterrupted run
    # one token a quantum, so the stream is far from done when it parks
    prompt, steps = [11, 12, 13], 24

    def drive(replica):
        want = replica.post({"tokens": prompt, "steps": steps})[0]
        events = replica.stream(prompt, steps)
        first = next(events)
        assert replica.front.pause(timeout=30) and replica.front.paused
        got = [first]
        reader = threading.Thread(target=lambda: got.extend(events))
        reader.start()
        time.sleep(0.5)
        held = len(got)
        time.sleep(0.5)
        # paused: at most the quantum in flight when the pause came
        assert len(got) == held and not any("done" in e for e in got)
        replica.front.resume()
        reader.join(timeout=60)
        assert not reader.is_alive()
        return want, got

    want, events = _serve(BASE + CONFIGS["int8-kv"]
                          + ["--tp", "2", "--engine-quantum", "1"], drive)
    assert events[-1]["done"] and events[-1]["tokens"] == want
    assert prompt + sum((e["delta"] for e in events if "delta" in e),
                        []) == want


def _error(call) -> str:
    with pytest.raises(urllib.error.HTTPError) as e:
        call()
    return e.value.read().decode()


def test_a_rank_out_of_step_stops_the_replica():
    # rank 1 runs its decode quanta on a rolled slot table: the ranks'
    # token check fails the request in flight with its own message and
    # ends the ranks; a later request fails fast with the same reason
    # (never a collective to an exited rank) and /healthz answers 503
    with mock.patch.object(serve, "_tp_rank_main",
                           torch_ranks.rolled_table_rank_main):
        replica = _Replica(BASE + CONFIGS["int8-kv"] + ["--tp", "2"])
    try:
        agree = "tp ranks drew different tokens"
        first = _error(lambda: replica.post({"tokens": PROMPTS[1],
                                             "steps": STEPS}))
        assert agree in first
        tp = replica.front.engine.replica
        assert not any(p.is_alive() for p in tp._procs)
        t0 = time.perf_counter()
        second = _error(lambda: replica.post({"tokens": PROMPTS[0],
                                              "steps": STEPS}))
        assert agree in second and "tp replica stopped" in second
        assert time.perf_counter() - t0 < 5
        health = _error(lambda: urllib.request.urlopen(
            replica.url + "/healthz", timeout=30))
        assert agree in health
    finally:
        replica.close()
