"""The port's program spans (``tpushare_torch.metrics.span``) on the CPU:
nothing is made or stored while no profiler runs; under the benchmark's
``DeviceTrace`` a request's spans share its rid across the client and
``decode-engine`` threads and nest by parent; sessions do not mix; the
spans' clock is the benchmark's; and the counts the spans carry agree
with what the requests did."""

import dataclasses
import threading

import pytest
import torch
from torch.autograd import profiler

from benchmark import cells
from benchmark.trace import DeviceTrace, Spans
from tpushare_torch import metrics
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import moe
from tpushare_torch.workloads.engine import DecodeEngine
from tpushare_torch.workloads.serve import _EngineFrontend

torch.set_num_threads(2)

PROMPTS = [[5, 9], [100, 2, 77, 31, 8, 4, 19], [240] * 11]
BUDGETS = [9, 4, 7]


def _engine(**kw):
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"],
                              dtype=torch.float32, **kw)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    return DecodeEngine(params, cfg, max_slots=4, max_len=64, quantum=4,
                        rolling=kw.get("attn_window") is not None)


def _train_step(preset="llama-tiny", **kw):
    """One train step's closure over tiny weights and a batch of 2 x 9."""
    cfg = dataclasses.replace(tm.PRESETS[preset], dtype=torch.float32, **kw)
    params = tm.train_params(tm.init_params(
        cfg, torch.Generator().manual_seed(0)))
    tx, step = tm.make_train_step(cfg)
    opt = tx.init(params)
    tokens = torch.randint(cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    return cfg, lambda: step(params, opt, tokens)


def _frontend_run(front):
    """Each prompt streamed from its own client thread; returns the
    client threads' names."""
    names = [f"client-{i}" for i in range(len(PROMPTS))]

    def consume(p, n):
        assert sum(front.generate_stream(p, n, timeout=60), []) != []

    threads = [threading.Thread(target=consume, args=(p, n), name=name)
               for p, n, name in zip(PROMPTS, BUDGETS, names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return names


@pytest.fixture
def frontend():
    front = _EngineFrontend(_engine())
    front.start()
    yield front
    front.stop()
    front.join(timeout=10)
    assert not front._thread.is_alive()


def _traced(fn):
    trace = DeviceTrace("cpu")
    trace.start()
    try:
        out = fn()
    finally:
        trace.close_window()
        trace.stop()
    return out


def test_off_makes_stores_and_synchronises_nothing(monkeypatch, frontend):
    made = []

    class Counted(metrics.Span):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a[0])
            super().__init__(*a)

    def refuse(*a, **kw):
        raise AssertionError("a CUDA event or synchronisation while off")

    monkeypatch.setattr(metrics, "Span", Counted)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    _traced(lambda: None)
    store = metrics._store
    eng = _engine()
    for p, n in zip(PROMPTS, BUDGETS):
        eng.submit(p, n)
    eng.drain()
    _frontend_run(frontend)
    for preset in ("llama-tiny", "llama-moe-tiny"):
        _train_step(preset)[1]()
    assert made == []
    assert metrics._store is store and store == []
    # recording on a CPU path still makes no CUDA event
    _traced(_train_step()[1])
    assert {"train.bwd", "train.update"} <= set(made)
    assert all(s.device_ms is None for s in metrics.last_session())


def test_a_requests_spans_share_its_rid_and_nest(frontend):
    clients = _traced(lambda: _frontend_run(frontend))
    spans = metrics.last_session()
    by_id = {s.id: s for s in spans}
    waits = [s for s in spans if s.name == "frontend.queue_wait"]
    assert len(waits) == len(PROMPTS)
    assert {s.thread for s in waits} == set(clients)
    assert len({s.rid for s in waits}) == len(PROMPTS)
    for wait in waits:
        mine = [s for s in spans if s.rid == wait.rid]
        assert sorted(s.name for s in mine) == ["engine.prefill",
                                                "frontend.queue_wait"]
        prefill, = (s for s in mine if s.name == "engine.prefill")
        assert prefill.thread == "decode-engine"
        assert wait.parent is None and prefill.parent is None
        assert wait.start_ns <= wait.end_ns <= prefill.start_ns \
            <= prefill.end_ns
    steps = [s for s in spans if s.name == "engine.step"]
    assert steps
    for s in spans:
        if s.name == "engine.step":
            assert by_id[s.parent].name == "engine.quantum"
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.thread == s.thread
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_two_sessions_do_not_mix():
    _, step = _train_step()
    _traced(step)
    first = {s.id for s in metrics.last_session()}
    assert first
    eng = _engine()
    _traced(lambda: (eng.submit(PROMPTS[0], 3), eng.drain()))
    second = metrics.last_session()
    assert second and not first & {s.id for s in second}
    assert {s.name for s in second} >= {"engine.prefill", "engine.quantum"}
    assert "train.bwd" not in {s.name for s in second}
    _traced(lambda: None)  # a session with no span reads empty
    assert metrics.last_session() == []


def test_program_spans_lie_inside_the_benchmarks_bracket():
    _, step = _train_step()
    bench = Spans()
    bench.on = True

    def bracketed():
        with bench.span("bench.step"):
            step()

    _traced(bracketed)
    (_, t0, t1, _), = bench.items
    spans = metrics.last_session()
    assert {s.name for s in spans} == {"train.bwd", "train.update"}
    assert all(t0 <= s.start_ns <= s.end_ns <= t1 for s in spans)


def test_moe_capacity_use_reads_k_over_e_when_nothing_drops():
    moe = tm.PRESETS["llama-moe-tiny"]
    E, k = moe.moe_experts, moe.moe_top_k
    cfg, step = _train_step("llama-moe-tiny", moe_capacity_factor=E / k)
    _traced(step)
    routes = [s for s in metrics.last_session() if s.name == "moe.route"]
    assert len(routes) == cfg.n_layers
    assert all(s.attrs["pairs"] == 2 * 8 * k
               and s.attrs["slots"] == E * 2 * 8 for s in routes)
    assert cells.reader("moe.capacity_use.train").read({}) == k / E * 100
    # at a capacity that drops pairs, kept falls short of the pairs
    _traced(_train_step("llama-moe-tiny", moe_capacity_factor=0.5)[1])
    routes = [s.attrs for s in metrics.last_session()
              if s.name == "moe.route"]
    kept, slots = (sum(a[n] for a in routes) for n in ("kept", "slots"))
    assert kept < sum(a["pairs"] for a in routes) and kept <= slots
    assert cells.reader("moe.capacity_use.train").read({}) == \
        kept / slots * 100


@pytest.mark.parametrize("experts", [None, (2, 5)], ids=["all", "shard"])
@pytest.mark.parametrize("capacity", [3, 8, 40])
def test_kept_from_the_counts_is_the_dispatch_sum(experts, capacity):
    """``moe.route``'s ``kept``, from the [k, E] counts, is the pairs the
    [T, E', C] dispatch holds, at capacities that drop and that do not."""
    logits = torch.randn(37, 8, generator=torch.Generator().manual_seed(3))
    dispatch = _traced(lambda: moe._route(logits, 2, capacity, experts)[0])
    route, = (s for s in metrics.last_session() if s.name == "moe.route")
    assert route.attrs["kept"] == dispatch.sum().item()
    assert route.attrs["slots"] == dispatch.shape[1] * capacity
    assert route.attrs["pairs"] == 37 * 2


@pytest.mark.parametrize("window", [None, 4], ids=["whole", "rolling"])
def test_quantum_counts_agree_with_the_streams(window):
    """Emitted tokens, live keys (min(position + 1, window) at each decode
    step) and keys read (slots x buffer a step) from the requests'
    lengths alone."""
    eng = _engine(attn_window=window)
    out = _traced(lambda: (
        [eng.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)],
        eng.drain())[1])
    spans = metrics.last_session()
    quanta = [s for s in spans if s.name == "engine.quantum"]
    steps = [s for s in spans if s.name == "engine.step"]
    assert len(steps) == 4 * len(quanta)  # the engine's quantum, 4
    assert all(s.attrs["rows"] == 4 and s.attrs["keys_read"] == 4 * 64
               for s in steps)
    emitted = live = 0
    for p, rid in zip(PROMPTS, range(len(PROMPTS))):
        n = len(out[rid]) - 1  # the first token is the prefill's
        emitted += n
        live += sum(min(len(p) + j + 1, window or 64) for j in range(n))
    assert sum(q.attrs["emitted"] for q in quanta) == emitted
    assert sum(q.attrs["live_keys"] for q in quanta) == live
    prefills = sorted((s.attrs["plen"], s.attrs["bucket"]) for s in spans
                      if s.name == "engine.prefill")
    if window is None:
        assert prefills == [(2, 8), (7, 8), (11, 16)]


def test_admission_wait_histogram_observes_each_admission():
    hist = metrics.Histogram("wait", "", metrics.LATENCY_BUCKETS)
    front = _EngineFrontend(_engine(), admission_wait=hist)
    front.start()
    try:
        front.generate_many(PROMPTS, 3, timeout=60)
        _frontend_run(front)
    finally:
        front.stop()
        front.join(timeout=10)
    assert hist.count == 2 * len(PROMPTS)
    assert "wait_sum" in hist.expose()


def test_the_profiler_hooks_the_spans_ride_on():
    """The recorder reads ``torch.autograd.profiler._is_profiler_enabled``
    and empties its store from ``_run_on_profiler_start``, both private
    to torch (held here from torch 2.11 to 2.13): a torch release that
    renames either fails this test first. Without the start hook the
    import warns and only ``metrics.new_session()`` empties the store."""
    assert isinstance(profiler._is_profiler_enabled, bool), torch.__version__
    assert getattr(profiler._run_on_profiler_start, "resets_spans",
                   False), torch.__version__
    hook = profiler._run_on_profiler_start
    metrics._reset_on_profiler_start()  # installed once, never twice
    assert profiler._run_on_profiler_start is hook
    _traced(_train_step()[1])
    assert metrics.last_session()
    metrics.new_session()
    assert metrics.last_session() == []


def test_without_the_start_hook_the_import_warns(monkeypatch, caplog):
    monkeypatch.delattr(profiler, "_run_on_profiler_start")
    with caplog.at_level("WARNING", logger=metrics.__name__):
        metrics._reset_on_profiler_start()
    assert "metrics.new_session()" in caplog.text
    assert not hasattr(profiler, "_run_on_profiler_start")
