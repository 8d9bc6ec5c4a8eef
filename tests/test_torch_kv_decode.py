"""The decode step's ``kv_decode`` path (tpushare_torch/kernels/kv_decode.py)
on the CPU: which steps of ``forward_cached`` take it, that on the CPU it
gives the einsum path's logits for every active row, that its plain
version attends exactly each row's span, that the engine's
``engine.step`` spans then count the keys the path reads, and what the
card's wrapper refuses to hand the kernel."""

import dataclasses

import pytest
import torch

from benchmark.trace import DeviceTrace
from tpushare_torch import metrics
from tpushare_torch.kernels import kv_decode as kd
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads.engine import DecodeEngine

torch.set_num_threads(2)

M = 16


def _cfg(nh=4, nkv=2, window=None, kv="int8", dtype=torch.bfloat16,
         head_dim=128):
    """llama-tiny at the kernel's widths by default: bf16, head_dim 128."""
    return dataclasses.replace(
        tm.PRESETS["llama-tiny"], n_heads=nh, n_kv_heads=nkv,
        d_model=head_dim * nh, attn_window=window, kv_cache_dtype=kv,
        dtype=dtype)


def _filled_cache(cfg, B, seed=1):
    """An int8 cache whose every position holds seeded keys and values, as
    if earlier steps had written them."""
    gen = torch.Generator().manual_seed(seed)
    cache = tm.init_kv_cache(cfg, B, M)
    for name in ("k", "v"):
        cache[name].copy_(torch.randint(-127, 128, cache[name].shape,
                                        generator=gen, dtype=torch.int8))
        cache[name + "s"].copy_(torch.rand(cache[name + "s"].shape,
                                           generator=gen) * 0.05 + 0.001)
    return cache


# (id, query heads, kv heads, window, positions (a list: one a row; an int:
# shared), write_rows)
CASES = [
    ("ragged", 4, 2, None, [0, 5, M - 1, 9], None),
    ("window", 4, 2, 4, [0, 3, 10, M - 1], None),
    ("inactive", 4, 2, None, [2, 7, M - 1, 0], [True, False, True, False]),
    ("reps1", 4, 4, None, [1, M - 1, 6, 0], None),
    ("reps4", 8, 2, 5, [M - 1, 4, 0, 11], [True, True, False, True]),
    ("shared", 4, 2, None, 7, None),
    ("shared-window", 4, 2, 3, M - 1, None),
    # a tensor-parallel rank of a 32 / 8-head model over 4 ranks: 8 query
    # heads, 2 kv heads
    ("tp-rank", 8, 2, None, [3, M - 1, 0, 8], [False, True, True, True]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_path_gives_the_einsum_logits(monkeypatch, case):
    """A decode step through ``kv_decode`` (its plain version here) and the
    same step forced onto the einsum path give bitwise the same logits on
    every row that writes, and the same cache."""
    _, nh, nkv, window, pos, rows = case
    cfg = _cfg(nh, nkv, window)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    B = 4
    tokens = torch.randint(cfg.vocab, (B, 1),
                           generator=torch.Generator().manual_seed(2))
    offset = pos if isinstance(pos, int) else torch.tensor(pos)
    write = None if rows is None else torch.tensor(rows)

    calls = []
    real = tm.kv_decode

    def recording(*a):
        calls.append(a[-2:])
        return real(*a)

    monkeypatch.setattr(tm, "kv_decode", recording)
    kernel_cache = _filled_cache(cfg, B)
    lk, kernel_cache = tm.forward_cached(params, tokens, kernel_cache,
                                         offset, cfg, write_rows=write)
    assert len(calls) == cfg.n_layers
    monkeypatch.setattr(tm, "kv_decode_spans", lambda *a, **k: None)
    einsum_cache = _filled_cache(cfg, B)
    le, einsum_cache = tm.forward_cached(params, tokens, einsum_cache,
                                         offset, cfg, write_rows=write)
    assert len(calls) == cfg.n_layers
    live = torch.ones(B, dtype=torch.bool) if write is None else write
    assert torch.equal(lk[live], le[live])
    for name in kernel_cache:
        assert torch.equal(kernel_cache[name], einsum_cache[name])
    lo, hi = calls[0]
    p = torch.full((B,), pos) if isinstance(pos, int) else torch.tensor(pos)
    want_lo = (p + 1 - (window or M + 1)).clamp(min=0)
    assert torch.equal(lo.long(), want_lo)
    assert torch.equal(hi.long(), torch.where(live, p + 1, want_lo))
    assert lo.dtype == hi.dtype == torch.int32


def _loop_reference(q, k, v, ks, vs, lo, hi):
    """Each row's attention over its span alone, in float64."""
    B, nh, hd = q.shape
    reps = nh // k.shape[2]
    out = torch.zeros(B, nh, hd, dtype=torch.float64)
    for b in range(B):
        keys = range(int(lo[b]), int(hi[b]))
        if not keys:
            continue
        for j in range(nh):
            g = j // reps
            kk = k[b, keys, g].double() * ks[b, keys, g].double()
            vv = v[b, keys, g].double() * vs[b, keys, g].double()
            s = kk @ q[b, j].double() * hd ** -0.5
            out[b, j] = torch.softmax(s, dim=0) @ vv
    return out.reshape(B, nh * hd)


@pytest.mark.parametrize("nkv,reps", [(2, 1), (2, 4), (1, 2), (4, 2)])
def test_plain_version_attends_each_rows_span(nkv, reps):
    """Ragged spans, spans starting past 0 (a window), a span of one key,
    an empty span (0 out) and a span to the buffer's end; in fp32 at
    head_dim 16, which the plain version takes as the einsum does."""
    gen = torch.Generator().manual_seed(3)
    B, hd = 6, 16
    q = torch.randn(B, nkv * reps, hd, generator=gen)
    k, v = (torch.randint(-127, 128, (B, M, nkv, hd), generator=gen,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, M, nkv, 1, generator=gen) * 0.05 + 0.001
              for _ in range(2))
    lo = torch.tensor([0, 3, 0, 7, 5, 9], dtype=torch.int32)
    hi = torch.tensor([M, 11, 1, 7, 6, M], dtype=torch.int32)
    out = kd.kv_decode_plain(q, k, v, ks, vs, lo, hi)
    assert out.shape == (B, nkv * reps * hd) and out.dtype == q.dtype
    ref = _loop_reference(q, k, v, ks, vs, lo, hi)
    torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out[3], torch.zeros(nkv * reps * hd))


@pytest.mark.parametrize("reps", [1, 2, 4, 8])
def test_on_the_cpu_the_wrapper_runs_the_plain_version(reps):
    """bf16 at head_dim 128, as the kernel takes it: bitwise the plain
    version, and no launch."""
    gen = torch.Generator().manual_seed(5)
    B, nkv, hd = 3, 2, 128
    q = torch.randn(B, nkv * reps, hd, generator=gen).bfloat16()
    k, v = (torch.randint(-127, 128, (B, M, nkv, hd), generator=gen,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, M, nkv, 1, generator=gen) * 0.05 + 0.001
              for _ in range(2))
    lo = torch.tensor([0, 4, 2], dtype=torch.int32)
    hi = torch.tensor([M, 9, 2], dtype=torch.int32)
    before = kd.LAUNCHES
    out = kd.kv_decode(q, k, v, ks, vs, lo, hi)
    assert kd.LAUNCHES == before  # the plain version is no launch
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, kd.kv_decode_plain(q, k, v, ks, vs, lo, hi))
    assert torch.equal(out[2], torch.zeros(nkv * reps * hd,
                                           dtype=torch.bfloat16))


# (id, cache dtype, T, rolling, model dtype, head_dim)
PATHS = [("int8-decode", "int8", 1, False, torch.bfloat16, 128),
         ("int8-chunk", "int8", 3, False, torch.bfloat16, 128),
         ("int8-ring", "int8", 1, True, torch.bfloat16, 128),
         ("model-cache", "model", 1, False, torch.bfloat16, 128),
         ("int8-fp32", "int8", 1, False, torch.float32, 128),
         ("int8-head-dim-16", "int8", 1, False, torch.bfloat16, 16)]


@pytest.mark.parametrize("case", PATHS, ids=[c[0] for c in PATHS])
def test_only_int8_decode_steps_reach_the_kernel(monkeypatch, case):
    """Only a bf16 decode step at head_dim 128 against an int8 cache
    without a ring; every other step keeps the einsum."""
    _, kv, T, rolling, dtype, head_dim = case
    cfg = _cfg(window=8 if rolling else None, kv=kv, dtype=dtype,
               head_dim=head_dim)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(tm, "kv_decode",
                        lambda *a: calls.append(1) or kd.kv_decode(*a))
    cache = tm.init_kv_cache(cfg, 2, M, rolling=rolling)
    tm.forward_cached(params, torch.zeros((2, 4), dtype=torch.long), cache,
                      0, cfg)
    calls.clear()
    tm.forward_cached(params, torch.ones((2, T), dtype=torch.long), cache,
                      4, cfg)
    assert len(calls) == (cfg.n_layers if case[0] == "int8-decode" else 0)
    assert (tm.kv_decode_spans(cfg, cache, 4, T) is not None) == \
        (case[0] == "int8-decode")


def test_greedy_decode_kv_takes_the_kernel_path_each_step(monkeypatch):
    """The non-engine decode: a shared offset, no write_rows; the prefill
    (T > 1) does not reach the kernel."""
    cfg = _cfg()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(tm, "kv_decode",
                        lambda *a: calls.append(a[-2:]) or kd.kv_decode(*a))
    prompt = torch.randint(cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(4))
    out = tm.greedy_decode_kv(params, prompt, 4, cfg)
    assert out.shape == (2, 9)
    assert len(calls) == 3 * cfg.n_layers
    assert [int(hi[0]) for _, hi in calls[::cfg.n_layers]] == [6, 7, 8]


PROMPTS = [[5, 9], [100, 2, 77, 31, 8, 4, 19], [240] * 11]
BUDGETS = [9, 4, 7]


# (id, cache dtype, model dtype): the kernel path, and two einsum paths
READS = [("int8", "int8", torch.bfloat16), ("model", "model", torch.bfloat16),
         ("int8-fp32", "int8", torch.float32)]


@pytest.mark.parametrize("case", READS, ids=[c[0] for c in READS])
def test_keys_read_counts_what_the_path_reads(case):
    """``engine.step``'s ``keys_read``: on the kernel path the sum of the
    rows' spans, so it equals the quanta's ``live_keys`` (kv_read_use
    100%); on the einsum path rows x the buffer, every step."""
    name, kv, dtype = case
    cfg = _cfg(kv=kv, dtype=dtype)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    eng = DecodeEngine(params, cfg, max_slots=4, max_len=64, quantum=4)
    trace = DeviceTrace("cpu")
    trace.start()
    try:
        for p, n in zip(PROMPTS, BUDGETS):
            eng.submit(p, n)
        eng.drain()
    finally:
        trace.close_window()
        trace.stop()
    spans = metrics.last_session()
    steps = [s for s in spans if s.name == "engine.step"]
    live = sum(s.attrs["live_keys"] for s in spans
               if s.name == "engine.quantum")
    read = [s.attrs["keys_read"] for s in steps]
    assert steps and all(isinstance(r, int) for r in read)
    if name == "int8":
        assert sum(read) == live
    else:
        assert read == [4 * 64] * len(steps)


def _args(B=2, nh=8, nkv=2, hd=128):
    q = torch.zeros(B, nh, hd, dtype=torch.bfloat16)
    k, v = (torch.zeros(B, M, nkv, hd, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.ones(B, M, nkv, 1) for _ in range(2))
    lo = torch.zeros(B, dtype=torch.int32)
    return [q, k, v, ks, vs, lo, lo + 1]


# (id, argument index, replacement) each of which the kernel cannot take
BAD = [("fp16-q", 0, lambda a: a.half()),
       ("reps-3", 0, lambda a: torch.zeros(2, 6, 128, dtype=torch.bfloat16)),
       ("head-dim-48", 0, lambda a: torch.zeros(2, 8, 48,
                                                dtype=torch.bfloat16)),
       ("bf16-k", 1, lambda a: a.bfloat16()),
       ("strided-v", 2, lambda a: torch.zeros(2, M, 4, 128,
                                              dtype=torch.int8)[:, :, ::2]),
       ("fp16-ks", 3, lambda a: a.half()),
       ("int64-lo", 5, lambda a: a.long()),
       ("unaligned-q", 0, lambda a: torch.zeros(
           2 * 8 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 128))]


@pytest.mark.parametrize("bad", BAD, ids=[b[0] for b in BAD])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    """What the card's launch checks before it hands pointers to the
    kernel (the shapes, types and layouts of the cache as the model keeps
    it pass)."""
    args = _args()
    kd._check(*args)
    _, i, change = bad
    args[i] = change(args[i])
    with pytest.raises(ValueError):
        kd._check(*args)


# (query heads, kv heads, head_dim, q dtype), each consistent in itself
OTHER = [(8, 2, 64, torch.bfloat16), (8, 2, 16, torch.bfloat16),
         (8, 2, 128, torch.float32), (6, 2, 128, torch.bfloat16),
         (32, 2, 128, torch.bfloat16)]


@pytest.mark.parametrize("case", OTHER,
                         ids=[f"H{c[0]}Hkv{c[1]}D{c[2]}-{str(c[3])[6:]}"
                              for c in OTHER])
def test_the_kernel_takes_bf16_at_head_dim_128_only(case):
    """On either device: these go to the einsum (``kv_decode_spans`` gives
    None for them), and the wrapper refuses them."""
    nh, nkv, hd, dtype = case
    args = _args(nh=nh, nkv=nkv, hd=hd)
    args[0] = args[0].to(dtype)
    assert not kd.takes(dtype, hd, nh // nkv)
    with pytest.raises(ValueError, match="takes bf16 q at head_dim 128"):
        kd.kv_decode(*args)
