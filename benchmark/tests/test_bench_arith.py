"""The yardstick's arithmetic, pinned: the copied roofline bounds to the
figures the kernel table of PERF.md holds, the closed-form pair count to
a brute count, the model counts to hand sums, and the traffic generator
to its seed."""

import json
from pathlib import Path

import pytest

from benchmark import arith, cells, traffic

BENCH = Path(__file__).resolve().parent.parent


def config(name):
    return cells.model_sizes(json.loads(
        (BENCH / "configs" / f"{name}.json").read_text()))


@pytest.mark.parametrize("kernel,S,ms,by", [
    ("fwd", 512, 0.00315, "bytes"),          # K1, llama-8b prefill S=512
    ("dq", 1023, 0.01302, "operations"),     # K2, train S=1023
    ("dkdv", 1023, 0.01735, "operations"),   # K3, train S=1023
])
def test_bounds_match_the_kernel_table(kernel, S, ms, by):
    args = (1, 32, 8, S, 128, "bfloat16", True, None)
    b = (arith.flash_bound(*args) if kernel == "fwd"
         else arith.flash_bwd_bound(kernel, *args))
    assert round(b["bound_ms"], 5) == ms
    assert b["bound_by"] == by


@pytest.mark.parametrize("S,causal,window", [
    (1, True, None), (7, True, None), (64, True, 16), (100, True, 99),
    (100, True, 100), (100, True, 1000), (33, False, None)])
def test_visible_pairs_counts_the_pairs(S, causal, window):
    brute = sum(1 for i in range(S) for j in range(S)
                if not causal or (j <= i and (window is None
                                              or i - j < window)))
    assert arith.visible_pairs(S, causal, window) == brute


def test_model_counts():
    m = config("mistral-7b")
    per_layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
    assert arith.layer_params(m) == per_layer
    assert per_layer * 32 == 6979321856
    mx = config("mixtral-8x7b-l4")
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    assert arith.layer_params(mx) == attn + 2 * 3 * 4096 * 14336 + 4096 * 8
    assert arith.layer_params(mx, active=False) == \
        attn + 8 * 3 * 4096 * 14336 + 4096 * 8
    assert arith.train_step_flops(m, 1, 4096, 4096) == 187942400163840
    assert arith.train_step_flops(mx, 1, 4096, None) == 43631901671424
    assert arith.prefill_flops(m, 384, 4096) == (
        2 * per_layer * 32 * 384 + 4 * 32 * 128 * (384 * 385 // 2) * 32
        + 2 * 4096 * 32000)


def test_decode_step_bytes():
    m = config("mistral-7b")
    weights = 6979321856 + 4096 * 32000
    scales = 4 * ((4096 + 2048 + 4096 + 2 * 14336 + 4096) * 32 + 32000)
    small = 2 * (2 * 32 * 4096 + 4096) + 2 * 2 * 4096
    kv = 32 * 2 * 8 * (128 + 4) * (100 + 200 + 2)
    assert arith.decode_step_bytes(m, [100, 200]) == \
        weights + scales + small + kv
    assert arith.decode_step_bytes(m, []) == 0


CHAT = json.loads((BENCH / "traffic" / "chat.json").read_text())


def test_lengths_sit_at_fixed_quantiles():
    assert traffic.lengths(CHAT["prompt"], 8) == \
        [406, 599, 761, 928, 1121, 1368, 1737, 2561]
    assert traffic.lengths(CHAT["output"], 8) == \
        [51, 76, 96, 117, 142, 173, 220, 324]
    assert traffic.lengths({"dist": "uniform", "min": 4096, "max": 16384},
                           4) == [5632, 8704, 11776, 14848]
    assert traffic.lengths({"dist": "fixed", "value": 32}, 3) == [32] * 3


def test_schedule_is_pinned_to_the_seed():
    s = traffic.schedule(CHAT, 2 ** 31 + 7, 5, 32000, rate=2.0)
    assert [(round(r.at, 4), len(r.prompt), r.max_new, r.prompt[:2])
            for r in s[:4]] == [
        (0.0, 1100, 163, [9639, 2316]), (0.0256, 1900, 102, [28418, 11790]),
        (0.3246, 2737, 193, [17890, 14407]), (0.4058, 681, 139, [23519, 1951])]
    again = traffic.schedule(CHAT, 2 ** 31 + 7, 5, 32000, rate=2.0)
    assert [(r.at, r.prompt, r.max_new) for r in again] == \
        [(r.at, r.prompt, r.max_new) for r in s]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 987654321])
def test_every_seed_gets_the_same_work(seed):
    base = traffic.schedule(CHAT, 0, 30, 32000)
    s = traffic.schedule(CHAT, seed, 30, 32000)
    assert len(s) == len(base) == round(CHAT["rate_per_s"] * 30)
    assert sorted(len(r.prompt) for r in s) == \
        sorted(len(r.prompt) for r in base)
    assert sorted(r.max_new for r in s) == sorted(r.max_new for r in base)
    assert s[0].at == 0.0 and all(a.at < b.at for a, b in zip(s, s[1:]))
    assert all(0 <= t < 32000 for r in s for t in r.prompt)
    assert s[-1].at < 30
