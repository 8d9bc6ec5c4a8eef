"""Port HBM gating (tpushare_torch/workloads/hbm.py) and metrics
(tpushare_torch/metrics.py) on plain dict envs, beside their references
(tpushare/workloads/hbm.py, tpushare/metrics.py)."""

import pytest
import torch

from tpushare import metrics as jmetrics
from tpushare.contract import constants
from tpushare.workloads import hbm as jhbm
from tpushare_torch import contract, metrics
from tpushare_torch.workloads import hbm

torch.set_num_threads(2)


def test_contract_names_are_the_reference_names():
    assert contract.ENV_VISIBLE_CHIPS == constants.ENV_VISIBLE_CHIPS
    assert contract.ENV_HBM_LIMIT == constants.ENV_HBM_LIMIT
    assert contract.ENV_HBM_CHIP_TOTAL == constants.ENV_HBM_CHIP_TOTAL
    assert contract.ENV_PLACEMENT_BOX == constants.ENV_PLACEMENT_BOX


def _grant(limit, total, chips=None):
    env = {contract.ENV_HBM_LIMIT: str(limit),
           contract.ENV_HBM_CHIP_TOTAL: str(total)}
    if chips:
        env[contract.ENV_VISIBLE_CHIPS] = chips
    return env


def test_fractional_grant_before_and_after_cuda_init():
    env = _grant(8192, 81920, chips="0,2")
    applied = hbm.apply_hbm_gating(env)
    assert applied == {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
                       "CUDA_VISIBLE_DEVICES": "0,2"}
    assert env["CUDA_VISIBLE_DEVICES"] == "0,2"
    seen = []
    assert hbm.apply_memory_fraction(env, seen.append) == 0.1
    assert seen == [0.1]
    # the same fraction the reference hands XLA
    ref = jhbm.apply_hbm_gating(_grant(8192, 81920))
    assert float(ref[constants.ENV_MEM_FRACTION]) == pytest.approx(0.1)


@pytest.mark.parametrize("env", [
    _grant(81920, 81920), _grant(0, 81920), _grant(9000, 8000),
    {contract.ENV_HBM_LIMIT: "lots", contract.ENV_HBM_CHIP_TOTAL: "80"}, {},
], ids=["whole-card", "zero", "over", "malformed", "empty"])
def test_no_fraction_for_whole_or_malformed_grants(env):
    before = dict(env)
    assert hbm.apply_hbm_gating(env) == {}
    assert env == before
    called = []
    assert hbm.apply_memory_fraction(env, called.append) is None
    assert called == []


def test_operator_settings_win():
    env = _grant(4096, 16384, chips="3")
    env["CUDA_VISIBLE_DEVICES"] = "1"
    env["PYTORCH_CUDA_ALLOC_CONF"] = "max_split_size_mb:128"
    assert hbm.apply_hbm_gating(env) == {}
    assert env["CUDA_VISIBLE_DEVICES"] == "1"
    assert env["PYTORCH_CUDA_ALLOC_CONF"] == "max_split_size_mb:128"
    assert hbm.grant_fraction(env) == 0.25


def _exercise(mod):
    reg = mod.Registry()
    c = reg.counter("x_total", "things\nwith a newline")
    h = reg.histogram("lat_seconds", "latency",
                      tuple(b * 100 for b in mod.LATENCY_BUCKETS))
    reg.gauge_func("slots", "slot pool", lambda: [('{state="free"}', 3.0)])
    reg.gauge_func("broken", "raises", lambda: 1 / 0)
    c.inc()
    c.inc(2)
    for v in (0.01, 0.3, 7.0, 1000.0):
        h.observe(v)
    return reg.expose(), c.value, h.count


def test_metrics_exposition_is_the_reference_text():
    assert metrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert _exercise(metrics) == _exercise(jmetrics)
