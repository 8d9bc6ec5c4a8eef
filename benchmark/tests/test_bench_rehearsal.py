"""Each cell end to end on the CPU at a tiny size, with the kernels'
plain versions: the line it prints has the contract's keys, and the
run is correct. Then the same runs with the timed path broken
underneath, once for each fault the cell can have, must come out not
correct. The harness's own look for a card is skipped here (``execute``
is what ``main`` calls once it has found one)."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import cells, run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in cells.spec()["workloads"]]


def go(cell, trace=False, seed=2 ** 31 + 3):
    return run.execute(cell, seed, 1.5, trace, device="cpu", t_start=0.0)


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end(tiny_cell, name, trace):
    cell = tiny_cell(name)
    out = go(cell, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(cell["limits"])
    json.dumps(out, allow_nan=False)
    names = {m["name"] for m in (cell["per_layer"] if trace
                                 else cell["end_to_end"])}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def _altered_token(monkeypatch):
    from tpushare_torch.workloads.engine import DecodeEngine
    pick = DecodeEngine._pick

    def altered(self, logits, *a):
        out = pick(self, logits, *a).clone()
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(DecodeEngine, "_pick", altered)


def _decode_keeps_state(monkeypatch):
    from tpushare_torch.workloads import engine
    fwd = engine.forward_cached

    def unchanged(*a, write_rows=None, **kw):
        if write_rows is not None:
            write_rows = torch.zeros_like(write_rows)
        return fwd(*a, write_rows=write_rows, **kw)
    monkeypatch.setattr(engine, "forward_cached", unchanged)


def _step_keeps_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)


def _half_the_rows(monkeypatch):
    from tpushare_torch.workloads import model
    loss = model.next_token_loss

    def half(logits, aux, targets, cfg):
        n = logits.shape[1] // 2
        return loss(logits[:, :n], aux, targets[:, :n], cfg)
    monkeypatch.setattr(model, "next_token_loss", half)


FAULTS = {"serve": [_altered_token, _decode_keeps_state],
          "train": [_step_keeps_state, _half_the_rows]}


@pytest.mark.parametrize("fault", [0, 1], ids=["first", "second"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, name,
                                            fault):
    cell = tiny_cell(name)
    FAULTS[cell["traffic"]["kind"]][fault](monkeypatch)
    out = go(cell)
    assert out["correct"] is False, out["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    subprocess.run(["cp", "-r", str(ROOT / "benchmark"),
                    str(ROOT / "BENCHMARK.json"), str(tmp_path)], check=True)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpushare_torch_x",
                        types.ModuleType("tpushare_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpushare.core",
                        types.ModuleType("tpushare.core"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "tpushare"]
