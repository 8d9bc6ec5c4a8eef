"""The control of each cell comes out not correct: the plain reference
put in the program's place, computed in the precision just below the
configuration's, and judged by the harness's own verdict
(``run.execute``) with the cell's numbers and limits. A served cell's
control is int4 products for the configuration's int8 (its first choice
at each position of the served sequences); a training cell's is every
product's operands in fp8 for the configuration's bf16. At the cells'
own size these readings are taken on the card by
``benchmark/calibrate.py seeds --control-seeds``; here at a tiny size
on the CPU, on three seeds each."""

import pytest

from benchmark import cells, check, run
from benchmark.calibrate import SERVE_CONTROL, TRAIN_CONTROL

SERVE = [w["name"] for w in cells.spec()["workloads"]
         if cells.cell(w["name"])["traffic"]["kind"] == "serve"]
TRAIN = [w["name"] for w in cells.spec()["workloads"]
         if cells.cell(w["name"])["traffic"]["kind"] == "train"]


def verdict(cell, seed):
    return run.execute(cell, seed, 1.5, False, device="cpu", t_start=0.0)


@pytest.mark.parametrize("seed", [11, 12, 2 ** 31 + 13])
@pytest.mark.parametrize("name", SERVE)
def test_serving_control_fails(tiny_cell, monkeypatch, name, seed):
    cell = tiny_cell(name)
    # some hundreds of served tokens, as at the cell's own size
    cell["traffic"]["output"] = {"dist": "lognormal", "median": 24,
                                 "sigma": 0.4, "min": 8, "max": 32}
    cell["traffic"]["check"]["sample"] = 6
    assert verdict(cell, seed)["correct"] is True
    real = check.serve_numbers

    def control_served(m, seed, traffic, picked, device, control=None):
        got = real(m, seed, traffic, picked, device, control=SERVE_CONTROL)
        return {"served_gap": got["control_gap"]}
    monkeypatch.setattr(check, "serve_numbers", control_served)
    out = verdict(cell, seed)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("seed", [21, 22, 2 ** 31 + 23])
@pytest.mark.parametrize("name", TRAIN)
def test_training_control_fails(tiny_cell, monkeypatch, name, seed):
    cell = tiny_cell(name)
    m = cells.model_sizes(cell["config"])
    real = check.train_numbers

    def control_trained(program, reference):
        return real(check.train_reference(m, seed, cell["traffic"], "cpu",
                                          TRAIN_CONTROL), reference)
    monkeypatch.setattr(check, "train_numbers", control_trained)
    out = verdict(cell, seed)
    assert out["correct"] is False, out["checks"]
