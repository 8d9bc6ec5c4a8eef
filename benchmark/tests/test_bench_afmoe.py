"""The AFMoE training cells' control comes out not correct: the plain
reference (``reference/afmoe.py``) put in the program's place with every
product's operands in fp8 (below the configuration's bf16), judged by
the harness's own verdict with the cell's limits; and the cell itself
comes out correct. At the cell's own size these readings are taken on
the card by ``benchmark/calibrate_afmoe.py --control-seeds``; here at a
tiny size on the CPU with an MoE layer kept (one dense layer, 4 held of
16 experts, expert width 32), on three seeds. The rehearsal's two
training faults (the AdamW step skipped, the loss over half of each row)
come out not correct there too, with the MoE layer in the timed path."""

import pytest

from benchmark import cells, check, run, weights_afmoe
from benchmark.calibrate import TRAIN_CONTROL
from benchmark.drivers import train_afmoe
from test_bench_rehearsal import FAULTS

AFMOE = [w["name"] for w in cells.spec()["workloads"]
         if cells.cell(w["name"])["traffic"]["kind"] == "train_afmoe"]


def with_moe(cell):
    conf = cell["config"]
    conf.update(num_dense_layers=1, num_experts=4, moe_intermediate_size=32)
    conf["published"] = dict(conf["published"], num_experts=16)
    return cell


def verdict(cell, seed):
    return run.execute(cell, seed, 1.5, False, device="cpu", t_start=0.0)


def test_there_is_an_afmoe_cell():
    assert AFMOE


@pytest.mark.parametrize("seed", [31, 32, 2 ** 31 + 33])
@pytest.mark.parametrize("name", AFMOE)
def test_afmoe_cell_is_correct_and_its_control_fails(tiny_cell, monkeypatch,
                                                     name, seed):
    cell = with_moe(tiny_cell(name))
    out = verdict(cell, seed)
    assert out["correct"] is True, out["checks"]
    m = weights_afmoe.sizes(cell["config"])
    real = check.train_numbers

    def control_trained(program, reference):
        return real(train_afmoe.train_reference(
            m, seed, cell["traffic"], "cpu", TRAIN_CONTROL), reference)
    monkeypatch.setattr(check, "train_numbers", control_trained)
    out = verdict(cell, seed)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [0, 1],
                         ids=["step_keeps_state", "half_the_rows"])
@pytest.mark.parametrize("name", AFMOE)
def test_a_broken_timed_path_with_an_moe_layer_is_not_correct(
        tiny_cell, monkeypatch, name, fault):
    cell = with_moe(tiny_cell(name))
    FAULTS["train"][fault](monkeypatch)
    out = verdict(cell, 2 ** 31 + 3)
    assert out["correct"] is False, out["checks"]
