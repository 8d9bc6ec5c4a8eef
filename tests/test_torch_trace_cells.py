"""Each cell of ``BENCHMARK.json`` traced on the CPU at the benchmark's
tiny sizes (``benchmark/conftest.py``): the per-layer metrics that read
the program's spans are reported and finite, and the counts agree with
what the cell's traffic implies offline."""

import math

import pytest
import torch

from benchmark import cells, run, traffic
from benchmark.conftest import shrink
from tpushare_torch.workloads.engine import _bucket

torch.set_num_threads(2)

SEED = 2 ** 31 + 11
SECONDS = 1.5
SPAN_METRICS = {
    "mistral-7b.chat": ["frontend.admission_wait_ms.serve",
                        "engine.prefill_pad_share.serve",
                        "engine.decode_lane_use.serve",
                        "engine.kv_read_use.serve"],
    "mixtral-8x7b-l4.train-4k": ["train.backward_ms.train",
                                 "train.update_ms.train",
                                 "moe.capacity_use.train"],
    "mistral-7b.train-4k": ["train.backward_ms.train",
                            "train.update_ms.train"],
    "trinity-mini-l8.train-8k": ["train.backward_ms.train",
                                 "train.update_ms.train",
                                 "train.optimizer_ms.train",
                                 "moe.expert_roofline.train",
                                 "moe.load_max_over_mean.train"],
}


def tiny(name):
    """The cell at the benchmark's tiny sizes; an AFMoE cell keeps an MoE
    layer (``shrink``'s two layers would both be dense): one dense layer,
    4 held of 16 experts, expert width 32."""
    cell = shrink(cells.cell(name))
    conf = cell["config"]
    if conf.get("model_type") == "afmoe":
        conf.update(num_dense_layers=1, num_experts=4,
                    moe_intermediate_size=32)
        conf["published"] = dict(conf["published"], num_experts=16)
    return cell


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_traced_cell_reports_the_program_span_metrics(name):
    cell = tiny(name)
    assert {m["name"] for m in cell["per_layer"]} >= set(SPAN_METRICS[name])
    out = run.execute(cell, SEED, SECONDS, True, device="cpu", t_start=0.0)
    assert out["correct"] is True, out["checks"]
    values = {n: out["metrics"][n]["value"] for n in SPAN_METRICS[name]}
    assert all(v is not None and math.isfinite(v) and v > 0
               for v in values.values()), values
    if name == "mistral-7b.chat":
        tr = cell["traffic"]
        sched = traffic.schedule(tr, SEED, SECONDS,
                                 cell["config"]["vocab_size"])
        sizes = [(len(r.prompt), min(_bucket(len(r.prompt)),
                                     tr["engine"]["max_len"])) for r in sched]
        pads = sum(b - n for n, b in sizes) / sum(b for _, b in sizes) * 100
        assert values["engine.prefill_pad_share.serve"] == \
            pytest.approx(pads, abs=1e-9)
        assert values["engine.decode_lane_use.serve"] <= 100
        assert values["engine.kv_read_use.serve"] <= 100
        # a CPU engine steps eagerly: no step replays a CUDA graph
        assert out["metrics"]["engine.graph_step_share.serve"]["value"] == 0
    if name.startswith("mixtral"):
        m = cells.model_sizes(cell["config"])
        assert values["moe.capacity_use.train"] == m["k"] / m["E"] * 100
    if name.startswith("trinity"):
        assert values["moe.load_max_over_mean.train"] >= 1
