"""Settings of the benchmark's own tests (``pytest benchmark/tests``).

``tiny_cell`` gives a cell of ``BENCHMARK.json`` cut to a size the CPU
runs in seconds: widths of 64, two layers, a vocabulary of 256, short
prompts and rows; the limits are the cell's own."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink(cell: dict) -> dict:
    conf = cell["config"]
    conf.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=256)
    if conf.get("sliding_window"):
        conf["sliding_window"] = 48
    tr = cell["traffic"]
    if tr["kind"] == "serve":
        tr.update(rate_per_s=4.0,
                  prompt={"dist": "lognormal", "median": 20, "sigma": 0.8,
                          "min": 4, "max": 60},
                  output={"dist": "lognormal", "median": 8, "sigma": 0.6,
                          "min": 2, "max": 16})
        tr["engine"].update(slots=4, max_len=96, quantum=4)
        tr["check"]["sample"] = 3
    else:
        tr.update(seq=64)
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark import cells
    return lambda name: shrink(cells.cell(name))
