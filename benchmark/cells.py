"""Find a cell's files by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the driver
``drivers/<kind>.py``), its limits (``limits/<cell>.json``) and its
per-layer metrics' readers (``metrics/<metric>.py``). A later cell adds
files and entries; nothing here changes for it."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _module(path: Path, name: str):
    if name not in sys.modules:
        mod_spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(mod_spec)
        sys.modules[name] = mod
        mod_spec.loader.exec_module(mod)
    return sys.modules[name]


def cell(workload: str, bench: dict | None = None) -> dict:
    """Everything a run of ``workload`` needs: ``{"name", "config",
    "traffic", "limits", "end_to_end", "per_layer"}``, the last two the
    metric entries of ``BENCHMARK.json`` that this cell reports."""
    bench = bench or spec()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"name": workload, "chips": entry["chips"],
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH_DIR / "traffic"
                                 / f"{entry['traffic']}.json"),
            "limits": load_json(BENCH_DIR / "limits" / f"{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str):
    """The metric's reader: a module with ``read(rec) -> float | None``."""
    return _module(BENCH_DIR / "metrics" / f"{metric}.py",
                   "_bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def model_sizes(conf: dict) -> dict:
    """The sizes the arithmetic and the reference read, from a
    configuration file's published keys; a number the file states under
    ``departures`` is what runs in its place."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return {"d": d, "f": conf["intermediate_size"],
            "L": conf["num_hidden_layers"], "H": H,
            "Hkv": conf["num_key_value_heads"],
            "hd": conf.get("head_dim") or d // H, "V": conf["vocab_size"],
            "E": conf.get("num_local_experts", 0),
            "k": conf.get("num_experts_per_tok", 0),
            "theta": conf["rope_theta"],
            "eps": conf.get("departures", {}).get("rms_norm_eps",
                                                  conf["rms_norm_eps"]),
            "window": conf.get("sliding_window"),
            "aux": conf.get("router_aux_loss_coef", 0.0),
            "capacity": conf.get("assumed", {}).get("moe_capacity_factor"),
            "dtype": conf["torch_dtype"]}
