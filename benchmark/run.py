"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 benchmark/run.py --workload mistral-7b.chat --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout, on a machine with as many CUDA cards as
the cell asks for; without them it exits 2 and prints no result. The
cell's traffic file names its driver (``drivers/<kind>.py``), which
sets up, measures for ``--seconds`` and checks what the timed path
produced against the plain reference. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (each read by
``metrics/<name>.py``), the device's busy time and a breakdown. The last
key of the line, ``checks``, holds each number compared beside its
limit, and so do the last lines on standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# caches of anything that builds at run time stay inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / "bench-cache" / _sub))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpushare")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Ctx:
    """What a driver gets: the cell, the run's arguments, and where it
    marks the window's opening (set-up ends there, less the time its
    checks read before it)."""

    def __init__(self, cell, seed, seconds, trace, device, t_start):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.check_s = 0.0
        self.t_window = None
        self.log = log

    def window_open(self, t: float) -> None:
        self.t_window = t
        self.mark("window opens")

    def mark(self, what: str) -> None:
        """Log how far set-up has come (seconds since the process began)."""
        self.log(f"set-up: {what} at {time.perf_counter() - self.t_start:.1f} s")

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_start - self.check_s


def _finite(x):
    return x if isinstance(x, (int, float)) and x == x \
        and abs(x) != float("inf") else None


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def execute(cell: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of ``cell`` (as :func:`benchmark.cells.cell` returns it):
    the result line's object. Takes no notice of whether the device is a
    card; :func:`main` does."""
    import torch

    from benchmark import cells

    ctx = Ctx(cell, seed, seconds, trace, device,
              T_START if t_start is None else t_start)
    out = cells.driver(cell["traffic"]["kind"]).run(ctx)
    rec = out["record"]
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = cells.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": _finite(value),
                                      "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell["end_to_end"]:
            value = (ctx.setup_s if m["name"] == "setup_s"
                     else out["end_to_end"].get(m["name"]))
            metrics[m["name"]] = {"value": _finite(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(torch.device(device))
                    if device.startswith("cuda") else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    result = {"correct": None, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and "trace" in rec:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    limits = cell["limits"]
    checks = {name: {"value": _finite(out["numbers"][name]),
                     "limit": limits[name]} for name in limits}
    for name, value in out["numbers"].items():
        if name not in limits:
            log(f"reading {name} {value!r} (not compared)")
    result["correct"] = (out["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import cells
    cell = cells.cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); torch "
            f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     device="cuda:0")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark measures the port alone")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
