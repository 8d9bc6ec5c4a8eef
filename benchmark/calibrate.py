"""Readings that set a cell's rate and limits, run on the card apart from
the benchmark's own runs (which never run this).

    python3 benchmark/calibrate.py sweep --workload mistral-7b.chat \\
        --seed 5 --rates 1.5,2,2.5 --seconds 30
    python3 benchmark/calibrate.py seeds --workload mistral-7b.chat \\
        --seeds 1,2,3 --control-seeds 1,2 --seconds 10

``sweep`` sets the replica up once and offers the cell's traffic at each
rate in turn, waiting for every request due, and prints each rate's
tails and completed tokens per second: the highest rate it sustains is
the knee. ``seeds`` runs the cell's whole driver once a seed in one
process, the window as short as given, and prints the numbers the check
compares (the lower readings of their limits). On ``--control-seeds``
it also prints the control's readings (the upper ones): for a served
cell the reference with int4 products (the precision below the
configuration's int8); for a training cell the reference with every
product's operands in fp8 (below bf16), and the planted fault of a loss
taken over half of each row's positions. Each reading is one JSON line
on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells, check, traffic as gen  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.run import Ctx, log  # noqa: E402
from benchmark.trace import Spans  # noqa: E402

SERVE_CONTROL = ref.Precision(weight_bits=4, kv_bits=8)
TRAIN_CONTROL = ref.Precision(fp8=True)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def sweep(cell, seed: int, rates: list, seconds: float, device: str):
    from benchmark.drivers import serve
    tr = cell["traffic"]
    m = cells.model_sizes(cell["config"])
    ctx = Ctx(cell, seed, seconds, False, device, time.perf_counter())
    scheds = [gen.schedule(tr, seed + i, seconds, m["V"], rate=r)
              for i, r in enumerate(rates)]
    with serve.replica(ctx, m, [len(q.prompt) for s in scheds for q in s]) \
            as front:
        for rate, sched in zip(rates, scheds):
            t0 = time.perf_counter()
            served = serve._window(ctx, front, sched, Spans(), {}, None)
            ok = [r for r in served if r.ok]
            ttft = sorted(r.first - r.due for r in ok)
            third = max(1, len(ok) // 3)
            emit({"rate": rate, "attempted": len(served),
                  "failed": len(served) - len(ok),
                  **serve.summarize(served),
                  "ttft_p50_ms": serve.percentile(ttft, 50) * 1e3,
                  "ttft_first_third_ms": sum(
                      r.first - r.due for r in ok[:third]) / third * 1e3,
                  "ttft_last_third_ms": sum(
                      r.first - r.due for r in ok[-third:]) / third * 1e3,
                  "tokens_per_s": sum(len(r.tokens) for r in ok)
                  / (max(r.last for r in ok) - min(r.due for r in ok)),
                  "elapsed_s": time.perf_counter() - t0})


def seeds(cell, seed_list: list, control: set, seconds: float, device):
    import torch
    drv = cells.driver(cell["traffic"]["kind"])
    m = cells.model_sizes(cell["config"])
    for seed in seed_list:
        ctx = Ctx(cell, seed, seconds, False, device, time.perf_counter())
        t0 = time.perf_counter()
        out = drv.run(ctx)
        line = {"seed": seed, "setup_s": ctx.setup_s, **out["numbers"],
                "attempted": out["attempted"], "failed": out["failed"],
                "end_to_end": out["end_to_end"],
                "memory_peak_bytes": out["record"].get("memory_peak_bytes"),
                "run_s": time.perf_counter() - t0}
        if seed in control:
            t1 = time.perf_counter()
            dev = torch.device(device)
            if cell["traffic"]["kind"] == "serve":
                line["control"] = check.serve_numbers(
                    m, seed, cell["traffic"], out["picked"], dev,
                    control=SERVE_CONTROL)
            else:
                reference = out["reference"]
                line["control"] = check.train_numbers(check.train_reference(
                    m, seed, cell["traffic"], dev, TRAIN_CONTROL), reference)
                line["fault_half_rows"] = check.train_numbers(
                    check.train_reference(m, seed, cell["traffic"], dev,
                                          loss_share=0.5), reference)
            line["control_s"] = time.perf_counter() - t1
        if "program" in out:
            line["losses"] = out["program"]["losses"]
            line["ref_losses"] = out["reference"]["losses"]
        emit(line)
        del out
        log(f"seed {seed} done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("mode", choices=("sweep", "seeds"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("calibrate runs on a CUDA card")
        return 2
    cell = cells.cell(args.workload)
    if args.mode == "sweep":
        sweep(cell, args.seed, [float(r) for r in args.rates.split(",")],
              args.seconds, "cuda:0")
    else:
        seeds(cell, [int(s) for s in args.seeds.split(",")],
              {int(s) for s in args.control_seeds.split(",") if s},
              args.seconds, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
