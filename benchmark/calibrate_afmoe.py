"""Readings that set an AFMoE training cell's limits, run on the card apart
from the benchmark's own runs (which never run this); the counterpart of
``benchmark/calibrate.py seeds`` for the ``train_afmoe`` driver.

    python3 benchmark/calibrate_afmoe.py --workload trinity-mini-l8.train-8k \\
        --seeds 1,2,3 --control-seeds 1,2 --seconds 5

Runs the cell's driver once a seed in one process, the window as short
as given, and prints the numbers the check compares (the lower readings
of their limits); on ``--control-seeds`` also the reference with every
product's operands in fp8 and the planted fault of a loss taken over
half of each row's positions (the upper readings). One JSON line a
reading on standard output.

    python3 benchmark/calibrate_afmoe.py --workload trinity-mini-l8.train-8k \\
        --router-steps 20 --seeds 1

follows the router instead: the program's train step and the plain
reference, each from the seed's weights and rows over that many steps
at the traffic's learning rate, and prints for each step and MoE layer
the pairs routed to the held experts and the largest expert load over
the mean (the readings of ``moe.route``'s ``held`` and ``max_load``).
``--sizes`` overrides the configuration's keys (a JSON object) and
``--rows B,S`` the traffic's rows, for a size that fits the CPU
(``--device cpu``; ``--program-dtype float32`` runs the program in
float32 too).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells, check, weights_afmoe  # noqa: E402
from benchmark.calibrate import TRAIN_CONTROL, emit  # noqa: E402
from benchmark.drivers import train_afmoe  # noqa: E402
from benchmark.run import Ctx, log  # noqa: E402


def seeds(cell, seed_list: list, control: set, seconds: float, device):
    import torch
    m = weights_afmoe.sizes(cell["config"])
    tr = cell["traffic"]
    for seed in seed_list:
        ctx = Ctx(cell, seed, seconds, False, device, time.perf_counter())
        t0 = time.perf_counter()
        out = train_afmoe.run(ctx)
        line = {"seed": seed, "setup_s": ctx.setup_s, **out["numbers"],
                "attempted": out["attempted"], "failed": out["failed"],
                "end_to_end": out["end_to_end"],
                "memory_peak_bytes": out["record"].get("memory_peak_bytes"),
                "losses": out["program"]["losses"],
                "ref_losses": out["reference"]["losses"],
                "run_s": time.perf_counter() - t0}
        if seed in control:
            t1 = time.perf_counter()
            dev = torch.device(device)
            reference = out["reference"]
            line["control"] = check.train_numbers(train_afmoe.train_reference(
                m, seed, tr, dev, TRAIN_CONTROL), reference)
            line["fault_half_rows"] = check.train_numbers(
                train_afmoe.train_reference(m, seed, tr, dev, loss_share=0.5),
                reference)
            line["control_s"] = time.perf_counter() - t1
        emit(line)
        del out
        log(f"seed {seed} done")


def router_steps(cell, seed: int, steps: int, device, program_dtype=None):
    """{"program": [...], "reference": [...]}: for each step, each MoE
    layer's pairs routed to the held experts and max load / mean load,
    from the loads the selection bias's update reads."""
    import torch
    from benchmark import weights
    from benchmark.reference import afmoe as ref
    from tpushare_torch.workloads import model as pm
    m = weights_afmoe.sizes(cell["config"])
    tr = cell["traffic"]
    dev = torch.device(device)
    held = m["held"]

    def reading(load):
        c = load.float()
        return [float(c[:held].sum()), float(c.max() / c.mean())]

    def per_step(loads, n_moe):
        return [loads[i:i + n_moe] for i in range(0, len(loads), n_moe)]

    n_moe = m["L"] - m["Ld"]
    cfg = train_afmoe.port_config(m, tr)
    if program_dtype is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=program_dtype)
    raw = weights_afmoe.draw(m, seed, dev)
    if program_dtype is not None:
        raw = {k: ({n: w if n in weights_afmoe.BUFFERS or n == "wg"
                    else w.to(program_dtype) for n, w in v.items()}
                   if k == "layers" else v.to(program_dtype))
               for k, v in raw.items()}
    loads: list = []
    real = pm.update_router_bias

    def seen(bias, load, rate, mesh=None):
        loads.append(reading(load))
        real(bias, load, rate, mesh)
    pm.update_router_bias = seen
    try:
        tx, train_step = pm.make_train_step(
            cfg, learning_rate=tr["learning_rate"])
        params = pm.train_params(raw)
        opt = tx.init(params)
        feed = weights.token_rows(seed, m["V"], tr["batch"], tr["seq"], dev)
        for _ in range(steps):
            params, opt, _loss = train_step(params, opt, next(feed))
    finally:
        pm.update_router_bias = real
    program = per_step(loads, n_moe)
    del params, opt, raw, train_step, tx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    loads = []
    real_moe = ref.moe

    def moe(u, lw, m_, prec, route=None):
        y, load = real_moe(u, lw, m_, prec, route)
        if not torch.is_grad_enabled():
            loads.append(reading(load))
        return y, load
    ref.moe = moe
    try:
        w = weights_afmoe.draw(m, seed, dev)
        feed = weights.token_rows(seed, m["V"], tr["batch"], tr["seq"], dev)
        ref.train(w, m, [next(feed) for _ in range(steps)],
                  ref.AdamW(lr=tr["learning_rate"]))
    finally:
        ref.moe = real_moe
    return {"program": program, "reference": per_step(loads, n_moe)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate_afmoe.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--router-steps", type=int, default=0)
    ap.add_argument("--sizes", default="{}")
    ap.add_argument("--rows", default="", help="batch,seq for the traffic's")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--program-dtype", default=None)
    args = ap.parse_args(argv)
    import torch
    if args.router_steps:
        cell = cells.cell(args.workload)
        cell["config"].update(json.loads(args.sizes))
        if args.rows:
            b, s = (int(x) for x in args.rows.split(","))
            cell["traffic"].update(batch=b, seq=s)
        dt = args.program_dtype and getattr(torch, args.program_dtype)
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            out = router_steps(cell, seed, args.router_steps, args.device, dt)
            emit({"seed": seed, "steps": args.router_steps,
                  "learning_rate": cell["traffic"]["learning_rate"],
                  "sizes": json.loads(args.sizes), "rows": args.rows,
                  **out,
                  "run_s": time.perf_counter() - t0})
        return 0
    if not torch.cuda.is_available():
        log("calibrate_afmoe runs on a CUDA card")
        return 2
    seeds(cells.cell(args.workload), [int(s) for s in args.seeds.split(",")],
          {int(s) for s in args.control_seeds.split(",") if s},
          args.seconds, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
