"""Binpack-demo tenant: the port of ``tpushare/workloads/player.py``.

    python -m tpushare_torch.workloads.player --preset llama-tiny \\
        --mode train --attn flash --steps 2 --device cpu

It applies the HBM grant (:func:`~tpushare_torch.workloads.hbm.apply_hbm_gating`
before CUDA initialises, the memory fraction after), echoes the grant env,
and loops either a forward pass (``--mode forward``) or a full forward,
backward and AdamW step (``--mode train``) of a llama preset, with random
weights from seed 0 over an all-zero ``[batch, seq]`` batch, as the
reference does. ``--steps`` is a total (0 runs forever); it prints
``step N: x train/s on cuda`` every 50 steps and at the last.
``--device`` defaults to ``cuda`` and raises without it.

Not ported yet, and refused with ``NotImplementedError``: ``--ckpt-dir``
(ROADMAP.md Queue 1 item 10), ``--sp ring`` and ``--multihost`` (item 13,
the sharded slice), the ViT presets (item 11) and the MoE presets
(item 13).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

# the reference's ViT presets (tpushare/workloads/vit.py PRESETS_VIT)
VIT_PRESETS = ("vit-b16", "vit-tiny")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpushare-torch-player")
    ap.add_argument("--preset", default="llama-tiny")
    ap.add_argument("--steps", type=int, default=0,
                    help="forward/train passes to run (0 = run forever)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", choices=["forward", "train"],
                    default="forward",
                    help="train = full fwd+bwd+adamw step")
    ap.add_argument("--attn", choices=["einsum", "flash"],
                    default="einsum")
    ap.add_argument("--sp", choices=["none", "ring"], default="none",
                    help="sequence-parallel attention (not ported yet)")
    ap.add_argument("--multihost", action="store_true",
                    help="multi-process gang member (not ported yet)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="train mode: checkpoint/resume directory (not "
                         "ported yet)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    return ap


def _refuse_unported(ap, args, presets) -> None:
    if args.ckpt_dir is not None:
        if args.mode != "train":
            ap.error("--ckpt-dir requires --mode train (forward and "
                     "--sp ring modes do not checkpoint)")
        raise NotImplementedError(
            "--ckpt-dir: checkpoint/resume is not ported yet (ROADMAP.md "
            "Queue 1 item 10)")
    if args.sp == "ring":
        raise NotImplementedError(
            "--sp ring: ring attention is not ported yet (ROADMAP.md "
            "Queue 1 item 13, the sharded slice)")
    if args.multihost:
        raise NotImplementedError(
            "--multihost: multi-process gangs are not ported yet "
            "(ROADMAP.md Queue 1 item 13, the sharded slice)")
    if args.preset in VIT_PRESETS:
        raise NotImplementedError(
            f"--preset {args.preset}: the ViT family is not ported yet "
            "(ROADMAP.md Queue 1 item 11)")
    if args.preset not in presets:
        ap.error(f"unknown preset {args.preset!r}")
    if presets[args.preset].moe_experts:
        raise NotImplementedError(
            f"--preset {args.preset}: MoE presets are not ported yet "
            "(ROADMAP.md Queue 1 item 13: expert parallel)")


def run(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` and run the player. Returns ``{"device", "mode",
    "steps", "step_s", "losses"}``: the host seconds of each step (each
    ends synchronised with the device) and, in train mode, each step's
    loss."""
    ap = _parser()
    args = ap.parse_args(argv)

    from tpushare_torch.workloads.model import PRESETS
    _refuse_unported(ap, args, PRESETS)

    from tpushare_torch.contract import (
        ENV_HBM_CHIP_TOTAL, ENV_HBM_LIMIT, ENV_VISIBLE_CHIPS)
    from tpushare_torch.workloads.hbm import (
        ENV_ALLOC_CONF, ENV_CUDA_VISIBLE, apply_hbm_gating,
        apply_memory_fraction)
    applied = apply_hbm_gating()  # before CUDA initialises

    # echo the contract env like the reference player; the allocator
    # settings stand where the reference echoes XLA's memory fraction
    for var in (ENV_VISIBLE_CHIPS, ENV_HBM_LIMIT, ENV_HBM_CHIP_TOTAL,
                ENV_CUDA_VISIBLE, ENV_ALLOC_CONF):
        print(f"{var}={os.environ.get(var, '<unset>')}", flush=True)
    if applied:
        print(f"gating applied: {applied}", flush=True)

    from tpushare_torch.workloads import resolve_device
    from tpushare_torch.workloads.model import (
        forward, init_params, make_train_step, train_params)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        fraction = apply_memory_fraction()
        if fraction is not None:
            print(f"memory fraction: {fraction:.4f}", flush=True)

    cfg = dataclasses.replace(PRESETS[args.preset],
                              attn=args.attn).validate()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    batch = torch.zeros((args.batch, args.seq), dtype=torch.long,
                        device=device)
    losses: list[float] = []

    if args.mode == "train":
        params = train_params(params)
        tx, train_step = make_train_step(cfg)
        opt_state = tx.init(params)

        def run_once():
            nonlocal params, opt_state
            params, opt_state, loss = train_step(params, opt_state, batch)
            losses.append(float(loss))  # waits for the step to finish

        unit = "train/s"
    else:
        def run_once():
            with torch.inference_mode():
                forward(params, batch, cfg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        unit = "fwd/s"

    step_s: list[float] = []
    done = 0
    t0 = time.perf_counter()
    while args.steps == 0 or done < args.steps:
        t_step = time.perf_counter()
        run_once()
        step_s.append(time.perf_counter() - t_step)
        done += 1
        if done % 50 == 0 or done == args.steps:
            dt = time.perf_counter() - t0
            print(f"step {done}: {done / dt:.1f} {unit} on {device.type}",
                  flush=True)
    return {"device": str(device), "mode": args.mode, "steps": done,
            "step_s": step_s, "losses": losses}


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
