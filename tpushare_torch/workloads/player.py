"""Binpack-demo tenant: the port of ``tpushare/workloads/player.py``.

    python -m tpushare_torch.workloads.player --preset llama-tiny \\
        --mode train --attn flash --steps 2 --device cpu
    python -m tpushare_torch.workloads.player --preset vit-tiny \\
        --mode train --attn flash --steps 4 --batch 2 --device cpu \\
        --ckpt-dir /tmp/vit-ckpt --ckpt-every 2

It applies the HBM grant (:func:`~tpushare_torch.workloads.hbm.apply_hbm_gating`
before CUDA initialises, the memory fraction after), echoes the grant env,
and loops either a forward pass (``--mode forward``) or a full forward,
backward and AdamW step (``--mode train``), with random weights from seed
0, as the reference does. The preset picks the family: llama presets run
an all-zero ``[batch, seq]`` token batch, ViT presets (``vit-b16``,
``vit-tiny``) an all-zero ``[batch, image, image, channels]`` image
batch with labels 0. ``--steps`` is a total (0 runs forever); it prints
``step N: x train/s on cuda`` every 50 steps and at the last.
``--device`` defaults to ``cuda`` and raises without it.

The MoE presets (``llama-moe-tiny``) train and run forward on one card.

``--ckpt-dir`` (train mode) resumes from the latest step there and saves
every ``--ckpt-every`` steps through
:class:`~tpushare_torch.workloads.checkpoint.TrainCheckpointer`; a
resumed run finishes what is left of ``--steps`` (resumed at step 2 of
``--steps 3``, it runs one step). Run as the ranks of a process group
(``torch.distributed`` already initialised, or ``RANK`` / ``WORLD_SIZE``
/ ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment, as ``torchrun``
sets them), each rank trains its shards of the state on the ``(1, n)``
dp x tp mesh over the n ranks, as the reference lays its state over all
its devices, and every rank writes its own shards. As in the reference
it supports dense presets only: with an MoE preset it exits
(``SystemExit``), since MoE state shards over "ep" (call
``TrainCheckpointer`` with a mesh of your own).

Not ported yet, and refused with ``NotImplementedError``: ``--sp ring``
and ``--multihost`` (ROADMAP.md Queue 1 item 13, the sharded slice).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch


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
                    help="train mode: checkpoint/resume directory — on "
                         "start the latest step there is restored, and "
                         "every --ckpt-every steps the state is saved "
                         "durably")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    return ap


def _family(ap, args):
    """The one family dispatch site: (cfg, init_fn, make_train,
    forward_fn, batch_fn), fixed together so they never pair across
    families. ``batch_fn(device)`` makes the all-zero batch."""
    from tpushare_torch.workloads import model
    if args.preset in model.PRESETS:
        cfg = dataclasses.replace(model.PRESETS[args.preset],
                                  attn=args.attn).validate()

        def batch(device):
            return (torch.zeros((args.batch, args.seq), dtype=torch.long,
                                device=device),)

        return (cfg, model.init_params, model.make_train_step,
                model.forward, batch)
    from tpushare_torch.workloads import vit
    if args.preset not in vit.PRESETS_VIT:
        ap.error(f"unknown preset {args.preset!r}")
    if args.sp == "ring":
        ap.error("--sp ring is a llama-attention mode; vit presets run "
                 "--mode forward/train")
    cfg = dataclasses.replace(vit.PRESETS_VIT[args.preset],
                              attn=args.attn).validate()

    def batch(device):
        return (torch.zeros((args.batch, cfg.image, cfg.image, cfg.channels),
                            device=device),
                torch.zeros((args.batch,), dtype=torch.long, device=device))

    return (cfg, vit.init_vit_params, vit.make_vit_train_step,
            vit.vit_forward, batch)


def _refuse_unported(args) -> None:
    if args.sp == "ring":
        raise NotImplementedError(
            "--sp ring: ring attention is not ported yet (ROADMAP.md "
            "Queue 1 item 13, the sharded slice)")
    if args.multihost:
        raise NotImplementedError(
            "--multihost: multi-process gangs are not ported yet "
            "(ROADMAP.md Queue 1 item 13, the sharded slice)")


def _rank_mesh(device_type: str):
    """The reference's ``(1, n)`` dp x tp mesh over this process's n
    ranks, or None for one process. Joins the process group from the
    launcher's environment (``torchrun``'s variables) when it is not
    joined yet."""
    import torch.distributed as dist
    from tpushare_torch.workloads import parallel
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return None
        rank = int(os.environ["RANK"])
        parallel.init_rank(rank, world, "tcp://{}:{}".format(
            os.environ.get("MASTER_ADDR", "localhost"),
            os.environ["MASTER_PORT"]), device_type)
    world = dist.get_world_size()
    if world == 1:
        return None
    return parallel.make_mesh(device_type, (1, world))


def run(argv: list[str] | None = None, return_state: bool = False) -> dict:
    """Parse ``argv`` and run the player. Returns ``{"device", "mode",
    "start_step", "steps", "step_s", "losses", "resume_s", "save_s"}``:
    the step the run started from (non-zero when it resumed from
    ``--ckpt-dir``), the step it ended at, the host seconds of each step
    it ran (each ends synchronised with the device; checkpoint saves are
    not in them), in train mode each step's loss, and with
    ``--ckpt-dir`` the seconds of the resume-or-init call and of each
    save. ``return_state`` adds the final ``"params"`` (and in train mode
    ``"opt_state"``)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None and args.mode != "train":
        ap.error("--ckpt-dir requires --mode train (forward and "
                 "--sp ring modes do not checkpoint)")
    cfg, init_fn, make_train, fwd_fn, batch_fn = _family(ap, args)
    _refuse_unported(args)
    if args.ckpt_dir is not None and getattr(cfg, "moe_experts", 0):
        raise SystemExit(
            "--ckpt-dir train mode supports dense presets; MoE state shards "
            "over 'ep' (use TrainCheckpointer directly on one process)")

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
    device = resolve_device(args.device)
    # a sharded checkpointed trainer joins its ranks first: that picks
    # each rank's card
    mesh = _rank_mesh(device.type) if args.ckpt_dir else None
    if mesh is not None:
        device = resolve_device(device.type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        fraction = apply_memory_fraction()
        if fraction is not None:
            print(f"memory fraction: {fraction:.4f}", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    batch = batch_fn(device)
    losses: list[float] = []
    opt_state = None
    start = 0
    resume_s = None
    save = None

    if args.mode == "train":
        tx, train_step = make_train(cfg)
        ckpt = None
        if args.ckpt_dir:
            from tpushare_torch.workloads.checkpoint import TrainCheckpointer
            ckpt = TrainCheckpointer(args.ckpt_dir)
            t_resume = time.perf_counter()
            params, opt_state, start = ckpt.resume_or_init(cfg, tx, gen,
                                                           mesh=mesh)
            resume_s = time.perf_counter() - t_resume
            if start:
                print(f"resumed from step {start} ({args.ckpt_dir})",
                      flush=True)
        else:
            from tpushare_torch.workloads.model import train_params
            params = train_params(init_fn(cfg, gen))
            opt_state = tx.init(params)
        trained = start

        def run_once():
            nonlocal params, opt_state, trained
            params, opt_state, loss = train_step(params, opt_state, *batch)
            losses.append(float(loss))  # waits for the step to finish
            trained += 1

        if ckpt is not None:
            def save() -> bool:
                return ckpt.maybe_save(trained, params, opt_state, cfg,
                                       every=args.ckpt_every)

        unit = "train/s"
    else:
        params = init_fn(cfg, gen)

        def run_once():
            with torch.inference_mode():
                fwd_fn(params, batch[0], cfg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        unit = "fwd/s"

    # --steps is a total budget: a resumed trainer finishes the remainder
    step_s: list[float] = []
    save_s: list[float] = []
    done = start
    t0 = time.perf_counter()
    while args.steps == 0 or done < args.steps:
        t_step = time.perf_counter()
        run_once()
        step_s.append(time.perf_counter() - t_step)
        if save is not None:
            t_save = time.perf_counter()
            if save():
                save_s.append(time.perf_counter() - t_save)
        done += 1
        if done % 50 == 0 or done == args.steps:
            dt = time.perf_counter() - t0
            print(f"step {done}: {(done - start) / dt:.1f} {unit} on "
                  f"{device.type}", flush=True)
    record = {"device": str(device), "mode": args.mode, "start_step": start,
              "steps": done, "step_s": step_s, "losses": losses,
              "resume_s": resume_s, "save_s": save_s}
    if return_state:
        record["params"] = params
        if opt_state is not None:
            record["opt_state"] = opt_state
    return record


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
