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
(``torch.distributed`` already initialised, ``RANK`` / ``WORLD_SIZE``
/ ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment, as ``torchrun``
sets them, or ``--multihost``), each rank trains its shards of the state
on the ``(1, n)`` dp x tp mesh over the n ranks, as the reference lays
its state over all its devices, and every rank writes its own shards. As
in the reference it supports dense presets only: with an MoE preset it
exits (``SystemExit``), since MoE state shards over "ep" (call
``TrainCheckpointer`` with a mesh of your own).

``--sp ring`` (llama presets, not with ``--mode train``) loops the
long-context hot op instead: ring attention
(:mod:`~tpushare_torch.workloads.ringattention`) over the n ranks of the
process group (one without one), on bf16 q, k and v at the preset's
heads, each rank drawing its own chunk of the sequence from a generator
seeded with its rank. The sequence is rounded up to 128-aligned chunks
a rank; it prints ``step N: x ring/s (S=... over n devices) on cuda``.

``--multihost`` makes the process a gang member (``samples/6-gang.yaml``
runs ``--sp ring --multihost`` on each): it joins the gang's process
group from the rendezvous env the device plugin injects
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) through
:func:`~tpushare_torch.workloads.parallel.init_from_gang_env`, with one
rank per visible card (the member starts the others as processes of its
own), and prints ``multihost: process P of N, rank r of world w``.
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
                    help="sequence-parallel attention over the ranks of "
                         "the process group (ring = GQA-native ring "
                         "attention)")
    ap.add_argument("--multihost", action="store_true",
                    help="gang member: join the gang's process group from "
                         "COORDINATOR_ADDRESS, NUM_PROCESSES and "
                         "PROCESS_ID, one rank per visible card")
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


def _rank_mesh(device_type: str, names=("dp", "tp")):
    """The reference's ``(1, n)`` dp x tp mesh over this process's n
    ranks (``(n,)`` for one axis name), or None for one process. Joins
    the process group from the launcher's environment (``torchrun``'s
    variables) when it is not joined yet."""
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
    shape = (world,) if len(names) == 1 else (1, world)
    return parallel.make_mesh(device_type, shape, names)


def _gang_member(argv: list[str], index: int, local: int) -> None:
    """A gang member's local rank ``index`` > 0 of ``local``, in a
    process of its own: the same run."""
    run(argv, _local=(index, local))


def _start_gang(argv: list[str], local: int) -> list:
    """Start the member's local ranks 1..local-1 (beside this process's
    rank 0) as processes running the same arguments."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gang_member, args=(argv, i, local),
                         daemon=True) for i in range(1, local)]
    for p in procs:
        p.start()
    return procs


def _ring_run(args, cfg, device):
    """(run_once, unit, n, held) of ``--sp ring``: this rank's chunk of
    bf16 q, k and v (in ``held``, with the last call's output chunk as
    ``held["out"]``), and ring attention over the group's ranks."""
    import torch.distributed as dist
    from tpushare_torch.workloads.ringattention import ring_attention
    mesh = _rank_mesh(device.type, names=("sp",))
    n = 1 if mesh is None else mesh.size()
    rank = dist.get_rank() if mesh is not None else 0
    # ring needs S divisible by the ranks; round UP to a 128-aligned
    # chunk a rank so any --seq works
    chunk = -(-max(args.seq, 128 * n) // (128 * n)) * 128
    gen = torch.Generator(device=device).manual_seed(rank)

    def draw(heads):
        return torch.randn((args.batch, heads, chunk, cfg.head_dim),
                           generator=gen, device=device).to(torch.bfloat16)

    held = {"q": draw(cfg.n_heads), "k": draw(cfg.n_kv_heads),
            "v": draw(cfg.n_kv_heads)}

    def run_once():
        with torch.inference_mode():
            held["out"] = ring_attention(held["q"], held["k"], held["v"],
                                         mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return run_once, f"ring/s (S={chunk * n} over {n} devices)", n, held


def run(argv: list[str] | None = None, return_state: bool = False,
        _local: tuple[int, int] | None = None) -> dict:
    """Parse ``argv`` and run the player. Returns ``{"device", "mode",
    "start_step", "steps", "step_s", "losses", "resume_s", "save_s"}``:
    the step the run started from (non-zero when it resumed from
    ``--ckpt-dir``), the step it ended at, the host seconds of each step
    it ran (each ends synchronised with the device; checkpoint saves are
    not in them), in train mode each step's loss, and with
    ``--ckpt-dir`` the seconds of the resume-or-init call and of each
    save; ``"world"``, the ranks of its process group (1 without one).
    ``return_state`` adds the final ``"params"`` (and in train mode
    ``"opt_state"``); with ``--sp ring``, ``"ring"``: this rank's q, k,
    v and last output chunk."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None and args.mode != "train":
        ap.error("--ckpt-dir requires --mode train (forward and "
                 "--sp ring modes do not checkpoint)")
    cfg, init_fn, make_train, fwd_fn, batch_fn = _family(ap, args)
    if args.sp == "ring" and args.mode == "train":
        ap.error("--sp ring runs the ring-attention loop (the long-context "
                 "hot op); it does not train the model - drop --mode train "
                 "or --sp ring")
    if args.ckpt_dir is not None and getattr(cfg, "moe_experts", 0):
        raise SystemExit(
            "--ckpt-dir train mode supports dense presets; MoE state shards "
            "over 'ep' (use TrainCheckpointer directly on one process)")

    from tpushare_torch.contract import (
        ENV_HBM_CHIP_TOTAL, ENV_HBM_LIMIT, ENV_VISIBLE_CHIPS)
    from tpushare_torch.workloads.hbm import (
        ENV_ALLOC_CONF, ENV_CUDA_VISIBLE, apply_hbm_gating)
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
    gang = []
    if args.multihost:
        # a member runs one rank per visible card: this process is its
        # local rank 0 and starts the others (``_local`` is (index,
        # count) in those)
        from tpushare_torch.workloads import parallel
        index, local = _local or (0, parallel.gang_local_ranks(device.type))
        if index == 0:
            gang = _start_gang(argv if argv is not None else sys.argv[1:],
                               local)
        joined = parallel.init_from_gang_env(device.type, index, local)
        print(f"multihost: process {joined['process']} of "
              f"{joined['processes']}, rank {joined['rank']} of world "
              f"{joined['world']}, transport {joined['backend']}",
              flush=True)
    try:
        return _run(args, cfg, init_fn, make_train, fwd_fn, batch_fn,
                    device, return_state)
    finally:
        import torch.distributed as dist
        if args.multihost and dist.is_initialized():
            dist.destroy_process_group()
        for p in gang:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _run(args, cfg, init_fn, make_train, fwd_fn, batch_fn, device,
         return_state):
    from tpushare_torch.workloads import resolve_device
    from tpushare_torch.workloads.hbm import apply_memory_fraction
    # a sharded checkpointed trainer joins its ranks first: that picks
    # each rank's card
    mesh = _rank_mesh(device.type) if args.ckpt_dir else None
    if mesh is not None or args.multihost:
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

    world, held = 1, None
    if args.sp == "ring":
        run_once, unit, world, held = _ring_run(args, cfg, device)
    elif args.mode == "train":
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
    import torch.distributed as dist
    record = {"device": str(device), "mode": args.mode, "start_step": start,
              "steps": done, "step_s": step_s, "losses": losses,
              "resume_s": resume_s, "save_s": save_s,
              "world": dist.get_world_size() if dist.is_initialized()
              else world}
    if return_state and held is not None:
        record["ring"] = held
    elif return_state:
        record["params"] = params
        if opt_state is not None:
            record["opt_state"] = opt_state
    return record


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
