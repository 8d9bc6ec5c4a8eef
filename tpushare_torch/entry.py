"""Entry points of the port: the compile check and the multi-device dry
run.

:func:`entry` is the counterpart of ``__graft_entry__.entry``: returns
``(fn, args)`` where ``fn(*args)`` is the llama-mini forward on a batch
of 2 x 128 random tokens, with weights and tokens drawn from fixed seeds
on ``device``. ``attn="flash"`` (the default) routes every layer's
attention through the flash-attention kernel; ``attn="einsum"`` is the
plain path it is compared with.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: one sharded training step of each
of the port's parallel layouts, over ``n`` ranks (processes of their
own; on the CPU, gloo ranks).
"""

from __future__ import annotations

import dataclasses
import functools

import torch


def entry(device="cuda", attn: str = "flash"):
    """(fn, example_args) for the llama-mini forward, B=2, S=128."""
    from tpushare_torch.workloads import resolve_device
    from tpushare_torch.workloads.model import PRESETS, forward, init_params

    dev = resolve_device(device)
    cfg = dataclasses.replace(PRESETS["llama-mini"], attn=attn).validate()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 128), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    return functools.partial(forward, cfg=cfg), (params, tokens)


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """One training step of each sharded layout over ``n_devices`` ranks
    on ``device`` ("cpu": gloo ranks, the analogue of the reference's
    8-device CPU mesh), as the reference's dry run: the dp x tp
    llama-tiny step on the most square mesh, whose wq placement must
    survive the update; the dp x tp x ep llama-moe-tiny step with ep = 2
    (for an even count); the dp x tp ViT step. Raises on a non-finite
    loss; prints and returns one line. The reference's sequence and
    pipeline parts are not ported (ROADMAP.md Queue 1 item 13)."""
    from tpushare_torch.workloads import parallel, resolve_device
    device_type = resolve_device(device).type
    results = parallel.run_ranks(_dryrun_rank, n_devices, n_devices,
                                 device_type, device_type=device_type)
    r = results[0]
    line = (f"dryrun_multichip ok: dp={r['dp']} x tp={r['tp']} "
            f"loss={r['loss']:.4f}; ep moe loss={r['moe_loss']:.4f}; "
            f"vit dp x tp loss={r['vit_loss']:.4f}; sp (ring attention, "
            f"Ulysses) and pp not ported (ROADMAP.md Queue 1 item 13)")
    print(line, flush=True)
    return line


def _dryrun_rank(n: int, device_type: str) -> dict:
    import math

    from tpushare_torch.workloads import model, parallel, vit
    from tpushare_torch.workloads.parallel import P

    dev = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def rows(t, mesh):
        return parallel.local_shard(t, P("dp", *([None] * (t.dim() - 1))),
                                    mesh)

    dp, tp = parallel.most_square(n)
    mesh = parallel.make_mesh(device_type, (dp, tp))
    cfg = model.PRESETS["llama-tiny"]
    params = model.train_params(model.init_params(cfg, gen(0), mesh=mesh))
    batch = max(dp * 2, 2)
    tokens = torch.randint(0, cfg.vocab, (batch, 16), generator=gen(1),
                           device=dev)
    tx, step = model.make_train_step(cfg)
    params, _, loss = step(params, tx.init(params), rows(tokens, mesh))
    if not math.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    # the parameters keep their tp placement through the update
    want = P(*model.param_specs(cfg)["layers"]["wq"][1:])
    got = parallel.spec_of(params["layers"][0]["wq"])
    if got != want:
        raise AssertionError(f"wq placement {got} after the step, not {want}")

    ep = 2 if n % 2 == 0 else 1
    moe_loss = float("nan")
    if ep > 1:
        dpe, tpe = parallel.most_square(n // ep)
        moe_mesh = parallel.make_mesh(device_type, (dpe, tpe, ep),
                                      parallel.MOE_AXES)
        mcfg = model.PRESETS["llama-moe-tiny"]
        mparams = model.train_params(model.init_params(mcfg, gen(3),
                                                       mesh=moe_mesh))
        mtokens = torch.randint(0, mcfg.vocab, (max(dpe * 2, 2), 16),
                                generator=gen(4), device=dev)
        mtx, mstep = model.make_train_step(mcfg)
        _, _, mloss = mstep(mparams, mtx.init(mparams),
                            rows(mtokens, moe_mesh))
        moe_loss = float(mloss)
        if not math.isfinite(moe_loss):
            raise AssertionError(f"non-finite MoE loss {moe_loss}")

    vcfg = vit.PRESETS_VIT["vit-tiny"]
    vparams = model.train_params(vit.init_vit_params(vcfg, gen(5),
                                                     mesh=mesh))
    images = torch.randn(batch, vcfg.image, vcfg.image, vcfg.channels,
                         generator=gen(6), device=dev)
    labels = torch.randint(0, vcfg.classes, (batch,), generator=gen(7),
                           device=dev)
    vtx, vstep = vit.make_vit_train_step(vcfg)
    _, _, vloss = vstep(vparams, vtx.init(vparams), rows(images, mesh),
                        rows(labels, mesh))
    if not math.isfinite(float(vloss)):
        raise AssertionError(f"non-finite vit loss {float(vloss)}")
    return {"dp": dp, "tp": tp, "loss": float(loss), "moe_loss": moe_loss,
            "vit_loss": float(vloss)}
