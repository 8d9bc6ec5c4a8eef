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
of the port's parallel layouts, and the sequence- and pipeline-parallel
parities, over ``n`` ranks (processes of their own; on the CPU, gloo
ranks).
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
    """The reference's dry run over ``n_devices`` ranks on ``device``
    ("cpu": gloo ranks, the analogue of the reference's 8-device CPU
    mesh): the dp x tp llama-tiny step on the most square mesh, whose wq
    placement must survive the update; ring attention over all ranks
    (causal, GQA and zigzag, fp32) and Ulysses with a window of S/2, each
    against ``attention_reference`` within 1e-4; the dp x tp x ep
    llama-moe-tiny step with ep = 2 (for an even count); the GPipe
    pipeline over min(4, n) stages of llama-tiny at one layer a stage,
    its logits against the sequential forward within 1e-3, and one
    pipelined train step; the dp x tp ViT step. Raises on a miss or a
    non-finite loss; prints and returns one line."""
    from tpushare_torch.workloads import parallel, resolve_device
    device_type = resolve_device(device).type
    results = parallel.run_ranks(_dryrun_rank, n_devices, n_devices,
                                 device_type, device_type=device_type)
    r = results[0]
    line = (f"dryrun_multichip ok: dp={r['dp']} x tp={r['tp']} "
            f"loss={r['loss']:.4f}; sp ring attention x{n_devices} "
            f"err={r['err']:.2e} gqa-ring err={r['err_g']:.2e} zigzag "
            f"err={r['err_z']:.2e} ulysses-window err={r['err_u']:.2e}; "
            f"ep moe loss={r['moe_loss']:.4f}; pp x{r['pp']} "
            f"err={r['pp_err']:.2e} loss={r['pp_loss']:.4f}; "
            f"vit dp x tp loss={r['vit_loss']:.4f}")
    print(line, flush=True)
    return line


def _dryrun_seq(n: int, device_type: str, dev, gen) -> dict:
    """Ring (causal, GQA, zigzag) and Ulysses with a window over all n
    ranks, fp32, each against ``attention_reference`` on the whole
    sequence."""
    from tpushare_torch.workloads import model, parallel
    from tpushare_torch.workloads.attention import attention_reference
    from tpushare_torch.workloads.ringattention import (
        gather_seq, ring_attention, shard_seq, zigzag_inverse, zigzag_order)
    from tpushare_torch.workloads.ulysses import ulysses_attention

    cfg = model.PRESETS["llama-tiny"]
    sp = parallel.make_mesh(device_type, (n,), ("sp",))
    B, H, S, D = 2, cfg.n_heads, 16 * n, cfg.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def err(got, want):
        return float((got - want).abs().max())

    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    ref = attention_reference(q, k, v, causal=True)
    out = {}
    with torch.no_grad():
        ring = gather_seq(ring_attention(*(shard_seq(t, sp) for t in
                                           (q, k, v)), sp), sp)
        out["err"] = err(ring, ref)
        # GQA-native: the small kv heads ride the ring
        Hkv = max(H // 2, 1)
        kg, vg = k[:, :Hkv], v[:, :Hkv]
        ring_g = gather_seq(ring_attention(*(shard_seq(t, sp) for t in
                                             (q, kg, vg)), sp), sp)
        g = H // Hkv
        out["err_g"] = err(ring_g, attention_reference(
            q, kg.repeat_interleave(g, 1), vg.repeat_interleave(g, 1)))
        perm, inv = zigzag_order(S, n), zigzag_inverse(S, n)
        ring_z = gather_seq(ring_attention(
            *(shard_seq(t[:, :, perm], sp) for t in (q, k, v)), sp,
            zigzag=True), sp)
        out["err_z"] = err(ring_z[:, :, inv], ref)
        # Ulysses needs H divisible by the ranks: fresh arrays with H = n
        qu, ku, vu = randn(B, n, S, D), randn(B, n, S, D), randn(B, n, S, D)
        W = S // 2
        uly = gather_seq(ulysses_attention(
            *(shard_seq(t, sp) for t in (qu, ku, vu)), sp, causal=True,
            window=W), sp)
        out["err_u"] = err(uly, attention_reference(qu, ku, vu, causal=True,
                                                    window=W))
    for name in ("err", "err_g", "err_z", "err_u"):
        if not out[name] < 1e-4:
            raise AssertionError(f"sequence-parallel {name} mismatch: "
                                 f"{out[name]}")
    return out


def _dryrun_pp(n: int, device_type: str, dev, gen) -> dict:
    """The GPipe pipeline over the first min(4, n) ranks, one llama-tiny
    layer a stage: logits against the sequential forward, then one
    pipelined train step."""
    import dataclasses
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from tpushare_torch.workloads import model
    from tpushare_torch.workloads.pipeline import (
        make_pipelined_train_step, pipelined_forward)

    pp = min(4, n)
    group = dist.new_group(list(range(pp)))
    cfg = dataclasses.replace(model.PRESETS["llama-tiny"], n_layers=pp)
    params = model.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (2 * pp, 12), generator=gen,
                           device=dev)
    if dist.get_rank() >= pp:
        return {"pp": pp, "pp_err": float("nan"), "pp_loss": float("nan")}
    mesh = DeviceMesh.from_group(group, device_type, mesh_dim_names=("pp",))
    with torch.no_grad():
        got = pipelined_forward(params, tokens, cfg, mesh)
        want = model.forward(params, tokens, cfg)
    err = float((got - want).abs().max())
    if not err < 1e-3:
        raise AssertionError(f"pipeline/sequential mismatch: {err}")
    tparams = model.train_params(params)
    tx, step = make_pipelined_train_step(cfg, mesh)
    _, _, loss = step(tparams, tx.init(tparams), tokens)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"non-finite pipeline loss {float(loss)}")
    return {"pp": pp, "pp_err": err, "pp_loss": float(loss)}


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

    seq = _dryrun_seq(n, device_type, dev, gen(2))

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

    pipe = _dryrun_pp(n, device_type, dev, gen(8))

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
            "vit_loss": float(vloss), **seq, **pipe}
