"""Rank-side halves of the port's multi-rank tests
(tests/test_torch_parallel.py, tests/test_torch_sharded.py,
tests/test_torch_ring.py, tests/test_torch_ulysses.py,
tests/test_torch_pipeline.py, tests/test_torch_afmoe.py).

Each function runs in every rank of a gloo world that
``tpushare_torch.workloads.parallel.run_ranks`` starts, with
``torch.distributed`` set up. They take numpy inputs and the JAX package's
results, computed by the test in its own process, and return plain numbers:
errors against those results and placements as specs. This module imports
no JAX, so that a spawned rank never pays for importing it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
from unittest import mock

import numpy as np
import torch

from tpushare_torch.workloads import checkpoint as ck
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import moe as tmoe
from tpushare_torch.workloads import parallel, player
from tpushare_torch.workloads import vit as tv
from tpushare_torch.workloads.convert import params_from_numpy
from tpushare_torch.workloads.parallel import P


def _rows(x, mesh):
    """This rank's rows of a batch (the "dp" shard)."""
    t = torch.as_tensor(np.asarray(x))
    return parallel.local_shard(t, P("dp", *([None] * (t.dim() - 1))), mesh)


def _leaf_errors(params, want: dict, specs: dict, mesh) -> np.ndarray:
    """|this rank's shard - the same shard of ``want``| of every leaf of a
    trainable tree, concatenated."""
    errs = []
    for name, w in tm.named_leaves(params):
        full = torch.as_tensor(np.asarray(want[name]))
        shard = parallel.local_shard(full, specs[name], mesh)
        errs.append((w.detach().to_local() - shard).abs().reshape(-1))
    return torch.cat(errs).numpy()


def _spec(t) -> tuple:
    return tuple(parallel.spec_of(t))


def parallel_checks(data: dict) -> dict:
    """The world of tests/test_torch_parallel.py."""
    out = {}

    # dp x tp llama-tiny fp32 train step (tests/test_workloads.py:82)
    d = data["dense"]
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=torch.float32)
    mesh = parallel.make_mesh("cpu", (2, 4))
    params = tm.train_params(parallel.distribute(
        params_from_numpy(d["params"]), tm.param_specs(cfg), mesh))
    tx, step = tm.make_train_step(cfg)
    params, _, loss = step(params, tx.init(params), _rows(d["tokens"], mesh))
    errs = _leaf_errors(params, d["updated"], ck.leaf_specs(cfg), mesh)
    out["dense"] = {"loss": float(loss), "max": float(errs.max()),
                    "mean": float(errs.mean()),
                    "wq": _spec(params["layers"][0]["wq"])}

    # the sharded int8 forward on a (1, 8) mesh (tests/test_workloads.py:106)
    q = data["int8"]
    mesh18 = parallel.make_mesh("cpu", (1, 8))
    cfg16 = tm.PRESETS["llama-tiny"]
    qp = tm.quantize_int8(params_from_numpy(q["params"]))
    qp = parallel.distribute(qp, tm.quant_specs(tm.param_specs(cfg16)),
                             mesh18)
    with torch.inference_mode():
        logits = tm.forward(qp, torch.as_tensor(q["tokens"]), cfg16)
    out["int8"] = {"max": float((logits - torch.as_tensor(q["logits"]))
                                .abs().max()),
                   "finite": bool(torch.isfinite(logits).all()),
                   "scale_wo": _spec(qp["layers"]["wo"]["scale"]),
                   "scale_wq": _spec(qp["layers"]["wq"]["scale"])}

    # moe_ffn over ("dp", "ep") against the one-device call
    # (tests/test_moe.py:77)
    m = data["moe_ffn"]
    mcfg = tmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4, top_k=2,
                          capacity_factor=4.0, dtype=torch.float32)
    mesh_ep = parallel.make_mesh("cpu", (2, 4), ("dp", "ep"))
    mp = parallel.distribute(params_from_numpy(m["params"]),
                             tmoe.moe_param_specs(), mesh_ep)
    y, aux = tmoe.moe_ffn(mp, _rows(m["x"], mesh_ep), mcfg)
    out["moe_ffn"] = {"y": float((y - _rows(m["y"], mesh_ep)).abs().max()),
                      "aux": float(aux), "w1": _spec(mp["w1"])}

    # the llama-moe-tiny train step on dp x tp x ep (tests/test_moe.py:136)
    e = data["moe_step"]
    ecfg = dataclasses.replace(tm.PRESETS["llama-moe-tiny"],
                               dtype=torch.float32,
                               moe_capacity_factor=e["capacity_factor"])
    mesh3 = parallel.make_mesh("cpu", (2, 2, 2), parallel.MOE_AXES)
    eparams = tm.train_params(parallel.distribute(
        params_from_numpy(e["params"]), tm.param_specs(ecfg), mesh3))
    etx, estep = tm.make_train_step(ecfg)
    eparams, _, eloss = estep(eparams, etx.init(eparams),
                              _rows(e["tokens"], mesh3))
    errs = _leaf_errors(eparams, e["updated"], ck.leaf_specs(ecfg), mesh3)
    out["moe_step"] = {"loss": float(eloss), "max": float(errs.max()),
                       "mean": float(errs.mean()),
                       "w1": _spec(eparams["layers"][0]["w1"])}

    out["p2p"] = _p2p_checks(mesh)

    # the ViT dp x tp forward (tests/test_vit.py:77)
    v = data["vit"]
    vcfg = dataclasses.replace(tv.PRESETS_VIT["vit-tiny"],
                               dtype=torch.float32)
    vp = parallel.distribute(params_from_numpy(v["params"]),
                             tv.vit_param_specs(vcfg), mesh)
    with torch.inference_mode():
        vl = tv.vit_forward(vp, _rows(v["images"], mesh), vcfg)
    out["vit"] = {"max": float((vl - _rows(v["logits"], mesh)).abs().max())}

    # init_params with a mesh: every rank's shards of the one draw
    full = tm.init_params(cfg16, torch.Generator().manual_seed(0))
    for int8, specs in ((False, tm.param_specs(cfg16)),
                        (True, tm.quant_specs(tm.param_specs(cfg16)))):
        got = tm.init_params(cfg16, torch.Generator().manual_seed(0),
                             mesh=mesh, int8=int8)
        want = tm.quantize_int8(full) if int8 else full
        same = parallel.tree_map(
            lambda g, w, s: torch.equal(g.to_local(),
                                        parallel.local_shard(w, s, mesh)),
            got, want, specs)
        out[f"init_int8={int8}"] = all(parallel.leaves(same))
    return out


def _p2p_checks(mesh) -> dict:
    """ppermute (a ring and a chain over "tp") and all_to_all over "tp"
    on the (2, 4) mesh, forward and backward, on values that name their
    rank; the test holds them against numpy."""
    r = torch.distributed.get_rank()
    w = torch.full((2, 3), float(r + 1))
    got = {}
    for name, perm in (("ring", [(i, (i + 1) % 4) for i in range(4)]),
                       ("chain", [(i, i + 1) for i in range(3)])):
        x = (torch.arange(6.0) + 100 * r).reshape(2, 3).requires_grad_()
        y = parallel.ppermute(x, perm, mesh, "tp")
        (y * w).sum().backward()
        got[name] = (y.detach().numpy(), x.grad.numpy())
    a = (torch.arange(48.0).reshape(2, 8, 3) + 1000 * r).requires_grad_()
    b = parallel.all_to_all(a, mesh, "tp", split_dim=1, concat_dim=2)
    (b * (torch.arange(48.0).reshape(b.shape) * (r + 1))).sum().backward()
    got["all_to_all"] = (b.detach().numpy(), a.grad.numpy())
    return got


def _trained(cfg, mesh, tokens, steps=2):
    params = tm.train_params(tm.init_params(
        cfg, torch.Generator().manual_seed(0), mesh=mesh))
    tx, step = tm.make_train_step(cfg)
    opt = tx.init(params)
    for _ in range(steps):
        params, opt, _ = step(params, opt, _rows(tokens, mesh))
    return params, opt, tx, step


def _full(t) -> torch.Tensor:
    """The whole tensor of a DTensor (an all-reduce of zero-filled
    buffers, one sharded dim at a time)."""
    if not parallel.is_dtensor(t):
        return t
    out = t.to_local()
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            dim = pl.dim
            moved = out.movedim(dim, -1).contiguous()
            moved = parallel.gather_last(moved, t.device_mesh, name)
            out = moved.movedim(-1, dim)
    return out


def sharded_checks(data: dict) -> dict:
    """The world of tests/test_torch_sharded.py."""
    out = {}
    root = data["dir"]
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=torch.float32)
    tokens = data["tokens"]

    # cross-mesh restore, dp 2 x tp 4 -> 4 x 2 (tests/test_checkpoint.py:65)
    m24 = parallel.make_mesh("cpu", (2, 4))
    m42 = parallel.make_mesh("cpu", (4, 2))
    params, opt, tx, step = _trained(cfg, m24, tokens)
    ckpt = ck.TrainCheckpointer(f"{root}/llama")
    ckpt.save(2, params, opt, cfg)
    saved = {n: _full(w.detach()) for n, w in tm.named_leaves(params)}
    saved_opt = {n: {k: _full(v) for k, v in opt.state[w].items()}
                 for n, w in tm.named_leaves(params)}
    rp, ro, rstep = ckpt.restore(cfg, tx, device="cpu", mesh=m42)
    # what a resuming trainer calls: the same state on the same mesh
    gp, go, gstart = ckpt.resume_or_init(cfg, tx, torch.Generator()
                                         .manual_seed(1), mesh=m42)
    resumed = gstart == 2 and all(
        torch.equal(a.detach().to_local(), b.detach().to_local())
        and a.placements == b.placements
        for a, b in zip(tm.param_leaves(gp), tm.param_leaves(rp))) and all(
        torch.equal(go.state[a]["exp_avg_sq"].to_local(),
                    ro.state[b]["exp_avg_sq"].to_local())
        for a, b in zip(tm.param_leaves(gp), tm.param_leaves(rp)))
    del gp, go
    same = all(torch.equal(_full(w.detach()), saved[n])
               for n, w in tm.named_leaves(rp))
    same_opt = all(torch.equal(_full(v), saved_opt[n][k])
                   for n, w in tm.named_leaves(rp)
                   for k, v in ro.state[w].items())
    wq = rp["layers"][0]["wq"]
    mu = ro.state[wq]["exp_avg"]
    # the resharded state trains on: the next step equals the one the
    # saving mesh takes
    rp, ro, rloss = step(rp, ro, _rows(tokens, m42))
    params, opt, loss = step(params, opt, _rows(tokens, m24))
    out["cross_mesh"] = {
        "step": rstep, "same": same, "same_opt": same_opt,
        "resumed": resumed,
        "wq": _spec(wq), "wq_mesh": dict(zip(wq.device_mesh.mesh_dim_names,
                                             wq.device_mesh.shape)),
        "mu": _spec(mu), "mu_mesh": dict(zip(mu.device_mesh.mesh_dim_names,
                                             mu.device_mesh.shape)),
        "local_wq": tuple(wq.to_local().shape),
        "next_loss": (float(rloss), float(loss))}

    # the ViT family (tests/test_checkpoint.py:137)
    vcfg = tv.PRESETS_VIT["vit-tiny"]
    vparams = tm.train_params(tv.init_vit_params(
        vcfg, torch.Generator().manual_seed(0), mesh=m24))
    vtx, vstep = tv.make_vit_train_step(vcfg)
    vopt = vtx.init(vparams)
    images, labels = data["images"], data["labels"]
    for _ in range(2):
        vparams, vopt, _ = vstep(vparams, vopt, _rows(images, m24),
                                 _rows(labels, m24))
    vck = ck.TrainCheckpointer(f"{root}/vit")
    vck.save(2, vparams, vopt, vcfg)
    vrp, _, _ = vck.restore(vcfg, vtx, device="cpu", mesh=m42)
    vwq = vrp["layers"][1]["wq"]
    out["vit"] = {
        "same": all(torch.equal(_full(a.detach()), _full(b.detach()))
                    for a, b in zip(tm.param_leaves(vparams),
                                    tm.param_leaves(vrp))),
        "wq": _spec(vwq), "wq_mesh": dict(zip(
            vwq.device_mesh.mesh_dim_names, vwq.device_mesh.shape))}
    try:
        vck.restore(cfg, tx, device="cpu", mesh=m42)
        out["vit"]["cross_family"] = "restored"
    except ValueError as e:
        out["vit"]["cross_family"] = str(e)

    # the restore target (tests/test_checkpoint.py:225)
    abstract = ck.abstract_train_state(cfg, tx, mesh=m24)
    out["abstract"] = {
        "wq": _spec(abstract["params"]["params.layers.0.wq"]),
        "nu": _spec(abstract["opt_state"]["opt.layers.0.wq.exp_avg_sq"]),
        "step": parallel.is_dtensor(abstract["opt_state"]
                                    ["opt.layers.0.wq.step"]),
        "keys": len(abstract["params"]), "opt_keys": len(
            abstract["opt_state"])}

    # TrainStateHandler with a mesh: save on 2 x 4, restore on 4 x 2
    from tpushare_torch.workloads.migrate import TrainStateHandler
    handler = TrainStateHandler(f"{root}/migrate", lambda: (
        7, params, opt, cfg), tx, device="cpu", mesh=m42)
    handler.save({"metadata": {"name": "p"}}, None)
    handler.restore({"metadata": {"name": "p"}}, None)
    hp, _, hstep = handler.restored
    out["handler"] = {
        "step": hstep, "wq": dict(zip(
            hp["layers"][0]["wq"].device_mesh.mesh_dim_names,
            hp["layers"][0]["wq"].device_mesh.shape)),
        "same": all(torch.equal(_full(a.detach()), _full(b.detach()))
                    for a, b in zip(tm.param_leaves(params),
                                    tm.param_leaves(hp)))}

    # the player's --ckpt-dir over the world's ranks: the (1, n) mesh,
    # then resumed on it
    base = ["--preset", "llama-tiny", "--mode", "train", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir",
            f"{root}/player", "--ckpt-every", "1"]
    first = player.run([*base, "--steps", "2"], return_state=True)
    again = player.run([*base, "--steps", "3"], return_state=True)
    out["player"] = {
        "first": (first["start_step"], first["steps"],
                  dict(zip(first["params"]["embed"].device_mesh
                           .mesh_dim_names,
                           first["params"]["embed"].device_mesh.shape))),
        "again": (again["start_step"], again["steps"],
                  dict(zip(again["params"]["embed"].device_mesh
                           .mesh_dim_names,
                           again["params"]["embed"].device_mesh.shape))),
        "losses": first["losses"] + again["losses"]}
    if torch.distributed.get_rank() == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- sequence and pipeline parallelism ---------------------------------------

def _t(x, dtype):
    return torch.as_tensor(np.asarray(x)).to(dtype)


_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _sp_meshes(names=("dp", "sp")) -> dict:
    """n -> a mesh whose last axis has n of the 4 ranks (n = 2: two
    rings of two, each on the same inputs)."""
    return {4: parallel.make_mesh("cpu", (4,), names[-1:]),
            2: parallel.make_mesh("cpu", (2, 2), names)}


def _np32(t) -> np.ndarray:
    return t.detach().float().numpy()


def _recording(module, name: str, log: list, what):
    """``module.name`` patched to append ``what(*args, **kwargs)`` to
    ``log`` before each call."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        log.append(what(*args, **kwargs))
        return real(*args, **kwargs)

    return mock.patch.object(module, name, wrapper)


def ring_checks(data: dict) -> dict:
    """The world of tests/test_torch_ring.py: every case's gathered
    output (natural order), and with a ``proj`` the gradients of
    sum(out * proj). ``route`` "flash" runs the card's route with the
    plain K1, K2 and K3 (their calls and this rank's hops recorded) and
    the fold beside it; otherwise ``ring_attention`` (the fold, on CPU
    tensors)."""
    from tpushare_torch.kernels import flash, flash_bwd
    from tpushare_torch.workloads import ringattention as ra

    meshes = _sp_meshes()
    out = {}
    for case in data["cases"]:
        mesh, n = meshes[case["n"]], case["n"]
        dt = _DTYPES[case["dtype"]]
        q, k, v = (_t(case[x], dt) for x in "qkv")
        S = q.shape[2]
        zz = case.get("zigzag", False)
        order = ra.zigzag_order(S, n) if zz else torch.arange(S)
        local = [ra.shard_seq(x[:, :, order], mesh).clone() for x in
                 (q, k, v)]
        if "proj" in case:
            for x in local:
                x.requires_grad_()
        got = {}
        with contextlib.ExitStack() as stack:
            if case.get("route") == "flash":
                calls = {"fwd": [], "dq": [], "dkdv": [], "hops": []}
                for module, name, key, what in (
                        (flash, "flash_fwd", "fwd",
                         lambda *a, causal: causal),
                        (flash_bwd, "flash_bwd_dq", "dq", lambda *a: a[-1]),
                        (flash_bwd, "flash_bwd_dkdv", "dkdv",
                         lambda *a: a[-1]),
                        (parallel, "ppermute", "hops",
                         lambda x, *a: (list(x.shape), str(x.dtype)))):
                    stack.enter_context(_recording(module, name,
                                                   calls[key], what))
                o = ra._ring_flash(*local, mesh, "sp", case["causal"], zz)
                got["fwd_hops"] = len(calls["hops"])
            else:
                o = ra.ring_attention(*local, mesh, causal=case["causal"],
                                      zigzag=zz)
            if "proj" in case:
                proj = ra.shard_seq(_t(case["proj"], torch.float32)[
                    :, :, order], mesh)
                (o.float() * proj).sum().backward()
                got["grads"] = [_np32(ra.gather_seq(x.grad, mesh)[
                    :, :, torch.argsort(order)]) for x in local]
        if case.get("route") == "flash":
            got["calls"] = calls
            with torch.no_grad():
                fold = ra._ring_fold(*local, mesh, "sp", case["causal"], zz)
            got["fold"] = _np32(ra.gather_seq(fold, mesh)[:, :, torch.argsort(
                order)])
        got["out"] = _np32(ra.gather_seq(o.detach(), mesh)[
            :, :, torch.argsort(order)])
        got["dtype"] = str(o.dtype)
        out[case["name"]] = got
    return out


def ulysses_checks(data: dict) -> dict:
    """The world of tests/test_torch_ulysses.py: every case's gathered
    output and, with a ``proj``, the gradients of sum(out * proj)."""
    from tpushare_torch.workloads import ringattention as ra
    from tpushare_torch.workloads.ulysses import ulysses_attention

    meshes = _sp_meshes()
    out = {}
    for case in data["cases"]:
        mesh = meshes[case["n"]]
        local = [ra.shard_seq(_t(case[x], torch.float32), mesh).clone()
                 for x in "qkv"]
        grad = "proj" in case
        for x in local:
            x.requires_grad_(grad)
        if case.get("ring"):
            o = ra.ring_attention(*local, mesh, causal=case["causal"])
        else:
            o = ulysses_attention(*local, mesh, causal=case["causal"],
                                  attn=case["attn"], window=case["window"])
        got = {"out": _np32(ra.gather_seq(o.detach(), mesh))}
        if grad:
            proj = ra.shard_seq(_t(case["proj"], torch.float32), mesh)
            (o * proj).sum().backward()
            got["grads"] = [_np32(ra.gather_seq(x.grad, mesh))
                            for x in local]
        out[case["name"]] = got
    return out


def pipeline_checks(data: dict) -> dict:
    """The world of tests/test_torch_pipeline.py: per case the pipelined
    logits and aux, the gradients of the reference's next-token loss
    (this rank's stage's layers, the embedding and the head), or the
    losses of the pipelined train step, on the JAX package's weights."""
    from tpushare_torch.workloads import pipeline as tp

    meshes = _sp_meshes(("dp", "pp"))
    out = {}
    for case in data["cases"]:
        mesh = meshes[case["n"]]
        cfg = dataclasses.replace(tm.PRESETS[case["preset"]],
                                  dtype=_DTYPES[case["dtype"]],
                                  **case.get("cfg", {}))
        params = params_from_numpy(case["params"])
        tokens = torch.as_tensor(case["tokens"])
        M = case.get("microbatches")
        got = {}
        if case["kind"] == "forward":
            with torch.no_grad():
                logits, aux = tp.pipelined_forward_with_aux(
                    params, tokens, cfg, mesh, M)
            got = {"logits": _np32(logits), "aux": float(aux)}
        elif case["kind"] == "grad":
            tparams = tm.train_params(params)

            def fwd(p, t, c):
                return tp.pipelined_forward_with_aux(p, t, c, mesh, M)

            loss = tm.loss_fn(tparams, tokens, cfg, forward_fn=fwd)
            loss.backward()
            got = {"loss": float(loss), "grads": {
                name: _np32(w.grad) for name, w in tm.named_leaves(tparams)
                if w.grad is not None}}
        else:
            tparams = tm.train_params(tp.stage_params(params, cfg, mesh))
            tx, step = tp.make_pipelined_train_step(
                cfg, mesh, M, learning_rate=case["lr"])
            opt = tx.init(tparams)
            losses = []
            for _ in range(case["steps"]):
                tparams, opt, loss = step(tparams, opt, tokens)
                losses.append(float(loss))
            got = {"losses": losses, "stage": parallel.axis_rank(mesh, "pp"),
                   "params": {name: _np32(w) for name, w in
                              tm.named_leaves(tparams)}}
        out[case["name"]] = got
    return out


# -- continuous batching under tensor parallelism -----------------------------

FP32_ENGINE = {"max_slots": 4, "max_len": 32, "quantum": 3}
ENGINE_PROMPTS = {"a": [5, 9], "b": [100, 2, 77, 31, 8, 4, 19],
                  "c": [240] * 11, "d": [7, 8]}


def engine_streams(engine) -> dict:
    """A ragged run (the port's or the JAX package's engine): a and b in
    flight, c joins one quantum later (d beside it, greedy, where the
    engine samples per request); returns {name: tokens}."""
    per_request = getattr(engine, "_per_request", False)
    rids = {k: engine.submit(ENGINE_PROMPTS[k], 8,
                             **({"temperature": 1.0, "top_p": 0.95}
                                if per_request else {}))
            for k in ("a", "b")}
    out = dict(engine.run_quantum())
    rids["c"] = engine.submit(ENGINE_PROMPTS["c"], 7)
    if per_request:
        rids["d"] = engine.submit(ENGINE_PROMPTS["d"], 9, temperature=0.0)
    out.update(engine.drain())
    return {k: [int(t) for t in out[r]] for k, r in rids.items()}


def tp_engine_checks(data: dict) -> dict:
    """The fp32 world of tests/test_torch_tp_engine.py: each run of
    ``data["runs"]`` (name -> the engine's sampling arguments) through
    the tp replica's engine protocol on a (1, 2) mesh, rank 0's
    ``serve._TPEngine`` broadcasting each device call, rank 1's
    ``DecodeEngine`` following in ``serve._rank_loop`` until rank 0
    sends the stop header. Each rank returns ``{"streams": {name:
    streams} (rank 0's), "step_graphs": [the graph attribute of each
    engine.step span of its first run]}``."""
    from tpushare_torch import metrics
    from tpushare_torch.workloads import serve
    from tpushare_torch.workloads.engine import DecodeEngine

    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=torch.float32)
    mesh = parallel.make_mesh("cpu", (1, 2))
    params = parallel.distribute(params_from_numpy(data["params"]),
                                 tm.param_specs(cfg), mesh)
    device = torch.device("cpu")
    out, graphs = {}, None
    for name, kw in data["runs"].items():
        traced = contextlib.nullcontext() if graphs is not None else \
            torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
        with traced:
            if torch.distributed.get_rank() == 0:
                replica = serve.TPReplica(None, device, [])
                out[name] = engine_streams(serve._TPEngine(
                    replica, params, cfg, **FP32_ENGINE, **kw))
                with replica.op(serve._STOP):
                    pass
            else:
                serve._rank_loop(None, device, DecodeEngine(
                    params, cfg, **FP32_ENGINE, **kw))
        if graphs is None:
            graphs = [s.attrs["graph"] for s in metrics.last_session()
                      if s.name == "engine.step"]
    return {"streams": out, "step_graphs": graphs}



def rolled_table_rank_main(argv, rank, world, addr, cards) -> None:
    """``serve._tp_rank_main`` with a fault in rank 1: it runs every
    decode quantum on the slot table rolled by one slot (each slot takes
    its neighbour's last token, position, flags, budget and key)."""
    from tpushare_torch.workloads import serve
    from tpushare_torch.workloads.engine import DecodeEngine
    real = DecodeEngine.load_slot_table

    def rolled(self, longs, floats):
        real(self, longs.roll(1, dims=1), floats.roll(1, dims=1))

    with (mock.patch.object(DecodeEngine, "load_slot_table", rolled)
          if rank == 1 else contextlib.nullcontext()):
        serve._tp_rank_main(argv, rank, world, addr, cards)


def afmoe_ep_checks(data: dict) -> dict:
    """trinity-mini-tiny in fp32 trained ``data["steps"]`` steps on a dp 2
    x ep 2 mesh (each "ep" rank holds half of the held experts; the
    selection bias steps from the counts summed over "dp"): each step's
    loss and every leaf, buffers included, whole."""
    cfg = dataclasses.replace(tm.PRESETS["trinity-mini-tiny"],
                              dtype=torch.float32)
    mesh = parallel.make_mesh("cpu", (2, 1, 2), parallel.MOE_AXES)
    params = tm.train_params(tm.init_params(
        cfg, torch.Generator().manual_seed(0), mesh=mesh))
    tx, step = tm.make_train_step(cfg)
    opt = tx.init(params)
    losses = []
    for tokens in data["tokens"][:data["steps"]]:
        params, opt, loss = step(params, opt, _rows(tokens, mesh))
        losses.append(float(loss))
    experts = params["layers"][-1]["w1"]
    return {"losses": losses,
            "local_experts": int(experts.to_local().shape[0]),
            "leaves": {n: _full(w.detach()).numpy()
                       for n, w in tm.named_leaves(params)}}
