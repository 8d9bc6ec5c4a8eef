"""Port training (tpushare_torch/workloads/model.py, player.py) against
the JAX reference (tpushare/workloads/model.py) on the CPU, at llama-tiny
size in fp32.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; the tokens are numpy-seeded. The flash
backend runs the reference's Pallas forward in interpret mode (whose
custom VJP then takes its fp32 blockwise backward) and the port's plain
forward and plain dq and dk/dv kernels.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import model as jm
from tpushare_torch.workloads import attention as ta
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import player
from tpushare_torch.workloads.convert import params_from_numpy

torch.set_num_threads(2)
# The first attention a process computes with torch's CPU kernels has been
# seen to come out about 1e-4 off (in roughly one fresh process of 70,
# the same wrong bits each time), with every later call exact to fp32.
# One small call at import keeps that first call out of the comparisons.
ta.flash_attention_plain(*torch.zeros(3, 1, 1, 8, 16).unbind(0))

ATTN = ["einsum", "flash"]
# loss and gradients: the same fp32 math in another summation order
# (measured: a few 1e-7)
GRAD = dict(atol=1e-5, rtol=1e-4)
# parameters after AdamW steps: each step moves an element by about the
# learning rate (3e-4) times g/|g|; where |g| is within a few 1e-7 of 0
# the direction is set by round-off, so single elements may differ by a
# fraction of the step (measured: at most 2.7e-5). The bulk must agree
# to round-off, which the mean bounds.
PARAM_MAX = 1e-4
PARAM_MEAN = 1e-7


def _cfgs(attn):
    return (dataclasses.replace(jm.PRESETS["llama-tiny"], dtype=jnp.float32,
                                attn=attn),
            dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=torch.float32,
                                attn=attn))


def _tokens():
    return np.random.default_rng(1).integers(0, 256, (2, 41))


def _jax_params(jcfg):
    return jm.init_params(jcfg, jax.random.key(0))


def _port_params(pj):
    return params_from_numpy(jax.tree.map(np.asarray, pj))


def _pairs(pt, pj):
    """(port tensor, reference array) for every parameter; the port's
    per-layer leaves against the reference's stacked layers."""
    pj = jax.tree.map(np.asarray, pj)
    for name in ("embed", "final_norm", "lm_head"):
        yield pt[name], pj[name]
    for i, lp in enumerate(pt["layers"]):
        for name, w in lp.items():
            yield w, pj["layers"][name][i]


@functools.cache
def _jax_value_and_grad(attn):
    jcfg, _ = _cfgs(attn)
    fn = jax.jit(jax.value_and_grad(functools.partial(jm.loss_fn, cfg=jcfg)))
    return fn(_jax_params(jcfg), jnp.asarray(_tokens(), jnp.int32))


@pytest.mark.parametrize("attn", ATTN)
def test_loss_and_grads_match_reference(attn):
    jcfg, tcfg = _cfgs(attn)
    lj, gj = _jax_value_and_grad(attn)
    pt = tm.train_params(_port_params(_jax_params(jcfg)))
    lt = tm.loss_fn(pt, torch.from_numpy(_tokens()), tcfg)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), **GRAD)
    grads = {"embed": pt["embed"].grad, "final_norm": pt["final_norm"].grad,
             "lm_head": pt["lm_head"].grad,
             "layers": [{n: w.grad for n, w in lp.items()}
                        for lp in pt["layers"]]}
    n = 0
    for got, want in _pairs(grads, gj):
        assert got is not None and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **GRAD)
        n += 1
    assert n == 3 + 2 * 9


@pytest.mark.parametrize("attn", ATTN)
def test_two_adamw_steps_match_reference(attn):
    jcfg, tcfg = _cfgs(attn)
    tok = _tokens()
    pj = _jax_params(jcfg)
    stacked = _port_params(pj)
    pt = tm.train_params(stacked)
    tx, step = jm.make_train_step(jcfg)
    ttx, tstep = tm.make_train_step(tcfg)
    sj, st = jax.jit(step), tx.init(pj)
    opt = ttx.init(pt)
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8
    assert group["betas"] == (0.9, 0.999) and group["lr"] == 3e-4
    for _ in range(2):
        pj, st, lj = sj(pj, st, jnp.asarray(tok, jnp.int32))
        pt, opt, lt = tstep(pt, opt, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.item(), float(lj), **GRAD)
    errs = np.concatenate([np.abs(got.detach().numpy() - want).ravel()
                           for got, want in _pairs(pt, pj)])
    assert errs.max() <= PARAM_MAX and errs.mean() <= PARAM_MEAN
    # the steps landed in the stacked tree the serving path reads
    assert torch.equal(stacked["layers"]["w2"][1], pt["layers"][1]["w2"])
    assert torch.equal(stacked["embed"], pt["embed"])
    # gradients are freed after each update
    assert all(w.grad is None for w in tm.param_leaves(pt))


def test_train_params_are_views_with_gradients():
    _, tcfg = _cfgs("einsum")
    stacked = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    pt = tm.train_params(stacked)
    leaves = tm.param_leaves(pt)
    assert len(leaves) == 3 + tcfg.n_layers * 9
    assert all(w.is_leaf and w.requires_grad for w in leaves)
    w1 = pt["layers"][1]["w1"]
    assert w1.shape == stacked["layers"]["w1"].shape[1:]
    assert w1.untyped_storage().data_ptr() == \
        stacked["layers"]["w1"].untyped_storage().data_ptr()
    assert not stacked["layers"]["w1"].requires_grad
    with pytest.raises(ValueError, match="int8"):
        tm.train_params(tm.quantize_int8(stacked))


@pytest.mark.parametrize("attn", ATTN)
def test_player_trains_on_cpu(attn, capsys):
    argv = ["--preset", "llama-tiny", "--mode", "train", "--attn", attn,
            "--steps", "2", "--seq", "33", "--device", "cpu"]
    assert player.main(argv) == 0
    out = capsys.readouterr().out
    assert "TPU_VISIBLE_CHIPS=" in out
    assert "train/s on cpu" in out and out.rstrip().splitlines()[-1] \
        .startswith("step 2: ")
    record = player.run(argv)
    assert record["steps"] == 2 and len(record["step_s"]) == 2
    losses = record["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0]


def test_player_forward_on_cpu(capsys):
    record = player.run(["--preset", "llama-tiny", "--steps", "3",
                         "--seq", "16", "--device", "cpu"])
    assert record["mode"] == "forward" and record["steps"] == 3
    assert "step 3: " in capsys.readouterr().out


@pytest.mark.parametrize("attn", ATTN)
def test_player_trains_moe_on_cpu(attn, capsys):
    argv = ["--preset", "llama-moe-tiny", "--mode", "train", "--attn", attn,
            "--steps", "2", "--seq", "33", "--device", "cpu"]
    record = player.run(argv, return_state=True)
    assert capsys.readouterr().out.rstrip().splitlines()[-1].startswith(
        "step 2: ")
    losses = record["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0]
    # the router trains in fp32 beside the bf16 experts
    lp = record["params"]["layers"][0]
    assert lp["wg"].dtype == torch.float32 and lp["w1"].dtype == torch.bfloat16
    assert record["opt_state"].state[lp["wg"]]["exp_avg"].dtype == \
        torch.float32


def test_player_moe_forward_on_cpu(capsys):
    record = player.run(["--preset", "llama-moe-tiny", "--steps", "2",
                         "--seq", "16", "--attn", "flash", "--device", "cpu"])
    assert record["mode"] == "forward" and record["steps"] == 2
    assert "step 2: " in capsys.readouterr().out


REFUSED = [
    # --ckpt-dir supports dense presets, as in the reference (MoE state
    # shards over "ep"); --sp ring is the reference's long-context loop,
    # which neither trains nor runs a ViT (its ap.error); --multihost
    # needs the gang's rendezvous env
    (["--mode", "train", "--ckpt-dir", "ckpt", "--preset",
      "llama-moe-tiny"], SystemExit, "dense presets"),
    (["--sp", "ring", "--mode", "train"], SystemExit,
     "does not train the model"),
    (["--multihost"], RuntimeError, "COORDINATOR_ADDRESS is not set"),
    (["--preset", "vit-tiny", "--sp", "ring"], SystemExit,
     "llama-attention mode"),
]


@pytest.mark.parametrize("extra,exc,match", REFUSED,
                         ids=["ckpt-dir", "sp-ring", "multihost", "vit"])
def test_player_refuses_unported_flags(extra, exc, match, capsys,
                                       monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(exc) as e:
        player.main(["--steps", "1", "--device", "cpu", *extra])
    assert match in str(e.value) + capsys.readouterr().err


def _players(argv: list, envs: list, timeout: float = 240,
             local: int | None = None) -> list:
    """``python -m tpushare_torch.workloads.player argv`` in one process
    per env of ``envs`` (each added to this one's), all at once; returns
    their stdouts, after each exited 0. With ``local``, each process
    counts that many local ranks for a gang member (one per card)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "tpushare_torch.workloads.player"]
    if local is not None:
        cmd = [sys.executable, "-c",
               "import sys; from tpushare_torch.workloads import parallel, "
               f"player; parallel.gang_local_ranks = lambda t: {local}; "
               "sys.exit(player.main(sys.argv[1:]))"]
    procs = [subprocess.Popen(
        [*cmd, *argv], cwd=root, env={**os.environ, **env},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for env in envs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


RING = ["--preset", "llama-tiny", "--sp", "ring", "--steps", "2", "--device",
        "cpu"]


def test_player_sp_ring_over_torchrun_ranks():
    # two ranks from torchrun's env: each draws its own 256-row chunk
    # (--seq 300 rounds up to 128-aligned chunks a rank)
    from tpushare_torch.workloads.parallel import free_port
    port = str(free_port())
    outs = _players([*RING, "--seq", "300"], [
        {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
         "MASTER_ADDR": "localhost", "MASTER_PORT": port} for r in range(2)])
    for out in outs:
        last = out.rstrip().splitlines()[-1]
        assert last.startswith("step 2: ") and last.endswith(
            "ring/s (S=512 over 2 devices) on cpu"), last


def test_player_sp_ring_on_one_process(capsys):
    record = player.run([*RING, "--seq", "100"])
    assert record["world"] == 1 and record["steps"] == 2
    assert "ring/s (S=128 over 1 devices) on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["ring", "ckpt", "two-local-ranks"])
def test_player_multihost_joins_from_the_gang_env(mode, tmp_path):
    # two gang members as the device plugin starts them: one rank each
    # on the CPU (world 2), or two local ranks each, as a member with
    # two cards starts them (world 4: ranks 2p and 2p+1 on member p)
    from tpushare_torch.workloads.parallel import free_port
    argv = [*RING, "--multihost"] if mode != "ckpt" else [
        "--preset", "llama-tiny", "--mode", "train", "--steps", "1",
        "--seq", "16", "--device", "cpu", "--multihost", "--ckpt-dir",
        str(tmp_path), "--ckpt-every", "1"]
    local = 2 if mode == "two-local-ranks" else 1
    addr = f"localhost:{free_port()}"
    outs = _players(argv, [{"COORDINATOR_ADDRESS": addr, "NUM_PROCESSES": "2",
                            "PROCESS_ID": str(p)} for p in range(2)],
                    local=local if local > 1 else None)
    world = 2 * local
    for p, out in enumerate(outs):
        for i in range(local):
            assert (f"multihost: process {p} of 2, rank {p * local + i} of "
                    f"world {world}, transport gloo") in out
        assert out.rstrip().splitlines()[-1].startswith("step ")
    if mode != "ckpt":
        assert (f"ring/s (S={128 * world} over {world} devices) on cpu"
                in outs[0])
    else:
        # both members wrote their shards of the (1, 2) mesh's step 1
        from tpushare_torch.workloads.checkpoint import TrainCheckpointer
        assert TrainCheckpointer(str(tmp_path)).steps() == [1]


@pytest.mark.parametrize("extra", [["--ckpt-dir", "ckpt"],
                                   ["--preset", "nope"],
                                   ["--preset", "vit-tiny", "--sp", "ring"]],
                         ids=["ckpt-dir-forward", "unknown-preset",
                              "vit-sp-ring"])
def test_player_usage_errors(extra):
    with pytest.raises(SystemExit):
        player.main(["--steps", "1", "--device", "cpu", *extra])


def test_player_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        player.main(["--steps", "1"])


VIT_TRAIN = ["--preset", "vit-tiny", "--mode", "train", "--attn", "flash",
             "--batch", "2", "--device", "cpu"]


def test_player_vit_train_and_forward_on_cpu(capsys):
    record = player.run([*VIT_TRAIN, "--steps", "2"])
    assert record["steps"] == 2 and record["start_step"] == 0
    losses = record["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    record = player.run(["--preset", "vit-tiny", "--steps", "1", "--attn",
                         "flash", "--batch", "2", "--device", "cpu"])
    assert record["mode"] == "forward" and record["steps"] == 1
    assert "step 1: " in capsys.readouterr().out


def test_player_vit_resume_finishes_the_budget(tmp_path, capsys):
    # uninterrupted: 3 steps, a checkpoint at step 2
    whole = player.run([*VIT_TRAIN, "--steps", "3", "--ckpt-dir",
                        str(tmp_path / "a"), "--ckpt-every", "2"],
                       return_state=True)
    assert whole["losses"][0] > whole["losses"][-1]
    # one save (step 2), timed apart from the steps
    assert len(whole["save_s"]) == 1 and whole["resume_s"] is not None
    # interrupted after step 2, then resumed with the same budget
    first = player.run([*VIT_TRAIN, "--steps", "2", "--ckpt-dir",
                        str(tmp_path / "b"), "--ckpt-every", "2"])
    assert first["losses"] == whole["losses"][:2]
    resumed = player.run([*VIT_TRAIN, "--steps", "3", "--ckpt-dir",
                          str(tmp_path / "b"), "--ckpt-every", "2"],
                         return_state=True)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["start_step"] == 2 and resumed["steps"] == 3
    assert resumed["losses"] == whole["losses"][2:]
    for a, b in zip(tm.param_leaves(resumed["params"]),
                    tm.param_leaves(whole["params"])):
        assert torch.equal(a, b)
    # a budget already spent runs no step
    done = player.run([*VIT_TRAIN, "--steps", "2", "--ckpt-dir",
                       str(tmp_path / "b")])
    assert done["start_step"] == 2 and done["losses"] == []


def test_player_llama_ckpt_dir_resumes(tmp_path):
    argv = ["--preset", "llama-tiny", "--mode", "train", "--seq", "17",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    first = player.run([*argv, "--steps", "1"])
    resumed = player.run([*argv, "--steps", "2"])
    assert first["steps"] == 1 and resumed["start_step"] == 1
    assert len(resumed["losses"]) == 1
    from tpushare_torch.workloads.checkpoint import TrainCheckpointer
    assert TrainCheckpointer(str(tmp_path)).steps() == [1, 2]
