"""The port's sharded checkpoints, the tensor-parallel replica and the
multi-device dry run, on the CPU.

- Checkpoints (tpushare_torch/workloads/checkpoint.py) saved by a dp 2 x
  tp 4 world restore onto dp 4 x tp 2 with the values saved, on the
  target placements, and train on (tests/test_checkpoint.py:65-91, :137,
  :210, :225 are the reference's counterparts). These run in one world of
  8 gloo ranks for the file (tests/torch_ranks.py:sharded_checks).
- ``serve --tp 2 --device cpu`` answers over HTTP with the JAX
  package's ``greedy_decode_kv`` tokens on the same weights (with
  ``--engine``: tests/test_torch_tp_engine.py).
- ``dryrun_multichip(8)`` runs its layouts over 8 gloo ranks: dp x tp,
  ring attention and Ulysses, ep, the pipeline, and the ViT.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import checkpoint as jck
from tpushare.workloads import model as jm
from tpushare_torch.entry import dryrun_multichip
from tpushare_torch.workloads import checkpoint as ck
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import parallel, serve
from tpushare_torch.workloads.parallel import P

import torch_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(11)
    data = {"dir": str(root),
            "tokens": rng.integers(0, 256, (4, 16)),
            "images": rng.standard_normal((4, 32, 32, 3), np.float32),
            "labels": rng.integers(0, 10, (4,))}
    return parallel.run_ranks(torch_ranks.sharded_checks, 8, data,
                              timeout=300)


def test_cross_mesh_restore_reshards_params_and_opt_state(world):
    # saved under dp=2 x tp=4, restored under dp=4 x tp=2: the values are
    # the ones saved, on the target placements, and training goes on
    for r in world:
        c = r["cross_mesh"]
        assert c["step"] == 2 and c["same"] and c["same_opt"]
        assert c["wq"] == (None, "tp") and c["wq_mesh"] == {"dp": 4, "tp": 2}
        # the AdamW first moment is sharded like its parameter, on the
        # new mesh
        assert c["mu"] == (None, "tp") and c["mu_mesh"] == {"dp": 4, "tp": 2}
        # each rank read its own shard (64 columns over 2), not the whole
        assert c["local_wq"] == (64, 32)
        new, old = c["next_loss"]
        np.testing.assert_allclose(new, old, rtol=1e-5)


def test_resume_or_init_restores_onto_its_mesh(world):
    # a trainer that builds its own mesh (4 x 2) and resumes: step 2's
    # state, bitwise what restore(mesh=) reads, on the same placements
    for r in world:
        assert r["cross_mesh"]["resumed"]


def test_vit_family_checkpoint_cross_mesh(world):
    for r in world:
        v = r["vit"]
        assert v["same"]
        assert v["wq"] == (None, "tp") and v["wq_mesh"] == {"dp": 4, "tp": 2}
        # a llama config never loads a ViT checkpoint
        assert "geometry" in v["cross_family"]


def test_abstract_state_carries_target_placements(world):
    cfg = tm.PRESETS["llama-tiny"]
    n_leaves = 3 + cfg.n_layers * 9
    for r in world:
        a = r["abstract"]
        assert a["wq"] == (None, "tp") and a["nu"] == (None, "tp")
        assert not a["step"]       # a replicated count, a plain tensor
        assert a["keys"] == n_leaves and a["opt_keys"] == 3 * n_leaves


def test_train_state_handler_restores_onto_its_mesh(world):
    for r in world:
        h = r["handler"]
        assert h["step"] == 7 and h["same"]
        assert h["wq"] == {"dp": 4, "tp": 2}


def test_player_ckpt_dir_trains_on_its_ranks(world):
    # --ckpt-dir over 8 ranks trains on the reference's (1, 8) mesh, and
    # resumes there for what is left of --steps
    for r in world:
        p = r["player"]
        assert p["first"] == (0, 2, {"dp": 1, "tp": 8})
        assert p["again"] == (2, 3, {"dp": 1, "tp": 8})
        assert len(p["losses"]) == 3 and all(np.isfinite(p["losses"]))
    assert len({tuple(r["player"]["losses"]) for r in world}) == 1


def test_opt_specs_mirror_param_specs():
    # the reference gives adamw's mu of the stacked wq P(None, None, "tp");
    # the port's per-layer moments take the layer's spec, and the step
    # counts are replicated
    cfg = tm.PRESETS["llama-tiny"]
    jtx, _ = jm.make_train_step(jm.PRESETS["llama-tiny"])
    jabs = jck.abstract_train_state(jm.PRESETS["llama-tiny"], jtx)
    jspecs = jck.opt_specs_like(jm.PRESETS["llama-tiny"], jabs["opt_state"])
    mu_wq = jspecs[0].mu["layers"]["wq"]
    tx, _ = tm.make_train_step(cfg)
    abstract = ck.abstract_train_state(cfg, tx)
    specs = ck.opt_specs_like(cfg, abstract["opt_state"])
    for i in range(cfg.n_layers):
        for key in ("exp_avg", "exp_avg_sq"):
            assert specs[f"opt.layers.{i}.wq.{key}"] == P(*mu_wq[1:])
            assert specs[f"opt.layers.{i}.wo.{key}"] == P("tp", None)
        assert specs[f"opt.layers.{i}.wq.step"] == P()
    assert specs["opt.lm_head.exp_avg"] == P(None, "tp")
    assert set(specs) == set(abstract["opt_state"])


def test_serve_tp2_tokens_equal_the_jax_replica():
    # the sample's flags at tp=2: the ranks draw the tp=1 replica's
    # weights (seed 0 on the CPU); the JAX package's greedy_decode_kv on
    # those weights, int8 and with the int8 KV cache, gives the tokens
    argv = ["--preset", "llama-tiny", "--quant", "int8", "--kv-cache-dtype",
            "int8", "--tp", "2", "--device", "cpu", "--port", "0"]
    httpd, replica = serve.build_server(argv)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    prompts = [[5, 9], [100, 2, 77, 31, 8, 4, 19], [240] * 11]
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
        got = []
        for p in prompts:
            req = urllib.request.Request(url, data=json.dumps(
                {"tokens": [p], "steps": 6}).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                got.append(json.loads(resp.read())["tokens"][0])
        stats = replica.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        replica.stop()
        thread.join(timeout=30)
    assert not thread.is_alive() and not replica._procs[0].is_alive()
    assert len(stats) == 2
    weights = tm.quantize_int8(tm.init_params(
        tm.PRESETS["llama-tiny"], torch.Generator().manual_seed(0)))
    pj = jax.tree.map(lambda t: jnp.asarray(
        t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
        else jnp.asarray(t.numpy()), weights)
    jcfg = dataclasses.replace(jm.PRESETS["llama-tiny"],
                               kv_cache_dtype="int8")
    want = [np.asarray(jm.greedy_decode_kv(
        pj, jnp.asarray([p], jnp.int32), 6, jcfg))[0].tolist()
        for p in prompts]
    assert got == want


def test_engine_usage_errors_under_tp_come_before_the_ranks(capsys,
                                                            monkeypatch):
    # --engine serves under --tp (tests/test_torch_tp_engine.py); a usage
    # error of its flags exits before any rank is started
    monkeypatch.setattr(serve, "_start_tp", None)
    with pytest.raises(SystemExit):
        serve.build_server(["--preset", "llama-tiny", "--tp", "2",
                            "--engine", "--attn-window", "8", "--rolling-kv",
                            "--engine-max-len", "8", "--device", "cpu",
                            "--port", "0"])
    assert "--engine-max-len >= 2*attn-window" in capsys.readouterr().err


def test_dryrun_multichip_on_eight_ranks(capsys):
    import re
    line = dryrun_multichip(8, device="cpu")
    assert line.startswith("dryrun_multichip ok: dp=2 x tp=4 loss=")
    assert "ep moe loss=" in line and "vit dp x tp loss=" in line
    assert "nan" not in line and "not ported" not in line
    assert line in capsys.readouterr().out
    # the reference's sequence- and pipeline-parallel parts, within its
    # limits (__graft_entry__.py:114-183, :214-242)
    assert "sp ring attention x8 err=" in line and "pp x4 err=" in line
    errs = {k: float(v) for k, v in re.findall(
        r"([a-z0-9-]+) err=([0-9.e+-]+)", line)}
    limits = {"x8": 1e-4, "gqa-ring": 1e-4, "zigzag": 1e-4,
              "ulysses-window": 1e-4, "x4": 1e-3}
    assert set(errs) == set(limits)
    for part, limit in limits.items():
        assert errs[part] < limit, (part, errs[part])
