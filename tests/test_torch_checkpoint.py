"""The port's checkpoint/resume (tpushare_torch/workloads/checkpoint.py)
and migration seam (tpushare_torch/workloads/migrate.py) on the CPU.

The round trips are bitwise: what is restored is what was saved, for
llama-tiny and vit-tiny, parameters and AdamW state alike, and a step
taken after a restore is the step the uninterrupted run takes.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tpushare_torch.workloads import checkpoint as ck
from tpushare_torch.workloads import migrate
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import vit as tv

torch.set_num_threads(2)

FAMILIES = {
    "llama": lambda: dataclasses.replace(tm.PRESETS["llama-tiny"],
                                         dtype=torch.float32),
    "vit": lambda: tv.PRESETS_VIT["vit-tiny"],
    # bf16 experts beside the fp32 router
    "moe": lambda: tm.PRESETS["llama-moe-tiny"],
    # the sigmoid router's selection bias, which no optimizer steps
    "afmoe": lambda: tm.PRESETS["trinity-mini-tiny"],
}


def _batch(cfg):
    rng = np.random.default_rng(3)
    if isinstance(cfg, tv.ViTConfig):
        return (torch.from_numpy(rng.standard_normal(
                    (2, cfg.image, cfg.image, cfg.channels),
                    dtype=np.float32)),
                torch.from_numpy(rng.integers(0, cfg.classes, (2,))))
    return (torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17))),)


def _trained(cfg, steps=1):
    """(params, opt_state, tx, train_step) after ``steps`` steps from
    seed 0."""
    _, init_fn, _, make_train = ck._family(cfg)
    tx, step = make_train(cfg)
    params = tm.train_params(init_fn(cfg, torch.Generator().manual_seed(0)))
    opt = tx.init(params)
    for _ in range(steps):
        params, opt, _ = step(params, opt, *_batch(cfg))
    return params, opt, tx, step


def _assert_same_state(a_params, a_opt, b_params, b_opt):
    na, nb = list(tm.named_leaves(a_params)), list(tm.named_leaves(b_params))
    assert [n for n, _ in na] == [n for n, _ in nb]
    for (_, x), (_, y) in zip(na, nb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    la, lb = tm.param_leaves(a_params), tm.param_leaves(b_params)
    for x, y in zip(la, lb):
        sa, sb = a_opt.state[x], b_opt.state[y]
        assert sorted(sa) == sorted(sb) == ["exp_avg", "exp_avg_sq", "step"]
        for key in sa:
            assert sa[key].dtype == sb[key].dtype
            assert torch.equal(sa[key], sb[key]), key


@pytest.mark.parametrize("family", list(FAMILIES))
def test_round_trip_is_bitwise(family, tmp_path):
    cfg = FAMILIES[family]()
    params, opt, tx, step = _trained(cfg)
    ckpt = ck.TrainCheckpointer(str(tmp_path))
    ckpt.save(1, params, opt, cfg)
    assert ckpt.steps() == [1] and ckpt.latest_step() == 1
    r_params, r_opt, r_step = ckpt.restore(cfg, tx, device="cpu")
    assert r_step == 1
    _assert_same_state(params, opt, r_params, r_opt)
    assert r_opt.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    # the restored state is live: the next step is the uninterrupted one
    params, opt, loss = step(params, opt, *_batch(cfg))
    r_params, r_opt, r_loss = step(r_params, r_opt, *_batch(cfg))
    assert torch.equal(loss, r_loss)
    _assert_same_state(params, opt, r_params, r_opt)


def test_moe_round_trip_keeps_the_router_state_fp32(tmp_path):
    cfg = FAMILIES["moe"]()
    params, opt, tx, _ = _trained(cfg, steps=2)
    ckpt = ck.TrainCheckpointer(str(tmp_path))
    ckpt.save(2, params, opt, cfg)
    r_params, r_opt, _ = ckpt.restore(cfg, tx, device="cpu")
    _assert_same_state(params, opt, r_params, r_opt)
    for lp in r_params["layers"]:
        assert lp["wg"].dtype == torch.float32
        assert lp["w1"].dtype == torch.bfloat16 and lp["w1"].dim() == 3
        for key in ("exp_avg", "exp_avg_sq"):
            assert r_opt.state[lp["wg"]][key].dtype == torch.float32
            assert r_opt.state[lp["w1"]][key].dtype == torch.bfloat16
    # the geometry guard tells an MoE checkpoint from a dense one
    with pytest.raises(ValueError, match="moe_experts"):
        ckpt.restore(dataclasses.replace(cfg, moe_experts=0), tx,
                     device="cpu")


def test_afmoe_round_trip_keeps_the_selection_bias(tmp_path):
    cfg = FAMILIES["afmoe"]()
    params, opt, tx, _ = _trained(cfg, steps=2)
    ckpt = ck.TrainCheckpointer(str(tmp_path))
    ckpt.save(2, params, opt, cfg)
    r_params, r_opt, _ = ckpt.restore(cfg, tx, device="cpu")
    _assert_same_state(params, opt, r_params, r_opt)
    moe_layers = [lp for lp in r_params["layers"] if "router_bias" in lp]
    assert len(moe_layers) == cfg.n_layers - cfg.dense_layers
    for lp in moe_layers:
        assert lp["router_bias"].dtype == torch.float32
        assert lp["router_bias"].abs().sum() > 0
        assert not lp["router_bias"].requires_grad
        assert lp["router_bias"] not in r_opt.state


@pytest.mark.parametrize("family", list(FAMILIES))
def test_resume_or_init_fresh_then_resumed(family, tmp_path):
    cfg = FAMILIES[family]()
    ckpt, tx, step = ck.make_resumable_trainer(cfg, str(tmp_path))
    params, opt, start = ckpt.resume_or_init(
        cfg, tx, torch.Generator().manual_seed(0))
    assert start == 0 and not opt.state
    fresh = tm.train_params(ck._family(cfg)[1](
        cfg, torch.Generator().manual_seed(0)))
    for a, b in zip(tm.param_leaves(params), tm.param_leaves(fresh)):
        assert torch.equal(a, b)
    for i in range(3):
        params, opt, _ = step(params, opt, *_batch(cfg))
        ckpt.maybe_save(i + 1, params, opt, cfg, every=2)
    assert ckpt.steps() == [2]
    # a second process with the same directory resumes at step 2
    again = ck.TrainCheckpointer(str(tmp_path))
    r_params, r_opt, start = again.resume_or_init(
        cfg, tx, torch.Generator().manual_seed(5))
    assert start == 2
    assert int(r_opt.state[tm.param_leaves(r_params)[0]]["step"]) == 2


def _save_llama(tmp_path):
    cfg = FAMILIES["llama"]()
    params, opt, tx, _ = _trained(cfg)
    ckpt = ck.TrainCheckpointer(str(tmp_path))
    ckpt.save(1, params, opt, cfg)
    return ckpt, cfg, tx


def test_geometry_and_family_guard_fires_before_state_is_read(
        tmp_path, monkeypatch):
    ckpt, cfg, tx = _save_llama(tmp_path)

    def no_read(*args):
        raise AssertionError("state was read before the geometry check")

    monkeypatch.setattr(ck, "_load_state", no_read)
    wider = dataclasses.replace(cfg, d_model=128)
    with pytest.raises(ValueError, match="geometry") as err:
        ckpt.restore(wider, tx, device="cpu")
    assert "'d_model': 64" in str(err.value) and \
        "'d_model': 128" in str(err.value)
    vit_cfg = FAMILIES["vit"]()
    with pytest.raises(ValueError, match="'family': 'vit'"):
        ckpt.restore(vit_cfg, tv.make_vit_train_step(vit_cfg)[0],
                     device="cpu")
    # dtype is not geometry: the guard passes and the state is read
    with pytest.raises(AssertionError, match="state was read"):
        ckpt.restore(dataclasses.replace(cfg, dtype=torch.bfloat16), tx,
                     device="cpu")


def test_checkpoint_without_family_tag_is_llama(tmp_path):
    ckpt, cfg, tx = _save_llama(tmp_path)
    meta = tmp_path / "1" / ck.META
    record = json.loads(meta.read_text())
    del record["geometry"]["family"]
    meta.write_text(json.dumps(record))
    _, _, step = ckpt.restore(cfg, tx, device="cpu")
    assert step == 1


def test_no_checkpoint_and_unknown_family(tmp_path):
    cfg = FAMILIES["llama"]()
    ckpt = ck.TrainCheckpointer(str(tmp_path / "new"))
    assert ckpt.latest_step() is None and ckpt.steps() == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(cfg, tm.AdamW(3e-4), device="cpu")

    @dataclasses.dataclass(frozen=True)
    class Other:
        d_model: int = 8

    with pytest.raises(TypeError, match="Other"):
        ck._geometry(Other())


def test_keep_retention_maybe_save_cadence_and_leftovers(tmp_path):
    cfg = FAMILIES["vit"]()
    params, opt, _, _ = _trained(cfg)
    ckpt = ck.TrainCheckpointer(str(tmp_path), keep=2)
    saved = [s for s in range(1, 8)
             if ckpt.maybe_save(s, params, opt, cfg, every=2)]
    assert saved == [2, 4, 6]
    assert ckpt.steps() == [4, 6]
    assert not ckpt.maybe_save(8, params, opt, cfg, every=0)
    # a crash mid-save leaves a temporary directory (and a step directory
    # without its meta.json is a half-written one): neither is a step
    (tmp_path / ".tmp-9-dead").mkdir()
    (tmp_path / ".tmp-9-dead" / "__0_0.distcp").write_bytes(b"partial")
    (tmp_path / "10").mkdir()
    assert ckpt.steps() == [4, 6] and ckpt.latest_step() == 6
    assert sorted(os.listdir(tmp_path / "6")) == [".metadata",
                                                  "__0_0.distcp", ck.META]
    # saving a step again replaces it whole
    ckpt.save(6, params, opt, cfg)
    assert ckpt.steps() == [4, 6]
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith(".tmp-") and p != ".tmp-9-dead"]


# -- migrate ------------------------------------------------------------------

class _Handler:
    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def save(self, pod, move):
        if self.fail:
            raise RuntimeError("disk full")
        self.calls.append(("save", pod, move))

    def restore(self, pod, move):
        self.calls.append(("restore", pod, move))


class _Move:
    def to_dict(self):
        return {"from": "node-a", "to": "node-b"}


def test_handler_dispatch_and_atomic_manifest(tmp_path):
    handler = _Handler()
    pod = {"metadata": {"name": "vit-finetune"}}
    migrate.register_checkpointer("vit-finetune", handler)
    try:
        seam = migrate.WorkloadCheckpointer(str(tmp_path))
        seam.save(pod, _Move())
        record = json.loads((tmp_path / "vit-finetune.migration.json")
                            .read_text())
        assert record["phase"] == "checkpointed"
        assert record["move"] == {"from": "node-a", "to": "node-b"}
        seam.restore(pod, _Move())
        assert [c[0] for c in handler.calls] == ["save", "restore"]
        record = json.loads((tmp_path / "vit-finetune.migration.json")
                            .read_text())
        assert record["phase"] == "restored"
        assert os.listdir(tmp_path) == ["vit-finetune.migration.json"]
        # a pod with no handler still gets its manifest
        seam.save("other-pod", "move-3")
        record = json.loads((tmp_path / "other-pod.migration.json")
                            .read_text())
        assert record["move"] == "move-3" and len(handler.calls) == 2
        # a failing handler aborts the move before the manifest says it
        # is durable
        migrate.register_checkpointer("vit-finetune", _Handler(fail=True))
        with pytest.raises(RuntimeError, match="disk full"):
            seam.save(pod, _Move())
        record = json.loads((tmp_path / "vit-finetune.migration.json")
                            .read_text())
        assert record["phase"] == "restored"
    finally:
        migrate.unregister_checkpointer("vit-finetune")
    migrate.unregister_checkpointer("vit-finetune")  # idempotent
    # without a directory nothing is written
    migrate.WorkloadCheckpointer().save(pod, _Move())


def test_train_state_handler_saves_and_restores(tmp_path):
    cfg = FAMILIES["vit"]()
    params, opt, tx, _ = _trained(cfg, steps=2)
    handler = migrate.TrainStateHandler(
        str(tmp_path), lambda: (2, params, opt, cfg), tx)
    migrate.register_checkpointer("vit-finetune", handler)
    try:
        seam = migrate.WorkloadCheckpointer()
        seam.save("vit-finetune", _Move())
        assert handler.restored is None
        seam.restore("vit-finetune", _Move())
    finally:
        migrate.unregister_checkpointer("vit-finetune")
    r_params, r_opt, step = handler.restored
    assert step == 2
    _assert_same_state(params, opt, r_params, r_opt)
    assert tm.param_leaves(r_params)[0].device.type == "cpu"
