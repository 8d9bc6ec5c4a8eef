"""The migration seam wired across the two packages: the scheduler side's
``Migrator`` (tpushare/defrag/migration.py) over the port's
``WorkloadCheckpointer`` and ``serve.frontend_for``
(tpushare_torch/workloads/migrate.py, serve.py). The ``Migrator`` is
duck-typed, so neither package imports the other; this test holds both.

One session (``begin``: pause, save; ``commit``: restore, resume) against
a port engine replica at ``--tp 1`` and at ``--tp 2`` in mid-stream, whose
resumed stream must end in an uninterrupted run's tokens, and one against
a port ``TrainStateHandler``, whose train state must come back bitwise.
"""

import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tpushare.defrag.migration import Migrator
from tpushare_torch.workloads import checkpoint as ck
from tpushare_torch.workloads import migrate, serve
from tpushare_torch.workloads import model as tm

torch.set_num_threads(2)

ENGINE_ARGV = ["--preset", "llama-tiny", "--quant", "int8",
               "--kv-cache-dtype", "int8", "--device", "cpu", "--port", "0",
               "--engine", "--engine-slots", "4", "--engine-max-len", "32",
               "--engine-quantum", "1"]


class _Move:
    def to_dict(self):
        return {"from": "node-a", "to": "node-b"}


def _manifest(directory, name):
    return json.loads((directory / f"{name}.migration.json").read_text())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    return urllib.request.urlopen(req, timeout=120)


@pytest.mark.parametrize("tp", [1, 2])
def test_migrator_parks_and_resumes_an_engine_replica(tp, tmp_path,
                                                      monkeypatch):
    name = f"llama-replica-tp{tp}"
    monkeypatch.setenv("POD_NAME", name)   # the name it registers under
    httpd, front = serve.build_server(ENGINE_ARGV + ["--tp", str(tp)])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
    prompt, steps = [11, 12, 13], 24
    migrator = Migrator(checkpointer=migrate.WorkloadCheckpointer(
        str(tmp_path)), frontend_for=serve.frontend_for, budget_s=60)
    try:
        assert serve.frontend_for({"metadata": {"name": name}}) is front
        with _post(url, {"tokens": prompt, "steps": steps}) as r:
            want = json.loads(r.read())["tokens"][0]
        events = []
        with _post(url, {"tokens": prompt, "steps": steps,
                         "stream": True}) as r:
            lines = iter(r)
            events.append(json.loads(next(lines)))
            session = migrator.session({"metadata": {"name": name}}, _Move())
            session.begin()        # the engine parks between quanta
            assert front.paused
            assert _manifest(tmp_path, name)["phase"] == "checkpointed"
            reader = threading.Thread(target=lambda: events.extend(
                json.loads(line) for line in lines))
            reader.start()
            time.sleep(0.5)
            held = len(events)
            time.sleep(0.5)
            assert len(events) == held
            assert not any("done" in e for e in events)
            session.commit()       # restored, and the loop runs again
            assert not front.paused
            assert _manifest(tmp_path, name)["phase"] == "restored"
            reader.join(timeout=60)
            assert not reader.is_alive()
    finally:
        httpd.shutdown()
        httpd.server_close()
        front.stop()
        front.join(timeout=60)
        thread.join(timeout=30)
        serve.unregister_frontend(name)
    assert not front._thread.is_alive()
    assert events[-1]["done"] and events[-1]["tokens"] == want
    assert prompt + sum((e["delta"] for e in events if "delta" in e),
                        []) == want


def test_migrator_saves_and_restores_a_train_state(tmp_path):
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=torch.float32)
    _, init_fn, _, make_train = ck._family(cfg)
    tx, step = make_train(cfg)
    params = tm.train_params(init_fn(cfg, torch.Generator().manual_seed(0)))
    opt = tx.init(params)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 17)))
    for _ in range(2):
        params, opt, _ = step(params, opt, tokens)
    name = "llama-trainer"
    handler = migrate.TrainStateHandler(str(tmp_path / "ckpt"),
                                        lambda: (2, params, opt, cfg), tx)
    migrate.register_checkpointer(name, handler)
    migrator = Migrator(checkpointer=migrate.WorkloadCheckpointer(
        str(tmp_path)), frontend_for=serve.frontend_for, budget_s=60)
    try:
        # a trainer has no serve loop: the session only checkpoints
        session = migrator.session({"metadata": {"name": name}}, _Move())
        session.begin()
        assert handler.restored is None
        assert _manifest(tmp_path, name)["phase"] == "checkpointed"
        session.commit()
        assert _manifest(tmp_path, name)["phase"] == "restored"
    finally:
        migrate.unregister_checkpointer(name)
    r_params, r_opt, r_step = handler.restored
    assert r_step == 2
    la, lb = tm.param_leaves(params), tm.param_leaves(r_params)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b)
        sa, sb = opt.state[a], r_opt.state[b]
        assert sorted(sa) == sorted(sb)
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    # the restored state trains on as the live one does
    _, _, loss = step(params, opt, tokens)
    _, _, r_loss = step(r_params, r_opt, tokens)
    assert torch.equal(loss, r_loss)
