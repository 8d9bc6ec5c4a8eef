"""Port serving replica (tpushare_torch/workloads/serve.py) on the CPU:
``build_server`` with ``--device cpu`` on an ephemeral port, served from a
thread and driven over HTTP."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workloads import model as jm
from tpushare.workloads.engine import DecodeEngine as JaxEngine
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import serve
from tpushare_torch.workloads.convert import params_from_numpy
from tpushare_torch.workloads.engine import DecodeEngine

torch.set_num_threads(2)

ENGINE_ARGV = ["--preset", "llama-tiny", "--device", "cpu", "--port", "0",
               "--engine", "--engine-slots", "4", "--engine-max-len", "64",
               "--engine-quantum", "3", "--attn", "flash",
               "--kv-cache-dtype", "int8"]


class _Server:
    def __init__(self, argv):
        self.httpd, self.front = serve.build_server(argv)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.front is not None:
            self.front.stop()
            self.front.join(timeout=10)
            assert not self.front._thread.is_alive()
        self.thread.join(timeout=10)

    def post(self, body, raw=None):
        data = raw if raw is not None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + "/generate", data=data)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def get(self, path):
        try:
            with urllib.request.urlopen(self.url + path, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()


@pytest.fixture(scope="module")
def server():
    s = _Server(ENGINE_ARGV)
    yield s
    s.close()


def _engine_tokens(server, prompts, steps):
    """The same prompts through a fresh engine of the replica's own
    weights and geometry."""
    front = server.front
    eng = DecodeEngine(front.engine.params, front.engine.cfg, max_slots=4,
                       max_len=64, quantum=3)
    rids = [eng.submit(p, steps) for p in prompts]
    out = eng.drain()
    return [list(p) + out[r] for p, r in zip(prompts, rids)]


def test_single_and_batch_generate_equal_the_engine(server):
    status, body = server.post({"tokens": [1, 2, 3], "steps": 5})
    assert status == 200
    single = json.loads(body)["tokens"]
    assert single == _engine_tokens(server, [[1, 2, 3]], 5)
    prompts = [[7, 8], [100] * 13, [3, 1, 4, 1, 5, 9, 2, 6]]
    status, body = server.post({"tokens": prompts, "steps": 6})
    assert status == 200
    assert json.loads(body)["tokens"] == _engine_tokens(server, prompts, 6)


def test_ndjson_stream(server):
    req = urllib.request.Request(
        server.url + "/generate",
        data=json.dumps({"tokens": [5, 6, 7], "steps": 8,
                         "stream": True}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        events = [json.loads(line) for line in r]
    deltas = [e["delta"] for e in events if "delta" in e]
    assert len(deltas[0]) == 1 and len(deltas) >= 3  # prefill, then quanta
    assert events[-1]["done"] is True
    assert events[-1]["tokens"] == [5, 6, 7] + sum(deltas, [])
    assert events[-1]["tokens"] == _engine_tokens(server, [[5, 6, 7]], 8)[0]


@pytest.mark.parametrize("body,raw,match", [
    ({"tokens": [1, 2], "steps": 0}, None, "steps 0"),
    ({"tokens": [[1, 2]], "steps": 2, "stream": True}, None, "ONE flat"),
    ({"tokens": [1, 999], "steps": 2}, None, "outside"),
    ({"tokens": [1] * 60, "steps": 10}, None, "exceeds max_len"),
    ({"tokens": [1], "steps": 2, "temperature": 0.5}, None,
     "per_request_sampling"),
    (None, b"{not json", "Expecting"),
], ids=["steps", "stream-batch", "vocab", "too-long", "sampling", "json"])
def test_bad_requests_get_400(server, body, raw, match):
    status, resp = server.post(body, raw)
    assert status == 400
    assert match in json.loads(resp)["error"]


def test_health_metrics_and_404(server):
    assert server.get("/healthz") == (200, b"ok")
    server.post({"tokens": [4, 4], "steps": 3})
    status, text = server.get("/metrics")
    text = text.decode()
    assert status == 200
    for name in ("tpushare_serve_requests_total",
                 "tpushare_serve_request_errors_total",
                 "tpushare_serve_generate_seconds_bucket{le=\"+Inf\"}",
                 'tpushare_serve_engine_slots{state="free"} 4.0',
                 "tpushare_serve_engine_queue_depth 0.0"):
        assert name in text, name
    generated = [ln for ln in text.splitlines()
                 if ln.startswith("tpushare_serve_tokens_generated_total ")]
    assert float(generated[0].split()[1]) >= 3
    waits = [ln for ln in text.splitlines() if ln.startswith(
        "tpushare_serve_engine_admission_wait_seconds_count ")]
    assert float(waits[0].split()[1]) >= 1
    assert server.get("/nope")[0] == 404
    assert server.post({"tokens": [1], "steps": 1}, None)[0] == 200
    req = urllib.request.Request(server.url + "/other", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 404


def test_pause_parks_the_engine_and_resume_drains(server):
    front = serve.frontend_for(os.environ.get("POD_NAME") or "llama-tiny")
    assert front is server.front
    assert front.pause(timeout=10) and front.paused
    result = {}
    t = threading.Thread(target=lambda: result.update(
        r=server.post({"tokens": [9, 9], "steps": 4})))
    t.start()
    deadline = time.monotonic() + 30
    while front.queue_depth < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # a loop that ignored the pause would take it now
    assert "r" not in result and front.queue_depth == 1
    front.resume()
    t.join(timeout=60)
    assert not t.is_alive() and result["r"][0] == 200


def test_served_tokens_equal_the_jax_engine():
    # the replica serving carried-across fp32 weights of the reference
    # gives the reference engine's greedy tokens
    jcfg = dataclasses.replace(jm.PRESETS["llama-tiny"], dtype=jnp.float32,
                               attn="flash")
    pj = jm.init_params(jcfg, jax.random.key(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    fp32 = dataclasses.replace(tm.PRESETS["llama-tiny"], dtype=torch.float32)
    prompts = [[5, 9], [100, 2, 77, 31, 8, 4, 19], [240] * 11]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tm.PRESETS, "llama-tiny", fp32)
        mp.setattr(tm, "init_params", lambda cfg, gen, int8: pt)
        s = _Server(["--preset", "llama-tiny", "--device", "cpu", "--port",
                     "0", "--engine", "--engine-slots", "4",
                     "--engine-max-len", "32", "--quant", "none",
                     "--attn", "flash"])
    try:
        status, body = s.post({"tokens": prompts, "steps": 7})
    finally:
        s.close()
    assert status == 200
    eng = JaxEngine(pj, jcfg, max_slots=4, max_len=32)
    rids = [eng.submit(p, 7) for p in prompts]
    out = eng.drain()
    ref = [p + [int(t) for t in out[r]] for p, r in zip(prompts, rids)]
    assert json.loads(body)["tokens"] == ref


def test_without_engine_serves_greedy_decode_kv():
    s = _Server(["--preset", "llama-tiny", "--device", "cpu", "--port", "0",
                 "--quant", "none"])
    try:
        status, body = s.post({"tokens": [[1, 2, 3], [4, 5, 6]], "steps": 4})
        assert s.post({"tokens": [1], "steps": 2, "stream": True})[0] == 400
    finally:
        s.close()
    assert status == 200
    rows = json.loads(body)["tokens"]
    assert len(rows) == 2 and all(len(r) == 7 for r in rows)


def test_moe_replica_serves_the_reference_greedy_decode_kv():
    # the non-engine replica of llama-moe-tiny serving carried-across fp32
    # weights gives the reference's KV-cached greedy tokens
    jcfg = dataclasses.replace(jm.PRESETS["llama-moe-tiny"],
                               dtype=jnp.float32, attn="flash")
    pj = jm.init_params(jcfg, jax.random.key(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    fp32 = dataclasses.replace(tm.PRESETS["llama-moe-tiny"],
                               dtype=torch.float32)
    prompts = [[5, 9, 200, 31, 8, 4], [100, 2, 77, 31, 8, 19]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tm.PRESETS, "llama-moe-tiny", fp32)
        mp.setattr(tm, "init_params", lambda cfg, gen, int8: pt)
        s = _Server(["--preset", "llama-moe-tiny", "--device", "cpu",
                     "--port", "0", "--quant", "none", "--attn", "flash"])
    try:
        assert s.front is None
        status, body = s.post({"tokens": prompts, "steps": 7})
    finally:
        s.close()
    assert status == 200
    ref = jm.greedy_decode_kv(pj, jnp.asarray(prompts, jnp.int32), 7, jcfg)
    assert json.loads(body)["tokens"] == np.asarray(ref).tolist()


@pytest.mark.parametrize("argv,exc,match", [
    # --tp 2 serves, with --engine too (tests/test_torch_sharded.py,
    # tests/test_torch_tp_engine.py); its usage errors come first
    (["--tp", "2", "--engine", "--no-kv-cache"], SystemExit,
     "--engine requires a KV-cached path"),
    (["--preset", "llama-moe-tiny", "--engine"], SystemExit,
     "--engine excludes MoE presets"),
])
def test_unported_options_raise(argv, exc, match, capsys):
    # a usage error exits with its message on stderr, as in the reference
    with pytest.raises(exc) as err:
        serve.build_server(["--device", "cpu", "--port", "0"] + argv)
    assert re.search(match, f"{err.value} {capsys.readouterr().err}")


def test_frontend_for_takes_a_pod_dict_or_a_name():
    front = object()
    serve.register_frontend("victim", front)
    try:
        assert serve.frontend_for({"metadata": {"name": "victim"}}) is front
        assert serve.frontend_for("victim") is front
        assert serve.frontend_for({"metadata": {"name": "other"}}) is None
        assert serve.frontend_for({}) is None
        assert serve.frontend_for("other") is None
    finally:
        serve.unregister_frontend("victim")
    assert serve.frontend_for("victim") is None
    serve.unregister_frontend("victim")  # unregistering twice is a no-op


def test_command_line_serves_and_stops_on_interrupt():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpushare_torch.workloads.serve", "--preset",
         "llama-tiny", "--device", "cpu", "--port", "0", "--engine",
         "--engine-max-len", "32"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        port = None
        for line in proc.stdout:
            if "ready on :" in line:
                port = int(line.split("ready on :")[1].split()[0])
                break
        assert port, "the server never said it was ready"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"tokens": [3, 4], "steps": 3}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            rows = json.loads(r.read())["tokens"]
        assert len(rows) == 1 and rows[0][:2] == [3, 4] and len(rows[0]) == 5
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
