"""The port's AFMoE (Arcee Trinity) model on the CPU: ``trinity-mini-tiny``
(d 64, 4 heads of head_dim 32 != d / heads, 2 kv heads, 6 layers S S S F
S S with one dense, 4 of 16 sigmoid-routed experts held, top-4, a shared
expert, window 24 at S 64) against the benchmark's plain reference
(``benchmark/reference/afmoe.py``) on seeded random weights; the MoE
layer's dropless path against every expert computed; shares of the
experts against the uncut layer, and training on a dp x ep gloo mesh
against one process; and the old configurations' graphs against the
same configurations with the new fields spelt out.

Both sides compute in float32 here, in another order, so the gaps are
a few ulps of the values; each tolerance says what it allows."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks

from benchmark import check, weights, weights_afmoe
from benchmark.drivers.train_afmoe import port_config, train_reference
from benchmark.reference import afmoe as ref
from tpushare_torch.workloads import model as pm
from tpushare_torch.workloads import moe, parallel, player

TINY = dataclasses.replace(pm.PRESETS["trinity-mini-tiny"],
                           dtype=torch.float32)
SIZES = {"d": 64, "L": 6, "H": 4, "Hkv": 2, "hd": 32, "V": 256,
         "types": ["sliding_attention"] * 3 + ["full_attention"]
         + ["sliding_attention"] * 2, "window": 24, "theta": 10000.0,
         "eps": 1e-5, "fd": 96, "Ld": 1, "E": 16, "held": 4, "k": 4, "f": 32,
         "fs": 32, "route_scale": 2.826, "bias_rate": 1e-3,
         "embed_scale": 8.0, "dtype": "float32"}
TRAFFIC = {"batch": 2, "seq": 64, "learning_rate": 3e-4,
           "check": {"steps": 3}}
ATTN = ["einsum", "flash"]
ROOT = Path(__file__).resolve().parent.parent


def test_the_sizes_are_the_preset():
    assert port_config(SIZES, {}) == dataclasses.replace(TINY, attn="einsum")
    assert TINY.head_dim == 32 != TINY.d_model // TINY.n_heads
    assert [TINY.window_of(i) for i in range(6)] == [24, 24, 24, None, 24, 24]
    assert [TINY.rope_of(i) for i in range(6)] == [True] * 3 + [False] \
        + [True] * 2
    assert [TINY.moe_layer(i) for i in range(6)] == [False] + [True] * 5


def test_the_l8_preset_is_the_benchmark_configuration():
    conf = json.loads((ROOT / "benchmark" / "configs"
                       / "trinity-mini-l8.json").read_text())
    assert port_config(weights_afmoe.sizes(conf), {}) == \
        pm.PRESETS["trinity-mini-l8"]


def test_flash_gets_each_layers_window(monkeypatch):
    seen = []
    flash = pm.flash_attention

    def recording(q, k, v, causal, window=None):
        seen.append(window)
        return flash(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(pm, "flash_attention", recording)
    w = weights_afmoe.draw(SIZES, 5, "cpu")
    pm.forward(w, torch.zeros((1, 40), dtype=torch.long),
               dataclasses.replace(TINY, attn="flash"))
    assert seen == [24, 24, 24, None, 24, 24]


@pytest.mark.parametrize("attn", ATTN)
def test_logits_match_the_reference(attn):
    w = weights_afmoe.draw(SIZES, 5, "cpu")
    tokens = torch.randint(256, (2, 64), generator=torch.Generator()
                           .manual_seed(1))
    port = pm.forward(w, tokens, dataclasses.replace(TINY, attn=attn))
    # float32 on both sides in another order: a few ulps of logits ~1
    torch.testing.assert_close(port, ref.logits(w, SIZES, tokens),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("attn", ATTN)
def test_loss_and_every_first_gradient_match_the_reference(attn):
    cfg = dataclasses.replace(TINY, attn=attn)
    params = pm.train_params(weights_afmoe.draw(SIZES, 9, "cpu"))
    batch = next(weights.token_rows(9, 256, 2, 64, "cpu"))
    loss = pm.loss_fn(params, batch, cfg)
    loss.backward()
    got = {k: v.grad for k, v in pm.named_leaves(params)
           if v.grad is not None}
    want, route = {}, {}

    def on_grad(t, key, grad):
        want[key] = grad.clone()
    losses = ref.train(weights_afmoe.draw(SIZES, 9, "cpu"), SIZES, [batch],
                       ref.AdamW(), on_grad=on_grad,
                       on_route=lambda m: route.update(margin=m.min()))
    # every token's 4th and 5th choice lie apart by more than the float32
    # round-off of the router's input (~1e-6 here: the two attention
    # paths differ by that much), so both sides choose the same experts;
    # some seeds hold exact ties, at which either choice is right
    assert float(route["margin"]) > 1e-5
    # the loss: float32 sums of ~1e4 terms in another order
    assert abs(float(loss.detach()) - losses[0]) < 1e-5
    assert set(got) == set(want) and len(got) == 3 + 6 * 11 + 3 + 5 * 7
    for key, g in want.items():
        # each leaf's gradient to 1e-4 of its norm: the float32 round-off
        # of a backward through six layers, orders of magnitude under
        # what a wrong term (a missing norm, RoPE on a full layer) moves
        gap = float((got[key] - g).norm()) / max(float(g.norm()), 1e-30)
        assert gap < 1e-4, (key, gap)


def test_three_steps_with_the_bias_update_match_the_reference():
    w = weights_afmoe.draw(SIZES, 7, "cpu")
    tx, step = pm.make_train_step(TINY, learning_rate=3e-4)
    params = pm.train_params(w)
    opt = tx.init(params)
    feed = weights.token_rows(7, 256, 2, 64, "cpu")
    losses, grads, samples = [], {}, {}
    for t in range(1, 4):
        batch = next(feed)
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        if t == 1:
            for k, v in pm.named_leaves(params):
                if k.rsplit(".", 1)[-1] in pm.BUFFERS:
                    continue
                g = opt.state[v]["exp_avg"] / 0.1
                grads[k] = float(g.norm())
                samples[k] = g.reshape(-1)[check.sample_index(
                    g.numel(), 7, k, "cpu")]
                if k == "embed":
                    rows = g[check.once(batch[:, :-1])[1]]
    program = {"losses": losses, "grads": grads, "samples": samples,
               "change": weights_afmoe.change_norms(SIZES, 7, w, "cpu"),
               "rows": rows}
    reference = train_reference(SIZES, 7, TRAFFIC, "cpu")
    numbers = check.train_numbers(program, reference)
    # float32 on both sides; AdamW's steps carry the gradients' ulps
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4
    assert numbers["grad_diff_median"] < 1e-4
    assert numbers["routed_row_gap"] < 1e-4
    # the selection bias after three updates: both sides chose the same
    # experts, so their sign steps agree to float32 round-off
    rw = weights_afmoe.draw(SIZES, 7, "cpu")
    feed = weights.token_rows(7, 256, 2, 64, "cpu")
    ref.train(rw, SIZES, [next(feed) for _ in range(3)], ref.AdamW())
    moved = w["layers"]["router_bias"]
    assert 0 < float(moved.abs().max()) <= 3 * 2 * 1e-3
    torch.testing.assert_close(moved, rw["layers"]["router_bias"],
                               rtol=0, atol=1e-9)


def test_held_experts_without_pairs_step_alike():
    """Every MoE layer's held experts biased out of every token's top-k:
    both sides take their weights' gradient as zero, so AdamW only
    decays them, and the rest trains as before."""
    def starved():
        w = weights_afmoe.draw(SIZES, 7, "cpu")
        w["layers"]["router_bias"][:, :SIZES["held"]] -= 10.0
        return w
    w, rw = starved(), starved()
    tx, step = pm.make_train_step(TINY, learning_rate=3e-4)
    params = pm.train_params(w)
    opt = tx.init(params)
    feed = weights.token_rows(7, 256, 2, 64, "cpu")
    batches = [next(feed) for _ in range(2)]
    losses = []
    for batch in batches:
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    want = ref.train(rw, SIZES, batches, ref.AdamW(lr=3e-4))
    # float32 on both sides, another order of summation
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
    decayed = (1 - 3e-4 * ref.AdamW.wd) ** 2
    drawn = weights_afmoe.draw(SIZES, 7, "cpu")["layers"]
    for name in ("w1", "w3", "w2"):
        torch.testing.assert_close(w["layers"][name], drawn[name] * decayed,
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(rw["layers"][name], w["layers"][name],
                                   rtol=1e-6, atol=0)


def _layer_params(E=16, held=None, d=64, f=32, fs=32, seed=0):
    """One MoE layer's float32 weights: the router over E, the experts
    [lo, hi) of ``held``, a shared expert and a random selection bias."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = held or (0, E)
    full = {"wg": torch.randn(d, E, generator=g) * d ** -0.5,
            "w1": torch.randn(E, d, f, generator=g) * d ** -0.5,
            "w3": torch.randn(E, d, f, generator=g) * d ** -0.5,
            "w2": torch.randn(E, f, d, generator=g) * f ** -0.5,
            "shared_w1": torch.randn(d, fs, generator=g) * d ** -0.5,
            "shared_w3": torch.randn(d, fs, generator=g) * d ** -0.5,
            "shared_w2": torch.randn(fs, d, generator=g) * fs ** -0.5,
            "router_bias": torch.randn(E, generator=g) * 0.01}
    return {k: v[lo:hi] if k in ("w1", "w3", "w2") else v
            for k, v in full.items()}


def _moe_cfg(held=None, **kw):
    base = dict(d_model=64, d_ff=32, n_experts=16, top_k=4,
                capacity_factor=None, dtype=torch.float32, score="sigmoid",
                route_scale=2.826, shared_d_ff=32, held=held)
    base.update(kw)
    return moe.MoEConfig(**base)


def test_four_shares_with_the_shared_expert_once_add_up_to_the_layer():
    x = torch.randn(3, 40, 64, generator=torch.Generator().manual_seed(1))
    whole, _ = moe.moe_ffn(_layer_params(), x, _moe_cfg())
    shares = [moe.moe_ffn(_layer_params(held=(lo, lo + 4)), x,
                          _moe_cfg(held=(lo, lo + 4)))[0]
              for lo in range(0, 16, 4)]
    shared = moe._shared(_layer_params(), x.reshape(-1, 64)).reshape(x.shape)
    # float32 sums of the same terms grouped otherwise
    torch.testing.assert_close(sum(shares) - 3 * shared, whole,
                               rtol=1e-5, atol=1e-5)


def _bias(kind):
    b = torch.zeros(16)
    if kind == "skewed":
        b[0] = 5.0           # every token's first choice is expert 0
    elif kind == "starved":
        b[2] = -5.0          # no token picks held expert 2
    return b


@pytest.mark.parametrize("score,kind", [
    ("sigmoid", "skewed"), ("sigmoid", "starved"), ("sigmoid", "random"),
    ("softmax", "random")])
def test_dropless_equals_every_expert_computed(score, kind):
    cfg = _moe_cfg(held=(0, 4), score=score,
                   route_scale=2.826 if score == "sigmoid" else 1.0)
    p = _layer_params(held=(0, 4), seed=3)
    if score == "sigmoid" and kind != "random":
        p["router_bias"] = _bias(kind)
    if score == "softmax":
        p = {k: v for k, v in p.items() if k != "router_bias"}
    x = torch.randn(96, 64, generator=torch.Generator().manual_seed(4))
    idx, _, _ = moe._choose(x @ p["wg"], cfg, p.get("router_bias"))
    load = torch.bincount(idx.reshape(-1), minlength=16)[:4]
    if kind == "skewed":
        assert int(load[0]) > int(load.sum()) // 2
    if kind == "starved":
        assert int(load[2]) == 0 and int(load.sum()) > 0
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()
              if k != "router_bias"}
    got, _ = moe.moe_ffn({**p, **leaves}, x, cfg)
    want = moe.moe_ffn_reference({**p, **leaves}, x, cfg)
    # the same float32 products, summed over k in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(5))
    g1 = torch.autograd.grad(got, list(leaves.values()), dy)
    g2 = torch.autograd.grad(want, list(leaves.values()), dy)
    for name, a, b in zip(leaves, g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


def test_held_experts_must_split_over_ep():
    class Mesh:
        mesh_dim_names = ("ep",)

        def size(self, i):
            return 2
    with pytest.raises(ValueError, match="do not split"):
        moe.moe_ffn(_layer_params(held=(0, 4)), torch.zeros(4, 64),
                    _moe_cfg(held=(0, 4)), mesh=Mesh())


def test_ep_split_training_matches_the_uncut_model():
    """Two steps on a dp 2 x ep 2 gloo mesh (the held experts split over
    "ep", combined by its all-reduce; the selection bias stepped from
    counts summed over "dp") against the same steps in one process. fp32
    throughout. The losses differ by the all-reduces' other order of
    summation; a leaf by up to a tenth of the two steps' lr (6e-5), since
    AdamW divides by sqrt(v) and so turns that rounding, on an element
    whose gradient is near zero, into a share of a whole step."""
    rng = np.random.default_rng(4)
    data = {"steps": 2, "tokens": [rng.integers(0, 256, (4, 33))
                                   for _ in range(2)]}
    ranks = parallel.run_ranks(torch_ranks.afmoe_ep_checks, 4, data,
                               timeout=300)
    cfg = TINY
    params = pm.train_params(pm.init_params(cfg, torch.Generator()
                                            .manual_seed(0)))
    tx, step = pm.make_train_step(cfg)
    opt = tx.init(params)
    losses = []
    for tokens in data["tokens"]:
        params, opt, loss = step(params, opt, torch.as_tensor(tokens))
        losses.append(float(loss))
    want = {n: w.detach().numpy() for n, w in pm.named_leaves(params)}
    assert ranks[0]["local_experts"] == 2
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        assert set(r["leaves"]) == set(want)
        for n, w in want.items():
            np.testing.assert_allclose(r["leaves"][n], w, rtol=0,
                                       atol=6e-5, err_msg=n)
    bias = [n for n in want if n.endswith("router_bias")]
    assert len(bias) == 5 and all(np.abs(want[n]).sum() > 0 for n in bias)


def test_afmoe_leaves_refuse_a_tp_mesh():
    class Mesh:
        mesh_dim_names = ("dp", "tp")

        def size(self, i):
            return 2
    with pytest.raises(ValueError, match="'tp'"):
        pm.init_params(TINY, torch.Generator().manual_seed(0), mesh=Mesh())


def _train_twice(seed):
    cfg = pm.PRESETS["trinity-mini-tiny"]
    params = pm.train_params(pm.init_params(cfg, torch.Generator()
                                            .manual_seed(seed)))
    tx, step = pm.make_train_step(cfg)
    opt = tx.init(params)
    feed = weights.token_rows(seed, 256, 2, 33, "cpu")
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, next(feed))
        losses.append(float(loss))
    return losses, [w.clone() for _, w in pm.named_leaves(params)]


def test_two_runs_are_bitwise_equal():
    (l1, w1), (l2, w2) = _train_twice(3), _train_twice(3)
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(w1, w2)) and len(w1) > 100


def _spelt_out(cfg):
    """``cfg`` with every new field at the value its default stands for."""
    kw = dict(block="llama", head_size=cfg.d_model // cfg.n_heads,
              rms_norm_eps=1e-6)
    if cfg.moe_experts:
        kw.update(moe_d_ff=cfg.d_ff, moe_route_scale=1.0,
                  moe_held=(0, cfg.moe_experts), dense_layers=0,
                  moe_shared_d_ff=0, moe_bias_rate=0.0)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("preset", ["llama-tiny", "llama-moe-tiny"])
@pytest.mark.parametrize("window", [None, 5])
def test_default_configs_keep_their_graphs(preset, window):
    cfg = dataclasses.replace(pm.PRESETS[preset], attn_window=window)
    tokens = torch.randint(256, (2, 17), generator=torch.Generator()
                           .manual_seed(2))
    out = []
    for c in (cfg, _spelt_out(cfg)):
        params = pm.train_params(pm.init_params(c, torch.Generator()
                                                .manual_seed(9)))
        loss = pm.loss_fn(params, tokens, c)
        loss.backward()
        out.append([loss] + [w.grad for _, w in pm.named_leaves(params)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("attn", ATTN)
def test_player_trains_trinity_tiny_on_cpu(attn, capsys):
    record = player.run(["--preset", "trinity-mini-tiny", "--mode", "train",
                         "--attn", attn, "--steps", "2", "--seq", "33",
                         "--device", "cpu"])
    assert record["steps"] == 2
    assert all(torch.isfinite(torch.tensor(record["losses"])))
    assert "step 2: " in capsys.readouterr().out
