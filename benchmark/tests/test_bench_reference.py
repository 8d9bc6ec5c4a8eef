"""The plain reference against the port, at tiny sizes on the CPU, in
float32 on both sides: the forward of a Mistral-style and of a
Mixtral-style model, the int8 products and int8 keys and values through
the port's cached serving path, rolling-window decode, the training
loss, gradients and AdamW steps. Where both compute the same float32
arithmetic in another order, they agree to a few ulps of the values."""


import pytest
import torch

from benchmark import check, weights
from benchmark.reference import model as ref
from tpushare_torch.workloads import model as pm


def sizes(**kw):
    m = {"d": 64, "f": 128, "L": 2, "H": 4, "Hkv": 2, "hd": 16, "V": 256,
         "E": 0, "k": 0, "theta": 10000.0, "eps": 1e-6, "window": None,
         "aux": 0.0, "capacity": None, "dtype": "float32"}
    m.update(kw)
    return m


def port_cfg(m, **kw):
    return pm.ModelConfig(
        vocab=m["V"], d_model=m["d"], n_layers=m["L"], n_heads=m["H"],
        n_kv_heads=m["Hkv"], d_ff=m["f"], rope_theta=m["theta"],
        dtype=torch.float32, attn_window=m["window"], moe_experts=m["E"],
        moe_top_k=m["k"] or 2, moe_capacity_factor=m["capacity"] or 2.0,
        moe_aux_weight=m["aux"], **kw)


DENSE = sizes()
MOE = sizes(E=4, k=2, capacity=2.0, aux=0.02, theta=1e6)


@pytest.mark.parametrize("m", [DENSE, MOE, sizes(window=8)],
                         ids=["dense", "moe", "window"])
def test_forward_logits(m):
    w = weights.draw(m, 3, "cpu")
    tokens = torch.randint(m["V"], (1, 24), generator=torch.Generator()
                           .manual_seed(1))
    port = pm.forward(w, tokens, port_cfg(m))[0]
    got = ref.served_logits(w, m, [(tokens[0, :1].tolist(),
                                    tokens[0, 1:].tolist() + [0])],
                            ref.FP32, "cpu")[0]
    torch.testing.assert_close(got, port, rtol=1e-4, atol=1e-4)


def test_int8_weights_and_kv_through_the_cached_path():
    m = DENSE
    w = weights.draw(m, 4, "cpu")
    cfg = port_cfg(m, kv_cache_dtype="int8")
    q = pm.quantize_int8(w)
    tokens = torch.randint(m["V"], (1, 20), generator=torch.Generator()
                           .manual_seed(2))
    cache = pm.init_kv_cache(cfg, 1, 20)
    port, _ = pm.forward_cached(q, tokens, cache, 0, cfg)
    got = ref.served_logits(w, m, [(tokens[0, :1].tolist(),
                                    tokens[0, 1:].tolist() + [0])],
                            ref.Precision(weight_bits=8, kv_bits=8), "cpu")[0]
    torch.testing.assert_close(got, port[0], rtol=1e-4, atol=1e-4)


def test_rolling_window_decode_serves_the_reference_argmax():
    m = sizes(window=8)
    w = weights.draw(m, 5, "cpu")
    cfg = port_cfg(m)
    prompt = torch.randint(m["V"], (1, 19), generator=torch.Generator()
                           .manual_seed(3))
    out = pm.greedy_decode_kv(w, prompt, 12, cfg, rolling=True)[0].tolist()
    served = out[19:]
    logits = ref.served_logits(w, m, [(out[:19], served)], ref.FP32, "cpu")
    assert check.served_gap(logits, [served]) < 1e-4


def test_quantize_matches_the_port():
    w = torch.randn(3, 32, 48, generator=torch.Generator().manual_seed(0))
    q = pm.quantize_int8({"embed": w[0], "final_norm": w[0, 0],
                          "lm_head": w[0], "layers": {"wq": w}})
    port = q["layers"]["wq"]["int8"].float() * q["layers"]["wq"]["scale"]
    torch.testing.assert_close(ref.quantize(w, 8), port, rtol=0, atol=0)


def test_adamw_matches_torch():
    p = torch.randn(50, generator=torch.Generator().manual_seed(1))
    theirs = p.clone().requires_grad_()
    opt = torch.optim.AdamW([theirs], lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4, foreach=False)
    mine, ours = p.clone(), ref.AdamW()
    for t in range(1, 4):
        g = torch.randn(50, generator=torch.Generator().manual_seed(t))
        theirs.grad = g.clone()
        opt.step()
        ours.update("p", mine, g, t)
    torch.testing.assert_close(mine, theirs.detach(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("m", [DENSE, MOE],
                         ids=["dense", "moe"])
def test_three_training_steps(m):
    cfg = port_cfg(m)
    w = weights.draw(m, 6, "cpu")
    tx, step = pm.make_train_step(cfg, learning_rate=3e-4)
    params = pm.train_params(w)
    opt = tx.init(params)
    feed = weights.token_rows(6, m["V"], 2, 16, "cpu")
    batches = [next(feed) for _ in range(3)]
    losses, grads, samples = [], {}, {}
    for t, b in enumerate(batches, start=1):
        params, opt, loss = step(params, opt, b)
        losses.append(float(loss))
        if t == 1:
            for k, v in pm.named_leaves(params):
                g = opt.state[v]["exp_avg"] / 0.1
                grads[k] = float(g.norm())
                samples[k] = g.reshape(-1)[check.sample_index(
                    g.numel(), 6, k, "cpu")]
                if k == "embed":
                    rows = g[check.once(batches[0][:, :-1])[1]]
    change = check.change_norms(m, 6, w, "cpu")
    program = {"losses": losses, "grads": grads, "change": change,
               "samples": samples, "rows": rows}
    tr = {"check": {"steps": 3}, "batch": 2, "seq": 16,
          "learning_rate": 3e-4}
    reference = check.train_reference(m, 6, tr, "cpu")
    numbers = check.train_numbers(program, reference)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4
    assert numbers["grad_diff_median"] < 1e-4
    assert numbers["routed_row_gap"] < 1e-4
