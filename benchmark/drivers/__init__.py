"""One driver per kind of traffic, named by the traffic file's ``kind``
(``serve``, ``train``): each has ``run(ctx) -> dict``."""

import torch

from benchmark import cells


def port_config(conf: dict, tr: dict):
    """The port's ``ModelConfig`` for a configuration file and the
    traffic's serving or training settings."""
    from tpushare_torch.workloads.model import ModelConfig
    m = cells.model_sizes(conf)
    moe = ({"moe_experts": m["E"], "moe_top_k": m["k"],
            "moe_capacity_factor": m["capacity"]} if m["E"] else {})
    return ModelConfig(
        vocab=m["V"], d_model=m["d"], n_layers=m["L"], n_heads=m["H"],
        n_kv_heads=m["Hkv"], d_ff=m["f"], rope_theta=m["theta"],
        dtype=getattr(torch, m["dtype"]), attn=tr.get("attn", "einsum"),
        attn_window=m["window"],
        kv_cache_dtype=tr.get("kv_cache_dtype", "model"),
        moe_aux_weight=m["aux"], **moe).validate()
