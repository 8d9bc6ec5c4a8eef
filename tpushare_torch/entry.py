"""Compile-check entry point of the port: the llama-mini forward.

Counterpart of ``__graft_entry__.entry``: returns ``(fn, args)`` where
``fn(*args)`` is the llama-mini forward on a batch of 2 x 128 random
tokens, with weights and tokens drawn from fixed seeds on ``device``.
``attn="flash"`` (the default) routes every layer's attention through
the flash-attention kernel; ``attn="einsum"`` is the plain path it is
compared with.
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
