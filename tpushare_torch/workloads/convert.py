"""Carry parameters across from the JAX package.

:func:`params_from_numpy` takes the reference's parameter pytree with
every leaf already converted to a numpy array (plain, or int8 weights as
``{"int8", "scale"}``) and returns the port's parameters, for either
family: the llama tree of ``model.init_params`` and the ViT tree of
``vit.init_vit_params`` have the same nesting in both packages. bf16 leaves
(numpy dtype name ``bfloat16``) go through float32, which is lossless, so
the port starts from bitwise the same weights. The caller does the
JAX-to-numpy step; this module never sees a JAX array.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: arrays that JAX exports are read-only
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts of numpy arrays -> the same dicts of torch tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf(np.asarray(tree), device)
