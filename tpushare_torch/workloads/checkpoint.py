"""Training checkpoint/resume on one process: the port of
``tpushare/workloads/checkpoint.py``.

A trainer that is preempted and placed again resumes from its latest
durable step instead of from scratch; ``samples/7-vit.yaml``'s "an
eviction costs at most ``--ckpt-every`` steps" rests on it. The
reference writes through orbax; the port writes through
``torch.distributed.checkpoint`` (DCP), one process, no process group:

- **State.** The parameters of a trainable tree
  (:func:`~tpushare_torch.workloads.model.train_params`, either family)
  and the AdamW state of its optimizer (both moments
  and the step count of every parameter), as one flat DCP state dict
  keyed ``params.<path>`` and ``opt.<path>.<state key>``; the
  optimizer's hyperparameters come from ``tx`` on restore.
- **Durable and atomic steps.** :meth:`TrainCheckpointer.save` writes a
  step into a temporary directory (DCP syncs every file), adds
  ``meta.json``, and renames the directory to the step's name with
  ``os.replace``; it returns once the step is durable. A temporary
  directory left by a crash is never listed as a step.
- **Retention.** The newest ``keep`` steps stay; older ones are deleted
  after each save.
- **Geometry guard.** The model's geometry and family tag are stored in
  ``meta.json`` and checked before any state is read: resuming a ViT run
  from a llama checkpoint, or a d_model 512 run from a d_model 4096 one,
  raises ``ValueError`` naming both. A checkpoint without a family tag
  is llama, as in the reference.

Not ported yet: sharded save and cross-mesh restore (the reference's
``abstract_train_state`` and ``opt_specs_like``), which wait for the
port's sharded slice and its DTensors (ROADMAP.md Queue 1 item 12).
Loading checkpoints across the two frameworks is not a goal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import uuid
import warnings
from pathlib import Path
from typing import Any

import torch

from tpushare_torch.workloads.model import (
    ModelConfig, init_params, make_train_step, named_leaves, train_params)

# geometry fields that must match between the checkpoint and the resuming
# process (the reference's lists); dtype is deliberately absent (a bf16
# run may resume an fp32 experiment) and attn/attn_window too (knobs,
# not state shape)
_GEOMETRY_FIELDS = ("vocab", "d_model", "n_layers", "n_heads",
                    "n_kv_heads", "d_ff", "moe_experts", "moe_top_k")
_VIT_GEOMETRY_FIELDS = ("image", "patch", "channels", "d_model",
                        "n_layers", "n_heads", "d_ff", "classes")
META = "meta.json"
_TMP_PREFIX = ".tmp-"


def _family(cfg):
    """(family_name, init_fn, geometry_fields, make_train): the one
    dispatch point for every call site, so state shapes, geometry and the
    train step always agree on the family. The ViT import stays lazy; an
    unknown config type fails here."""
    if isinstance(cfg, ModelConfig):
        return "llama", init_params, _GEOMETRY_FIELDS, make_train_step
    if type(cfg).__name__ == "ViTConfig":
        from tpushare_torch.workloads import vit
        return ("vit", vit.init_vit_params, _VIT_GEOMETRY_FIELDS,
                vit.make_vit_train_step)
    raise TypeError(
        f"unknown workload family for config type "
        f"{type(cfg).__qualname__} — teach _family() about it")


def _geometry(cfg) -> dict:
    name, _, fields, _ = _family(cfg)
    geo = {f: getattr(cfg, f) for f in fields}
    geo["family"] = name
    return geo


def _opt_params(opt_state) -> list:
    return [p for group in opt_state.param_groups for p in group["params"]]


def train_state_dict(params, opt_state) -> dict:
    """The flat DCP state dict of a trainable tree and its optimizer:
    ``params.<path>`` and ``opt.<path>.<key>`` (``step``, ``exp_avg``,
    ``exp_avg_sq``; none before the first step), sharing the live
    tensors' storage."""
    leaves = list(named_leaves(params))
    if [id(p) for p in _opt_params(opt_state)] != [id(w) for _, w in leaves]:
        raise ValueError("the optimizer does not hold this tree's leaves "
                         "in its order; build it with tx.init(params)")
    sd = {}
    for name, w in leaves:
        sd[f"params.{name}"] = w.detach()
        for key, value in opt_state.state.get(w, {}).items():
            sd[f"opt.{name}.{key}"] = value
    return sd


def _no_dist() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized())


@contextlib.contextmanager
def _single_process():
    """Silence DCP's warning that it assumes one process: here it does,
    by design."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        yield


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrainCheckpointer:
    """Checkpoint/resume for ``make_train_step`` / ``make_vit_train_step``
    state, one directory per step under ``directory``.

    >>> ckpt = TrainCheckpointer(dir, keep=3)
    >>> params, opt_state, start = ckpt.resume_or_init(cfg, tx, generator)
    >>> for step in range(start, total):
    ...     params, opt_state, loss = train_step(params, opt_state, *batch)
    ...     ckpt.maybe_save(step + 1, params, opt_state, cfg, every=50)
    >>> ckpt.close()
    """

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep={keep} must be >= 1")
        self.directory = Path(directory)
        self.keep = keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    def steps(self) -> list[int]:
        """All retained checkpoint steps, ascending (at most ``keep``)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit()
                      and (p / META).is_file())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Any, opt_state: Any, cfg) -> None:
        """Write ``step`` and return once it is durable: the state into a
        temporary directory, then ``meta.json``, then one rename to the
        step's directory. Older steps beyond ``keep`` are deleted."""
        import torch.distributed.checkpoint as dcp
        sd = train_state_dict(params, opt_state)
        tmp = self.directory / f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex}"
        tmp.mkdir()
        try:
            with _single_process():
                dcp.save(sd, storage_writer=dcp.FileSystemWriter(
                    tmp, sync_files=True), no_dist=_no_dist())
            with open(tmp / META, "w", encoding="utf-8") as f:
                json.dump({"step": step, "geometry": _geometry(cfg)}, f,
                          sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            final = self._step_dir(step)
            old = None
            if final.exists():  # saving a step again replaces it whole
                old = self.directory / f"{_TMP_PREFIX}old-{uuid.uuid4().hex}"
                os.replace(final, old)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        for stale in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(stale), ignore_errors=True)

    def maybe_save(self, step: int, params: Any, opt_state: Any, cfg,
                   every: int) -> bool:
        if every <= 0 or step % every:
            return False
        self.save(step, params, opt_state, cfg)
        return True

    def restore(self, cfg, tx: Any, device="cuda",
                step: int | None = None) -> tuple[Any, Any, int]:
        """Returns ``(params, opt_state, step)`` at ``step`` (default the
        latest): the trainable tree on ``device`` and ``tx``'s optimizer
        over it, its AdamW state restored. Raises FileNotFoundError when
        the directory holds no checkpoint and ValueError on a geometry or
        family mismatch, before any state is read."""
        from tpushare_torch.workloads import resolve_device
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint to restore in {self.directory}")
        path = self._step_dir(step)
        if not (path / META).is_file():
            raise FileNotFoundError(f"no checkpoint at step {step} in "
                                    f"{self.directory}")
        # geometry first, state second: a wrong-geometry state is never
        # read, and the error names the mistake, not a tensor
        saved_geo = json.loads((path / META).read_text())["geometry"]
        # checkpoints written before the family tag existed are llama
        saved_geo.setdefault("family", "llama")
        want_geo = _geometry(cfg)
        if saved_geo != want_geo:
            raise ValueError(
                f"checkpoint geometry {saved_geo} != resuming config "
                f"{want_geo} — refusing to load mismatched state")
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(0)
        params = train_params(_family(cfg)[1](cfg, gen))
        opt_state = tx.init(params)
        _load_state(path, params, opt_state)
        return params, opt_state, step

    def resume_or_init(self, cfg, tx: Any, generator: torch.Generator
                       ) -> tuple[Any, Any, int]:
        """The latest checkpoint if one exists, else a fresh init from
        ``generator`` (on its device): the one call a preemptable trainer
        makes at startup. Returns ``(params, opt_state, start_step)``;
        start_step 0 means fresh."""
        if self.latest_step() is not None:
            return self.restore(cfg, tx, device=generator.device)
        params = train_params(_family(cfg)[1](cfg, generator))
        return params, tx.init(params), 0

    def close(self) -> None:
        """Nothing stays open between calls; kept for the reference's
        interface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _load_state(path: Path, params, opt_state) -> None:
    """Read a step's state into ``params`` (in place, through their
    storage) and into ``opt_state``'s AdamW state."""
    import torch.distributed.checkpoint as dcp
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    leaves = list(named_leaves(params))
    target = {f"params.{name}": w.detach() for name, w in leaves}
    want = {k for k in saved if k.startswith("params.")}
    if want != set(target):
        raise ValueError(
            f"checkpoint parameters differ from the config's: missing "
            f"{sorted(set(target) - want)[:4]}, extra "
            f"{sorted(want - set(target))[:4]}")
    by_name = {name: w for name, w in leaves}
    opt_keys: dict[str, dict[str, str]] = {}
    for key, meta in saved.items():
        if not key.startswith("opt."):
            continue
        name, _, state_key = key[len("opt."):].rpartition(".")
        w = by_name[name]
        props = meta.properties
        # moments on the parameter's device; step counts where the
        # optimizer's load_state_dict places them
        dev = w.device if state_key != "step" else torch.device("cpu")
        target[key] = torch.empty(tuple(meta.size), dtype=props.dtype,
                                  device=dev)
        opt_keys.setdefault(name, {})[state_key] = key
    with _single_process():
        dcp.load(target, checkpoint_id=path, no_dist=_no_dist())
    state = {i: {sk: target[k] for sk, k in opt_keys[name].items()}
             for i, (name, _) in enumerate(leaves) if name in opt_keys}
    sd = opt_state.state_dict()
    sd["state"] = state
    opt_state.load_state_dict(sd)


def make_resumable_trainer(cfg, directory: str, keep: int = 3,
                           learning_rate: float = 3e-4):
    """``(ckpt, tx, train_step)`` ready for the player's train mode or
    any custom loop; the train step is the family's (llama next-token
    loss, ViT classification loss)."""
    cfg = dataclasses.replace(cfg).validate()
    tx, train_step = _family(cfg)[3](cfg, learning_rate=learning_rate)
    return TrainCheckpointer(directory, keep=keep), tx, train_step
