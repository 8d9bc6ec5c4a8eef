"""Training checkpoint/resume: the port of
``tpushare/workloads/checkpoint.py``.

A trainer that is preempted and placed again resumes from its latest
durable step instead of from scratch; ``samples/7-vit.yaml``'s "an
eviction costs at most ``--ckpt-every`` steps" rests on it. The
reference writes through orbax; the port writes through
``torch.distributed.checkpoint`` (DCP), in one process or over the
ranks of a process group:

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

- **Sharded save, cross-mesh restore.** A tree of DTensors on a mesh
  (``init_params(cfg, gen, mesh=...)``, see
  :mod:`~tpushare_torch.workloads.parallel`)
  is saved by every rank of the process group into one step directory,
  each rank writing its own shards. :meth:`TrainCheckpointer.restore`
  with ``mesh=`` reads onto the target mesh's placements
  (:func:`abstract_train_state`), which may differ from the saving one
  (dp 2 x tp 4 -> 4 x 2): DCP reads each rank's new shard from the files,
  with no gather onto one rank. The optimizer's moments take their
  parameter's placements, the specs :func:`opt_specs_like` names.

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
    ModelConfig, init_params, make_train_step, named_leaves, named_params,
    param_specs, train_params)
from tpushare_torch.workloads.parallel import P

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


def _specs(cfg) -> dict:
    """The family's spec tree (``param_specs`` or ``vit_param_specs``)."""
    if _family(cfg)[0] == "vit":
        from tpushare_torch.workloads import vit
        return vit.vit_param_specs(cfg)
    return param_specs(cfg)


def _geometry(cfg) -> dict:
    name, _, fields, _ = _family(cfg)
    geo = {f: getattr(cfg, f) for f in fields}
    geo["family"] = name
    return geo


def leaf_specs(cfg) -> dict:
    """The spec of every leaf of a trainable tree by its path
    (:func:`~tpushare_torch.workloads.model.named_leaves`): a top-level
    weight's own, a layer's ``layers.<i>.<name>`` its stack's without the
    layer axis."""
    specs = _specs(cfg)
    out = {}
    for name, spec in specs.items():
        if name != "layers":
            out[name] = spec
    for i in range(cfg.n_layers):
        for name, spec in specs["layers"].items():
            out[f"layers.{i}.{name}"] = P(*spec[1:])
    return out


def opt_specs_like(cfg, abstract_opt: dict) -> dict:
    """The spec of every optimizer state entry of a flat state dict
    (``opt.<path>.<key>``, as :func:`train_state_dict` names them): a
    moment takes its parameter's spec, an entry of another rank (the
    step count) is replicated, ``P()``."""
    index = leaf_specs(cfg)
    out = {}
    for key, value in abstract_opt.items():
        name = key[len("opt."):].rpartition(".")[0]
        spec = index.get(name)
        out[key] = spec if spec is not None and value.dim() == len(spec) \
            else P()
    return out


def abstract_train_state(cfg, tx: Any, mesh=None, device="cpu") -> dict:
    """The restore target: ``{"params": {...}, "opt_state": {...}}``, the
    flat state dicts a restore reads into, allocated and not drawn (the
    AdamW moments and step count of every parameter). On a ``mesh`` the
    tensors are DTensors on its placements (:func:`leaf_specs`,
    :func:`opt_specs_like`): what makes a restore cross-mesh, since DCP
    reads each shard straight onto its target."""
    return _abstract(_targets(cfg, tx, mesh, device)[0])


def _abstract(params) -> dict:
    """:func:`abstract_train_state` over an allocated tree: its
    ``params`` entries share the tree's storage, so a restore that reads
    into them fills the tree."""
    sd = {f"params.{n}": w.detach() for n, w in named_leaves(params)}
    opt = {}
    for n, w in named_params(params):
        opt[f"opt.{n}.step"] = torch.zeros((), dtype=torch.float32)
        for key in ("exp_avg", "exp_avg_sq"):
            opt[f"opt.{n}.{key}"] = torch.empty_like(w.detach())
    return {"params": sd, "opt_state": opt}


def _targets(cfg, tx, mesh, device):
    """A trainable tree allocated without drawing (on ``mesh`` when given)
    and ``tx``'s optimizer over it."""
    cfg.validate()
    from tpushare_torch.workloads import resolve_device
    init_fn = _family(cfg)[1]
    params = train_params(init_fn(cfg, None, mesh=mesh,
                                  device=resolve_device(device)))
    return params, tx.init(params)


def _opt_params(opt_state) -> list:
    return [p for group in opt_state.param_groups for p in group["params"]]


def train_state_dict(params, opt_state) -> dict:
    """The flat DCP state dict of a trainable tree and its optimizer:
    ``params.<path>`` and ``opt.<path>.<key>`` (``step``, ``exp_avg``,
    ``exp_avg_sq``; none before the first step), sharing the live
    tensors' storage. The state a layer keeps beside its weights
    (:data:`~tpushare_torch.workloads.model.BUFFERS`, an AFMoE router's
    selection bias) is saved as ``params.<path>`` with no optimizer
    state."""
    leaves = list(named_leaves(params))
    if [id(p) for p in _opt_params(opt_state)] != \
            [id(w) for _, w in named_params(params)]:
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


def _rank0() -> bool:
    import torch.distributed as dist
    return _no_dist() or dist.get_rank() == 0


def _barrier() -> None:
    if not _no_dist():
        import torch.distributed as dist
        dist.barrier()


def _same_name(name: str) -> str:
    """``name`` as rank 0 chose it, on every rank of the process group."""
    if _no_dist():
        return name
    import torch.distributed as dist
    box = [name]
    dist.broadcast_object_list(box, src=0)
    return box[0]


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
        step's directory. Older steps beyond ``keep`` are deleted. In a
        process group every rank calls it: each writes its own shards
        into the directory rank 0 names, and rank 0 finishes the step."""
        import torch.distributed.checkpoint as dcp
        sd = train_state_dict(params, opt_state)
        tmp = self.directory / _same_name(
            f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex}")
        if _rank0():
            tmp.mkdir()
        _barrier()
        try:
            with _single_process():
                dcp.save(sd, storage_writer=dcp.FileSystemWriter(
                    tmp, sync_files=True), no_dist=_no_dist())
            old = None
            if _rank0():
                old = self._finish(step, tmp, cfg)
        except BaseException:
            if _rank0():
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        _barrier()
        if _rank0():
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
            for stale in self.steps()[:-self.keep]:
                shutil.rmtree(self._step_dir(stale), ignore_errors=True)

    def _finish(self, step: int, tmp: Path, cfg) -> Path | None:
        """``meta.json`` into ``tmp``, then ``tmp`` renamed to the step's
        directory; returns the directory a step saved again replaced."""
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
        return old

    def maybe_save(self, step: int, params: Any, opt_state: Any, cfg,
                   every: int) -> bool:
        if every <= 0 or step % every:
            return False
        self.save(step, params, opt_state, cfg)
        return True

    def restore(self, cfg, tx: Any, device="cuda",
                step: int | None = None, mesh=None) -> tuple[Any, Any, int]:
        """Returns ``(params, opt_state, step)`` at ``step`` (default the
        latest): the trainable tree on ``device`` and ``tx``'s optimizer
        over it, its AdamW state restored; with ``mesh``, DTensors on the
        mesh's placements, whatever mesh saved them (every rank calls it).
        Raises FileNotFoundError when the directory holds no checkpoint
        and ValueError on a geometry or family mismatch, before any state
        is read."""
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
        params, opt_state = _targets(cfg, tx, mesh, device)
        _load_state(path, params, opt_state, _abstract(params))
        return params, opt_state, step

    def resume_or_init(self, cfg, tx: Any, generator: torch.Generator,
                       mesh=None) -> tuple[Any, Any, int]:
        """The latest checkpoint if one exists, else a fresh init from
        ``generator`` (on its device; on ``mesh``, each rank's shards of
        the same draw): the one call a preemptable trainer makes at
        startup. Returns ``(params, opt_state, start_step)``; start_step
        0 means fresh."""
        if self.latest_step() is not None:
            return self.restore(cfg, tx, device=generator.device, mesh=mesh)
        params = train_params(_family(cfg)[1](cfg, generator, mesh=mesh))
        return params, tx.init(params), 0

    def close(self) -> None:
        """Nothing stays open between calls; kept for the reference's
        interface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _load_state(path: Path, params, opt_state, abstract: dict) -> None:
    """Read a step's state into ``abstract``'s targets (those of
    :func:`abstract_train_state`; the parameters in place, through the
    tree's storage) and the saved AdamW state into ``opt_state``. Every
    saved entry must have its target's shape; DCP casts it to the
    target's dtype (a bf16 run may resume an fp32 one)."""
    import torch.distributed.checkpoint as dcp
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    targets = {**abstract["params"], **abstract["opt_state"]}
    want = {k for k in saved if k.startswith("params.")}
    if want != set(abstract["params"]):
        raise ValueError(
            f"checkpoint parameters differ from the config's: missing "
            f"{sorted(set(abstract['params']) - want)[:4]}, extra "
            f"{sorted(want - set(abstract['params']))[:4]}")
    load = {}
    opt_keys: dict[str, dict[str, str]] = {}
    for key, meta in saved.items():
        if key not in targets:
            raise ValueError(f"checkpoint state {key} has no target")
        t = targets[key]
        if tuple(meta.size) != tuple(t.shape):
            raise ValueError(f"checkpoint state {key} of shape "
                             f"{tuple(meta.size)} for a target of "
                             f"{tuple(t.shape)}")
        load[key] = t
        if key.startswith("opt."):
            name, _, state_key = key[len("opt."):].rpartition(".")
            opt_keys.setdefault(name, {})[state_key] = key
    with _single_process():
        dcp.load(load, checkpoint_id=path, no_dist=_no_dist())
    state = {i: {sk: load[k] for sk, k in opt_keys[name].items()}
             for i, (name, _) in enumerate(named_params(params))
             if name in opt_keys}
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
