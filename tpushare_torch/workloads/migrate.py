"""Workload-side wiring of live migration: the port of
``tpushare/workloads/migrate.py``.

The scheduler side's migrator is duck-typed: it parks a victim, asks a
``checkpointer`` to ``save(pod, move)`` before the eviction and to
``restore(pod, move)`` after the re-placement. This module is where the
port's workloads plug in:

- a process-local handler registry (:func:`register_checkpointer`,
  :func:`unregister_checkpointer`) keyed by the workload's pod name;
  anything registered exposes ``save(pod, move)`` / ``restore(pod,
  move)``;
- :class:`WorkloadCheckpointer`, the ``checkpointer`` seam: it dispatches
  to the victim's handler and, with a directory, writes an atomic
  per-move manifest (who moved where, when), so every move can be
  audited even for a workload with no handler;
- :class:`TrainStateHandler`, which adapts a live training loop to the
  seam over the port's
  :class:`~tpushare_torch.workloads.checkpoint.TrainCheckpointer`.

The reference's ``default_migrator`` builds the scheduler side's
``Migrator`` from ``tpushare.defrag``; the port imports nothing of the
JAX package and has none. That ``Migrator`` is duck-typed: built with
``checkpointer=WorkloadCheckpointer()`` and ``frontend_for=``
:func:`tpushare_torch.workloads.serve.frontend_for`, it drives the
port's workloads as it does the reference's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

_HANDLERS: dict[str, Any] = {}
_HANDLERS_LOCK = threading.Lock()


def _pod_name(pod: Any) -> str:
    if isinstance(pod, str):
        return pod
    return ((pod or {}).get("metadata") or {}).get("name") or ""


def register_checkpointer(name: str, handler: Any) -> None:
    """Register a per-workload checkpoint handler (``save(pod, move)`` /
    ``restore(pod, move)``) under the workload's pod name."""
    with _HANDLERS_LOCK:
        _HANDLERS[name] = handler


def unregister_checkpointer(name: str) -> None:
    with _HANDLERS_LOCK:
        _HANDLERS.pop(name, None)


class WorkloadCheckpointer:
    """The migrator's ``checkpointer`` seam: dispatch to the victim's
    registered handler, and (with a directory) persist a per-move
    manifest. A handler failure propagates, and so does a manifest IO
    failure: "durable before evict" is the contract."""

    def __init__(self, directory: str | None = None) -> None:
        self._dir = directory

    def _manifest(self, phase: str, pod: Any, move: Any) -> None:
        if not self._dir:
            return
        os.makedirs(self._dir, exist_ok=True)
        name = _pod_name(pod) or "unknown"
        path = os.path.join(self._dir, f"{name}.migration.json")
        record = {"phase": phase, "pod": name,
                  "time_unix": round(time.time(), 3),
                  "move": move.to_dict() if hasattr(move, "to_dict")
                  else str(move)}
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(record, f, sort_keys=True)
        os.replace(tmp, path)  # atomic: a partial write is never visible

    def _handler(self, pod: Any):
        with _HANDLERS_LOCK:
            return _HANDLERS.get(_pod_name(pod))

    def save(self, pod: Any, move: Any) -> None:
        handler = self._handler(pod)
        if handler is not None:
            handler.save(pod, move)
        self._manifest("checkpointed", pod, move)

    def restore(self, pod: Any, move: Any) -> None:
        handler = self._handler(pod)
        if handler is not None:
            handler.restore(pod, move)
        self._manifest("restored", pod, move)


class TrainStateHandler:
    """Adapter from a live training loop to the migration seam: the loop
    supplies ``state_fn() -> (step, params, opt_state, cfg)`` and ``tx``
    (its ``AdamW``); save blocks until the step is durable, and restore
    reads the latest step back onto ``device`` (default: the device the
    loop's parameters are on) and keeps it in :attr:`restored`. With a
    ``mesh`` (every rank of a sharded loop holds a handler) the save is
    sharded and the restore lands on that mesh's placements, which may
    differ from the saving one's: a re-placed gang resumes on a
    different slice shape."""

    def __init__(self, directory: str, state_fn, tx, device=None,
                 keep: int = 3, mesh=None) -> None:
        from tpushare_torch.workloads.checkpoint import TrainCheckpointer
        self._ckpt = TrainCheckpointer(directory, keep=keep)
        self._state_fn = state_fn
        self._tx = tx
        self._device = device
        self._mesh = mesh
        self._restored: Any = None

    @property
    def restored(self) -> Any:
        """The ``(params, opt_state, step)`` the last restore produced:
        the training loop picks it up when its pod re-enters the run."""
        return self._restored

    def save(self, pod: Any, move: Any) -> None:
        step, params, opt_state, cfg = self._state_fn()
        self._ckpt.save(step, params, opt_state, cfg)  # blocks: durable

    def restore(self, pod: Any, move: Any) -> None:
        from tpushare_torch.workloads.model import param_leaves
        _step, params, _opt, cfg = self._state_fn()
        device = self._device or param_leaves(params)[0].device
        self._restored = self._ckpt.restore(cfg, self._tx, device=device,
                                            mesh=self._mesh)
