"""Data, tensor and expert parallelism for the port: the ranks, the mesh,
the placements and the explicit collectives of the sharded paths.

The reference lays its weights over a ``jax.sharding.Mesh`` with
``PartitionSpec`` trees (``model.param_specs``, ``quant_specs``,
``moe.moe_param_specs``, ``vit.vit_param_specs``) and lets XLA insert the
collectives; one controller drives every device. The port runs one
process per rank instead:

- :class:`P` is the port's spec type: per tensor dimension, the mesh
  axis it is sharded over or None. :func:`placements` turns one into
  DTensor placements on a ``DeviceMesh`` whose dims carry the reference's
  axis names, ``("dp", "tp")`` or ``("dp", "tp", "ep")``.
- The state is held as DTensors (:func:`distribute`, :func:`local_shard`),
  which ``torch.distributed.checkpoint`` saves shard by shard and
  reshards on load. The model computes on their local shards
  (:func:`localize`) with explicit collectives, never through DTensor op
  dispatch, so the CUDA kernels always get plain local tensors.
- The Megatron pair: :func:`copy_to` (identity forward, all-reduce of the
  gradient) before a column-parallel product, :func:`reduce_from`
  (all-reduce forward, identity backward) after a row-parallel one;
  :func:`gather_last` for vocab-sharded logits; :func:`dp_mean_grads`.
- The sequence and pipeline paths move tensors between ranks:
  :func:`ppermute` (``lax.ppermute``: each rank's tensor to its target
  of a permutation, zeros where a rank has no source; its backward is the
  reversed permutation) and :func:`all_to_all` (the tiled
  ``lax.all_to_all``; its backward is the inverse all-to-all).
  :func:`tie` keeps a tensor's backward in the graph where the forward
  leaves it unused, so that every rank runs every collective of a
  backward in the same order.
- Activations are reduced in fp32. With NCCL every collective takes CUDA
  tensors. gloo carries CUDA tensors for ``all_reduce``, ``broadcast``
  and ``all_to_all_single``, so ranks that share one card run the
  dp/tp/ep paths and Ulysses on them directly; its ``send``/``recv``
  (and so ``batch_isend_irecv``) crash a rank on a CUDA tensor
  (``chip_smoke.py``'s seq phase probes these calls), so on that
  transport :func:`ppermute` sends and receives through host buffers.
- :func:`transport` is the one rule for the backend: NCCL when every rank
  of a host has a card of its own, gloo when ranks share one (or run on
  the CPU). It counts the ranks of one host, not the world's.
- :func:`run_ranks` starts ranks as processes of their own, each with the
  process group set up, and returns what each returned.
  :func:`init_from_gang_env` joins a gang member's ranks from the
  rendezvous env the device plugin injects.
"""

from __future__ import annotations

import itertools
import math
import multiprocessing
import os
import socket
import sys
import traceback

import torch
import torch.distributed as dist

AXES = ("dp", "tp")
MOE_AXES = ("dp", "tp", "ep")


class P(tuple):
    """A partition spec: per tensor dim, the mesh axis name it is sharded
    over, or None (replicated along that dim)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


# -- trees --------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (and of the trees
    in ``rest``, which share the first tree's structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# -- mesh and placements ------------------------------------------------------

def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 without a mesh or for an axis it lacks."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim whose axis names tensor dim d, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    unknown = [a for a in spec if a is not None and a not in names]
    if unknown:
        raise ValueError(f"spec {spec} names axes {unknown} that the mesh "
                         f"{names} lacks")
    return [Shard(spec.index(n)) if n in spec else Replicate()
            for n in names]


def spec_of(t) -> P:
    """The spec a DTensor's placements stand for (None per replicated
    dim)."""
    axes = [None] * t.dim()
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            axes[pl.dim] = name
    return P(*axes)


def shard_range(size: int, mesh, axis: str | None) -> tuple[int, int]:
    """[lo, hi) of this rank's shard of a dim of ``size`` over ``axis``."""
    n = axis_size(mesh, axis) if axis else 1
    if size % n:
        raise ValueError(f"dim of {size} does not divide over {n} "
                         f"{axis!r} ranks")
    part = size // n
    r = axis_rank(mesh, axis) if axis else 0
    return r * part, (r + 1) * part


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec`` (a view)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a {t.dim()}-d tensor")
    for d, axis in enumerate(spec):
        if axis is not None:
            lo, hi = shard_range(t.shape[d], mesh, axis)
            t = t.narrow(d, lo, hi - lo)
    return t


def as_dtensor(local: torch.Tensor, spec: P, mesh):
    """A DTensor over ``local`` (its storage, no copy, no communication)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False)


def distribute(tree, specs, mesh):
    """A tree of full tensors (the same on every rank) as DTensors holding
    this rank's shards, copied out so the full tensors can be freed."""
    return tree_map(
        lambda t, s: as_dtensor(local_shard(t, s, mesh).contiguous().clone(),
                                s, mesh), tree, specs)


def is_dtensor(t) -> bool:
    # no DTensor exists before torch.distributed.tensor is loaded, and
    # loading it (a few seconds) is for the sharded paths alone
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


def localize(tree, mesh=None):
    """``(tree of local tensors, mesh)``: each DTensor leaf replaced by its
    local shard (``to_local``, so gradients flow back to the DTensor
    leaf), and the mesh they live on; ``mesh`` is kept for a plain tree."""
    found = []

    def local(t):
        if isinstance(t, torch.Tensor) and is_dtensor(t):
            found.append(t.device_mesh)
            return t.to_local()
        return t

    out = tree_map(local, tree)
    return out, (found[0] if found else mesh)


def mesh_of(tree):
    for t in leaves(tree):
        if isinstance(t, torch.Tensor) and is_dtensor(t):
            return t.device_mesh
    return None


# -- collectives --------------------------------------------------------------

def _reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().contiguous()   # a copy whenever x is not fp32
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_fp32(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``axis`` in the
    backward: where a replicated activation enters work that each rank
    does on its own shard (a column-parallel product, its experts)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh.get_group(axis))


def reduce_from(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """All-reduce (sum, in fp32) forward, identity backward: after a
    row-parallel product, whose per-rank partial sums make the output."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh.get_group(axis))


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, r, sum_grads):
        ctx.r, ctx.width, ctx.group, ctx.sum = r, x.shape[-1], group, sum_grads
        buf = x.new_zeros((*x.shape[:-1], n * x.shape[-1]),
                          dtype=torch.float32)
        buf.narrow(-1, r * x.shape[-1], x.shape[-1]).copy_(x)
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum:
            g = _reduce_fp32(g, ctx.group)
        return g.narrow(-1, ctx.r * ctx.width, ctx.width), None, None, None, \
            None


def gather_last(x: torch.Tensor, mesh, axis: str = "tp",
                sum_grads: bool = False) -> torch.Tensor:
    """The full last dim of a tensor sharded on it over ``axis``: an
    all-reduce of a zero-filled buffer holding this rank's shard, so it
    is exact. The backward keeps this rank's slice of the gradient: as it
    is where every rank computes the same loss from the result (the
    vocab-sharded logits), summed over the ranks first with
    ``sum_grads`` (each rank uses its own part of the result)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _GatherLast.apply(x, mesh.get_group(axis), n,
                             axis_rank(mesh, axis), sum_grads)


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_fp32(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Differentiable sum over ``axis`` whose backward sums the gradients
    too: for a statistic every rank of ``axis`` computes the same loss
    from (the global MoE router means)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _SumBoth.apply(x, mesh.get_group(axis))


def gather_counts(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` along ``axis``, in rank order (an
    all-reduce of a zero-filled buffer; no gradient)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x[None]
    buf = x.new_zeros((n, *x.shape))
    buf[axis_rank(mesh, axis)] = x
    dist.all_reduce(buf, group=mesh.get_group(axis))
    return buf


def mean_over(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """The mean of ``x`` over ``axis`` (no gradient)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _reduce_fp32(x.detach(), mesh.get_group(axis)) / n


# -- moving tensors between ranks: the sequence and pipeline paths ----------

def _peers(perm, n: int, r: int) -> tuple[int | None, int | None]:
    """(source, target) of axis rank ``r`` under ``perm``, a list of
    (source, target) pairs of axis ranks in which each rank is at most
    once a source and once a target; None where it has none."""
    srcs = [a for a, b in perm if b == r]
    dsts = [b for a, b in perm if a == r]
    if len(srcs) > 1 or len(dsts) > 1 or not all(
            0 <= i < n for pair in perm for i in pair):
        raise ValueError(f"perm {perm} is not a permutation of {n} ranks")
    return (srcs[0] if srcs else None), (dsts[0] if dsts else None)


def _send_recv(x: torch.Tensor, src, dst, group) -> torch.Tensor:
    """Send ``x`` to axis rank ``dst`` and receive a tensor like it from
    ``src`` (zeros without one). NCCL posts both at once on the card;
    gloo takes host tensors for point-to-point, so a CUDA tensor goes
    through a host buffer each way (ranks sharing a card)."""
    out = torch.zeros_like(x)
    x = x.contiguous()
    nccl = dist.get_backend(group) == "nccl"
    staged = not nccl and x.device.type != "cpu"
    send = x.cpu() if staged else x
    recv = torch.empty(x.shape, dtype=x.dtype) if staged else out
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    if nccl:
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = [op.op(op.tensor, op.peer, op.group) for op in ops]
    for w in works:
        w.wait()
    if staged and src is not None:
        out.copy_(recv)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group, n, r):
        ctx.perm, ctx.group, ctx.n, ctx.r = perm, group, n, r
        return _send_recv(x, *_peers(perm, n, r), group)

    @staticmethod
    def backward(ctx, g):
        back = [(b, a) for a, b in ctx.perm]
        return (_send_recv(g, *_peers(back, ctx.n, ctx.r), ctx.group),
                None, None, None, None)


def ppermute(x: torch.Tensor, perm, mesh, axis: str) -> torch.Tensor:
    """``lax.ppermute`` over ``axis``: this rank's ``x`` goes to its
    target in ``perm`` ((source, target) pairs of axis ranks), and it
    returns what its source sent, or zeros where it has none.
    Differentiable: the gradient travels the reversed permutation. Every
    rank of ``axis`` must call it, in the same order as the others, and
    must reach its backward too (see :func:`tie`)."""
    n = axis_size(mesh, axis)
    if n == 1:
        _, dst = _peers(perm, 1, 0)
        return x if dst == 0 else torch.zeros_like(x)
    return _PPermute.apply(x, [tuple(p) for p in perm], mesh.get_group(axis),
                           n, axis_rank(mesh, axis))


def _a2a(x: torch.Tensor, group, n: int, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all: tile i of ``x`` along ``split_dim`` goes to
    rank i; the tiles received are concatenated along ``concat_dim`` in
    rank order."""
    shape = list(x.shape)
    if shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(shape)} does not split "
                         f"over {n} ranks")
    tiles = x.reshape(*shape[:split_dim], n, shape[split_dim] // n,
                      *shape[split_dim + 1:]).movedim(split_dim, 0)
    tiles = tiles.contiguous()
    got = torch.empty_like(tiles)
    dist.all_to_all_single(got, tiles, group=group)
    tile = list(tiles.shape[1:])
    out = got.movedim(0, concat_dim)
    tile[concat_dim] *= n
    return out.reshape(tile)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = group, n, concat_dim, split_dim
        return _a2a(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into n tiles along ``split_dim``, tile i sent to axis rank
    i, the n tiles received concatenated along ``concat_dim`` in rank
    order. Differentiable: the backward is the inverse all-to-all."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis), n, split_dim, concat_dim)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.others))


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x``, with ``others`` joined to it in the graph (their gradient
    from it is zero). Where a rank's forward leaves a tensor that came
    out of a collective unused (a pipeline stage's bubble, a ring chunk
    that is fully masked), tying it to a tensor the loss reaches keeps
    that collective's backward in the rank's graph, so every rank posts
    the same backward collectives in the same order and none waits on a
    partner that never came."""
    if not torch.is_grad_enabled():
        return x
    others = [o for o in others if o.requires_grad]
    if not others:
        return x
    return _Tie.apply(x, *others)


BUCKET = 1 << 26   # elements in one fp32 all-reduce of gradients


def dp_mean_grads(params: list, mesh) -> None:
    """Average the gradients of ``params`` over "dp", in place: every leaf
    is replicated over "dp" (the batch is what dp shards). Local
    gradients are summed in fp32 buckets of at most ``BUCKET`` elements."""
    n = axis_size(mesh, "dp")
    if n == 1:
        return
    group = mesh.get_group("dp")
    grads = [(p.grad.to_local() if is_dtensor(p.grad) else p.grad)
             for p in params if p.grad is not None]
    i = 0
    while i < len(grads):
        j, size = i, 0
        while j < len(grads) and (j == i or size + grads[j].numel() <= BUCKET):
            size += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1).float() for g in grads[i:j]])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        off = 0
        for g in grads[i:j]:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        i = j


# -- drawing weights shard by shard -------------------------------------------

DRAW_CHUNK = 1 << 26   # fp32 elements of one piece of a draw (256 MiB)


def draw(shape: tuple, generator, mult: float, dtype, spec: P | None = None,
         mesh=None, amax: bool = False, device=None):
    """This rank's shard (under ``spec``; all of it without a mesh) of a
    weight of ``shape`` ``[*lead, R, C]``, drawn in fixed pieces, the
    same on one card and on every rank: one leading index at a time in
    row-major order, and within it the ``[R, C]`` matrix in blocks of
    ``max(1, DRAW_CHUNK // C)`` whole rows, each block one
    ``torch.randn((rows, C), generator=generator)``, times ``mult``, cast
    to ``dtype``. Every rank draws every piece and keeps the part inside
    its shard, so N ranks hold exactly the shards of the one-card weight.
    With ``amax``, also the fp32 maximum of |value| over dim -2 (keepdim)
    of every column and leading index this rank holds, over all rows,
    this rank's or not: what a per-output-channel int8 scale of the whole
    weight needs. Returns ``(shard, amax or None)``. ``generator`` None
    allocates the shard on ``device`` without drawing (a target to load
    into)."""
    ranges = [shard_range(s, mesh, a)
              for s, a in zip(shape, spec or (None,) * len(shape))]
    own_shape = [hi - lo for lo, hi in ranges]
    dev = generator.device if generator is not None else torch.device(
        device or "cpu")
    own = torch.empty(own_shape, dtype=dtype, device=dev)
    red = None
    if amax:
        red = torch.zeros((*own_shape[:-2], 1, own_shape[-1]),
                          dtype=torch.float32, device=dev)
    if generator is None:
        return own, red
    *lead, R, C = shape
    (r0, r1), (c0, c1) = ranges[-2:]
    step = max(1, DRAW_CHUNK // C)
    for idx in itertools.product(*map(range, lead)):
        held = all(lo <= i < hi for i, (lo, hi) in zip(idx, ranges))
        at = tuple(i - lo for i, (lo, _) in zip(idx, ranges))
        for b0 in range(0, R, step):
            b1 = min(b0 + step, R)
            block = torch.randn((b1 - b0, C), generator=generator,
                                device=dev).mul_(mult).to(dtype)
            if not held:
                continue
            lo, hi = max(b0, r0), min(b1, r1)
            if lo < hi:
                own[at][lo - r0:hi - r0] = block[lo - b0:hi - b0, c0:c1]
            if amax:
                top = block[:, c0:c1].float().abs().amax(0, keepdim=True)
                red[at] = torch.maximum(red[at], top)
    return own, red


# -- ranks --------------------------------------------------------------------

def transport(device_type: str, world: int,
              local_world: int | None = None) -> str:
    """NCCL when every rank of a host has a card of its own, gloo when
    ranks share one card or run on the CPU (NCCL refuses two ranks on one
    GPU; see the module's note on what gloo takes on the card). It
    counts the ranks on this host, ``local_world`` (default
    ``$LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else ``world``, all
    ranks on this host), against this host's cards: a gang of two hosts
    of four cards each is world 8 and NCCL."""
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int,
                local_world: int | None = None) -> torch.device:
    """The card of ``rank``: by its index among this host's
    ``local_world`` ranks (the rank itself with all ranks on this host,
    the default), its own card where the host has enough, else the one
    they share (modulo the visible cards)."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = rank % local_world if local_world else rank
    return torch.device("cuda", local % torch.cuda.device_count())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, addr: str, device_type: str,
              device: torch.device | None = None,
              local_world: int | None = None) -> str:
    """Join the process group at ``addr`` (``tcp://localhost:<port>``) as
    ``rank`` of ``world``, on ``device`` (default :func:`rank_device`),
    ``local_world`` of the ranks on this host (see :func:`transport`);
    returns the backend."""
    backend = transport(device_type, world, local_world)
    if device_type == "cuda":
        torch.cuda.set_device(device or rank_device(device_type, rank,
                                                    local_world))
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank)
    return backend


def gang_local_ranks(device_type: str) -> int:
    """The ranks a gang member starts: one per visible card (one on the
    CPU)."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def init_from_gang_env(device_type: str, index: int = 0,
                       local: int | None = None,
                       timeout: float = 300.0) -> dict:
    """Join a gang's process group from the rendezvous env the device
    plugin injects into each member (``COORDINATOR_ADDRESS`` as
    ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``; the names of
    :mod:`tpushare_torch.contract`), as local rank ``index`` of the
    member's ``local`` ranks (default :func:`gang_local_ranks`): global
    rank ``PROCESS_ID * local + index`` of world ``NUM_PROCESSES *
    local``. The ranks first meet in a TCP store at the coordinator's
    address and tell each other their host names; the ranks on this
    host, against its cards, pick the transport (:func:`transport`) and
    this rank's card. Returns ``{"rank", "world", "process",
    "processes", "backend"}``."""
    from datetime import timedelta

    from tpushare_torch.contract import (
        ENV_COORDINATOR_ADDRESS, ENV_NUM_PROCESSES, ENV_PROCESS_ID)
    try:
        addr = os.environ[ENV_COORDINATOR_ADDRESS]
        processes = int(os.environ[ENV_NUM_PROCESSES])
        process = int(os.environ[ENV_PROCESS_ID])
    except KeyError as e:
        raise RuntimeError(f"--multihost: {e.args[0]} is not set (the gang "
                           "rendezvous env: COORDINATOR_ADDRESS, "
                           "NUM_PROCESSES, PROCESS_ID)") from None
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"{ENV_COORDINATOR_ADDRESS}={addr!r}: expected "
                         "host:port")
    local = local or gang_local_ranks(device_type)
    world, rank = processes * local, process * local + index
    if not (0 <= process < processes and 0 <= index < local):
        raise ValueError(f"process {process} of {processes}, local rank "
                         f"{index} of {local}")
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timedelta(seconds=timeout))
    store.set(f"gang/host/{rank}", socket.gethostname())
    hosts = [store.get(f"gang/host/{r}").decode() for r in range(world)]
    mine = [r for r in range(world) if hosts[r] == hosts[rank]]
    backend = transport(device_type, world, len(mine))
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, mine.index(rank)))
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timedelta(seconds=timeout))
    return {"rank": rank, "world": world, "process": process,
            "processes": processes, "backend": backend}


def make_mesh(device_type: str, shape: tuple, names: tuple = AXES):
    """A ``DeviceMesh`` of ``shape`` over the world's ranks in rank order,
    with the reference's axis names."""
    from torch.distributed.device_mesh import init_device_mesh
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} over {dist.get_world_size()} ranks")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def most_square(n: int) -> tuple[int, int]:
    """(a, b) with a * b == n, a <= b, a as large as it can be."""
    for cand in range(int(n ** 0.5), 0, -1):
        if n % cand == 0:
            return cand, n // cand
    return 1, n


def _rank_main(fn, rank, world, addr, device_type, args, results, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        init_rank(rank, world, addr, device_type, local_world=world)
        out = fn(*args)
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 -- the parent re-raises it
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device_type: str = "cpu",
              timeout: float = 600.0, env: dict | None = None) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, one per rank, each
    inside the process group (``dist`` initialised, backend by
    :func:`transport`), and return the ranks' results in rank order.
    ``fn`` must be importable (a module-level function of a module that
    does not import JAX). A rank that raises fails the call with its
    traceback; so does one that has not answered within ``timeout``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    addr = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, addr, device_type, args,
                               results, env or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    errors = []
    try:
        import queue as _queue
        while len(got) + len(errors) < world:
            try:
                rank, status, out = results.get(timeout=timeout)
            except _queue.Empty:
                missing = sorted(set(range(world)) - set(got))
                raise TimeoutError(f"ranks {missing} gave no result in "
                                   f"{timeout} s") from None
            if status == "ok":
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world)]
