"""Continuous-batching decode engine (slot-based, fixed shapes).

Counterpart of ``tpushare/workloads/engine.py``, with the same host API
and the same design:

- **Slots, not batches**: the KV cache holds ``max_slots`` rows, allocated
  once; a request occupies a free slot, decodes in lock-step with the
  other residents and frees its slot when it completes.
- **Per-slot positions**: one decode step advances every slot one token,
  each at its own position, through :func:`forward_cached` with a
  per-row offset vector (the reference's vmap over slots, written out as
  the batch dimension). Inactive slots are computed and discarded: their
  cache, position and last token are left untouched. Every step runs at
  the same shapes, so a request's numbers never depend on its
  co-tenants.
- **Decode quantum**: the host reads the ``[k, S]`` block of emitted
  tokens once per quantum of ``k`` steps, not once per token.
- **Bucketed prefill**: a prompt is padded to the next power-of-two
  bucket (capped at ``max_len``) and prefilled B=1 from position 0 —
  through the flash kernel with ``cfg.attn == "flash"`` — into a fresh
  one-row cache, which is then copied into the slot. Pad positions sit
  past the slot's position watermark, masked, and are overwritten as
  decode advances.
- **Rolling slots** (``rolling=True``): each slot's buffer is a ring with
  its own watermark row; prefill goes in ``attn_window``-sized chunks.

Sampling (``temperature > 0``) is keyed by (seed, request id, query
position) only, so a request's stream does not depend on its slot, its
co-tenants or where quanta fall. The reference draws from JAX's
threefry; those bits cannot be reproduced in torch, so the port has its
own counter-keyed generator (:func:`_uniform`): a 32-bit integer hash of
the key and the vocabulary index gives each token a uniform number, and
Gumbel-max picks the sample.

MoE presets stay excluded, as in the reference: capacity routing couples
slots.

Tensor parallelism: the engine runs on a rank's shards as on whole
weights (its KV pool holds the rank's kv heads). Its two device calls,
:meth:`DecodeEngine.prefill_slot` and :meth:`DecodeEngine.decode_quantum`,
read only their arguments and the slot table
(:meth:`DecodeEngine.slot_table`), so a tensor-parallel replica
(``serve.py``) runs each on every rank from rank 0's host decisions:
rank 0's tokens are the ones every rank feeds back.
"""

from __future__ import annotations

import dataclasses

import torch

from tpushare_torch import metrics
from tpushare_torch.workloads import parallel
from tpushare_torch.workloads.model import (
    ModelConfig, forward_cached, init_kv_cache, kv_decode_spans,
    local_heads)


@dataclasses.dataclass
class _Request:
    rid: int
    slot: int
    tokens: list  # generated so far (host copy)
    budget: int   # max new tokens
    plen: int     # prompt length: the slot decodes at plen + len(tokens) - 1


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# -- counter-keyed random numbers ---------------------------------------------
# 32-bit arithmetic in int64 tensors (or Python ints): every product stays
# below 2**49, so nothing overflows and CPU and GPU give the same bits.

_M32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """(x * m) mod 2**32 for 0 <= x < 2**32."""
    return ((x & 0xFFFF) * m + ((((x >> 16) * m) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijective 32-bit integer hash (lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _request_key(seed: int, rid: int) -> int:
    return _mix32(_mix32(seed & _M32) ^ (rid & _M32))


def _uniform(rkey: torch.Tensor, qpos: torch.Tensor,
             salt: torch.Tensor) -> torch.Tensor:
    """Uniform numbers in (0, 1), ``[N, V]``, a function of each row's
    request key and query position and of the vocabulary index only
    (``salt`` [V] is the hashed index)."""
    step = _mix32(rkey ^ _mix32(qpos & _M32))
    bits = _mix32(_mix32(step[:, None] ^ salt[None, :]))
    return ((bits >> 8).float() + 0.5) * (2.0 ** -24)


class DecodeEngine:
    """Continuous-batching decoder over a fixed slot pool (greedy by
    default; per-engine or per-request sampling optional).

    >>> eng = DecodeEngine(params, cfg, max_slots=8, max_len=256)
    >>> rid = eng.submit([1, 17, 23], max_new=32)   # joins mid-flight
    >>> finished = eng.run_quantum()                 # {rid: [tokens...]}

    ``submit`` raises RuntimeError when no slot is free (callers queue;
    the serve frontend does). Completion = budget exhausted or ``eos_id``
    emitted. The engine runs on the parameters' device; ``device``, when
    given, must name that device.
    """

    def __init__(self, params: dict, cfg: ModelConfig, max_slots: int,
                 max_len: int, quantum: int = 8,
                 eos_id: int | None = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 per_request_sampling: bool = False,
                 rolling: bool = False, device=None):
        cfg.validate()
        if cfg.moe_experts:
            raise ValueError("continuous batching excludes MoE presets "
                             "(capacity routing couples slots)")
        if rolling:
            if cfg.attn_window is None:
                raise ValueError("rolling slots require cfg.attn_window")
            if max_len < 2 * cfg.attn_window:
                raise ValueError(
                    f"rolling max_len {max_len} < 2*attn_window "
                    f"{2 * cfg.attn_window} (chunked-prefill retention)")
        if temperature < 0:
            raise ValueError(f"temperature {temperature} must be >= 0")
        if top_k < 0 or top_k > cfg.vocab:
            raise ValueError(f"top_k {top_k} outside [0, vocab]")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p {top_p} outside (0, 1]")
        if (top_k > 0 or top_p < 1.0) and temperature == 0.0 \
                and not per_request_sampling:
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature 0 is "
                "greedy argmax and would silently ignore them)")
        dev = params["embed"].device
        if device is not None:
            want = torch.device(device)
            if want.type != dev.type or (want.index is not None
                                         and want.index != dev.index):
                raise ValueError(f"device {want} differs from the "
                                 f"parameters' device {dev}")
        self._dev = dev
        local, mesh = parallel.localize(params)
        self._kv_heads = local_heads(local, cfg, mesh)[1]
        self._per_request = bool(per_request_sampling)
        self._rolling = bool(rolling)
        self._params = params
        self._cfg = cfg
        self._S = int(max_slots)
        self._M = int(max_len)
        self._quantum = int(quantum)
        self._eos = -1 if eos_id is None else int(eos_id)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        self._seed = int(seed)
        self._salt = _mix32(torch.arange(cfg.vocab, dtype=torch.long,
                                         device=dev) + 0x9E3779B9 & _M32)

        S = self._S
        self._cache = init_kv_cache(cfg, S, self._M, device=dev,
                                    kv_heads=self._kv_heads)
        if rolling:
            # one ring watermark row per slot: slots advance independently
            self._cache["pos"] = torch.full((S, self._M), -1,
                                            dtype=torch.long, device=dev)

        def zeros(dtype=torch.long):
            return torch.zeros(S, dtype=dtype, device=dev)

        self._pos = zeros()
        self._last = zeros()
        self._active = zeros(torch.bool)
        self._remaining = zeros()
        self._rkey = zeros()
        self._slot_temp = zeros(torch.float32)
        self._slot_topp = torch.ones(S, device=dev)
        self._slot_eos = torch.full((S,), self._eos, dtype=torch.long,
                                    device=dev)
        self._free = list(range(S))
        self._by_slot: dict[int, _Request] = {}
        self._by_rid: dict[int, _Request] = {}
        self._next_rid = 0
        # requests completed by their own prefill (budget 1 / instant
        # eos), surfaced by the next run_quantum/drain
        self._done_now: dict[int, list[int]] = {}
        # tokens emitted per rid by the most recent run_quantum (the
        # streaming hook); valid until the next call, same thread only
        self.last_quantum_tokens: dict[int, list[int]] = {}

    @property
    def cfg(self) -> ModelConfig:
        return self._cfg

    @property
    def params(self) -> dict:
        return self._params

    # -- token selection ------------------------------------------------------

    def _topk_mask(self, scaled: torch.Tensor) -> torch.Tensor:
        if self._top_k > 0:
            kth = torch.topk(scaled, self._top_k, dim=-1).values[:, -1:]
            return scaled.masked_fill(scaled < kth, float("-inf"))
        return scaled

    @staticmethod
    def _nucleus_mask(scaled: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Keep the smallest descending-probability prefix whose mass
        reaches p (the crossing token included); ties at the floor all
        survive. p is per row."""
        svals = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(svals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        kth = ((cum - probs) < p[:, None]).sum(dim=-1)
        floor = svals.gather(1, (kth - 1)[:, None])
        return scaled.masked_fill(scaled < floor, float("-inf"))

    def _sample(self, scaled, rkey, qpos):
        u = _uniform(rkey, qpos, self._salt)
        return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)

    def _pick(self, logits, rkey, qpos, temp, topp) -> torch.Tensor:
        """Next tokens [N] from final-position logits [N, V]."""
        if self._per_request:
            greedy = torch.argmax(logits, dim=-1)
            scaled = logits.float() / temp.clamp_min(1e-6)[:, None]
            scaled = self._nucleus_mask(self._topk_mask(scaled), topp)
            return torch.where(temp > 0.0, self._sample(scaled, rkey, qpos),
                               greedy)
        if self._temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        scaled = self._topk_mask((logits / self._temperature).float())
        if self._top_p < 1.0:
            scaled = self._nucleus_mask(scaled, torch.full_like(
                scaled[:, 0], self._top_p))
        return self._sample(scaled, rkey, qpos)

    # -- prefill --------------------------------------------------------------

    def _prefill(self, padded: torch.Tensor, plen: int, rkey, temp, topp):
        """B=1 prefill of the padded prompt into a fresh one-row cache;
        returns (first token [1], cache)."""
        cfg, M = self._cfg, self._M
        if self._rolling:
            # W-wide chunks, pads confined to the last one (the ring
            # retention contract of greedy_decode_kv's chunked prefill)
            W = cfg.attn_window
            cache1 = init_kv_cache(cfg, 1, M, rolling=True, device=self._dev,
                                   kv_heads=self._kv_heads)
            final = None
            for off in range(0, padded.shape[0], W):
                chunk = padded[off:off + W]
                logits, cache1 = forward_cached(
                    self._params, chunk[None], cache1, off, cfg)
                if off <= plen - 1 < off + chunk.shape[0]:
                    final = logits[0, plen - 1 - off]
        else:
            cache1 = init_kv_cache(cfg, 1, M, device=self._dev,
                                   kv_heads=self._kv_heads)
            logits, cache1 = forward_cached(
                self._params, padded[None], cache1, 0, cfg,
                prefill_from_zero=True)
            final = logits[0, plen - 1]
        # the prefill emits for query position plen-1; decode continues
        # from plen, so the sample keys never collide
        qpos = torch.full((1,), plen - 1, dtype=torch.long, device=self._dev)
        first = self._pick(final[None], rkey, qpos, temp, topp)
        return first, cache1

    @torch.inference_mode()
    def prefill_slot(self, slot: int, padded: torch.Tensor, plen: int,
                     rkey: torch.Tensor, temp: torch.Tensor,
                     topp: torch.Tensor) -> torch.Tensor:
        """The prefill's device call: prefill the padded prompt ``[bucket]``
        and copy its one-row cache into ``slot``'s row; returns the first
        token ``[1]``."""
        first, cache1 = self._prefill(padded, plen, rkey, temp, topp)
        for n, buf in self._cache.items():
            if n == "pos":
                buf[slot] = cache1["pos"]
            else:
                buf[:, slot] = cache1[n][:, 0]
        return first

    # -- host API -------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def resident(self) -> int:
        return self._S - len(self._free)

    @torch.inference_mode()
    def submit(self, prompt: list[int], max_new: int,
               temperature: float | None = None,
               top_p: float | None = None,
               eos_id: int | None = None) -> int:
        """Prefill ``prompt`` into a free slot; returns the request id.
        The first generated token comes from the prefill itself.

        ``temperature``/``top_p`` override the engine's for this request
        (needs ``per_request_sampling=True``); ``eos_id`` overrides the
        stop token in either mode."""
        if not self._free:
            raise RuntimeError("no free slot (queue upstream)")
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if not self._rolling and len(prompt) + max_new > self._M:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_len {self._M}")
        if (temperature is not None or top_p is not None) \
                and not self._per_request:
            raise ValueError(
                "per-request temperature/top_p need "
                "per_request_sampling=True (the static engine fixes its "
                "knobs at construction)")
        r_temp = self._temperature if temperature is None \
            else float(temperature)
        r_topp = self._top_p if top_p is None else float(top_p)
        r_eos = self._eos if eos_id is None else int(eos_id)
        if r_temp < 0:
            raise ValueError(f"temperature {r_temp} must be >= 0")
        if not 0.0 < r_topp <= 1.0:
            raise ValueError(f"top_p {r_topp} outside (0, 1]")
        if top_p is not None and r_topp < 1.0 and r_temp == 0.0:
            raise ValueError(
                "top_p requires temperature > 0 for this request "
                "(temperature 0 is greedy argmax and would silently "
                "ignore it)")
        if any(not 0 <= t < self._cfg.vocab for t in prompt):
            raise ValueError(f"prompt token outside [0, {self._cfg.vocab})")
        plen = len(prompt)
        if self._rolling:
            W = self._cfg.attn_window
            bucket = min(_bucket(plen), -(-plen // W) * W)
        else:
            # the bucket stays inside the slot's buffer (non-pow2 max_len)
            bucket = min(_bucket(plen), self._M)
        slot = self._free.pop()
        dev = self._dev
        padded = torch.zeros(bucket, dtype=torch.long)
        padded[:plen] = torch.tensor(prompt, dtype=torch.long)
        padded = padded.to(dev)
        rid = self._next_rid
        self._next_rid += 1
        rkey = _request_key(self._seed, rid)
        with metrics.span("engine.prefill", rid=rid, plen=plen,
                          bucket=bucket):
            rkey_t = torch.full((1,), rkey, dtype=torch.long, device=dev)
            temp_t = torch.full((1,), r_temp, device=dev)
            topp_t = torch.full((1,), r_topp, device=dev)
            first = self.prefill_slot(slot, padded, plen, rkey_t, temp_t,
                                      topp_t)
            self._pos[slot] = plen
            self._last[slot] = first[0]
            # a prefill-time eos completes the request on the host side;
            # the lane goes inactive on the device too
            self._active[slot] = (first[0] != r_eos) & (max_new > 1)
            self._remaining[slot] = max_new - 1
            self._rkey[slot] = rkey
            self._slot_temp[slot] = r_temp
            self._slot_topp[slot] = r_topp
            self._slot_eos[slot] = r_eos
            first_tok = int(first[0])
        req = _Request(rid=rid, slot=slot, tokens=[first_tok],
                       budget=max_new, plen=plen)
        self._by_slot[slot] = req
        self._by_rid[rid] = req
        if max_new == 1 or first_tok == r_eos:
            self._free.append(slot)
            del self._by_slot[slot]
            self._done_now[rid] = req.tokens
        return rid

    def peek_tokens(self, rid: int) -> list[int] | None:
        """Tokens generated so far for an unreported request (None once
        it has been reported finished, or for an unknown rid)."""
        req = self._by_rid.get(rid)
        return list(req.tokens) if req is not None else None

    def slot_table(self) -> tuple[torch.Tensor, torch.Tensor]:
        """What a decode quantum reads of the host's decisions: ``(longs
        [6, S], floats [2, S])``, the slots' last tokens, positions,
        active flags, remaining budgets, request keys and stop tokens,
        then their temperatures and top-p."""
        longs = torch.stack([self._last, self._pos, self._active.long(),
                             self._remaining, self._rkey, self._slot_eos])
        return longs, torch.stack([self._slot_temp, self._slot_topp])

    def load_slot_table(self, longs: torch.Tensor,
                        floats: torch.Tensor) -> None:
        """Take another engine's :meth:`slot_table` as this one's."""
        (self._last, self._pos, active, self._remaining, self._rkey,
         self._slot_eos) = longs.unbind(0)
        self._active = active.bool()
        self._slot_temp, self._slot_topp = floats.unbind(0)

    @torch.inference_mode()
    def decode_quantum(self, k: int) -> torch.Tensor:
        """k lock-step decode steps on the device; returns [k + 1, S]:
        the emitted tokens (-1 = idle lane) and, last, the active flags.
        Every step computes all S rows (span ``engine.step``: ``rows``,
        and ``keys_read``, the cache positions its attention reads: the
        sum of the active rows' spans, on the device, where the step runs
        the ``kv_decode`` kernel; every row's whole buffer where it runs
        the einsum)."""
        emitted = []
        rows = self._last.shape[0]
        for _ in range(k):
            with metrics.span("engine.step", rows=rows) as step:
                active = self._active
                if step:
                    spans = kv_decode_spans(self._cfg, self._cache,
                                            self._pos, 1, active)
                    step.add(keys_read=rows * self._cache["k"].shape[2]
                             if spans is None else (spans[1] - spans[0]).sum())
                logits, _ = forward_cached(
                    self._params, self._last[:, None], self._cache,
                    self._pos, self._cfg, prefill_from_zero=False,
                    write_rows=active)
                nxt = self._pick(logits[:, -1], self._rkey, self._pos,
                                 self._slot_temp, self._slot_topp)
                emitted.append(torch.where(active, nxt, -1))
                step = active.long()
                self._pos = self._pos + step
                self._remaining = self._remaining - step
                done = active & ((nxt == self._slot_eos)
                                 | (self._remaining <= 0))
                self._last = torch.where(active, nxt, self._last)
                self._active = active & ~done
        return torch.cat([torch.stack(emitted), self._active[None].long()])

    def run_quantum(self, k: int | None = None) -> dict[int, list[int]]:
        """Advance all resident requests up to ``k`` (default: the
        engine's quantum) tokens; returns {rid: full token list} for
        requests that finished during this quantum (or at submit)."""
        finished: dict[int, list[int]] = self._done_now
        self._done_now = {}
        self.last_quantum_tokens = {}
        if not self._by_slot:
            for rid in finished:
                self._by_rid.pop(rid, None)
            return finished
        k = self._quantum if k is None else int(k)
        with metrics.span("engine.quantum") as quantum:
            # the quantum's one host sync
            block = self.decode_quantum(k).cpu()
            emitted_host, active_host = block[:-1], block[-1]
            if quantum:
                quantum.add(emitted=int((emitted_host >= 0).sum()),
                            live_keys=self._live_keys(emitted_host))
        for slot, req in list(self._by_slot.items()):
            toks = [int(t) for t in emitted_host[:, slot] if t >= 0]
            req.tokens.extend(toks)
            if toks:
                self.last_quantum_tokens[req.rid] = toks
            if not active_host[slot]:
                finished[req.rid] = req.tokens
                del self._by_slot[slot]
                self._free.append(slot)
        for rid in finished:
            self._by_rid.pop(rid, None)
        return finished

    def _live_keys(self, emitted: torch.Tensor) -> int:
        """The keys a quantum's steps attend, summed over each step's
        active lanes: ``min(position + 1, window)``, from the residents'
        positions before it and its emitted block ``[k, S]`` (a lane,
        once idle, stays idle within the quantum)."""
        pos0 = torch.zeros(emitted.shape[1], dtype=torch.long)
        for slot, req in self._by_slot.items():
            pos0[slot] = req.plen + len(req.tokens) - 1
        live = emitted >= 0
        keys = pos0 + live.long().cumsum(0) - live.long() + 1
        if self._cfg.attn_window is not None:
            keys = keys.clamp(max=self._cfg.attn_window)
        return int((keys * live).sum())

    def drain(self) -> dict[int, list[int]]:
        """Run quanta until every resident request completes."""
        out: dict[int, list[int]] = {}
        while self._by_slot or self._done_now:
            out.update(self.run_quantum())
        return out
