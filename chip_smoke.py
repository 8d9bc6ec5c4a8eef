#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py                     # every phase, as a check
    python3 chip_smoke.py --out results.json  # also write every number
    python3 chip_smoke.py --compare build/parent  # parent against change
    python3 chip_smoke.py --plant kv-scale,rope-offset  # the moe token
                                              # check against planted faults
    python3 chip_smoke.py --plant dp-mean,copy-to-bwd  # the shard
                                              # trainer's check, likewise
    python3 chip_smoke.py --plant pp-embed-sum,ring-local-lse  # the seq
                                              # pipeline's, the ring backward's
    python3 chip_smoke.py --plant tp-engine-table  # the tp engine's checks

Phases, each printing its own lines; any failure exits non-zero:

1. card     -- name, power limit, torch and CUDA versions; TF32 off; the
               device plugin's NVML enumerator against nvidia-smi.
2. build    -- the hand-written kernels, built from ``tpushare_torch/csrc``
               (one ``nvcc`` per source, all started together), with
               ptxas's registers, stack, spills and wgmma serialisation
               notes per kernel; a spill in a bf16 kernel fails, and so
               does a wgmma serialisation note in a bf16 backward one.
3. kernels  -- each kernel against its plain PyTorch version on the card,
               at the shapes the serving and training paths give it, with
               times, the ratio to SDPA (for the backward pair, the SDPA
               backward timed in CUDA graphs) and the share of the bound;
               one-CTA probes of the forward's and the backward's tile
               step; the backward kernels also launch twice for bitwise
               equal gradients; the decode attention over the int8 cache
               (``kv_decode``) at the chat cell's decode shape against its
               plain version, timed beside its byte bound and the plain
               version (the einsum chain it replaced).
4. train    -- the trainer (``player --mode train --attn flash``) at
               llama-8b width and depth, three AdamW steps on one batch of
               1024 tokens; the launch counts must show every layer's
               forward and backward went through the kernels; then one
               llama-8b-width layer's flash gradients against einsum's.
5. moe      -- the mixture-of-experts family at Mixtral-8x7B widths (the
               llama-8b geometry with 8 experts of d_ff 14336, top-2
               routing, depth cut to 4 layers), put into the port's
               presets for the phase: (a) the trainer (``player --mode
               train --attn flash``), three AdamW steps on one batch of
               1024 tokens at capacity factor 2.0, whose all-zero batch
               drops half the tokens at each k; every layer's forward and
               backward must go through the kernels and the losses must
               fall; (b) one layer of those widths, ``moe_ffn`` against
               the dense ``moe_ffn_reference`` where nothing drops, and
               ``moe_ffn`` timed at the train run's 1023 tokens against
               its bound; (c) the int8 replica at capacity factor 4.0
               (dropless) without ``--engine`` answering HTTP requests,
               every prefill through K1 and every decode step's layers
               through ``kv_decode``, the served tokens
               against an uncached einsum forward; (d) ``llama-moe-tiny``
               trained for two steps (head_dim 16 through K1, K2, K3).
               Runs before serve, whose engine replica stays registered.
6. serve    -- the int8 serving replica (``llama-8b``, int8 weights, int8
               KV cache, ``--attn flash``, continuous batching) answering
               HTTP requests; the launch counts must show every prefill
               went through K1 and every decode step's layers through
               ``kv_decode`` (a step the engine's CUDA graph replays
               counts its layers' launches). Then, on the same weights,
               an engine of the chat cell's pool (32 slots of 4096, every
               slot busy) times its decode step untraced, eager and
               replayed in turns, and counts each one's host launches.
6b. shard   -- data, tensor and expert parallelism, ranks sharing the one
               card over gloo: (a) ``samples/5-serving.yaml`` as deployed,
               the llama-8b int8 replica with ``--tp 4 --engine`` (four
               ranks, each under the sample's 8192 MiB grant, in a child
               process) serving the serve phase's ragged concurrent
               traffic, every prefill through K1 and every decode step's
               layers through ``kv_decode`` on every rank, every served
               token against the tp=1 replica's uncached forward
               on the same seeded weights, co-tenant invariance, and
               first-token logits against the tp=1 replica; (b) the
               trainer (``TrainCheckpointer.resume_or_init(mesh=)`` and
               ``make_train_step``) at
               llama-8b widths cut to 4 layers, dp=2 x tp=2 over four
               ranks for three AdamW steps on seeded random tokens with a
               checkpoint at step 2, then a second run restoring it onto a
               (1, 4) mesh for step 3, losses and parameters after steps 1
               and 3 held against the one-process trainer, every layer
               through K1, K2 and K3; (c) one Mixtral-width MoE layer at
               ep=2, forward and backward at T=1023, against the
               one-process ``moe_ffn``.
6c. seq     -- sequence and pipeline parallelism, four ranks sharing the
               card over gloo: which of gloo's calls take CUDA tensors;
               (a) ``samples/6-gang.yaml``'s hot op, ``player --sp ring``
               at llama-8b heads over S = 32768 (8192 rows a rank), every
               visiting chunk through K1 (r + 1 launches a call on rank
               r), the output against one-process K1 over the whole
               sequence, the same sequence zigzagged (2n + 1 launches a
               rank), and at S = 4096 against the plain fold; (b) two
               ``player --sp ring --multihost`` gang members from the
               rendezvous env; (c) Ulysses at llama-8b heads over S =
               32768 with a 4096 window, forward and backward bitwise
               one-process ``flash_attention``; (d) the GPipe pipeline at
               llama-8b widths cut to 8 layers, pp = 4, B = 4 in 4
               microbatches on seeded random tokens: logits against the
               one-process forward, three train steps held against the
               one-process trainer as in shard (b), K1, K2, K3 on every
               stage's layers; (e) ``ring_attention``'s forward and
               backward at the heads and S of (a), contiguous and
               zigzagged, K2 and K3 on every visible pair (r + 1 and
               2n + 1 a rank, as K1), dq, dk and dv against one-process
               ``flash_attention`` and at S = 4096 against the fp32 fold.
7. entry    -- the llama-mini forward of ``tpushare_torch.entry`` with the
               flash kernel against the einsum path.
8. vit      -- the ViT-B/16 fine-tune tenant of ``samples/7-vit.yaml``
               (``player --preset vit-b16 --mode train --batch 32 --attn
               flash``) under the sample's 4096 MiB grant with
               ``TPUSHARE_FLASH_FWD=pipelined``, in child processes (the
               grant's memory fraction is process-wide): three steps with
               a checkpoint at step 2, a second process that resumes from
               it and must reach the same step-3 state bitwise, a forward
               run; the launch counts must show every layer went through
               K4, K2 and K3 and none through K1; then ViT-B/16 logits
               through K4 against the einsum path.

The second-to-last line is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
``tpushare_torch`` package beside this script, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
from pathlib import Path

from benchmark.arith import flash_bound, flash_bwd_bound, roofline

ROOT = Path(__file__).resolve().parent


# kernel vs plain: both accumulate in fp32; they differ in summation
# order and, in bf16, in which p values round one way or the other, so
# bf16 allows a few output ulps (2**-7 at 1.0) and fp32 a few 1e-6
TOL = {"bfloat16": {"out": 2e-2, "lse": 1e-3},
       "float32": {"out": 1e-4, "lse": 1e-4}}
# kv_decode at the chat cell's decode shape (B, M, H, Hkv, D), timed over
# KV_LAYERS layers' caches (2.1 GB, against L2's 50 MB); spans (label,
# least and most keys a row, active rows: the rest read nothing). The
# chat cell's steps hold ~16k live keys (~13% of 32 x 4096, as its
# engine.kv_read_use metric reads on the einsum path)
KV_SHAPE = (32, 4096, 32, 8, 128)
KV_LAYERS = 8
KV_SPANS = [("chat mean, 1-1024 keys", 1, 1024, 32),
            ("1-4096 keys, 24 active", 1, 4096, 24),
            ("whole buffer", 4096, 4096, 32)]
# kernel vs plain (bf16 out): the plain version rounds q . k to bf16
# after the product (2**-9 of a raw dot) and p * vs to bf16 before the PV
# product, where the kernel keeps both in fp32; a row of one key gives
# out = v * vs, up to ~4, whose bf16 ulp is 2**-6
KV_TOL = 2e-2
# flash vs einsum llama-mini logits (bf16, 4 layers): the einsum path
# rounds scores to bf16 before the softmax, the kernel keeps them fp32,
# so the logits (|logit| up to about 6) may differ by a few bf16 ulps
# of 2**-5: allow 4
ENTRY_TOL = 0.125
# served greedy tokens against an uncached einsum forward over the same
# sequence: the served token's reference logit must be within this of
# the reference maximum (the int8 KV cache and the different GEMM
# shapes move logits by a few 1e-2; a broken path misses by the logit
# spread, about 4)
SERVE_MARGIN = 0.5

# backward kernel vs plain, relative to the plain version's largest
# magnitude: both sum in fp32 in another order, and in bf16 a P or dS
# value near a rounding boundary may round the other way, which moves a
# gradient by up to a bf16 ulp or two (2**-7 of the magnitude); fp32 by
# a few 1e-7
BWD_REL = {"bfloat16": 2 ** -7, "float32": 1e-5}
# flash vs einsum gradients of one llama-8b-width layer, relative to the
# einsum gradient's largest magnitude: the einsum path rounds scores to
# bf16 before the softmax and the kernels keep them fp32, so P and dS
# differ by about 2**-9 relative; summed over 1023 tokens in bf16 products
# the gradients move by a percent or so. A broken kernel misses by the
# gradient's own size.
LAYER_GRAD_REL = 0.05
# flash (K4) vs einsum ViT-B/16 logits (bf16, 12 layers), relative to
# the largest einsum logit: the einsum path rounds scores to bf16 before
# the softmax and the kernels keep them fp32, so every layer's attention
# output moves by a bf16 ulp here and there, and twelve residual layers
# carry that into the logits by a few percent of their spread at most; a
# broken kernel misses by the spread itself
VIT_LOGIT_REL = 0.05
VIT_SHAPE = "vit-b16 B=32 S=197"
VIT_LAYERS = 12
VIT_GRANT_MIB = 4096
VIT_STEPS = 3
VIT_ARGV = ["--preset", "vit-b16", "--batch", "32", "--attn", "flash",
            "--device", "cuda"]
TRAIN_ARGV = ["--preset", "llama-8b", "--mode", "train", "--attn", "flash",
              "--batch", "1", "--seq", "1024", "--steps", "3",
              "--device", "cuda"]

SERVE_ARGV = ["--preset", "llama-8b", "--quant", "int8",
              "--kv-cache-dtype", "int8", "--attn", "flash", "--engine",
              "--engine-slots", "8", "--engine-max-len", "512",
              "--device", "cuda", "--port", "0"]

# the moe phase: Mixtral-8x7B's widths (the llama-8b geometry with
# moe_experts=8, top-2) at 4 of its 32 layers, under two preset names
# that exist only while the phase runs
MOE_LAYERS = 4
MOE_PRESET = "mixtral-8x7b-l4"
MOE_DROPLESS_PRESET = "mixtral-8x7b-l4-dropless"   # capacity factor 4.0
MOE_TRAIN_ARGV = ["--preset", MOE_PRESET, "--mode", "train", "--attn",
                  "flash", "--batch", "1", "--seq", "1024", "--steps",
                  "3", "--device", "cuda"]
MOE_SERVE_ARGV = ["--preset", MOE_DROPLESS_PRESET, "--quant", "int8",
                  "--kv-cache-dtype", "int8", "--attn", "flash", "--device",
                  "cuda", "--port", "0"]
MOE_TINY_ARGV = ["--preset", "llama-moe-tiny", "--mode", "train", "--attn",
                 "flash", "--batch", "1", "--seq", "128", "--steps",
                 "2", "--device", "cuda"]
# the replica's prompt batches (B, S), in the order they are drawn; the
# kernels phase holds K1 at each, and K1-K3 at llama-moe-tiny's shape
MOE_SERVE_PREFILLS = ((1, 100), (3, 128), (1, 450))
MOE_TINY_SHAPE = "llama-moe-tiny train S=127"
# moe_ffn vs moe_ffn_reference on one Mixtral-width layer in bf16 where
# nothing drops, relative to the reference's largest output: the packed
# path rounds the gates to bf16 and sums the two experts' outputs in one
# fp32 product, the dense one rounds each weighted output to bf16 and adds
# them in bf16, and the expert GEMMs run at other shapes; each moves an
# output by a bf16 ulp or two (2**-7 of its magnitude). A wrong routing
# misses by the output itself.
MOE_LAYER_REL = 2 ** -5
# moe serve (moe_token_check): layer 0's router logits (spread about 1)
# on the served path against the uncached einsum forward: the int8 KV
# cache and the flash prefill move them by a few 1e-2 (at most 0.037 on
# an H100). The planted faults of --plant moved them by 0.62 (decode
# RoPE one position ahead) and 2.15 (KV scales doubled)
MOE_ROUTER0_TOL = 0.1
# the share of generated positions whose experts may differ in some layer
# between the two paths. Which experts sit within those few 1e-2 of each
# other is the weight draw's, so the sound path's count is a draw's luck:
# on an H100 it read 7-19 of 97 over weight seeds 0-23 (6-18 over seeds
# 0-5 of an earlier draw), the planted faults 90-92 (KV scales doubled)
# and 62-70 (decode RoPE one ahead) over seeds 0-3
MOE_FLIP_SHARE = 0.3


# the shard phase: sample 5's replica (tp over the ranks of its 4-chip
# grant, here four ranks on one card, each under the sample's grant)
SHARD_TP = 4
SHARD_GRANT_MIB = 8192
SHARD_SERVE_ARGV = ["--preset", "llama-8b", "--quant", "int8",
                    "--kv-cache-dtype", "int8", "--attn", "flash", "--tp",
                    str(SHARD_TP), "--engine", "--engine-slots", "8",
                    "--engine-max-len", "512", "--device", "cuda", "--port",
                    "0"]
# the prompts whose first-token logits are held against the tp=1
# replica, and which the replica's path without its engine
# (``TPReplica.decode``: every rank runs greedy_decode_kv in lockstep)
# serves from the same ranks, each alone, for SHARD_DECODE_STEPS tokens
SHARD_PROMPTS = (5, 100, 240, 450)
SHARD_DECODE_STEPS = 8
# what the tp replica's token agreement (serve._agree) raises: a planted
# fault counts as refused only by it, or by the token or co-tenant check
TP_AGREE_MESSAGE = "tp ranks drew different tokens"
# first-token logits of the tp=4 replica against the tp=1 one (same
# int8 weights, the flash prefill over an int8 cache): the row-parallel
# products round each rank's bf16 partial sum before the fp32
# all-reduce where tp=1 rounds the whole sum once, about a bf16 ulp of
# each layer's output, carried through 32 residual layers; a broken
# shard or a missing all-reduce misses by the logit spread (about 4)
SHARD_LOGIT_TOL = 0.25
# the trainer: llama-8b widths at 2 layers (:func:`shard_config`; the
# depth is cut so that the run's time goes to the tp replica's traffic),
# on B=2 rows of 1024 seeded random tokens, so the two dp ranks take
# different rows
SHARD_LAYERS = 2
SHARD_BATCH, SHARD_SEQ, SHARD_TOKEN_SEED = 2, 1024, 7
SHARD_LR = 3e-4
# the parameters of the sharded runs against the one-process trainer's,
# after step 1 and step 3, this rank's shard of each leaf: AdamW's first
# step moves a weight by about lr whatever its gradient's size, so where
# the meshes' reduction orders turn a near-zero gradient's sign, a
# weight differs by 2 lr (plus a bf16 ulp of |w| < 0.2: 2**-10), by up
# to 6 lr over three steps. A wrong shard or a restore onto the wrong
# placements misses by the weights themselves (0.016 to 0.2 here)
SHARD_STEP_TOL = {1: 2 * SHARD_LR + 2 ** -10, 3: 6 * SHARD_LR + 2 ** -10}
# the bulk of those differences: mean |d| over each leaf's elements, in
# units of lr. Only near-zero gradients turn sign in a sound run; a
# gradient without its dp mean or a tp all-reduce turns a large share
# (``--plant dp-mean,copy-to-bwd``)
SHARD_MEAN_TOL = 0.1
# the losses of steps 1-3: step 1's differs by the logits' rounding,
# steps 2 and 3 by what the updates above move
SHARD_LOSS_TOL = 0.05
# the leaves the ranks hold against the one-process trainer's
SHARD_REF_LEAVES = ("lm_head", "final_norm", "layers.0.attn_norm",
                    "layers.0.wq", "layers.0.wk", "layers.0.wv",
                    "layers.0.wo", "layers.0.w1", "layers.0.w3",
                    "layers.0.w2", "layers.1.w2")
SHARD_ENGINE_SHAPE = "tp=4 engine prefill S=512"
SHARD_MOE_T = 1023
SHARD_TRAIN_SHAPE = "tp=2 train S=1023"

# the seq phase: sequence and pipeline parallelism, four ranks sharing the
# card over gloo as a gang member's four chips would hold them.
# (a) samples/6-gang.yaml's hot op, ``player --sp ring``, at llama-8b
# heads (32 query, 8 kv, of 128) over S = 32768 (Llama 3.1's 32k-class
# context): 8192 rows a rank
SEQ_RANKS = 4
SEQ_S = 32768
SEQ_RING_STEPS = 3
SEQ_RING_ARGV = ["--preset", "llama-8b", "--sp", "ring", "--seq",
                 str(SEQ_S), "--steps", str(SEQ_RING_STEPS), "--device",
                 "cuda"]
# the ring's output against one-process K1 over the whole sequence: each
# visiting chunk's O is rounded to bf16 (half an ulp, 2**-9 of |O|)
# before the fp32 merge and the merged O once more, where one-process K1
# rounds once. Rank 0's rows fold one chunk and come out bitwise; every
# other row sees over 8192 keys, so |O| < 1 there and the merge moves it
# by at most a few 2**-9: allow 2**-7
RING_TOL = 2 ** -7
# the card's route against the plain fold, at S = 4096 (the fold's fp32
# scores take 128 MB a step there, 8 GiB at 32768): kernel vs plain, as
# in the kernels phase (TOL)
SEQ_FOLD_S = 4096
# (b) two gang members, as the device plugin starts them
SEQ_GANG_ARGV = ["--preset", "llama-8b", "--sp", "ring", "--multihost",
                 "--steps", "2", "--device", "cuda"]
# (c) Ulysses at llama-8b heads over S = 32768 with Mistral 7B's
# published sliding window
SEQ_WINDOW = 4096
SEQ_ULYSSES_SEED = 21
# (e) the ring's forward and backward, the same heads and S, on seeded q,
# k, v and dO, contiguous and zigzagged: dq, dk and dv against
# one-process flash_attention (K1-K3 through _Flash) over the whole
# sequence. Every piece of the ring's backward leaves K2 or K3 rounded to
# bf16 (half an ulp, 2**-9 of |piece|) before the fp32 sum across the
# ring, and the sum is rounded once more, where one process rounds once:
# with at most 2n + 1 = 9 pieces a tensor, and no piece larger than
# max|grad| in these diffuse rows, under 10 * 2**-9 of max|grad|; a
# chunk's own LSE in place of the merged one (``--plant ring-local-lse``)
# rescales every piece's P and misses by the gradients' own size
SEQ_GRAD_SEED = 23
RING_GRAD_REL = 2 ** -5
# at SEQ_FOLD_S the card's gradients against the plain fold's in fp32 on
# the same bf16 values: the kernels' bf16 P and dS (as the kernels
# phase's BWD_REL allows), relative to max|grad| as the forward's 2e-2
RING_FOLD_GRAD_REL = 2e-2
SEQ_RING_SHAPE = f"ring chunk S={SEQ_S // SEQ_RANKS}"
SEQ_RING_HALF_SHAPE = f"ring zigzag half S={SEQ_S // SEQ_RANKS // 2}"
SEQ_ULYSSES_SHAPE = f"ulysses heads S={SEQ_S} window {SEQ_WINDOW}"
# (d) the GPipe pipeline at llama-8b widths, depth cut from 32 to 8
# layers (2 a stage), pp = 4, B = 4 in M = 4 microbatches, on S = 1024
# seeded random tokens
PP_LAYERS = 8
PP_BATCH, PP_SEQ, PP_TOKEN_SEED = 4, 1024, 11
PP_MICROBATCHES = 4
# logits of the pipelined forward against the one-process forward: the
# microbatches' products (1023 rows) round as cuBLAS picks for their
# shape, the one process's (4092 rows) as for its own, a bf16 ulp here
# and there carried through 8 residual layers; a wrong stage order or a
# lost handoff misses by the logit spread (about 4), as SHARD_LOGIT_TOL
PP_LOGIT_TOL = 0.25
# the leaves held against the one-process trainer after steps 1 and 3:
# every layer's attention weights and norms (every stage's), two layers'
# w2, and the embedding and head every rank holds
PP_REF_LEAVES = ("embed", "lm_head", "final_norm", "layers.1.w2",
                 "layers.6.w2", *(f"layers.{i}.{n}" for i in range(PP_LAYERS)
                                  for n in ("wq", "wk", "wv", "wo",
                                            "attn_norm", "ffn_norm")))


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self):
        self.results: dict = {}

    # -- 1. card ---------------------------------------------------------------
    def card(self):
        import torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        self.smi = smi.stdout.strip().splitlines()[0]
        log(self.smi)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.kind = torch.cuda.get_device_name(0)
        log(f"card: {self.kind}, {torch.cuda.device_count()} visible; "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
            "TF32 off for matmul and cuDNN")
        self.results["card"] = {"nvidia_smi": self.smi, "kind": self.kind,
                                "torch": torch.__version__,
                                "cuda": torch.version.cuda,
                                "nvml": self._nvml()}

    def _nvml(self) -> dict:
        """The device plugin's GPU enumerator on this host: NVML must
        load and report every card, each under its /dev/nvidia<minor>
        node (which exists), with nvidia-smi's memory total; torch sees a
        little less of each (what CUDA keeps for itself)."""
        import torch
        from tpushare_torch.deviceplugin import (NvmlEnumerator,
                                                 detect_enumerator)
        nvml = NvmlEnumerator()
        if not nvml.available():
            raise AssertionError("NVML (libnvidia-ml.so.1) did not load")
        chips = nvml.enumerate()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.total",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        smi_mib = [int(x) for x in smi.stdout.split()]
        torch_mib = [torch.cuda.get_device_properties(i).total_memory / 2**20
                     for i in range(torch.cuda.device_count())]
        problems = []
        if len(chips) != torch.cuda.device_count():
            problems.append(f"{len(chips)} cards, torch sees "
                            f"{torch.cuda.device_count()}")
        if [c.hbm_mib for c in chips] != smi_mib:
            problems.append(f"hbm_mib {[c.hbm_mib for c in chips]} against "
                            f"nvidia-smi's {smi_mib}")
        for c, t in zip(chips, torch_mib):
            if not os.path.exists(c.device_path):
                problems.append(f"{c.device_path} does not exist")
            if not 0 <= c.hbm_mib - t <= 0.02 * c.hbm_mib:
                problems.append(f"card {c.idx}: NVML {c.hbm_mib} MiB, "
                                f"torch {t:.1f} MiB")
        if detect_enumerator() is None:
            problems.append("detect_enumerator found no NVML enumerator")
        if problems:
            raise AssertionError("NVML enumerator: " + "; ".join(problems))
        log(f"card: NVML enumerator: {len(chips)} card(s), mesh "
            f"{nvml.mesh.label()}: " + "; ".join(
                f"idx {c.idx} {c.device_path} (exists) hbm_mib {c.hbm_mib} "
                f"(nvidia-smi {m}; torch {t:.1f} MiB)"
                for c, m, t in zip(chips, smi_mib, torch_mib)))
        return {"count": len(chips), "mesh": nvml.mesh.label(),
                "records": [{"idx": c.idx, "coords": list(c.coords),
                             "hbm_mib": c.hbm_mib,
                             "device_path": c.device_path} for c in chips],
                "nvidia_smi_mib": smi_mib, "torch_mib": torch_mib}

    # -- 2. build --------------------------------------------------------------
    def build(self):
        from tpushare_torch.kernels import build
        t0 = time.perf_counter()
        built = build.build(verbose=True)
        wall = time.perf_counter() - t0
        reports = {}
        for name, info in built.items():
            log(f"build {name}: {info['seconds']:.1f} s -> "
                f"{Path(info['path']).relative_to(ROOT)}")
            reports[name] = ptxas_report(info["log"])
            highest = sass_highest_register(info["path"])
            for r in reports[name]:
                r["highest_register"] = highest.get(r["kernel"])
                log(f"  ptxas {r['kernel']}: {r['registers']} registers, "
                    f"{r['stack']} bytes stack, {r['spill_stores']} / "
                    f"{r['spill_loads']} bytes spill stores / loads; "
                    f"machine code up to R{r['highest_register']}"
                    + "".join(f"\n    NOTE {s}" for s in r["serialized"]))
        log(f"build: all kernels in {wall:.1f} s")
        self.results["build_s"] = wall
        self.results["ptxas"] = reports
        hopper = [r for rs in reports.values() for r in rs
                  if "_tc_kernel" in r["kernel"]]
        spills = [r["kernel"] for r in hopper
                  if r["spill_stores"] or r["spill_loads"]]
        if spills:
            raise AssertionError(f"ptxas spills in the bf16 Hopper "
                                 f"kernels: {spills}")
        serialized = [r["kernel"] for r in hopper
                      if "bwd" in r["kernel"] and r["serialized"]]
        if serialized:
            raise AssertionError(f"ptxas serialised wgmma in the bf16 "
                                 f"backward kernels: {serialized}")

    # -- 3. kernels ------------------------------------------------------------
    def kernels(self):
        import torch
        import torch.nn.functional as F
        from tpushare_torch.kernels import flash
        from tpushare_torch.workloads.attention import flash_attention_plain

        bf16, f32 = torch.bfloat16, torch.float32
        # (label, B, H, Hkv, S, D, dtype, causal, window, model layout);
        # model layout takes q, k and v as the model hands them, [B, S, H,
        # D] projections transposed to [B, H, S, D]
        shapes = [("llama-8b prefill S=8", 1, 32, 8, 8, 128, bf16, True, None,
                   False),
                  ("llama-8b prefill S=128", 1, 32, 8, 128, 128, bf16, True,
                   None, False),
                  ("llama-8b prefill S=512", 1, 32, 8, 512, 128, bf16, True,
                   None, False),
                  ("llama-8b train S=1023", 1, 32, 8, 1023, 128, bf16, True,
                   None, False),
                  *[(f"moe serve prefill B={B} S={S}", B, 32, 8, S, 128,
                     bf16, True, None, True)
                    for B, S in MOE_SERVE_PREFILLS],
                  ("entry llama-mini", 2, 8, 4, 128, 64, bf16, True, None,
                   False),
                  ("ragged S=200", 1, 32, 8, 200, 128, bf16, True, None,
                   False),
                  ("non-causal", 1, 32, 8, 256, 128, bf16, False, None,
                   False),
                  ("window 77", 1, 32, 8, 256, 128, bf16, True, 77, False),
                  ("fp32", 1, 8, 2, 256, 64, f32, True, None, False),
                  ("D=16 (llama-tiny)", 2, 4, 2, 96, 16, bf16, True, None,
                   False),
                  (MOE_TINY_SHAPE, 1, 4, 2, 127, 16, bf16, True, None, True),
                  # a rank's heads: the tp=4 replica's prefills, the tp=2
                  # trainer's layers
                  *[(f"tp=4 prefill S={S}", 1, 8, 2, S, 128, bf16, True,
                     None, True) for S in (100, 450)],
                  # the tp=4 engine's prefills are bucketed: 512 is the
                  # bucket of its longest prompts (300 and 450 tokens)
                  (SHARD_ENGINE_SHAPE, 1, 8, 2, 512, 128, bf16, True, None,
                   True),
                  (SHARD_TRAIN_SHAPE, 1, 16, 4, 1023, 128, bf16, True, None,
                   True),
                  # the ring's visiting chunks (S/n rows against S/n keys:
                  # the diagonal causal, the others fully visible) and
                  # Ulysses' head subset over the whole sequence
                  (SEQ_RING_SHAPE, 1, 32, 8, SEQ_S // SEQ_RANKS, 128, bf16,
                   True, None, False),
                  (SEQ_RING_SHAPE + " non-causal", 1, 32, 8,
                   SEQ_S // SEQ_RANKS, 128, bf16, False, None, False),
                  (SEQ_ULYSSES_SHAPE, 1, 32 // SEQ_RANKS, 8 // SEQ_RANKS,
                   SEQ_S, 128, bf16, True, SEQ_WINDOW, False),
                  (VIT_SHAPE, 32, 12, 12, 197, 64, bf16, False, None, True)]
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = []
        for label, B, H, Hkv, S, D, dt, causal, window, bshd in shapes:
            if bshd:
                q, k, v = (torch.randn(B, S, h, D, generator=gen,
                                       device=dev).to(dt).transpose(1, 2)
                           for h in (H, Hkv, Hkv))
            else:
                q = torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
                k = torch.randn(B, Hkv, S, D, generator=gen,
                                device=dev).to(dt)
                v = torch.randn(B, Hkv, S, D, generator=gen,
                                device=dev).to(dt)
            out, lse = flash.flash_fwd(q, k, v, causal, window)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_plain(q, k, v, causal, window)
            err_o = (out.float() - ref_out.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            tol = TOL[str(dt).split(".")[-1]]
            if not (err_o <= tol["out"] and err_l <= tol["lse"]):
                raise AssertionError(
                    f"{label}: kernel vs plain max|dO| {err_o:.3g} (tol "
                    f"{tol['out']}), max|dLSE| {err_l:.3g} (tol "
                    f"{tol['lse']})")

            def kernel():
                return flash.flash_fwd(q, k, v, causal, window)

            ms = time_ms(kernel, 50)
            host_ms = call_ms(kernel)
            plain_ms = time_ms(
                lambda: flash_attention_plain(q, k, v, causal, window),
                plain_calls(S, 5))
            mask = None
            if window is not None:
                pos = torch.arange(S, device=dev)
                mask = ((pos[None, :] <= pos[:, None])
                        & (pos[None, :] >= pos[:, None] - (window - 1)))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True), 50)
            bound = flash_bound(B, H, Hkv, S, D, dt, causal, window)
            row = {"shape": label, "B": B, "H": H, "Hkv": Hkv, "S": S,
                   "D": D, "dtype": str(dt), "causal": causal,
                   "window": window, "max_abs_err_out": err_o,
                   "max_abs_err_lse": err_l, "ms": ms, "call_ms": host_ms,
                   "plain_ms": plain_ms,
                   "library_ms": lib_ms, **bound,
                   "sdpa_ratio": ms / lib_ms,
                   "bound_share": bound["bound_ms"] / ms}
            rows.append(row)
            log(f"kernel flash_fwd [{label}] B={B} H={H} Hkv={Hkv} S={S} "
                f"D={D} {str(dt)[6:]} causal={causal} window={window}: "
                f"max|dO| {err_o:.3g} max|dLSE| {err_l:.3g}; "
                f"{ms:.4f} ms ({host_ms:.4f} ms a call from Python), "
                f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
                f"(ratio {row['sdpa_ratio']:.2f}), bound "
                f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
                f"({bound['flops']:.4g} FLOP, {bound['bytes']:.4g} B; "
                f"share {row['bound_share']:.3f})")
            row["pipelined"] = self._kernel_pipelined(
                label, q, k, v, causal, window, out, lse, ref_out, ref_lse,
                tol, row)
        self.results["kernel_shapes"] = rows
        self._tile_step_probe()
        self._bwd_tile_step_probe()
        self._kernels_bwd()
        self._kv_decode()

    def _kv_decode(self):
        """The decode attention over the int8 cache (``kv_decode``) at the
        chat cell's decode shape: 32 slots of 4096 positions, Mistral-7B's
        heads (32 query, 8 kv, head_dim 128), window 4096, bf16 queries;
        keys and values drawn N(0, 1) and quantised as the model stores
        them. For each set of spans: the kernel against its plain version,
        its device time over ``KV_LAYERS`` layers' caches in turn (more
        bytes than L2 holds, as a decode step finds them), its byte bound,
        and the plain version's time, which is the einsum chain the decode
        step ran before the kernel, masked by span."""
        import torch
        from tpushare_torch.kernels import kv_decode
        from tpushare_torch.workloads.model import _kv_quant

        B, M, H, Hkv, D = KV_SHAPE
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(9)
        q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
        layers = []
        for _ in range(KV_LAYERS):
            k8, ks = _kv_quant(torch.randn(B, M, Hkv, D, generator=gen,
                                           device=dev))
            v8, vs = _kv_quant(torch.randn(B, M, Hkv, D, generator=gen,
                                           device=dev))
            layers.append((k8, v8, ks, vs))
        rows = []
        for label, least, most, active in KV_SPANS:
            hi = torch.randint(least, most + 1, (B,), generator=gen,
                               device=dev, dtype=torch.int32)
            lo = torch.zeros_like(hi)
            hi = torch.where(torch.arange(B, device=dev) < active, hi, lo)
            out = kv_decode.kv_decode(q, *layers[0][:2], *layers[0][2:],
                                      lo, hi)
            torch.cuda.synchronize()
            ref = kv_decode.kv_decode_plain(q, *layers[0][:2],
                                            *layers[0][2:], lo, hi)
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= KV_TOL:
                raise AssertionError(f"kv_decode [{label}]: kernel vs plain "
                                     f"max|d| {err:.3g} (tol {KV_TOL})")
            turn = [0]

            def kernel():
                k8, v8, ks, vs = layers[turn[0] % KV_LAYERS]
                turn[0] += 1
                return kv_decode.kv_decode(q, k8, v8, ks, vs, lo, hi)

            def plain():
                k8, v8, ks, vs = layers[turn[0] % KV_LAYERS]
                turn[0] += 1
                return kv_decode.kv_decode_plain(q, k8, v8, ks, vs, lo, hi)

            ms = time_ms(kernel, KV_LAYERS)
            host_ms = call_ms(kernel)
            plain_ms = time_ms(plain, KV_LAYERS, reps=3)
            keys = int((hi - lo).sum())
            # each live key's int8 K and V rows and fp32 scales read once,
            # q read and the output written once
            nbytes = keys * Hkv * (2 * D + 8) + 2 * 2 * B * H * D + 8 * B
            bound = roofline(4 * keys * H * D, nbytes, torch.bfloat16)
            row = {"shape": label, "B": B, "M": M, "H": H, "Hkv": Hkv,
                   "D": D, "live_keys": keys, "max_abs_err": err, "ms": ms,
                   "call_ms": host_ms, "plain_ms": plain_ms, **bound,
                   "bound_share": bound["bound_ms"] / ms}
            rows.append(row)
            log(f"kernel kv_decode [{label}] B={B} M={M} H={H} Hkv={Hkv} "
                f"D={D}, {keys} live keys: max|d| {err:.3g} against plain; "
                f"{ms:.4f} ms ({host_ms:.4f} ms a call from Python), plain "
                f"(the einsum chain) {plain_ms:.4f} ms, bound "
                f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
                f"({bound['bytes']:.4g} B; share {row['bound_share']:.3f})")
        self.results["kv_decode_shapes"] = rows

    def _tile_step_probe(self):
        """The latency of one kv tile step: K1 and K4 on one CTA (B = H =
        1, one 128-row q tile, causal off) over n and 2n 64-key tiles; the
        difference over n is one step's time."""
        import torch
        from tpushare_torch.kernels import flash

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(5)
        n = 16
        out = []
        for D in (64, 128):
            q = torch.randn(1, 1, 128, D, generator=gen, device=dev).to(
                torch.bfloat16)
            rec = {"D": D, "n_tiles": n}
            for name, pipelined in (("flash_fwd", False),
                                    ("flash_fwd_pipelined", True)):
                times = []
                for tiles in (n, 2 * n):
                    k, v = (torch.randn(1, 1, tiles * 64, D, generator=gen,
                                        device=dev).to(torch.bfloat16)
                            for _ in range(2))
                    times.append(time_ms(
                        lambda: flash.flash_fwd(q, k, v, False,
                                                pipelined=pipelined), 50))
                rec[name] = {"ms_n": times[0], "ms_2n": times[1],
                             "step_us": (times[1] - times[0]) / n * 1e3}
            out.append(rec)
            log(f"tile step D={D}: one CTA over {n} and {2 * n} kv tiles: "
                f"flash_fwd {rec['flash_fwd']['ms_n']:.4f} / "
                f"{rec['flash_fwd']['ms_2n']:.4f} ms = "
                f"{rec['flash_fwd']['step_us']:.3f} us a step; "
                f"flash_fwd_pipelined "
                f"{rec['flash_fwd_pipelined']['ms_n']:.4f} / "
                f"{rec['flash_fwd_pipelined']['ms_2n']:.4f} ms = "
                f"{rec['flash_fwd_pipelined']['step_us']:.3f} us a step")
        self.results["tile_step"] = out

    def _bwd_tile_step_probe(self):
        """The latency of one backward tile step: each kernel on one CTA
        (B = H = Hkv = 1, causal off) over n and 2n tiles; the difference
        over n is one step's time. K2: 128 query rows over n and 2n
        64-key tiles; K3: 64 keys over n and 2n 64-row q tiles."""
        import torch
        from tpushare_torch.kernels import flash, flash_bwd
        from tpushare_torch.workloads import attention

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(6)
        n = 16

        def inputs(S, Skv, D):
            q, do = (torch.randn(1, 1, S, D, generator=gen, device=dev).to(
                torch.bfloat16) for _ in range(2))
            k, v = (torch.randn(1, 1, Skv, D, generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            out, lse = flash.flash_fwd(q, k, v, False)
            qs, do, lse, delta = attention._bwd_residuals(q, out, lse, do)
            return qs, k, v, do, lse, delta

        out = []
        for D in (64, 128):
            rec = {"D": D, "n_tiles": n}
            for name, fn, shape in (
                    ("dq", flash_bwd.flash_bwd_dq,
                     lambda t: (128, t * 64)),
                    ("dkdv", flash_bwd.flash_bwd_dkdv,
                     lambda t: (t * 64, 64))):
                times = []
                for tiles in (n, 2 * n):
                    args = inputs(*shape(tiles), D)
                    times.append(time_ms(lambda: fn(*args, False), 50))
                rec[name] = {"ms_n": times[0], "ms_2n": times[1],
                             "step_us": (times[1] - times[0]) / n * 1e3}
            out.append(rec)
            log(f"bwd tile step D={D}: one CTA over {n} and {2 * n} tiles: "
                f"flash_bwd_dq (128 query rows x 64 keys a step) "
                f"{rec['dq']['ms_n']:.4f} / {rec['dq']['ms_2n']:.4f} ms = "
                f"{rec['dq']['step_us']:.3f} us a step; flash_bwd_dkdv (64 "
                f"keys x 64 query rows a step) {rec['dkdv']['ms_n']:.4f} / "
                f"{rec['dkdv']['ms_2n']:.4f} ms = "
                f"{rec['dkdv']['step_us']:.3f} us a step")
        self.results["bwd_tile_step"] = out

    def _kernel_pipelined(self, label, q, k, v, causal, window, out, lse,
                          ref_out, ref_lse, tol, row) -> dict:
        """K4 on K1's inputs: bitwise K1's output and LSE, within TOL of
        the plain version, and its times. Its plain version and the SDPA
        call are K1's, timed on these inputs in K1's row."""
        import torch
        from tpushare_torch.kernels import flash

        def kernel():
            return flash.flash_fwd(q, k, v, causal, window, pipelined=True)

        p_out, p_lse = kernel()
        torch.cuda.synchronize()
        if not (torch.equal(p_out, out) and torch.equal(p_lse, lse)):
            diff = (p_out.float() - out.float()).abs().max().item()
            raise AssertionError(f"{label}: flash_fwd_pipelined is not "
                                 f"bitwise flash_fwd (max|dO| {diff:.3g})")
        err_o = (p_out.float() - ref_out.float()).abs().max().item()
        err_l = (p_lse - ref_lse).abs().max().item()
        if not (err_o <= tol["out"] and err_l <= tol["lse"]):
            raise AssertionError(f"{label}: flash_fwd_pipelined vs plain "
                                 f"max|dO| {err_o:.3g}, max|dLSE| {err_l:.3g}")
        rec = {"bitwise_flash_fwd": True, "max_abs_err_out": err_o,
               "max_abs_err_lse": err_l, "ms": time_ms(kernel, 50),
               "call_ms": call_ms(kernel)}
        rec["sdpa_ratio"] = rec["ms"] / row["library_ms"]
        rec["bound_share"] = row["bound_ms"] / rec["ms"]
        log(f"kernel flash_fwd_pipelined [{label}]: bitwise flash_fwd "
            f"(output and LSE); {rec['ms']:.4f} ms ({rec['call_ms']:.4f} ms "
            f"a call from Python) against flash_fwd {row['ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms (ratio "
            f"{rec['sdpa_ratio']:.2f}), bound {row['bound_ms']:.4f} ms "
            f"(share {rec['bound_share']:.3f})")
        return rec

    def _kernels_bwd(self):
        """K2 (dq) and K3 (dk/dv) against their plain versions, on inputs
        made from K1's own output (O and LSE), as the training path makes
        them."""
        import torch
        from tpushare_torch.kernels import flash, flash_bwd
        from tpushare_torch.workloads import attention

        bf16, f32 = torch.bfloat16, torch.float32
        # (label, B, H, Hkv, S, D, dtype, causal, window, model layout)
        shapes = [("llama-8b train S=1023", 1, 32, 8, 1023, 128, bf16, True,
                   None, True),
                  ("llama-8b S=512", 1, 32, 8, 512, 128, bf16, True, None,
                   False),
                  ("non-causal", 1, 32, 8, 256, 128, bf16, False, None,
                   False),
                  ("window 77", 1, 32, 8, 256, 128, bf16, True, 77, False),
                  ("fp32", 1, 8, 2, 256, 64, f32, True, None, False),
                  ("D=16 (llama-tiny)", 2, 4, 2, 96, 16, bf16, True, None,
                   False),
                  (MOE_TINY_SHAPE, 1, 4, 2, 127, 16, bf16, True, None, True),
                  (SHARD_TRAIN_SHAPE, 1, 16, 4, 1023, 128, bf16, True, None,
                   True),
                  # the ring's backward: a visiting chunk of S/n rows and
                  # keys (the diagonal causal, the others fully visible),
                  # and zigzag's half pieces
                  *[(f"{label}{'' if causal else ' non-causal'}", 1, 32, 8,
                     rows, 128, bf16, causal, None, False)
                    for label, rows in ((SEQ_RING_SHAPE, SEQ_S // SEQ_RANKS),
                                        (SEQ_RING_HALF_SHAPE,
                                         SEQ_S // SEQ_RANKS // 2))
                    for causal in (True, False)],
                  # Ulysses' head subset over the whole sequence
                  (SEQ_ULYSSES_SHAPE, 1, 32 // SEQ_RANKS, 8 // SEQ_RANKS,
                   SEQ_S, 128, bf16, True, SEQ_WINDOW, False),
                  (VIT_SHAPE, 32, 12, 12, 197, 64, bf16, False, None, True)]
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(1)
        rows = []
        for label, B, H, Hkv, S, D, dt, causal, window, bshd in shapes:
            dims = ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, H, S, D))
            if bshd:
                # the model's [B, S, H, D] projections, transposed views
                q, k, v, do = (torch.randn(b, s, h, d, generator=gen,
                                           device=dev).to(dt).transpose(1, 2)
                               for b, h, s, d in dims)
            else:
                q, k, v, do = (torch.randn(d, generator=gen,
                                           device=dev).to(dt) for d in dims)
            out, lse = flash.flash_fwd(q, k, v, causal, window)
            qs, do_c, lse_c, delta = attention._bwd_residuals(q, out, lse,
                                                              do)
            args = (qs, k, v, do_c, lse_c, delta)

            def dq_kernel():
                return flash_bwd.flash_bwd_dq(*args, causal, window)

            def dkdv_kernel():
                return flash_bwd.flash_bwd_dkdv(*args, causal, window)

            got = (dq_kernel(), *dkdv_kernel())
            torch.cuda.synchronize()
            again = (dq_kernel(), *dkdv_kernel())
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{label}: two launches of the "
                                     "backward kernels differ")
            want = (attention.flash_bwd_dq_plain(*args, causal, window),
                    *attention.flash_bwd_dkdv_plain(*args, causal, window))
            rel_tol = BWD_REL[str(dt).split(".")[-1]]
            errs = {}
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                err = (a.float() - b.float()).abs().max().item()
                scale = b.float().abs().max().item()
                errs[name] = (err, scale)
                if not err <= rel_tol * scale:
                    raise AssertionError(
                        f"{label}: {name} kernel vs plain max|d| {err:.3g} "
                        f"> {rel_tol:.3g} x max|{name}| {scale:.3g}")

            sdpa = sdpa_backward_ms(q, k, v, do, causal, window)
            lib_ms = sdpa["ms"]
            row = {"shape": label, "B": B, "H": H, "Hkv": Hkv, "S": S,
                   "D": D, "dtype": str(dt), "causal": causal,
                   "window": window, "model_layout": bshd,
                   "library_ms": lib_ms, "sdpa": sdpa}
            for key, fn, plain, names in (
                    ("dq", dq_kernel,
                     lambda: attention.flash_bwd_dq_plain(*args, causal,
                                                          window), ("dq",)),
                    ("dkdv", dkdv_kernel,
                     lambda: attention.flash_bwd_dkdv_plain(*args, causal,
                                                            window),
                     ("dk", "dv"))):
                bound = flash_bwd_bound(key, B, H, Hkv, S, D, dt, causal,
                                        window)
                row[key] = {"ms": time_ms(fn, 20), "call_ms": call_ms(fn),
                            "plain_ms": time_ms(plain, plain_calls(S)),
                            "max_abs_err": max(errs[n][0] for n in names),
                            "max_abs": max(errs[n][1] for n in names),
                            **bound}
                r = row[key]
                r["bound_share"] = r["bound_ms"] / r["ms"]
                log(f"kernel flash_bwd_{key} [{label}] B={B} H={H} Hkv={Hkv}"
                    f" S={S} D={D} {str(dt)[6:]} causal={causal} "
                    f"window={window}: max|d| {r['max_abs_err']:.3g} of "
                    f"max {r['max_abs']:.3g}; {r['ms']:.4f} ms "
                    f"({r['call_ms']:.4f} ms a call from Python), plain "
                    f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                    f"by {r['bound_by']} ({r['flops']:.4g} FLOP, "
                    f"{r['bytes']:.4g} B; share {r['bound_share']:.3f})")
            row["sdpa_ratio"] = (row["dq"]["ms"] + row["dkdv"]["ms"]) / lib_ms
            log(f"sdpa backward [{label}]: {lib_ms:.4f} ms on the device "
                f"(fwd+bwd {sdpa['fwd_bwd_ms']:.4f} minus fwd "
                f"{sdpa['fwd_ms']:.4f}, CUDA graphs; backend "
                f"{sdpa['backend']}); dq+dkdv "
                f"{row['dq']['ms'] + row['dkdv']['ms']:.4f} ms, ratio "
                f"{row['sdpa_ratio']:.2f}; both kernels bitwise equal over "
                "two launches")
            rows.append(row)
        self.results["bwd_kernel_shapes"] = rows

    # -- 4. trainer ----------------------------------------------------------------
    def train(self):
        record = self._train_run(TRAIN_ARGV, "train: llama-8b")
        self.train_launches = tuple(record["launches"].values())
        record["layer_grads"] = self._layer_grads()
        self.results["train"] = record

    def _train_run(self, argv, label) -> dict:
        """A trainer's main path on the card: ``player.run(argv)`` with
        the three launch counts set to 0 just before it and read just
        after. K1, K2 and K3 must each launch once a layer and step, and
        the losses must be finite and fall. Logs and returns the losses,
        step times, launches and peak allocation."""
        import gc

        import torch
        from tpushare_torch.kernels import flash, flash_bwd
        from tpushare_torch.workloads import model, player

        gc.collect()
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(0).total_memory
        before = torch.cuda.memory_allocated()
        log(f"{label}: memory_allocated before {before / 2**30:.2f} GiB of "
            f"{total / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()

        # -- the main path, with the launch counts read around it only --
        flash.LAUNCHES = 0
        flash_bwd.LAUNCHES_DQ = 0
        flash_bwd.LAUNCHES_DKDV = 0
        t0 = time.perf_counter()
        record = player.run(argv, return_state=True)
        main_s = time.perf_counter() - t0
        launches = (flash.LAUNCHES, flash_bwd.LAUNCHES_DQ,
                    flash_bwd.LAUNCHES_DKDV)
        # -- end of the main path --

        peak = torch.cuda.max_memory_allocated()
        n_params = sum(w.numel()
                       for w in model.param_leaves(record.pop("params")))
        del record["opt_state"]
        gc.collect()
        torch.cuda.empty_cache()

        def arg(flag):
            return argv[argv.index(flag) + 1]

        layers = model.PRESETS[arg("--preset")].n_layers
        steps, batch, seq = (int(arg(f)) for f in ("--steps", "--batch",
                                                   "--seq"))
        losses = record["losses"]
        if launches != (layers * steps,) * 3:
            raise AssertionError(
                f"{label}: launches flash_fwd/dq/dkdv {launches}, expected "
                f"{layers} layers x {steps} steps each")
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: loss did not fall: {losses}")
        step_s = statistics.median(record["step_s"][1:])
        tokens_s = batch * (seq - 1) / step_s
        log(f"{label}: {n_params:.4g} parameters, B={batch} "
            f"S={seq - 1}, {steps} AdamW steps: losses "
            + ", ".join(f"{x:.6g}" for x in losses)
            + f"; launches flash_fwd {launches[0]}, flash_bwd_dq "
            f"{launches[1]}, flash_bwd_dkdv {launches[2]} = {layers} x "
            f"{steps} each")
        log(f"{label}: step times " + ", ".join(
            f"{t * 1e3:.1f}" for t in record["step_s"])
            + f" ms; steady step {step_s * 1e3:.1f} ms = {tokens_s:.1f} "
            f"tokens/s; max_memory_allocated {peak / 2**30:.2f} GiB "
            f"({peak / 1e9:.2f} GB), {(total - peak) / 2**30:.2f} GiB of the "
            f"card left; main path {main_s:.1f} s")
        if total - peak < 4 * 2**30:
            log(f"{label}: NOTE under 4 GiB of the card left at the peak")
        return {"argv": argv, "parameters": n_params, "losses": losses,
                "step_s": record["step_s"], "steady_step_s": step_s,
                "tokens_per_s": tokens_s, "max_memory_allocated": peak,
                "total_memory": total,
                "launches": {"flash_fwd": launches[0],
                             "flash_bwd_dq": launches[1],
                             "flash_bwd_dkdv": launches[2]},
                "main_path_s": main_s}

    def _layer_grads(self) -> dict:
        """One llama-8b-width decoder layer: flash and einsum parameter
        gradients of the same scalar on the same input."""
        import dataclasses

        import torch
        from tpushare_torch.workloads import model

        cfg = dataclasses.replace(model.PRESETS["llama-8b"], n_layers=1)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(2)
        lp = model.train_params(model.init_params(cfg, gen))["layers"][0]
        S = 1023
        x = torch.randn(1, S, cfg.d_model, generator=gen, device=dev).to(
            cfg.dtype)
        proj = torch.randn(1, S, cfg.d_model, generator=gen, device=dev)
        positions = torch.arange(S, device=dev)[None]
        names = list(lp)
        grads = {}
        for attn in ("flash", "einsum"):
            out, _ = model.decoder_layer(
                x, lp, positions, dataclasses.replace(cfg, attn=attn))
            loss = (out.float() * proj).sum()
            grads[attn] = torch.autograd.grad(loss, [lp[n] for n in names])
        worst = {}
        for name, gf, ge in zip(names, grads["flash"], grads["einsum"]):
            err = (gf.float() - ge.float()).abs().max().item()
            scale = ge.float().abs().max().item()
            if not (math.isfinite(err) and err <= LAYER_GRAD_REL * scale):
                raise AssertionError(
                    f"layer grads: {name} flash vs einsum max|d| {err:.3g} "
                    f"> {LAYER_GRAD_REL} x max|g| {scale:.3g}")
            worst[name] = {"max_abs_diff": err, "max_abs": scale}
        rel = max(w["max_abs_diff"] / w["max_abs"] for w in worst.values())
        log(f"train: one llama-8b-width layer (S={S}), flash vs einsum "
            f"parameter gradients: worst max|d| / max|g| {rel:.4f} (limit "
            f"{LAYER_GRAD_REL}) over {', '.join(names)}")
        return worst

    # -- 5. mixture of experts -----------------------------------------------
    def moe(self):
        with moe_presets() as mixtral:
            record = {
                "train": self._train_run(
                    MOE_TRAIN_ARGV, f"moe train: Mixtral-8x7B widths, "
                    f"{MOE_LAYERS} layers, capacity factor "
                    f"{mixtral.moe_capacity_factor}"),
                "layer": self._moe_layer(mixtral),
                "serve": self._moe_serve()}
            failures = record["serve"]["token_check"]["failures"]
            if failures:
                raise AssertionError("moe serve: " + "; ".join(failures))
            record["tiny_train"] = self._train_run(
                MOE_TINY_ARGV, "moe tiny: llama-moe-tiny (head_dim 16)")
        self.moe_launches = {
            "moe_train": record["train"]["launches"],
            "moe_serve": {"flash_fwd": record["serve"]["launches"],
                          "kv_decode": record["serve"]["kv_decode_launches"]},
            "moe_tiny_train": record["tiny_train"]["launches"]}
        self.results["moe"] = record

    def _moe_layer(self, cfg) -> dict:
        """One Mixtral-width MoE layer in bf16: ``moe_ffn`` against the
        dense ``moe_ffn_reference`` at T = 512 and capacity factor E/k
        (nothing drops), ``expert_load``, then ``moe_ffn``'s forward timed
        at the train run's T = 1023 and capacity factor 2.0."""
        import dataclasses

        import torch
        from tpushare_torch.workloads import moe

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(4)
        mcfg = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
        params = moe.init_moe_params(mcfg, gen)
        E, d, f, k = mcfg.n_experts, mcfg.d_model, mcfg.d_ff, mcfg.top_k

        def routed(x, c):
            """Assignments kept by the routing of ``x`` under ``c``."""
            logits = x.float() @ params["wg"]
            return int(moe._route(logits, k, c.capacity(x.shape[0]))[0]
                       .sum())

        with torch.inference_mode():
            x = torch.randn(512, d, generator=gen, device=dev).to(mcfg.dtype)
            y, aux = moe.moe_ffn(params, x, mcfg)
            ref = moe.moe_ffn_reference(params, x, mcfg)
            load = moe.expert_load(params, x, mcfg)
            kept = routed(x, mcfg)
        torch.cuda.synchronize()
        if y.shape != x.shape or not torch.isfinite(y).all():
            raise AssertionError("moe layer: wrong shape or non-finite")
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if kept != 512 * k:
            raise AssertionError(f"moe layer: {kept} of {512 * k} "
                                 "assignments kept at capacity factor E/k")
        if int(load.sum()) != 512:
            raise AssertionError(f"moe layer: expert_load {load.tolist()} "
                                 "does not sum to 512")
        if not err <= MOE_LAYER_REL * scale:
            raise AssertionError(
                f"moe layer: moe_ffn vs moe_ffn_reference max|d| {err:.4g}"
                f" > {MOE_LAYER_REL} x max|y| {scale:.4g}")
        log(f"moe layer: Mixtral-width layer, T=512, capacity factor "
            f"{mcfg.capacity_factor} ({kept} of {512 * k} assignments kept):"
            f" moe_ffn vs moe_ffn_reference max|d| {err:.4g} of max|y| "
            f"{scale:.4g} (limit {MOE_LAYER_REL} x); aux {aux.item():.4f};"
            f" expert_load {load.tolist()}")

        tcfg = dataclasses.replace(mcfg, capacity_factor=2.0)
        T = 1023
        C = tcfg.capacity(T)
        with torch.inference_mode():
            x = torch.randn(T, d, generator=gen, device=dev).to(mcfg.dtype)
            kept = routed(x, tcfg)

            def packed():
                return moe.moe_ffn(params, x, tcfg)

            def dense():
                return moe.moe_ffn_reference(params, x, tcfg)

            ms = time_ms(packed, 5)
            host_ms = call_ms(packed, 10)
            plain_ms = time_ms(dense, 3)
        # the least time: every expert weight read once, x read and y
        # written once; the operations are the router product and three
        # expert products over the E*C slots moe_ffn computes (padded
        # slots included) or over the assignments this input keeps
        item = 2
        nbytes = 3 * E * d * f * item + d * E * 4 + 2 * T * d * item
        router = 2 * T * d * E
        padded = roofline(router + 3 * 2 * E * C * d * f, nbytes,
                          torch.bfloat16)
        needed = roofline(router + 3 * 2 * kept * d * f, nbytes,
                          torch.bfloat16)
        log(f"moe layer: moe_ffn forward, T={T}, capacity factor 2.0 "
            f"(C={C}, E*C={E * C} slots, {kept} of {T * k} assignments "
            f"kept): {ms:.4f} ms on the device ({host_ms:.4f} ms a call "
            f"from Python), the dense moe_ffn_reference {plain_ms:.4f} ms; "
            f"bound {padded['bound_ms']:.4f} ms by {padded['bound_by']} "
            f"over the slots ({padded['flops']:.4g} FLOP, "
            f"{nbytes:.4g} B; share {padded['bound_ms'] / ms:.3f}), "
            f"{needed['bound_ms']:.4f} ms by {needed['bound_by']} over the "
            f"kept assignments (share {needed['bound_ms'] / ms:.3f})")
        return {"max_abs_diff": err, "max_abs": scale, "tol_rel":
                MOE_LAYER_REL, "expert_load": load.tolist(),
                "timed": {"T": T, "capacity": C, "kept": kept, "ms": ms,
                          "call_ms": host_ms, "plain_ms": plain_ms,
                          "bound_slots": padded, "bound_kept": needed}}

    def _moe_serve(self) -> dict:
        """The Mixtral-width int8 replica without ``--engine``: HTTP
        requests through ``greedy_decode_kv``, every prefill through K1
        and every decode step's layers through ``kv_decode``, the tokens
        against an uncached einsum forward."""
        import dataclasses
        import gc

        import torch
        from tpushare_torch.kernels import flash, kv_decode
        from tpushare_torch.workloads import model, serve

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        httpd, front = serve.build_server(MOE_SERVE_ARGV)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if front is not None:
            raise AssertionError("moe serve: an engine without --engine")
        cfg = dataclasses.replace(model.PRESETS[MOE_DROPLESS_PRESET],
                                  kv_cache_dtype="int8")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        rng = torch.Generator().manual_seed(8)

        def prompts(B, S):
            return torch.randint(0, cfg.vocab, (B, S),
                                 generator=rng).tolist()

        # the first request meets the cold caches (cuBLAS, the allocator),
        # so the time to first token is read from the second
        first, warm, long = (prompts(B, S) for B, S in MOE_SERVE_PREFILLS)
        requests = [(warm, 16), (first, 1), (first, 32), (long, 16)]
        answers, times = {}, []
        try:
            # -- the main path, with the launch counts read around it only --
            flash.LAUNCHES = kv_decode.LAUNCHES = 0
            t_main = time.perf_counter()
            for i, (batch, steps) in enumerate(requests):
                t0 = time.perf_counter()
                rows = post(url, {"tokens": batch, "steps": steps})
                times.append(time.perf_counter() - t0)
                check_rows(batch, rows, steps, cfg.vocab)
                answers[i] = (batch, rows)
            main_s = time.perf_counter() - t_main
            launches, kv_launches = flash.LAUNCHES, kv_decode.LAUNCHES
            # -- end of the main path --
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        mem = torch.cuda.max_memory_allocated()
        del httpd
        gc.collect()
        torch.cuda.empty_cache()
        expect = cfg.n_layers * len(requests)
        if launches != expect:
            raise AssertionError(f"moe serve: flash_fwd launches {launches}"
                                 f" != {cfg.n_layers} layers x "
                                 f"{len(requests)} prefills = {expect}")
        # greedy_decode_kv: one prefill, then steps - 1 decode steps
        steps = sum(n - 1 for _, n in requests)
        if kv_launches != cfg.n_layers * steps:
            raise AssertionError(f"moe serve: kv_decode launches "
                                 f"{kv_launches} != {cfg.n_layers} layers x "
                                 f"{steps} decode steps")
        ttft, decode_rate = times[1], 31 / (times[2] - times[1])
        # the replica's weights again, from the same seed
        with torch.inference_mode():
            params = model.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                int8=True)
        check = moe_token_check(params, dataclasses.replace(
            cfg, attn="flash"), answers)
        del params
        log(f"moe serve: Mixtral-width int8 replica (capacity factor "
            f"{cfg.moe_capacity_factor}, no engine) built in {build_s:.1f} "
            f"s; {len(requests)} requests, flash_fwd launches {launches} = "
            f"{cfg.n_layers} x {len(requests)} prefills, kv_decode launches "
            f"{kv_launches} = {cfg.n_layers} x {steps} decode steps; "
            f"greedy_decode_kv "
            f"again gives the served tokens bitwise: "
            f"{check['bitwise_served']}; layer 0's router logits"
            f" within {check['router0_max_abs_diff']:.4f} of the uncached "
            f"einsum forward's (limit {MOE_ROUTER0_TOL}); of "
            f"{check['positions']} generated positions {check['flipped']} "
            f"routed otherwise in some layer (limit {MOE_FLIP_SHARE} of "
            f"them), and where every layer routed alike the served tokens "
            f"are within {check['worst_gap_alike']:.3f} of its top logit "
            f"(limit {SERVE_MARGIN}; {check['worst_gap_flipped']:.3f} "
            "where one flipped)")
        log(f"moe serve: the first request (3 x 128 + 16 tokens) "
            f"{times[0]:.3f} s; prompt 100: time to first token "
            f"{ttft * 1e3:.1f} ms (a request of one token), 32 tokens in "
            f"{times[2] * 1e3:.1f} ms = {decode_rate:.1f} decode tokens/s; "
            f"450 + 16 tokens {times[3]:.3f} s; max_memory_allocated "
            f"{mem / 2**30:.2f} GiB; main path {main_s:.1f} s")
        return {"argv": MOE_SERVE_ARGV, "requests": len(requests),
                "launches": launches, "kv_decode_launches": kv_launches,
                "decode_steps": steps, "request_s": times,
                "ttft_ms": ttft * 1e3, "decode_tokens_per_s": decode_rate,
                "token_check": check, "build_s": build_s,
                "max_memory_allocated": mem, "main_path_s": main_s}

    # -- 6. serving replica ------------------------------------------------------
    def serve(self):
        import torch
        from tpushare_torch.kernels import flash
        from tpushare_torch.workloads import serve

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        httpd, front = serve.build_server(SERVE_ARGV)
        torch.cuda.synchronize()
        self.build_peak = torch.cuda.max_memory_allocated()
        log(f"serve: llama-8b int8 replica built in "
            f"{time.perf_counter() - t0:.1f} s (peak allocated "
            f"{self.build_peak / 2**30:.2f} GiB while quantising)")
        torch.cuda.reset_peak_memory_stats()
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            self._drive(url, front, flash)
        finally:
            httpd.shutdown()
            httpd.server_close()
            front.stop()
            front.join(timeout=30)
            thread.join(timeout=30)

    def _drive(self, url, front, flash):
        import torch
        from tpushare_torch.kernels import kv_decode
        cfg = front.engine.cfg
        steps = [0]
        decode = front.engine.decode_quantum

        def counted(k):
            steps[0] += k
            return decode(k)

        front.engine.decode_quantum = counted

        def reset():
            flash.LAUNCHES = kv_decode.LAUNCHES = steps[0] = 0

        traffic = engine_traffic(url, cfg.vocab, reset,
                                 lambda: (flash.LAUNCHES, kv_decode.LAUNCHES,
                                          steps[0]))
        launches, kv_launches, steps = traffic["counts"]
        if kv_launches != cfg.n_layers * steps:
            raise AssertionError(f"kv_decode launches {kv_launches} != "
                                 f"{cfg.n_layers} layers x {steps} decode "
                                 f"steps = {cfg.n_layers * steps}")
        self.kv_launches = kv_launches
        log(f"serve: {steps} decode steps, kv_decode launches "
            f"{kv_launches} = {cfg.n_layers} x {steps}")
        if not traffic["cotenant_equal"]:
            raise AssertionError("co-tenant invariance: the solo request's "
                                 "tokens changed beside co-tenants")
        prefills = traffic["requests"]
        expect = cfg.n_layers * prefills
        if launches != expect:
            raise AssertionError(f"flash_fwd launches {launches} != "
                                 f"{cfg.n_layers} layers x {prefills} "
                                 f"prefills = {expect}")
        self.launches = launches
        log(f"serve: {prefills} requests, flash_fwd launches {launches} "
            f"= {cfg.n_layers} x {prefills} prefills; co-tenant invariance "
            "bitwise")
        log(f"serve: one stream (prompt 100, 32 tokens): time to first "
            f"token {traffic['ttft_s'] * 1e3:.1f} ms, then "
            f"{traffic['stream_decode_tokens_per_s']:.1f} decode tokens/s; "
            f"4 co-resident requests (32 tokens each): "
            f"{traffic['four_requests_tokens_per_s']:.1f} tokens/s over "
            f"{traffic['together_s']:.3f} s, their prefills included; "
            f"ragged batch of 3: {traffic['batch_s']:.3f} s")
        margin = self._check_tokens(front.engine.params, cfg,
                                    traffic["answers"])
        if margin > SERVE_MARGIN:
            raise AssertionError(f"served token {margin:.3f} below the "
                                 f"reference top logit (limit "
                                 f"{SERVE_MARGIN})")
        mem = torch.cuda.max_memory_allocated()
        log(f"serve: served tokens within {margin:.3f} of the uncached "
            f"einsum forward's top logit (limit {SERVE_MARGIN}); "
            f"max_memory_allocated {mem / 2**30:.2f} GiB; main path "
            f"{traffic['main_s']:.1f} s")
        metrics = urllib.request.urlopen(url + "/metrics", timeout=30).read()
        if b"tpushare_serve_tokens_generated_total" not in metrics:
            raise AssertionError("/metrics lacks the token counter")
        graph = decode_graph(front.engine.params, cfg)
        self.results["serve"] = {
            "requests": prefills, "launches": launches,
            "kv_decode_launches": kv_launches, "decode_steps": steps,
            "decode_graph": graph,
            "ttft_ms": traffic["ttft_s"] * 1e3,
            "stream_s": traffic["stream_s"],
            "stream_decode_tokens_per_s":
                traffic["stream_decode_tokens_per_s"],
            "four_requests_tokens_per_s":
                traffic["four_requests_tokens_per_s"],
            "batch_s": traffic["batch_s"],
            "max_memory_allocated": mem, "build_peak": self.build_peak,
            "token_margin": margin,
            "main_path_s": traffic["main_s"]}

    def _check_tokens(self, params, cfg, answers) -> float:
        """Each served greedy token against an uncached einsum forward
        over the served sequence: returns the worst gap between the
        reference logit of the served token and the reference maximum
        (the caller holds it to ``SERVE_MARGIN``)."""
        import dataclasses

        import torch
        from tpushare_torch.workloads.model import forward
        cfg = dataclasses.replace(cfg, attn="einsum")
        worst = 0.0
        with torch.inference_mode():
            for prompts, rows in answers.values():
                for p, row in zip(prompts, rows):
                    seq = torch.tensor([row], device="cuda")
                    logits = forward(params, seq[:, :-1], cfg)[0]
                    if not torch.isfinite(logits).all():
                        raise AssertionError("non-finite reference logits")
                    gen = seq[0, len(p):]
                    ref = logits[len(p) - 1:]
                    gap = ref.max(dim=-1).values - ref.gather(
                        1, gen[:, None])[:, 0]
                    worst = max(worst, gap.max().item())
        return worst

    # -- 6b. data, tensor and expert parallelism ------------------------------
    def shard(self):
        import torch
        from tpushare_torch.workloads import parallel
        log(f"shard: transport for {SHARD_TP} ranks on this card: "
            f"{parallel.transport('cuda', SHARD_TP)} "
            f"({torch.cuda.device_count()} card(s) visible)")
        record = {"transport": parallel.transport("cuda", SHARD_TP),
                  "serve": self._shard_serve(),
                  "train": self._shard_train(),
                  "moe": self._shard_moe()}
        self.shard_launches = {
            "shard_serve": {"flash_fwd": record["serve"]["launches"],
                            "kv_decode": min(record["serve"][
                                "kv_decode_launches_per_rank"])},
            "shard_decode": {"flash_fwd":
                             record["serve"]["decode"]["launches"],
                             "kv_decode": min(record["serve"]["decode"][
                                 "kv_decode_launches_per_rank"])},
            "shard_train": record["train"]["launches"],
            "shard_resume": record["train"]["resume_launches"]}
        self.results["shard"] = record

    def _shard_serve(self, plant: str | None = None) -> dict:
        """Sample 5's replica as deployed, with its engine: ``serve --tp 4
        --engine`` in a child process (rank 0, which starts ranks 1-3)
        under the sample's grant, serving the serve phase's traffic
        (:func:`engine_traffic`), then from the same ranks the replica's
        path without its engine, ``SHARD_PROMPTS`` each alone. Here:
        every token of both against the tp=1 replica's uncached einsum
        forward on the same seeded weights, co-tenant invariance, each
        rank's K1 and kv_decode launches on each path and its peak, and
        the first-token logits of ``SHARD_PROMPTS`` against the tp=1
        replica's. With ``plant`` (:data:`SHARD_ENGINE_PLANTS`, planted
        in rank 1) returns what the checks refused instead of raising."""
        import dataclasses
        import gc
        import tempfile

        import torch
        from tpushare_torch.workloads import model

        cfg = dataclasses.replace(model.PRESETS["llama-8b"], attn="flash",
                                  kv_cache_dtype="int8")
        rng = torch.Generator().manual_seed(9)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
                   for n in SHARD_PROMPTS]
        total_mib = torch.cuda.get_device_properties(0).total_memory // 2**20
        env = dict(os.environ, TPUSHARE_HBM_LIMIT_MIB=str(SHARD_GRANT_MIB),
                   TPUSHARE_HBM_CHIP_TOTAL_MIB=str(total_mib))
        (ROOT / "build").mkdir(exist_ok=True)
        logits_path = Path(tempfile.mkdtemp(prefix="shard-", dir=ROOT /
                                            "build")) / "logits.pt"
        # -- the main paths: the child resets every rank's launch count
        # to 0 just before each path's traffic and reads them just
        # after --
        out = run_child_cmd(["--serve-child", json.dumps(
            {"argv": SHARD_SERVE_ARGV, "prompts": prompts,
             "vocab": cfg.vocab, "logits": str(logits_path),
             "plant": plant})], env)
        # -- end of the main paths --
        record = {"argv": SHARD_SERVE_ARGV, "grant_mib": SHARD_GRANT_MIB,
                  "build_s": out["build_s"], "transport": out["transport"]}
        if "refused" in out:
            record["failures"] = [f"the replica failed its traffic: "
                                  f"{out['refused']}"]
            log(f"shard serve: {record['failures'][0]}")
            return record
        traffic, decode = out["traffic"], out["decode"]
        failures = []
        got = torch.load(logits_path).cuda()
        logits_path.unlink()
        grant = SHARD_GRANT_MIB * 2**20
        launches = [s["flash_fwd"] for s in traffic["counts"]]
        decode_launches = [s["flash_fwd"] for s in decode["counts"]]
        kv_launches = [s["kv_decode"] for s in traffic["counts"]]
        decode_kv_launches = [s["kv_decode"] for s in decode["counts"]]
        # the engine's quanta, and greedy_decode_kv's steps - 1 a prompt
        engine_steps = out["engine_decode_steps"]
        decode_steps = (SHARD_DECODE_STEPS - 1) * len(prompts)
        peaks = [max(b["max_memory_allocated"], s["max_memory_allocated"],
                     d["max_memory_allocated"])
                 for b, s, d in zip(out["built_stats"], traffic["counts"],
                                    decode["counts"])]
        for path, counts, prefills in (("engine", launches,
                                        traffic["requests"]),
                                       ("decode", decode_launches,
                                        len(prompts))):
            for r, n in enumerate(counts):
                if n != cfg.n_layers * prefills:
                    failures.append(f"{path} path: rank {r} flash_fwd "
                                    f"launches {n} != {cfg.n_layers} "
                                    f"layers x {prefills} prefills")
        for path, counts, steps in (("engine", kv_launches, engine_steps),
                                    ("decode", decode_kv_launches,
                                     decode_steps)):
            for r, n in enumerate(counts):
                if n != cfg.n_layers * steps:
                    failures.append(f"{path} path: rank {r} kv_decode "
                                    f"launches {n} != {cfg.n_layers} "
                                    f"layers x {steps} decode steps")
        for p, row in zip(prompts, decode["rows"]):
            check_rows([p], [row], SHARD_DECODE_STEPS, cfg.vocab)
        for r, peak in enumerate(peaks):
            if peak > grant:
                failures.append(f"rank {r} peak {peak} B over the "
                                f"{SHARD_GRANT_MIB} MiB grant")
        if not traffic["cotenant_equal"]:
            failures.append("co-tenant invariance: the solo request's "
                            "tokens changed beside co-tenants")
        # the tp=1 replica of the same seed, here, without a grant
        with torch.inference_mode():
            params = model.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                int8=True)
            want = []
            for p in prompts:
                tokens = torch.tensor([p], device="cuda")
                cache = model.init_kv_cache(cfg, 1, len(p) + 1,
                                            device="cuda")
                logits, _ = model.forward_cached(params, tokens, cache, 0,
                                                 cfg, prefill_from_zero=True)
                want.append(logits[:, -1])
            want = torch.cat(want)
        err = (got - want).abs().max().item()
        spread = want.abs().max().item()
        answers = {k: tuple(v) for k, v in traffic["answers"].items()}
        margin = self._check_tokens(params, cfg, answers)
        decode_margin = self._check_tokens(
            params, cfg, {"decode": (prompts, decode["rows"])})
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if not err <= SHARD_LOGIT_TOL:
            failures.append(f"first-token logits tp=4 vs tp=1 max|d| "
                            f"{err:.4g} > {SHARD_LOGIT_TOL}")
        for path, gap in (("engine", margin), ("decode", decode_margin)):
            if not gap <= SERVE_MARGIN:
                failures.append(f"{path} path: served token {gap:.3f} below"
                                f" the tp=1 reference's top logit (limit "
                                f"{SERVE_MARGIN})")
        decode_rate = (SHARD_DECODE_STEPS - 1) / max(
            decode["request_s"][-1] - decode["prefill_s"][-1], 1e-9)
        log(f"shard serve: llama-8b int8 replica --tp {SHARD_TP} --engine "
            f"(8 slots, max_len 512), four ranks on this card under "
            f"{SHARD_GRANT_MIB} MiB each, built in {out['build_s']:.1f} s; "
            f"{traffic['requests']} requests (the serve phase's traffic) in "
            f"{traffic['main_s']:.1f} s: one stream's time to first token "
            f"{traffic['ttft_s'] * 1e3:.1f} ms, then "
            f"{traffic['stream_decode_tokens_per_s']:.2f} decode tokens/s; "
            "4 co-resident requests "
            f"{traffic['four_requests_tokens_per_s']:.2f} tokens/s over "
            f"{traffic['together_s']:.2f} s; co-tenant invariance "
            f"{traffic['cotenant_equal']}; flash_fwd launches "
            "per rank " + ", ".join(map(str, launches))
            + f" = {cfg.n_layers} x {traffic['requests']} prefills; "
            "kv_decode launches per rank " + ", ".join(map(str, kv_launches))
            + f" = {cfg.n_layers} x {engine_steps} decode steps; peak "
            "allocated per rank " + ", ".join(f"{p / 2**30:.2f}"
                                              for p in peaks) + " GiB")
        log(f"shard serve: the same ranks without the engine "
            f"(TPReplica.decode): prompts "
            f"{', '.join(map(str, SHARD_PROMPTS))}, each alone for "
            f"{SHARD_DECODE_STEPS} tokens, in " + ", ".join(
                f"{t:.3f}" for t in decode["request_s"])
            + " s (a prefill alone: " + ", ".join(
                f"{t * 1e3:.1f}" for t in decode["prefill_s"])
            + f" ms), {decode_rate:.2f} decode tokens/s at the 450 prompt; "
            "flash_fwd launches per rank "
            + ", ".join(map(str, decode_launches))
            + f" = {cfg.n_layers} x {len(prompts)} prefills; kv_decode "
            "launches per rank " + ", ".join(map(str, decode_kv_launches))
            + f" = {cfg.n_layers} x {decode_steps} decode steps")
        log(f"shard serve: first-token logits tp=4 vs tp=1 max|d| {err:.4g} "
            f"of max|logit| {spread:.3g} (limit {SHARD_LOGIT_TOL}); served "
            f"tokens within {margin:.3f} (engine) and {decode_margin:.3f} "
            f"(without it) of the tp=1 uncached einsum forward's top logit "
            f"(limit {SERVE_MARGIN})")
        record.update({
            "prompts": list(SHARD_PROMPTS), "requests": traffic["requests"],
            "launches": min(launches), "launches_per_rank": launches,
            "kv_decode_launches_per_rank": kv_launches,
            "decode_steps": engine_steps,
            "peak_per_rank": peaks, "ttft_ms": traffic["ttft_s"] * 1e3,
            "stream_decode_tokens_per_s":
                traffic["stream_decode_tokens_per_s"],
            "four_requests_tokens_per_s":
                traffic["four_requests_tokens_per_s"],
            "batch_s": traffic["batch_s"], "main_path_s": traffic["main_s"],
            "cotenant_equal": traffic["cotenant_equal"],
            "first_token_logits_max_abs_diff": err, "token_margin": margin,
            "decode": {"steps": SHARD_DECODE_STEPS,
                       "launches": min(decode_launches),
                       "launches_per_rank": decode_launches,
                       "kv_decode_launches_per_rank": decode_kv_launches,
                       "request_s": decode["request_s"],
                       "prefill_s": decode["prefill_s"],
                       "decode_tokens_per_s_450": decode_rate,
                       "token_margin": decode_margin},
            "failures": failures})
        if failures and plant is None:
            raise AssertionError("shard serve: " + "; ".join(failures))
        return record

    def _shard_train(self, plant: str | None = None) -> dict:
        """The trainer on dp=2 x tp=2, then restored onto (1, 4), against
        the one-process trainer's losses and its parameters after steps
        1 and 3. With ``plant`` (:data:`SHARD_PLANTS`) only the first run,
        with that fault in every rank, and the failures are returned."""
        import gc
        import shutil
        import tempfile

        import torch
        from tpushare_torch.workloads import parallel

        (ROOT / "build").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="shard-train-", dir=ROOT /
                                     "build"))
        ref_path = work / "ref.pt"
        second = None
        try:
            ref = shard_trainer(shard_config(), None, 3, snaps=(1, 3))
            torch.save(ref.pop("snap"), ref_path)
            gc.collect()
            torch.cuda.empty_cache()
            ckpt = str(work / "ckpt")
            # -- the main path: each rank sets its launch counts to 0 just
            # before resume_or_init and reads them after its last step --
            first = parallel.run_ranks(
                shard_train_rank, SHARD_TP, (2, SHARD_TP // 2), ckpt,
                str(ref_path), plant, device_type="cuda", timeout=900)
            if plant is None:
                second = parallel.run_ranks(
                    shard_train_rank, SHARD_TP, (1, SHARD_TP), ckpt,
                    str(ref_path), None, device_type="cuda", timeout=900)
            # -- end of the main path --
        finally:
            shutil.rmtree(work, ignore_errors=True)
        readings, failures = shard_train_judge(first, second, ref["losses"])
        if plant is not None:
            return {"readings": readings, "failures": failures}
        want = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"),
                             SHARD_LAYERS * 3)
        for r, run in enumerate(first):
            if run["launches"] != want:
                failures.append(f"rank {r} launches {run['launches']}, "
                                f"expected {want}")
        for r, run in enumerate(second):
            if run["start"] != 2 or len(run["losses"]) != 1:
                failures.append(f"resumed rank {r} started at step "
                                f"{run['start']} and ran "
                                f"{len(run['losses'])} steps")
            if set(run["launches"].values()) != {SHARD_LAYERS}:
                failures.append(f"resumed rank {r} launches "
                                f"{run['launches']}")
        log(f"shard train: held against the one-process trainer: {readings}")
        if failures:
            raise AssertionError("shard train: " + "; ".join(failures))
        losses = first[0]["losses"]
        step_s = statistics.median(first[0]["step_s"][1:])
        log(f"shard train: llama-8b widths at {SHARD_LAYERS} layers, "
            f"B={SHARD_BATCH} S={SHARD_SEQ - 1} (seeded random tokens), "
            f"dp=2 x tp=2 over {SHARD_TP} ranks: losses "
            + ", ".join(f"{x:.6g}" for x in losses) + "; one process: "
            + ", ".join(f"{x:.6g}" for x in ref["losses"])
            + "; step times " + ", ".join(f"{t * 1e3:.1f}"
                                          for t in first[0]["step_s"])
            + " ms (one process " + ", ".join(
                f"{t * 1e3:.1f}" for t in ref["step_s"]) + " ms); "
            f"the step-2 save {first[0]['save_s'][0]:.2f} s; launches per "
            "rank " + "; ".join(", ".join(str(v) for v in run["launches"]
                                          .values()) for run in first)
            + f" (K1, K2, K3 = {SHARD_LAYERS} x 3); peak allocated per rank "
            + ", ".join(f"{run['peak'] / 2**30:.2f}" for run in first)
            + " GiB")
        log(f"shard train: restored onto (1, 4) in {second[0]['resume_s']:.2f}"
            f" s, step 3 loss {second[0]['losses'][0]:.6g}; launches per rank "
            + "; ".join(", ".join(str(v) for v in run["launches"].values())
                        for run in second)
            + f"; losses max|d| {readings['loss_max_abs_diff']:.4g} (limit "
            f"{SHARD_LOSS_TOL}); parameters max|d| after step 1 "
            f"{readings['max_abs_diff'][1]:.4g} (limit "
            f"{SHARD_STEP_TOL[1]:.4g}), after step 3 "
            f"{readings['max_abs_diff'][3]:.4g} (limit "
            f"{SHARD_STEP_TOL[3]:.4g}); worst leaf's mean |d| "
            f"{readings['worst_mean_lr'][1]:.4g} lr after step 1, "
            f"{readings['worst_mean_lr'][3]:.4g} lr after step 3 (limit "
            f"{SHARD_MEAN_TOL} lr)")
        return {"batch": SHARD_BATCH, "seq": SHARD_SEQ, "losses": losses,
                "resumed_loss": second[0]["losses"][0],
                "reference_losses": ref["losses"],
                "reference_step_s": ref["step_s"],
                "step_s": first[0]["step_s"], "steady_step_s": step_s,
                "save_s": first[0]["save_s"],
                "resume_s": second[0]["resume_s"],
                "peak_per_rank": [run["peak"] for run in first],
                **readings,
                "launches": first[0]["launches"],
                "resume_launches": second[0]["launches"]}

    def _shard_moe(self) -> dict:
        """One Mixtral-width MoE layer at ep=2 (two ranks), forward and
        backward at T=1023, against the one-process ``moe_ffn``."""
        from tpushare_torch.workloads import parallel
        runs = parallel.run_ranks(shard_moe_rank, 2, SHARD_MOE_T,
                                  device_type="cuda", timeout=600)
        worst = max(e / m for run in runs
                    for e, m in run["errors"].values())
        if not worst <= MOE_LAYER_REL:
            raise AssertionError(f"shard moe: ep=2 vs one process "
                                 f"{runs[0]['errors']} (limit "
                                 f"{MOE_LAYER_REL} x max)")
        r0 = runs[0]
        log(f"shard moe: one Mixtral-width layer at ep=2, T={SHARD_MOE_T}, "
            f"forward and backward: y, aux and every gradient within "
            f"{worst:.4g} of the one-process moe_ffn's largest magnitude "
            f"(limit {MOE_LAYER_REL}); {r0['ep_ms']:.3f} ms at ep=2 (rank 0, "
            f"CUDA events) against {r0['one_ms']:.3f} ms in one process")
        return {"T": SHARD_MOE_T, "worst_rel": worst, "errors": r0["errors"],
                "ep_ms": r0["ep_ms"], "one_ms": r0["one_ms"]}

    # -- 6c. seq -----------------------------------------------------------
    def seq(self):
        """Sequence and pipeline parallelism, four ranks sharing the card
        over gloo: what gloo carries for CUDA tensors; then one world of
        four ranks for (a) ``player --sp ring`` at S = 32768, (c) Ulysses
        and (d) the pipeline, after the pipeline's one-process reference;
        then (b) two ``--multihost`` gang members."""
        import torch
        from tpushare_torch.workloads import parallel
        probes = gloo_probes()
        log("seq: gloo with CUDA tensors between two ranks on this card: "
            + "; ".join(f"{op} {res}" for op, res in probes.items()))
        transport = parallel.transport("cuda", SEQ_RANKS)
        log(f"seq: transport for {SEQ_RANKS} ranks: {transport} "
            f"({torch.cuda.device_count()} card(s) visible)")
        world, ref = self._seq_world(("ring", "ring_grad", "ulysses",
                                      "pipeline"))
        failures = []
        ring = self._seq_ring([r["ring"] for r in world], failures)
        ring_grad = self._seq_ring_grad([r["ring_grad"] for r in world],
                                        failures)
        uly = self._seq_ulysses([r["ulysses"] for r in world], failures)
        readings, pp_fail = seq_pipeline_judge(
            [r["pipeline"] for r in world], ref)
        failures += pp_fail
        pipe = self._seq_pipeline_log([r["pipeline"] for r in world], ref,
                                      readings)
        gang = self._seq_gang(failures)
        if failures:
            raise AssertionError("seq: " + "; ".join(failures))
        self.seq_launches = {
            "seq_ring": {"flash_fwd": ring["launches_per_rank"][-1]},
            "seq_ring_zigzag": {"flash_fwd": ring["zigzag_launches"][0]},
            "seq_ring_grad": ring_grad["runs"][-1]["contiguous"]["launches"],
            "seq_ring_grad_zigzag":
                ring_grad["runs"][0]["zigzag"]["launches"],
            "seq_ulysses": uly["launches"],
            "seq_pipeline": pipe["launches"]}
        self.results["seq"] = {"gloo_cuda": probes, "transport": transport,
                               "ring": ring, "ring_grad": ring_grad,
                               "ulysses": uly,
                               "pipeline": pipe, "gang": gang}

    def _seq_world(self, parts, plant: str | None = None):
        """The pipeline's one-process reference (with "pipeline" among
        ``parts``), then ``parts`` in one world of ``SEQ_RANKS`` ranks;
        returns (each rank's results, the reference's losses and times
        or None)."""
        import gc
        import shutil
        import tempfile

        import torch
        from tpushare_torch.workloads import parallel

        (ROOT / "build").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="seq-", dir=ROOT / "build"))
        try:
            torch.cuda.reset_peak_memory_stats()
            ref = (pp_reference(work / "ref.pt") if "pipeline" in parts
                   else None)
            gc.collect()
            torch.cuda.empty_cache()
            # -- each part resets its counts just before its main path and
            # reads them just after (seq_ring_rank, seq_ulysses_rank,
            # seq_pipeline_rank) --
            world = parallel.run_ranks(seq_rank, SEQ_RANKS, list(parts),
                                       str(work / "ref.pt"), plant,
                                       device_type="cuda", timeout=1200)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return world, ref

    def _seq_ring(self, runs, failures) -> dict:
        n = len(runs)
        for r, run in enumerate(runs):
            want = SEQ_RING_STEPS * (r + 1)
            if run["launches"] != want:
                failures.append(f"ring: rank {r} K1 launches "
                                f"{run['launches']} != {SEQ_RING_STEPS} "
                                f"steps x {r + 1} visible chunks")
            if run["zigzag_launches"] != 2 * n + 1:
                failures.append(f"ring zigzag: rank {r} K1 launches "
                                f"{run['zigzag_launches']} != {2 * n + 1}")
            if not (run["finite"] and run["world"] == n
                    and run["shape"] == [1, 32, SEQ_S // n, 128]):
                failures.append(f"ring: rank {r} output {run['shape']}, "
                                f"finite {run['finite']}, world "
                                f"{run['world']}")
            for name in ("err", "err_zigzag"):
                if not run[name] <= RING_TOL:
                    failures.append(f"ring: rank {r} {name} {run[name]:.4g}"
                                    f" against one-process K1 (limit "
                                    f"{RING_TOL})")
            for layout, f in run["fold"].items():
                if not (f["vs_plain"] <= TOL["bfloat16"]["out"]
                        and f["plain_vs_k1"] <= TOL["bfloat16"]["out"]):
                    failures.append(f"ring at S={SEQ_FOLD_S} {layout}: {f}"
                                    f" (limit {TOL['bfloat16']['out']})")
        steady = [statistics.median(run["step_s"][1:]) for run in runs]
        rate = 1 / max(steady)
        log(f"seq ring: player --sp ring, llama-8b heads (32/8 of 128), "
            f"bf16, S={SEQ_S} over {n} ranks ({SEQ_S // n} rows a rank): "
            f"{rate:.3f} ring/s (steps " + ", ".join(
                f"{t * 1e3:.1f}" for t in runs[0]["step_s"]) + " ms, rank "
            "0); K1 launches per rank " + ", ".join(
                str(run["launches"]) for run in runs)
            + f" = {SEQ_RING_STEPS} steps x r+1; against one-process K1 "
            "over the whole sequence max|d| per rank " + ", ".join(
                f"{run['err']:.3g}" for run in runs)
            + f" (limit {RING_TOL}; rank 0 bitwise: {runs[0]['bitwise']}; "
            f"max|O| {runs[0]['max_abs']:.3g}); peak allocated per rank "
            + ", ".join(f"{run['peak'] / 2**30:.2f}" for run in runs)
            + " GiB")
        log("seq ring zigzag: ring_attention(zigzag=True) on the same "
            "sequence: K1 launches per rank " + ", ".join(
                str(run["zigzag_launches"]) for run in runs)
            + f" (= 2n+1); max|d| " + ", ".join(
                f"{run['err_zigzag']:.3g}" for run in runs)
            + "; one call " + ", ".join(f"{run['zigzag_s'] * 1e3:.1f}"
                                        for run in runs) + " ms")
        def worst(key):
            return "; ".join(
                f"{k} {max(run['fold'][k][key] for run in runs):.3g}"
                for k in ("contiguous", "zigzag"))

        log(f"seq ring at S={SEQ_FOLD_S}: K1 route vs plain fold max|d| "
            + worst("vs_plain") + "; plain fold vs one-process K1 "
            + worst("plain_vs_k1"))
        return {"S": SEQ_S, "ranks": n, "ring_per_s": rate,
                "step_s": [run["step_s"] for run in runs],
                "launches_per_rank": [run["launches"] for run in runs],
                "zigzag_launches": [run["zigzag_launches"] for run in runs],
                "max_abs_diff": [run["err"] for run in runs],
                "zigzag_max_abs_diff": [run["err_zigzag"] for run in runs],
                "rank0_bitwise": runs[0]["bitwise"],
                "zigzag_s": [run["zigzag_s"] for run in runs],
                "fold": [run["fold"] for run in runs],
                "peak_per_rank": [run["peak"] for run in runs]}

    def _seq_ring_grad(self, runs, failures) -> dict:
        readings, found = seq_ring_grad_judge(runs)
        failures += found
        n = len(runs)
        for layout in ("contiguous", "zigzag"):
            log(f"seq ring backward {layout}: ring_attention forward and "
                f"backward, llama-8b heads, bf16, S={SEQ_S} over {n} ranks:"
                " K1, K2, K3 launches per rank " + "; ".join(
                    ", ".join(str(v) for v in run["runs"][layout]
                              ["launches"].values()) for run in runs)
                + " (r+1 contiguous, 2n+1 zigzag); dq, dk, dv max|d| / "
                "max|grad| against one-process flash_attention per rank "
                + "; ".join(", ".join(
                    f"{e / t:.3g}" for e, t in run["runs"][layout]["errs"]
                    .values()) for run in runs)
                + f" (limit {RING_GRAD_REL:.4g}); forward and backward "
                + ", ".join(f"{run['runs'][layout]['wall_s'] * 1e3:.1f}"
                            for run in runs) + " ms a rank, first call")
        log(f"seq ring backward: a warm call " + ", ".join(
            f"{run['warm_s'] * 1e3:.1f}" for run in runs) + " ms a rank "
            f"(host clock) against {runs[0]['one_ms']:.2f} ms in one "
            "process (CUDA events); peak allocated per rank " + ", ".join(
                f"{run['peak'] / 2**30:.2f}" for run in runs)
            + f" GiB; at S={SEQ_FOLD_S} against the fp32 fold worst max|d|"
            f" / max|grad| {readings['worst_rel']['fold']:.3g} (limit "
            f"{RING_FOLD_GRAD_REL})")
        return {"runs": [run["runs"] for run in runs],
                "warm_s": [run["warm_s"] for run in runs],
                "one_ms": runs[0]["one_ms"],
                "peak_per_rank": [run["peak"] for run in runs],
                "fold": [run["fold"] for run in runs], **readings}

    def _seq_ulysses(self, runs, failures) -> dict:
        want = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"),
                             1)
        for r, run in enumerate(runs):
            if run["launches"] != want:
                failures.append(f"ulysses: rank {r} launches "
                                f"{run['launches']}, expected {want}")
            if not all(run["bitwise"].values()):
                failures.append(f"ulysses: rank {r} not bitwise one-process "
                                f"flash_attention: {run['max_abs_diff']}")
        log(f"seq ulysses: {len(runs)} ranks, llama-8b heads (8/2 a rank), "
            f"S={SEQ_S}, window {SEQ_WINDOW}, attn=flash, forward and "
            "backward: output and dq, dk, dv bitwise one-process "
            "flash_attention on every rank: " + ", ".join(
                str(all(run["bitwise"].values())) for run in runs)
            + f"; K1, K2, K3 launches per rank "
            + "; ".join(", ".join(str(v) for v in run["launches"].values())
                        for run in runs)
            + "; forward and backward " + ", ".join(
                f"{run['wall_s'] * 1e3:.1f}" for run in runs)
            + " ms a rank, again " + ", ".join(
                f"{run['warm_s'] * 1e3:.1f}" for run in runs)
            + f" ms (host clock) against {runs[0]['one_ms']:.2f} ms in one "
            "process (CUDA events); peak allocated per rank " + ", ".join(
                f"{run['peak'] / 2**30:.2f}" for run in runs) + " GiB")
        return {"launches": runs[0]["launches"],
                "bitwise": [run["bitwise"] for run in runs],
                "max_abs_diff": [run["max_abs_diff"] for run in runs],
                "wall_s": [run["wall_s"] for run in runs],
                "warm_s": [run["warm_s"] for run in runs],
                "one_ms": runs[0]["one_ms"],
                "peak_per_rank": [run["peak"] for run in runs]}

    def _seq_pipeline_log(self, runs, ref, readings) -> dict:
        log(f"seq pipeline: llama-8b widths at {PP_LAYERS} layers, pp="
            f"{len(runs)} ({PP_LAYERS // len(runs)} layers a stage), "
            f"B={PP_BATCH} in {PP_MICROBATCHES} microbatches, S="
            f"{PP_SEQ - 1} (seeded random tokens): logits vs one process "
            "max|d| " + ", ".join(f"{run['logit_err']:.4g}" for run in runs)
            + f" (limit {PP_LOGIT_TOL}; max|logit| "
            f"{runs[0]['logit_spread']:.3g}); losses "
            + ", ".join(f"{x:.6g}" for x in runs[0]["losses"])
            + "; one process: " + ", ".join(f"{x:.6g}" for x in ref["losses"])
            + "; step times " + ", ".join(f"{t * 1e3:.1f}"
                                          for t in runs[0]["step_s"])
            + " ms (one process " + ", ".join(
                f"{t * 1e3:.1f}" for t in ref["step_s"]) + " ms); K1, K2, "
            "K3 launches per rank " + "; ".join(
                ", ".join(str(v) for v in run["launches"].values())
                for run in runs)
            + f" (= 3 steps x {PP_MICROBATCHES} microbatches x "
            f"{PP_LAYERS // len(runs)} layers); forward check "
            + ", ".join(str(run["fwd_launches"]) for run in runs)
            + "; peak allocated per rank " + ", ".join(
                f"{run['peak'] / 2**30:.2f}" for run in runs)
            + f" GiB (one process {ref['peak'] / 2**30:.2f})")
        log(f"seq pipeline: parameters max|d| after step 1 "
            f"{readings['max_abs_diff'][1]:.4g} (limit "
            f"{SHARD_STEP_TOL[1]:.4g}), after step 3 "
            f"{readings['max_abs_diff'][3]:.4g} (limit "
            f"{SHARD_STEP_TOL[3]:.4g}); worst leaf's mean |d| "
            f"{readings['worst_mean_lr'][1]:.4g} lr after step 1, "
            f"{readings['worst_mean_lr'][3]:.4g} lr after step 3 (limit "
            f"{SHARD_MEAN_TOL} lr); losses max|d| "
            f"{readings['loss_max_abs_diff']:.4g} (limit {SHARD_LOSS_TOL});"
            f" embedding, norm and head equal on every rank: "
            f"{readings['replicated_equal']}")
        return {"layers": PP_LAYERS, "stages": len(runs), "batch": PP_BATCH,
                "microbatches": PP_MICROBATCHES, "seq": PP_SEQ,
                "losses": runs[0]["losses"],
                "reference_losses": ref["losses"],
                "step_s": runs[0]["step_s"],
                "reference_step_s": ref["step_s"],
                "logit_max_abs_diff": [run["logit_err"] for run in runs],
                "launches": runs[0]["launches"],
                "fwd_launches": [run["fwd_launches"] for run in runs],
                "peak_per_rank": [run["peak"] for run in runs],
                "reference_peak": ref["peak"], **readings}

    def _seq_gang(self, failures) -> dict:
        """(b) two ``player --sp ring --multihost`` processes with the
        rendezvous env the device plugin injects, each starting one rank
        per visible card."""
        import torch
        from tpushare_torch.workloads import parallel
        local = torch.cuda.device_count()
        world = 2 * local
        addr = f"localhost:{parallel.free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpushare_torch.workloads.player",
             *SEQ_GANG_ARGV], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=dict(
                os.environ, COORDINATOR_ADDRESS=addr, NUM_PROCESSES="2",
                PROCESS_ID=str(p))) for p in range(2)]
        t0 = time.perf_counter()
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=600)
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate(timeout=30)
        wall = time.perf_counter() - t0
        lines = []
        for p, (rc, out, err) in enumerate(outs):
            # a member's local ranks share its stdout, so their lines may
            # interleave: read the reports wherever they stand
            join = re.findall(r"multihost: process (\d+) of 2, rank (\d+) of "
                              r"world (\d+), transport (gloo|nccl)", out)
            steps = re.findall(r"step 2: [\d.]+ ring/s \(S=\d+ over (\d+) "
                               r"devices\)", out)
            lines.append((join, steps))
            want = {(str(p), str(p * local + i), str(world))
                    for i in range(local)}
            if rc != 0 or {j[:3] for j in join} != want or \
                    steps != [str(world)] * local:
                failures.append(f"gang member {p} exited {rc}: "
                                f"{out[-1500:]} {err[-1500:]}")
        log(f"seq gang: two members (NUM_PROCESSES=2, PROCESS_ID=0/1, "
            f"COORDINATOR_ADDRESS={addr}), {local} rank(s) each, in "
            f"{wall:.1f} s: " + " | ".join(
                f"member {p}: ranks " + ", ".join(r for _, r, _, _ in j)
                + f" of world {world} over " + ", ".join({t for *_, t in j})
                + f"; {len(st)} finished two ring steps"
                for p, (j, st) in enumerate(lines)))
        return {"wall_s": wall, "ranks_per_member": local, "lines": lines}

    # -- 7. entry ----------------------------------------------------------------
    def entry(self):
        import torch
        from tpushare_torch.entry import entry
        with torch.inference_mode():
            fn, args = entry(device="cuda", attn="flash")
            flash_logits = fn(*args)
            fn, args = entry(device="cuda", attn="einsum")
            ein_logits = fn(*args)
        if flash_logits.shape != (2, 128, 2048):
            raise AssertionError(f"entry logits {tuple(flash_logits.shape)}")
        if not torch.isfinite(flash_logits).all():
            raise AssertionError("entry: non-finite logits")
        diff = (flash_logits - ein_logits).abs().max().item()
        scale = ein_logits.abs().max().item()
        log(f"entry: llama-mini B=2 S=128 logits flash vs einsum max|d| "
            f"{diff:.4g} (tol {ENTRY_TOL}; max|logit| {scale:.3g})")
        if diff > ENTRY_TOL:
            raise AssertionError(f"entry: flash vs einsum {diff} > "
                                 f"{ENTRY_TOL}")
        self.results["entry"] = {"max_abs_diff": diff, "max_abs": scale}

    # -- 8. ViT-B/16 tenant -------------------------------------------------------
    def vit(self):
        import shutil
        import tempfile

        import torch
        total_mib = torch.cuda.get_device_properties(0).total_memory // 2**20
        env = dict(os.environ, TPUSHARE_FLASH_FWD="pipelined",
                   TPUSHARE_HBM_LIMIT_MIB=str(VIT_GRANT_MIB),
                   TPUSHARE_HBM_CHIP_TOTAL_MIB=str(total_mib))
        (ROOT / "build").mkdir(exist_ok=True)
        ckpt_dir = tempfile.mkdtemp(prefix="vit-ckpt-", dir=ROOT / "build")
        train = [*VIT_ARGV, "--mode", "train", "--steps", str(VIT_STEPS),
                 "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]
        try:
            # -- the main path: each child resets the launch counts to 0
            # just before player.run and reads them just after --
            whole = run_child(train, env)
            resumed = run_child(train, env)
            fwd = run_child([*VIT_ARGV, "--mode", "forward", "--steps",
                             str(VIT_STEPS)], env)
            # -- end of the main path --
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        grant = VIT_GRANT_MIB * 2**20

        def expect(run, name, steps, fwd_launches, bwd_launches):
            got = run["launches"]
            want = {"flash_fwd": 0, "flash_fwd_pipelined": fwd_launches,
                    "flash_bwd_dq": bwd_launches,
                    "flash_bwd_dkdv": bwd_launches}
            if got != want:
                raise AssertionError(f"vit {name}: launches {got}, expected "
                                     f"{want} ({VIT_LAYERS} layers x {steps}"
                                     " steps)")
            if run["max_memory_allocated"] > grant:
                raise AssertionError(
                    f"vit {name}: peak {run['max_memory_allocated']} B over "
                    f"the {VIT_GRANT_MIB} MiB grant")
            if not all(math.isfinite(x) for x in run["losses"]):
                raise AssertionError(f"vit {name}: losses {run['losses']}")

        per_step = VIT_LAYERS
        expect(whole, "train", VIT_STEPS, per_step * VIT_STEPS,
               per_step * VIT_STEPS)
        if resumed["start_step"] != 2 or resumed["steps"] != VIT_STEPS:
            raise AssertionError(f"vit resume: started at "
                                 f"{resumed['start_step']}, ended at "
                                 f"{resumed['steps']}")
        expect(resumed, "resume", 1, per_step, per_step)
        expect(fwd, "forward", VIT_STEPS, per_step * VIT_STEPS, 0)
        if len(whole["losses"]) != VIT_STEPS:
            raise AssertionError(f"vit train losses {whole['losses']}")
        same_loss = resumed["losses"] == whole["losses"][-1:]
        if not (same_loss and resumed["digest"] == whole["digest"]):
            raise AssertionError(
                f"vit resume: step-{VIT_STEPS} loss {resumed['losses']} vs "
                f"{whole['losses'][-1:]}, state digest {resumed['digest']} "
                f"vs {whole['digest']}")
        step_s = statistics.median(whole["step_s"][1:])
        fwd_s = statistics.median(fwd["step_s"][1:])
        batch = int(VIT_ARGV[VIT_ARGV.index("--batch") + 1])
        log(f"vit: ViT-B/16 B={batch} train under a {VIT_GRANT_MIB} MiB grant"
            f" (memory fraction {whole['memory_fraction']:.4f}), "
            f"TPUSHARE_FLASH_FWD=pipelined: losses "
            + ", ".join(f"{x:.6g}" for x in whole["losses"])
            + f"; launches flash_fwd_pipelined "
            f"{whole['launches']['flash_fwd_pipelined']}, flash_fwd 0, "
            f"flash_bwd_dq {whole['launches']['flash_bwd_dq']}, "
            f"flash_bwd_dkdv {whole['launches']['flash_bwd_dkdv']} = "
            f"{VIT_LAYERS} x {VIT_STEPS} each")
        log("vit: train step times " + ", ".join(
            f"{t * 1e3:.1f}" for t in whole["step_s"])
            + f" ms; steady step {step_s * 1e3:.1f} ms = "
            f"{batch / step_s:.1f} images/s; max_memory_allocated "
            f"{whole['max_memory_allocated'] / 2**20:.1f} MiB of the "
            f"{VIT_GRANT_MIB} MiB grant; the checkpoint at step 2 took "
            f"{whole['save_s'][0]:.2f} s to save (not in the step times)")
        log(f"vit: a second process resumed from step 2 and ran step "
            f"{VIT_STEPS}: loss {resumed['losses'][0]:.6g}, parameters and "
            f"AdamW moments bitwise the uninterrupted run's (sha256 "
            f"{whole['digest'][:16]}); its step took "
            f"{resumed['step_s'][0] * 1e3:.1f} ms after a restore of "
            f"{resumed['resume_s']:.2f} s ({resumed['setup_s']:.2f} s from "
            "the call to the first step)")
        log("vit: forward step times " + ", ".join(
            f"{t * 1e3:.1f}" for t in fwd["step_s"])
            + f" ms = {batch / fwd_s:.1f} images/s; launches "
            f"flash_fwd_pipelined {fwd['launches']['flash_fwd_pipelined']}"
            f" = {VIT_LAYERS} x {VIT_STEPS}; max_memory_allocated "
            f"{fwd['max_memory_allocated'] / 2**20:.1f} MiB")
        self.vit_launches = {"vit_train": whole["launches"],
                             "vit_resume": resumed["launches"],
                             "vit_forward": fwd["launches"]}
        self.results["vit"] = {
            "train": whole, "resume": resumed, "forward": fwd,
            "steady_step_s": step_s, "train_images_per_s": batch / step_s,
            "forward_images_per_s": batch / fwd_s,
            "grant_mib": VIT_GRANT_MIB,
            "logits": self._vit_logits()}

    def _vit_logits(self) -> dict:
        """ViT-B/16 at full width and depth, random weights and images
        from a seed: logits through K4 against the einsum path."""
        import dataclasses

        import torch
        from tpushare_torch.workloads import vit
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(3)
        cfg = vit.PRESETS_VIT["vit-b16"]
        params = vit.init_vit_params(cfg, gen)
        images = torch.randn(8, cfg.image, cfg.image, cfg.channels,
                             generator=gen, device=dev)
        old = os.environ.get("TPUSHARE_FLASH_FWD")
        os.environ["TPUSHARE_FLASH_FWD"] = "pipelined"
        try:
            with torch.inference_mode():
                flash_logits = vit.vit_forward(
                    params, images, dataclasses.replace(cfg, attn="flash"))
                ein_logits = vit.vit_forward(params, images, cfg)
        finally:
            if old is None:
                os.environ.pop("TPUSHARE_FLASH_FWD")
            else:
                os.environ["TPUSHARE_FLASH_FWD"] = old
        if flash_logits.shape != (8, cfg.classes) or not \
                torch.isfinite(flash_logits).all():
            raise AssertionError("vit logits: wrong shape or non-finite")
        diff = (flash_logits - ein_logits).abs().max().item()
        scale = ein_logits.abs().max().item()
        same_top = (flash_logits.argmax(-1) == ein_logits.argmax(-1)).sum()
        log(f"vit: ViT-B/16 logits (B=8, seeded images), K4 vs einsum "
            f"max|d| {diff:.4g} of max|logit| {scale:.4g} (limit "
            f"{VIT_LOGIT_REL} x); top-1 equal on {int(same_top)} of 8")
        if not diff <= VIT_LOGIT_REL * scale:
            raise AssertionError(f"vit logits: K4 vs einsum {diff:.4g} > "
                                 f"{VIT_LOGIT_REL} x {scale:.4g}")
        return {"max_abs_diff": diff, "max_abs": scale,
                "top1_equal": int(same_top)}

    def kernel_line(self) -> list:
        """The ``{"kernels": [...]}`` records. K1: times at the largest
        serving prefill bucket, launches from the serving path (and from
        the training, moe and vit paths beside them). K2 and K3: times at
        the training shape, launches from the training path (the moe and
        vit paths beside them); ``library_ms`` is the
        whole SDPA backward (device-timed), a yardstick for the pair, so
        their ``sdpa_ratio`` is the pair's sum over it. Errors are the
        worst over the bf16 shapes."""
        rows = self.results["kernel_shapes"]
        head = next(r for r in rows if r["shape"] == "llama-8b prefill S=512")
        path = [r for r in rows if r["dtype"] == "torch.bfloat16"]
        fwd = {"name": "flash_fwd", "route": "cuda",
               "source": "tpushare_torch/csrc/flash_fwd.cu",
               "replaces": "tpushare/workloads/attention.py:279",
               "launches": self.launches,
               "launches_by_path": {
                   "serve": self.launches, "train": self.train_launches[0],
                   **{k: v["flash_fwd"]
                      for k, v in (*self.moe_launches.items(),
                                   *self.shard_launches.items(),
                                   *self.seq_launches.items(),
                                   *self.vit_launches.items())}},
               "max_abs_err": max(r["max_abs_err_out"] for r in path),
               "ms": head["ms"], "plain_ms": head["plain_ms"],
               "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
               "library_ms": head["library_ms"], "shape": head["shape"],
               "sdpa_ratio": head["sdpa_ratio"],
               "bound_share": head["bound_share"]}
        rows = self.results["bwd_kernel_shapes"]
        head = next(r for r in rows if r["shape"] == "llama-8b train S=1023")
        path = [r for r in rows if r["dtype"] == "torch.bfloat16"]
        out = [fwd]
        for key, line, launches in (("dq", 627, self.train_launches[1]),
                                    ("dkdv", 695, self.train_launches[2])):
            k = head[key]
            out.append({
                "name": f"flash_bwd_{key}", "route": "cuda",
                "source": "tpushare_torch/csrc/flash_bwd.cu",
                "replaces": f"tpushare/workloads/attention.py:{line}",
                "launches": launches,
                "launches_by_path": {
                    "train": launches,
                    **{k: v[f"flash_bwd_{key}"]
                       for k, v in (*self.moe_launches.items(),
                                    *self.shard_launches.items(),
                                    *self.seq_launches.items(),
                                    *self.vit_launches.items())
                       if f"flash_bwd_{key}" in v}},
                "max_abs_err": max(r[key]["max_abs_err"] for r in path),
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "sdpa_ratio": head["sdpa_ratio"],
                "bound_share": k["bound_share"]})
        # K4: times at the ViT-B/16 shape, launches from the vit path (its
        # train run; the resumed and forward runs beside them); its plain
        # version and the SDPA call are K1's, timed on the same inputs
        rows = self.results["kernel_shapes"]
        vit_row = next(r for r in rows if r["shape"] == VIT_SHAPE)
        path = [r for r in rows if r["dtype"] == "torch.bfloat16"]
        out.append({
            "name": "flash_fwd_pipelined", "route": "cuda",
            "source": "tpushare_torch/csrc/flash_fwd.cu",
            "replaces": "tpushare/workloads/attention.py:376",
            "launches": self.vit_launches["vit_train"]["flash_fwd_pipelined"],
            "launches_by_path": {k: v["flash_fwd_pipelined"]
                                 for k, v in self.vit_launches.items()},
            "max_abs_err": max(r["pipelined"]["max_abs_err_out"]
                               for r in path),
            "ms": vit_row["pipelined"]["ms"], "plain_ms": vit_row["plain_ms"],
            "bound_ms": vit_row["bound_ms"], "bound_by": vit_row["bound_by"],
            "library_ms": vit_row["library_ms"], "shape": VIT_SHAPE,
            "sdpa_ratio": vit_row["pipelined"]["sdpa_ratio"],
            "bound_share": vit_row["pipelined"]["bound_share"]})
        # kv_decode: times at the chat cell's mean spans, launches from the
        # serving paths' decode steps (per rank on the sharded ones); it
        # replaces no TPU kernel (the reference's decode einsum, whose int8
        # convert XLA fuses)
        rows = self.results["kv_decode_shapes"]
        out.append({
            "name": "kv_decode", "route": "cuda",
            "source": "tpushare_torch/csrc/kv_decode.cu", "replaces": None,
            "launches": self.kv_launches,
            "launches_by_path": {
                "serve": self.kv_launches,
                **{k: v["kv_decode"]
                   for k, v in (*self.moe_launches.items(),
                                *self.shard_launches.items())
                   if "kv_decode" in v}},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": None, "shape": rows[0]["shape"],
            "sdpa_ratio": None, "bound_share": rows[0]["bound_share"]})
        return out


def kernel_name(mangled: str) -> str:
    """``flash_fwd_tc_kernel<128, true>`` for a mangled kernel name."""
    import re
    m = re.search(r"(flash_[a-z_]*kernel)I(.*?)EEv", mangled)
    if not m:
        return mangled
    rest = m.group(2)
    args = (["bf16"] if "bfloat16" in rest
            else ["fp32"] if rest.startswith("f") else [])
    args += re.findall(r"Li(\d+)", rest)
    args += ["true" if b == "1" else "false"
             for b in re.findall(r"Lb([01])", rest)]
    return f"{m.group(1)}<{', '.join(args)}>"


def sass_highest_register(library: Path) -> dict:
    """The highest register each kernel's machine code names, by kernel
    name (``cuobjdump -sass``, beside ``nvcc``): what a warp-specialised
    kernel's consumer path really uses, which ptxas's launch count does
    not show. Empty where the toolkit has no cuobjdump."""
    import re
    from tpushare_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m.group(1))
            out[name] = 0
        elif name is not None:
            for r in re.findall(r"\bR(\d+)\b", ln):
                out[name] = max(out[name], int(r))
    return out


def ptxas_report(log: str) -> list:
    """Per kernel that ``nvcc -Xptxas -v`` compiled: its name with the
    template arguments, registers (at launch), stack and spill bytes, and
    the "wgmma ... serialized" notes ptxas gave it."""
    import re

    records, notes, cur = [], {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"kernel": kernel_name(m.group(1)), "mangled": m.group(1),
                   "registers": None, "stack": None, "spill_stores": None,
                   "spill_loads": None, "serialized": []}
            records.append(cur)
            continue
        m = re.search(r"\((C75\d\d)\).*?serialized (due to .*?) in the "
                      r"function '(\S+)'", ln)
        if m:
            notes.setdefault(m.group(3), []).append(
                f"{m.group(1)} wgmma serialized {m.group(2)}")
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    for r in records:
        r["serialized"] = notes.get(r.pop("mangled"), [])
    return records


def sdpa_backward_ms(q, k, v, do, causal, window) -> dict:
    """The backward of ``F.scaled_dot_product_attention(...,
    enable_gqa=True)`` on the same inputs, timed as the kernels are: its
    forward and backward (``torch.autograd.grad`` on static inputs) and
    its forward alone, each captured in a CUDA graph (:func:`time_ms`),
    and the difference. Also the backend that ran, read from the kernel
    names a profiler sees. A yardstick that the port never calls."""
    import torch
    import torch.nn.functional as F
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None
    if window is not None:
        pos = torch.arange(q.shape[2], device=q.device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] >= pos[:, None] - (window - 1)))

    def fwd():
        return F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qg, kg, vg), do)

    fwd_ms = time_ms(fwd, 20)
    both_ms = time_ms(fwd_bwd, 20)
    return {"ms": both_ms - fwd_ms, "fwd_ms": fwd_ms, "fwd_bwd_ms": both_ms,
            **sdpa_backend(fwd_bwd)}


def sdpa_backend(fn) -> dict:
    """Which SDPA backend ``fn`` ran: flash, cudnn, efficient or math, from
    the names of the CUDA kernels one call launches (torch.profiler), with
    the names; "not measured" when the profiler sees no device kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if str(e.device_type).endswith("CUDA")})
    low = " ".join(names).lower()
    backend = ("not measured" if not names
               else "cudnn" if "cudnn" in low
               else "flash" if "flash" in low
               else "efficient" if "fmha" in low or "efficient" in low
               else "math")
    return {"backend": backend, "kernels": names}


def time_ms(fn, calls: int, reps: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between two CUDA events; the median
    replay over ``calls``. The graph takes the host's launch cost out of
    the time, and the inputs stay in L2 between calls, as they are when
    a prefill layer hands its fresh q/k/v to the kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def plain_calls(S: int, calls: int = 3) -> int:
    """Calls a graph of a plain version holds: ``calls``, or one from S =
    8192 on, where one plain call takes 0.1-1.5 s."""
    return 1 if S >= 8192 else calls


def call_ms(fn, reps: int = 30) -> float:
    """Median time of one call from Python, host launch cost included:
    CUDA events around each call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def engine_traffic(url: str, vocab: int, reset, read) -> dict:
    """The serve phase's traffic against a replica with ``--engine``:
    eleven prompts of 5-450 tokens drawn from a seeded generator (a
    ragged batch of three and two concurrent clients for 16 tokens, a
    streamed prompt, a prompt alone and then amid three more for 32),
    each row checked by :func:`check_rows`. ``reset()`` is called just
    before the first request and ``read()`` just after the last (the
    launch counts around the main path). Returns the answers (for the token check), the
    timings, what ``read()`` returned under "counts", and whether the
    prompt served alone gave bitwise the tokens it gave amid the
    others."""
    import torch
    rng = torch.Generator().manual_seed(7)

    def prompt(n):
        return torch.randint(0, vocab, (n,), generator=rng).tolist()

    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert r.read() == b"ok"
    ragged = [prompt(n) for n in (5, 37, 200)]
    stream_p = prompt(100)
    client_p = [prompt(300), prompt(20)]
    solo = prompt(64)
    mates = [prompt(n) for n in (9, 130, 450)]
    steps, long = 16, 32
    answers: dict = {}

    # -- the main path, with the counts read around it only --
    reset()
    t_main = time.perf_counter()
    t0 = time.perf_counter()
    rows = post(url, {"tokens": ragged, "steps": steps})
    batch_s = time.perf_counter() - t0
    check_rows(ragged, rows, steps, vocab)
    answers["batch"] = (ragged, rows)

    ttft, stream_s, stream_rows = post_stream(url, stream_p, long)
    check_rows([stream_p], stream_rows, long, vocab)
    answers["stream"] = ([stream_p], stream_rows)

    results: dict = {}

    def client(i):
        results[i] = post(url, {"tokens": client_p[i], "steps": steps})

    clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    if len(results) != 2:
        raise AssertionError("a concurrent client got no answer")
    for i in range(2):
        check_rows([client_p[i]], results[i], steps, vocab)
    answers["clients"] = (client_p, [results[0][0], results[1][0]])

    alone = post(url, {"tokens": [solo], "steps": long})
    t0 = time.perf_counter()
    together = post(url, {"tokens": [solo] + mates, "steps": long})
    together_s = time.perf_counter() - t0
    check_rows([solo] + mates, together, long, vocab)
    answers["together"] = ([solo] + mates, together)
    main_s = time.perf_counter() - t_main
    counts = read()
    # -- end of the main path --
    return {"answers": answers, "counts": counts,
            "requests": len(ragged) + 1 + 2 + 1 + 1 + len(mates),
            "cotenant_equal": alone[0] == together[0],
            "ttft_s": ttft, "stream_s": stream_s,
            "stream_decode_tokens_per_s": (long - 1) / (stream_s - ttft),
            "four_requests_tokens_per_s": 4 * long / together_s,
            "together_s": together_s, "batch_s": batch_s, "main_s": main_s}


# the chat cell's slot pool, its prompts' median length and a quantum
GRAPH_SLOTS, GRAPH_MAX_LEN, GRAPH_PLEN, GRAPH_K = 32, 4096, 1020, 8
# host calls that put work on the card's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def host_launches(fn) -> int:
    """Host calls that launch device work while ``fn()`` runs (the
    profiler's CUDA runtime and driver events), with the program's spans
    off as in an untraced run (a recorded ``engine.step`` adds its
    ``keys_read`` sum)."""
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpushare_torch import metrics
    with mock.patch.object(metrics, "span", lambda *a, **kw: metrics.OFF), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)


def decode_graph(params, cfg) -> dict:
    """The decode step as the engine's CUDA graph, on the serve phase's
    weights at the chat cell's pool: every slot busy with a prompt of
    about 1020 tokens, then, untraced and synchronised, quanta of 8
    eager steps (the engine's private step) and 8 replayed ones
    (``decode_quantum``, whose first call captures) in turns, eager,
    graph, graph, eager; the capture's seconds and the graph's memory
    (the card's reserved bytes before and after it); and one quantum of
    each under the profiler, counting host launches a step."""
    import torch
    from tpushare_torch.workloads.engine import DecodeEngine

    eng = DecodeEngine(params, cfg, GRAPH_SLOTS, GRAPH_MAX_LEN,
                       quantum=GRAPH_K)
    rng = torch.Generator().manual_seed(17)
    for i in range(GRAPH_SLOTS):
        n = GRAPH_PLEN + 16 * (i - GRAPH_SLOTS // 2)
        eng.submit(torch.randint(0, cfg.vocab, (n,), generator=rng).tolist(),
                   GRAPH_MAX_LEN - GRAPH_PLEN - 16 * GRAPH_SLOTS)
    capture = eng._capture
    took: dict = {}

    def timed_capture():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        out = capture()
        torch.cuda.synchronize()
        took["s"] = time.perf_counter() - t0
        took["pool_bytes"] = torch.cuda.memory_reserved() - reserved
        return out

    eng._capture = timed_capture

    def eager():
        with torch.inference_mode():
            for _ in range(GRAPH_K):
                eng._step()

    def graph():
        eng.decode_quantum(GRAPH_K).cpu()

    def ms_a_step(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / GRAPH_K

    eager()
    graph()  # captures
    times = {"eager": [], "graph": []}
    for name, fn in (("eager", eager), ("graph", graph), ("graph", graph),
                     ("eager", eager)):
        for _ in range(3):
            times[name].append(ms_a_step(fn))
    # a quantum's launches over its steps (the replayed one's: a replay
    # and a copy of its row a step, and the quantum's row of flags)
    launches = {"eager": host_launches(eager) / GRAPH_K,
                "graph": host_launches(graph) / GRAPH_K}
    out = {"slots": GRAPH_SLOTS, "max_len": GRAPH_MAX_LEN, "k": GRAPH_K,
           "step_ms": times,
           "step_ms_median": {k: statistics.median(v)
                              for k, v in times.items()},
           "host_launches_a_step": launches, "capture_s": took["s"],
           "graph_pool_bytes": took["pool_bytes"],
           "graph_kv_decode_launches": eng._graph_launches}
    if eng._graph_launches != cfg.n_layers:
        raise AssertionError(f"decode graph: {eng._graph_launches} "
                             f"kv_decode launches a replay != "
                             f"{cfg.n_layers} layers")
    log(f"serve: decode step at {GRAPH_SLOTS} slots of {GRAPH_MAX_LEN} "
        f"(every slot busy), untraced: eager "
        f"{out['step_ms_median']['eager']:.2f} ms, replayed "
        f"{out['step_ms_median']['graph']:.2f} ms (medians of "
        f"{len(times['eager'])} quanta of {GRAPH_K}); host launches a "
        f"step {launches['eager']:.2f} eager, {launches['graph']:.2f} "
        f"replayed; "
        f"capture {took['s']:.2f} s, graph pool "
        f"{took['pool_bytes'] / 2**20:.1f} MiB")
    del eng
    torch.cuda.empty_cache()
    return out


def post(url: str, body: dict) -> list:
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())["tokens"]


def post_stream(url: str, prompt: list, steps: int):
    """NDJSON stream; returns (seconds to the first delta, seconds to the
    last delta, [tokens])."""
    req = urllib.request.Request(
        url + "/generate",
        data=json.dumps({"tokens": prompt, "steps": steps,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttft, last, deltas, final = None, None, [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            event = json.loads(line)
            if "error" in event:
                raise AssertionError(f"stream error: {event['error']}")
            if "delta" in event:
                last = time.perf_counter() - t0
                ttft = last if ttft is None else ttft
                deltas.extend(event["delta"])
            if event.get("done"):
                final = event["tokens"]
    if final is None or final != prompt + deltas:
        raise AssertionError("stream: deltas do not add up to the result")
    return ttft, last, [final]


def check_rows(prompts, rows, steps, vocab):
    if len(rows) != len(prompts):
        raise AssertionError(f"{len(rows)} rows for {len(prompts)} prompts")
    for p, row in zip(prompts, rows):
        if row[:len(p)] != p or len(row) != len(p) + steps:
            raise AssertionError(f"row of {len(row)} for a prompt of "
                                 f"{len(p)} + {steps} steps")
        if not all(isinstance(t, int) and 0 <= t < vocab for t in row):
            raise AssertionError("token outside the vocabulary")


def moe_token_check(params, cfg, answers) -> dict:
    """The served MoE tokens against an uncached einsum forward, route by
    route. Capacity factor E/k drops nothing on either path, but the int8
    KV cache and the flash prefill move a layer's router logits by a few
    1e-2, which flips a token's expert where two logits are that
    close; the flipped token's hidden state then moves by its own size,
    and through attention the later layers' routing of other tokens too.
    So each served batch is decoded again here with ``greedy_decode_kv``
    (it must give the served tokens bitwise), the router logits of every
    layer and position are read on both paths, and:

    - layer 0's router logits, which see the attention and the cache
      before any routing, agree within ``MOE_ROUTER0_TOL``;
    - at each generated position where every layer chose the same
      experts on both paths, the served token is within ``SERVE_MARGIN``
      of the reference's top logit;
    - at most ``MOE_FLIP_SHARE`` of the generated positions chose other
      experts in some layer.

    The router logits are read by wrapping ``model.moe_ffn`` for the
    check only, and each forward must show every layer's call. Returns
    the counts and the rules broken under "failures"; the caller
    judges."""
    import dataclasses
    from unittest import mock

    import torch
    from tpushare_torch.workloads import model

    ref_cfg = dataclasses.replace(cfg, attn="einsum")
    dev = params["embed"].device
    k, L = cfg.moe_top_k, cfg.n_layers
    router: list = []
    inner = model.moe_ffn

    def recording(p, x, mcfg, mesh=None):
        router.append((x.float() @ p["wg"]).reshape(*x.shape[:-1], -1))
        return inner(p, x, mcfg, mesh=mesh)

    def read(calls, what):
        if len(router) != L * calls:
            raise AssertionError(f"moe token check: {len(router)} router "
                                 f"readings for {what}, expected {L} layers"
                                 f" x {calls} forwards")
        out = list(router)
        router.clear()
        return out

    stats = {"positions": 0, "flipped": 0, "worst_gap_alike": 0.0,
             "worst_gap_flipped": 0.0, "router0_max_abs_diff": 0.0,
             "bitwise_served": True}
    with mock.patch.object(model, "moe_ffn", recording), \
            torch.inference_mode():
        for prompts, rows in answers.values():
            S, steps = len(prompts[0]), len(rows[0]) - len(prompts[0])
            router.clear()
            again = model.greedy_decode_kv(
                params, torch.tensor(prompts, device=dev), steps, cfg)
            stats["bitwise_served"] &= again.tolist() == rows
            cached = read(steps, "greedy_decode_kv")
            served = [torch.cat(cached[layer::L], dim=1)
                      for layer in range(L)]              # [B, S+steps-1, E]
            for b, row in enumerate(rows):
                seq = torch.tensor([row], device=dev)
                logits = model.forward(params, seq[:, :-1], ref_cfg)[0]
                ref = read(1, "the uncached forward")
                if not torch.isfinite(logits).all():
                    raise AssertionError("non-finite reference logits")
                stats["router0_max_abs_diff"] = max(
                    stats["router0_max_abs_diff"],
                    (served[0][b] - ref[0][0]).abs().max().item())
                for j in range(S - 1, S + steps - 1):
                    alike = all(
                        set(served[layer][b, j].topk(k).indices.tolist())
                        == set(ref[layer][0, j].topk(k).indices.tolist())
                        for layer in range(L))
                    gap = (logits[j].max() - logits[j, row[j + 1]]).item()
                    key = "worst_gap_alike" if alike else "worst_gap_flipped"
                    stats[key] = max(stats[key], gap)
                    stats["positions"] += 1
                    stats["flipped"] += not alike
    stats["flip_share"] = stats["flipped"] / stats["positions"]
    failures = []
    if not stats["bitwise_served"]:
        failures.append("greedy_decode_kv does not give the served tokens")
    if stats["router0_max_abs_diff"] > MOE_ROUTER0_TOL:
        failures.append(f"layer 0 router logits differ by "
                        f"{stats['router0_max_abs_diff']:.4f} (limit "
                        f"{MOE_ROUTER0_TOL})")
    if stats["worst_gap_alike"] > SERVE_MARGIN:
        failures.append(f"a served token {stats['worst_gap_alike']:.3f} "
                        f"below the reference top logit where both routed "
                        f"alike (limit {SERVE_MARGIN})")
    if stats["flip_share"] > MOE_FLIP_SHARE:
        failures.append(f"{stats['flipped']} of {stats['positions']} "
                        f"positions routed otherwise (limit "
                        f"{MOE_FLIP_SHARE})")
    stats["failures"] = failures
    log(f"moe serve: token check: {stats}")
    return stats


@contextlib.contextmanager
def moe_presets():
    """The moe phase's two presets in the port's ``model.PRESETS`` while
    the block runs; yields the Mixtral-width config."""
    import dataclasses
    import gc

    import torch
    from tpushare_torch.workloads import model

    mixtral = dataclasses.replace(model.PRESETS["llama-8b"],
                                  n_layers=MOE_LAYERS, moe_experts=8)
    added = {MOE_PRESET: mixtral,
             MOE_DROPLESS_PRESET: dataclasses.replace(
                 mixtral, moe_capacity_factor=4.0)}
    model.PRESETS.update(added)
    try:
        yield mixtral
    finally:
        for name in added:
            model.PRESETS.pop(name)
        gc.collect()
        torch.cuda.empty_cache()


def _plant_kv_scale():
    """Every int8 KV cache scale written twice too large."""
    from unittest import mock

    from tpushare_torch.workloads import model
    inner = model._kv_quant

    def faulty(x):
        q, scale = inner(x)
        return q, 2 * scale
    return mock.patch.object(model, "_kv_quant", faulty)


def _plant_rope_offset():
    """A decode step's RoPE positions one ahead of its cache position."""
    from unittest import mock

    from tpushare_torch.workloads import model
    inner = model._qkv

    def faulty(h, lp, positions, cfg, mesh=None, layer=0):
        if h.shape[1] == 1:
            positions = positions + 1
        return inner(h, lp, positions, cfg, mesh, layer)
    return mock.patch.object(model, "_qkv", faulty)


# faults for ``--plant``, each planted into the port's serving path for
# one run of the moe replica, to read what ``moe_token_check`` sees of it
PLANTS = {"kv-scale": _plant_kv_scale, "rope-offset": _plant_rope_offset}


def planted(faults: list, out: str | None) -> int:
    """Each fault of ``faults`` planted once after the card and build
    phases: one of :data:`PLANTS` into the moe phase's replica and its
    token check, one of :data:`SHARD_PLANTS` into the shard phase's dp x
    tp trainer and its check against the one-process trainer, one of
    :data:`SHARD_ENGINE_PLANTS` into a rank of the shard phase's tp engine
    replica and its checks, one of :data:`SEQ_PLANTS` into the seq
    phase's part that :data:`SEQ_PLANT_PARTS` names (the pipeline, the
    ring's backward) and its check. Prints the check's readings for
    each; exits 0 only if the check refused every fault."""
    smoke = Smoke()
    smoke.card()
    smoke.build()
    readings, missed = {}, []
    for name in faults:
        if name in SHARD_PLANTS:
            doc = SHARD_PLANTS[name].__doc__
            check = smoke._shard_train(plant=name)
        elif name in SHARD_ENGINE_PLANTS:
            doc = SHARD_ENGINE_PLANTS[name].__doc__
            check = smoke._shard_serve(plant=name)
        elif name in SEQ_PLANTS:
            doc = SEQ_PLANTS[name].__doc__
            part = SEQ_PLANT_PARTS[name]
            world, ref = smoke._seq_world((part,), plant=name)
            runs = [r[part] for r in world]
            seen, failures = (seq_pipeline_judge(runs, ref)
                              if part == "pipeline"
                              else seq_ring_grad_judge(runs))
            check = {"readings": seen, "failures": failures}
        else:
            doc = PLANTS[name].__doc__
            with moe_presets(), PLANTS[name]():
                check = smoke._moe_serve()["token_check"]
        readings[name] = check
        log(f"plant {name}: {' '.join(doc.split())} The check "
            + (f"refused it: {'; '.join(check['failures'])}"
               if check["failures"] else f"MISSED it: {check}"))
        if not check["failures"]:
            missed.append(name)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(readings, indent=1))
    return 1 if missed else 0


def shard_config():
    """The shard phase's trainer: llama-8b widths at ``SHARD_LAYERS``
    layers, ``--attn flash``."""
    import dataclasses
    from tpushare_torch.workloads import model
    cfg = dataclasses.replace(model.PRESETS["llama-8b"],
                              n_layers=SHARD_LAYERS, attn="flash")
    return cfg.validate()


def shard_trainer(cfg, mesh, steps: int, ckpt_dir: str | None = None,
                  ref: dict | None = None, snaps: tuple = ()) -> dict:
    """The shard phase's trainer on ``mesh`` (None: one process) through
    the calls a trainer with a mesh of its own makes:
    ``TrainCheckpointer(ckpt_dir).resume_or_init(mesh=)`` (a fresh
    ``init_params`` without ``ckpt_dir``), ``make_train_step`` over this
    rank's rows of the seeded batch up to step ``steps``, a save at step
    2. The launch counts are set to 0 just before the init and read
    after the last step. After each step in ``snaps`` it keeps
    ``SHARD_REF_LEAVES``: with ``ref`` (the one-process run's, by step)
    the (max, sum, count) of |difference| over this rank's shards, else
    the tensors. Returns the losses, the host seconds of each step, of
    the init and of the save, the launches and those snapshots."""
    import torch
    from tpushare_torch.kernels import flash, flash_bwd
    from tpushare_torch.workloads import model, parallel
    from tpushare_torch.workloads.checkpoint import (
        TrainCheckpointer, leaf_specs)

    dev = torch.device("cuda", torch.cuda.current_device())
    tokens = torch.randint(0, cfg.vocab, (SHARD_BATCH, SHARD_SEQ),
                           generator=torch.Generator(device=dev).manual_seed(
                               SHARD_TOKEN_SEED), device=dev)
    rows = parallel.local_shard(tokens, model.batch_spec(), mesh)
    specs = leaf_specs(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    tx, train_step = model.make_train_step(cfg, learning_rate=SHARD_LR)
    losses, step_s, save_s, snap = [], [], [], {}

    def keep(params, step):
        got = {}
        for name, w in model.named_leaves(params):
            if name not in SHARD_REF_LEAVES:
                continue
            w = w.detach()
            w = w.to_local() if parallel.is_dtensor(w) else w
            if ref is None:
                got[name] = w.cpu().clone()
                continue
            want = parallel.local_shard(ref[step][name], specs[name], mesh)
            d = (w.float() - want.to(dev).float()).abs()
            got[name] = (d.max().item(), d.sum().item(), d.numel())
        snap[step] = got

    flash.LAUNCHES = 0
    flash_bwd.LAUNCHES_DQ = flash_bwd.LAUNCHES_DKDV = 0
    t0 = time.perf_counter()
    ckpt = None
    if ckpt_dir is not None:
        ckpt = TrainCheckpointer(ckpt_dir)
        params, opt, start = ckpt.resume_or_init(cfg, tx, gen, mesh=mesh)
    else:
        params = model.train_params(model.init_params(cfg, gen, mesh=mesh))
        opt, start = tx.init(params), 0
    resume_s = time.perf_counter() - t0
    for done in range(start + 1, steps + 1):
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, rows)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        if done in snaps:
            keep(params, done)
        if ckpt is not None and done == 2:
            t0 = time.perf_counter()
            ckpt.save(done, params, opt, cfg)
            save_s.append(time.perf_counter() - t0)
    launches = {"flash_fwd": flash.LAUNCHES,
                "flash_bwd_dq": flash_bwd.LAUNCHES_DQ,
                "flash_bwd_dkdv": flash_bwd.LAUNCHES_DKDV}
    return {"start": start, "losses": losses, "step_s": step_s,
            "resume_s": resume_s, "save_s": save_s, "launches": launches,
            "snap": snap}


def shard_train_rank(mesh_shape: tuple, ckpt_dir: str, ref_path: str,
                     plant: str | None) -> dict:
    """One rank of the shard phase's trainer: :func:`shard_trainer` on
    the dp x tp mesh of ``mesh_shape``, held against the one-process
    run's leaves in ``ref_path``, with the fault ``plant`` in place (a
    name of :data:`SHARD_PLANTS`) when one is given."""
    import torch
    from tpushare_torch.workloads import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path, mmap=True)
    fault = SHARD_PLANTS[plant]() if plant else contextlib.nullcontext()
    with fault:
        torch.cuda.reset_peak_memory_stats()
        mesh = parallel.make_mesh("cuda", tuple(mesh_shape))
        out = shard_trainer(shard_config(), mesh, 3, ckpt_dir, ref,
                            snaps=(1, 3))
    return {**out, "peak": torch.cuda.max_memory_allocated()}


def shard_train_judge(first: list, second: list | None,
                      ref_losses: list) -> tuple[dict, list]:
    """The sharded runs' readings against the one-process trainer's
    (``first``: the dp x tp ranks' results, ``second``: those of the
    resumed run, or None) and what breaks a limit: the losses
    (``SHARD_LOSS_TOL``), every parameter after steps 1 and 3
    (``SHARD_STEP_TOL``) and each leaf's mean |d| (``SHARD_MEAN_TOL``)."""
    runs = [*first, *(second or [])]
    loss_err = max(abs(a - b) for a, b in zip(first[0]["losses"],
                                              ref_losses))
    if second:
        loss_err = max(loss_err, abs(second[0]["losses"][0] - ref_losses[2]))
    max_d, mean_lr = {}, {}
    for step in (1, 3):
        total: dict = {}
        for run in runs:
            for name, (m, s, n) in run["snap"].get(step, {}).items():
                max_d[step] = max(max_d.get(step, 0.0), m)
                t = total.setdefault(name, [0.0, 0])
                t[0] += s
                t[1] += n
        mean_lr[step] = {name: s / n / SHARD_LR
                         for name, (s, n) in total.items()}
    readings = {"loss_max_abs_diff": loss_err, "max_abs_diff": max_d,
                "mean_abs_diff_lr": mean_lr,
                "worst_mean_lr": {k: max(v.values())
                                  for k, v in mean_lr.items()}}
    failures = []
    if not loss_err <= SHARD_LOSS_TOL:
        failures.append(f"losses {first[0]['losses']} vs one process "
                        f"{ref_losses}: max|d| {loss_err:.4g} (limit "
                        f"{SHARD_LOSS_TOL})")
    for step in (1, 3):
        if not max_d[step] <= SHARD_STEP_TOL[step]:
            failures.append(f"parameters after step {step} max|d| "
                            f"{max_d[step]:.4g} (limit "
                            f"{SHARD_STEP_TOL[step]:.4g})")
        bad = {n: round(v, 4) for n, v in mean_lr[step].items()
               if not v <= SHARD_MEAN_TOL}
        if bad:
            failures.append(f"after step {step} the mean |d| of {bad} "
                            f"(in lr; limit {SHARD_MEAN_TOL})")
    return readings, failures


def _plant_dp_mean():
    """Gradients never averaged over "dp" (each dp rank steps on its own
    rows' gradient)."""
    from unittest import mock

    from tpushare_torch.workloads import parallel
    return mock.patch.object(parallel, "dp_mean_grads",
                             lambda params, mesh: None)


def _plant_copy_to_bwd():
    """``copy_to``'s backward without its all-reduce over "tp" (the
    gradient of a column-parallel product's input is this rank's part
    alone)."""
    from unittest import mock

    from tpushare_torch.workloads import parallel
    return mock.patch.object(parallel._CopyTo, "backward",
                             staticmethod(lambda ctx, g: (g, None)))


# faults for ``--plant`` in the shard phase's trainer, planted in each of
# its ranks for one dp x tp run, to read what its check sees of them
SHARD_PLANTS = {"dp-mean": _plant_dp_mean, "copy-to-bwd": _plant_copy_to_bwd}


def shard_moe_rank(T: int) -> dict:
    """One rank of the ep=2 MoE layer: the layer on the (1, 1, 2) mesh and
    the whole layer in this process, forward and backward of the same
    scalar; returns each output's and gradient's (max|d| on this rank's
    shard, max of the whole), and both passes' device ms."""
    import torch
    from tpushare_torch.workloads import moe, parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = parallel.make_mesh("cuda", (1, 1, 2), parallel.MOE_AXES)
    cfg = moe.MoEConfig(d_model=4096, d_ff=14336, n_experts=8, top_k=2,
                        capacity_factor=2.0, dtype=torch.bfloat16)
    dev = torch.device("cuda", torch.cuda.current_device())

    def draw(m):
        return moe.init_moe_params(
            cfg, torch.Generator(device=dev).manual_seed(4), mesh=m)

    full = {k: v.requires_grad_() for k, v in draw(None).items()}
    sharded = {k: v.requires_grad_() for k, v in draw(mesh).items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(T, 4096, generator=gen, device=dev).to(torch.bfloat16)
    proj = torch.randn(T, 4096, generator=gen, device=dev)

    def run(params):
        xr = x.detach().requires_grad_()
        y, aux = moe.moe_ffn(params, xr, cfg)
        ((y.float() * proj).sum() + aux).backward()
        return y, aux, xr.grad

    y1, aux1, dx1 = run(full)
    y2, aux2, dx2 = run(sharded)
    errors = {}
    for name, a, b in (("y", y2, y1), ("aux", aux2, aux1), ("dx", dx2, dx1)):
        errors[name] = ((a.float() - b.float()).abs().max().item(),
                        b.float().abs().max().item())
    specs = moe.moe_param_specs()
    for name in full:
        want = parallel.local_shard(full[name].grad, specs[name], mesh)
        got = sharded[name].grad.to_local()
        errors[f"d{name}"] = ((got.float() - want.float()).abs().max().item(),
                              full[name].grad.float().abs().max().item())

    def timed(params):
        for p in params.values():
            p.grad = None
        run(params)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(params)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    ep_ms = timed(sharded)
    one_ms = timed(full)
    return {"errors": errors, "ep_ms": ep_ms, "one_ms": one_ms}


def pp_config():
    """The seq phase's pipeline: llama-8b widths at ``PP_LAYERS`` layers,
    ``--attn flash``."""
    import dataclasses
    from tpushare_torch.workloads import model
    cfg = dataclasses.replace(model.PRESETS["llama-8b"], n_layers=PP_LAYERS,
                              attn="flash")
    return cfg.validate()


def pp_tokens(dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(PP_TOKEN_SEED)
    return torch.randint(0, pp_config().vocab, (PP_BATCH, PP_SEQ),
                         device=dev, generator=gen)


def pp_reference(path: Path) -> dict:
    """The one-process run the pipeline is held against: the forward's
    logits on the batch's first 1023 positions, then three
    ``make_train_step`` steps from the same seed with ``PP_REF_LEAVES``
    after steps 1 and 3, saved to ``path``; returns the losses and step
    times."""
    import torch
    from tpushare_torch.workloads import model

    cfg = pp_config()
    dev = torch.device("cuda", torch.cuda.current_device())
    tokens = pp_tokens(dev)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    with torch.inference_mode():
        logits = model.forward(params, tokens[:, :-1], cfg).cpu()
    params = model.train_params(params)
    tx, step = model.make_train_step(cfg, learning_rate=SHARD_LR)
    opt = tx.init(params)
    losses, step_s, snap = [], [], {}
    for done in (1, 2, 3):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if done in (1, 3):
            snap[done] = {n: w.detach().cpu().clone()
                          for n, w in model.named_leaves(params)
                          if n in PP_REF_LEAVES}
    torch.save({"logits": logits, "snap": snap}, path)
    return {"losses": losses, "step_s": step_s,
            "peak": torch.cuda.max_memory_allocated()}


def seq_ring_rank() -> dict:
    """(a) on one rank: ``player --sp ring`` at ``SEQ_S`` (the main path,
    its K1 count set to 0 just before and read just after), then its
    output chunk against one-process K1 over the whole gathered sequence,
    the same sequence zigzagged through ``ring_attention(zigzag=True)``
    (its own count), and at ``SEQ_FOLD_S`` the card's route against the
    plain fold, contiguous and zigzag."""
    import torch
    import torch.distributed as dist
    from tpushare_torch.kernels import flash
    from tpushare_torch.workloads import parallel, player
    from tpushare_torch.workloads import ringattention as ra
    from tpushare_torch.workloads.attention import flash_attention

    r, n = dist.get_rank(), dist.get_world_size()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path --
    flash.LAUNCHES = 0
    record = player.run(SEQ_RING_ARGV, return_state=True)
    launches = flash.LAUNCHES
    # -- end of the main path --
    peak = torch.cuda.max_memory_allocated()
    held = record.pop("ring")
    out = held["out"]
    finite = bool(torch.isfinite(out).all())
    mesh = parallel.make_mesh("cuda", (n,), ("sp",))
    q, k, v = (ra.gather_seq(held[x], mesh) for x in "qkv")
    S, per = q.shape[2], out.shape[2]
    with torch.inference_mode():
        whole = flash_attention(q, k, v, causal=True)
    mine = whole.narrow(2, r * per, per)
    err = (out.float() - mine.float()).abs().max().item()
    bitwise = bool(torch.equal(out, mine))
    # zigzag through the library call, on the same sequence
    perm = ra.zigzag_order(S, n).to(q.device)
    zq, zk, zv = (ra.shard_seq(t[:, :, perm], mesh).contiguous()
                  for t in (q, k, v))
    torch.cuda.synchronize()
    flash.LAUNCHES = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        zout = ra.ring_attention(zq, zk, zv, mesh, zigzag=True)
    torch.cuda.synchronize()
    zigzag_s = time.perf_counter() - t0
    zigzag_launches = flash.LAUNCHES
    zwant = ra.shard_seq(whole[:, :, perm], mesh)
    err_z = (zout.float() - zwant.float()).abs().max().item()
    # the card's route against the plain fold, on the first SEQ_FOLD_S
    # positions
    fold = {}
    fq, fk, fv = (t[:, :, :SEQ_FOLD_S] for t in (q, k, v))
    fwhole = whole[:, :, :SEQ_FOLD_S]
    for zz in (False, True):
        order = (ra.zigzag_order(SEQ_FOLD_S, n).to(q.device) if zz
                 else torch.arange(SEQ_FOLD_S, device=q.device))
        loc = [ra.shard_seq(t[:, :, order], mesh).contiguous()
               for t in (fq, fk, fv)]
        with torch.inference_mode():
            got = ra._ring_flash(*loc, mesh, "sp", True, zz)
            plain = ra._ring_fold(*loc, mesh, "sp", True, zz)
        want = ra.shard_seq(fwhole[:, :, order], mesh)
        fold["zigzag" if zz else "contiguous"] = {
            "vs_plain": (got.float() - plain.float()).abs().max().item(),
            "plain_vs_k1": (plain.float() - want.float()).abs().max().item()}
    return {"launches": launches, "zigzag_launches": zigzag_launches,
            "err": err, "bitwise": bitwise, "err_zigzag": err_z,
            "max_abs": whole.abs().max().item(), "finite": finite,
            "shape": list(out.shape), "step_s": record["step_s"],
            "world": record["world"], "zigzag_s": zigzag_s, "peak": peak,
            "fold": fold}


def seq_ring_grad_rank(plant: str | None) -> dict:
    """(e) on one rank: ``ring_attention`` forward and backward of a
    seeded dO at ``SEQ_S``, contiguous and zigzagged (the main path, the
    counts set to 0 just before each and read just after), each rank's
    dq, dk and dv against one-process ``flash_attention`` over the whole
    sequence, a warm call's time against one process's (rank 0, the
    others waiting), and at ``SEQ_FOLD_S`` the card's gradients against
    the plain fold's in fp32. ``plant`` (:data:`SEQ_PLANTS`) is planted
    around the ring's calls."""
    import torch
    import torch.distributed as dist
    from tpushare_torch.kernels import flash, flash_bwd
    from tpushare_torch.workloads import parallel
    from tpushare_torch.workloads import ringattention as ra
    from tpushare_torch.workloads.attention import flash_attention

    r, n = dist.get_rank(), dist.get_world_size()
    mesh = parallel.make_mesh("cuda", (n,), ("sp",))
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEQ_GRAD_SEED)

    def randn(h):
        return torch.randn(1, h, SEQ_S, 128, generator=gen,
                           device=dev).to(torch.bfloat16)

    def fault():
        return SEQ_PLANTS[plant]() if plant else contextlib.nullcontext()

    q, k, v, do = randn(32), randn(8), randn(8), randn(32)
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*full, causal=True).backward(do)
    whole = [t.grad for t in full]
    del full
    torch.cuda.empty_cache()
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for zz in (False, True):
        order = ra.zigzag_order(SEQ_S, n).to(dev) if zz else None

        def mine(t, order=order):
            return ra.shard_seq(t if order is None else t[:, :, order],
                                mesh).contiguous()

        local = [mine(t).requires_grad_() for t in (q, k, v)]
        dol = mine(do)
        torch.cuda.synchronize()
        with fault():
            # -- the main path --
            flash.LAUNCHES = flash_bwd.LAUNCHES_DQ = 0
            flash_bwd.LAUNCHES_DKDV = 0
            t0 = time.perf_counter()
            ra.ring_attention(*local, mesh, zigzag=zz).backward(dol)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {"flash_fwd": flash.LAUNCHES,
                        "flash_bwd_dq": flash_bwd.LAUNCHES_DQ,
                        "flash_bwd_dkdv": flash_bwd.LAUNCHES_DKDV}
            # -- end of the main path --
        errs = {}
        for x, t, w in zip("qkv", local, whole):
            want = mine(w).float()
            errs[f"d{x}"] = ((t.grad.float() - want).abs().max().item(),
                             want.abs().max().item())
        runs["zigzag" if zz else "contiguous"] = {
            "launches": launches, "wall_s": wall_s, "errs": errs}
    peak = torch.cuda.max_memory_allocated()
    # a warm call of the contiguous ring; then one process's forward and
    # backward on rank 0 alone, the other ranks waiting
    local = [ra.shard_seq(t, mesh).contiguous().requires_grad_()
             for t in (q, k, v)]
    dol = ra.shard_seq(do, mesh).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ra.ring_attention(*local, mesh).backward(dol)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    dist.barrier()
    one_ms = None
    if r == 0:
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        flash_attention(*full, causal=True).backward(do)
        end.record()
        end.synchronize()
        one_ms = start.elapsed_time(end)
        del full
    dist.barrier()
    # the card's route against the plain fold in fp32, at SEQ_FOLD_S
    fold = {}
    fq, fk, fv, fdo = (t[:, :, :SEQ_FOLD_S] for t in (q, k, v, do))
    for zz in (False, True):
        order = (ra.zigzag_order(SEQ_FOLD_S, n).to(dev) if zz
                 else torch.arange(SEQ_FOLD_S, device=dev))
        loc = [ra.shard_seq(t[:, :, order], mesh).contiguous()
               for t in (fq, fk, fv)]
        dloc = ra.shard_seq(fdo[:, :, order], mesh).contiguous()
        card = [t.clone().requires_grad_() for t in loc]
        with fault():
            ra.ring_attention(*card, mesh, zigzag=zz).backward(dloc)
        plain = [t.float().requires_grad_() for t in loc]
        ra._ring_fold(*plain, mesh, "sp", True, zz).backward(dloc.float())
        fold["zigzag" if zz else "contiguous"] = {
            f"d{x}": ((a.grad.float() - b.grad).abs().max().item(),
                      b.grad.abs().max().item())
            for x, a, b in zip("qkv", card, plain)}
        del card, plain
        torch.cuda.empty_cache()
    return {"runs": runs, "warm_s": warm_s, "one_ms": one_ms, "peak": peak,
            "fold": fold}


def seq_ring_grad_judge(runs: list) -> tuple[dict, list]:
    """The ring backward's readings on every rank and what breaks a limit:
    K1, K2 and K3 launches a call (r + 1 on rank r contiguous, 2n + 1
    zigzagged), dq, dk and dv within ``RING_GRAD_REL`` of max|grad| of
    one-process ``flash_attention``, and at ``SEQ_FOLD_S`` within
    ``RING_FOLD_GRAD_REL`` of the fp32 fold's."""
    n = len(runs)
    failures = []
    worst = {"one_process": 0.0, "fold": 0.0}
    for r, run in enumerate(runs):
        for layout, got in run["runs"].items():
            pairs = 2 * n + 1 if layout == "zigzag" else r + 1
            want = dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkdv"), pairs)
            if got["launches"] != want:
                failures.append(f"ring backward {layout}: rank {r} launches "
                                f"{got['launches']}, expected {want}")
            for name, (err, top) in got["errs"].items():
                worst["one_process"] = max(worst["one_process"], err / top)
                if not err <= RING_GRAD_REL * top:
                    failures.append(
                        f"ring backward {layout}: rank {r} {name} max|d| "
                        f"{err:.4g} > {RING_GRAD_REL:.4g} x max|{name}| "
                        f"{top:.4g} against one-process flash_attention")
        for layout, errs in run["fold"].items():
            for name, (err, top) in errs.items():
                worst["fold"] = max(worst["fold"], err / top)
                if not err <= RING_FOLD_GRAD_REL * top:
                    failures.append(
                        f"ring backward at S={SEQ_FOLD_S} {layout}: rank {r}"
                        f" {name} max|d| {err:.4g} > {RING_FOLD_GRAD_REL} x "
                        f"max|{name}| {top:.4g} against the fp32 fold")
    return {"worst_rel": worst}, failures


def seq_ulysses_rank() -> dict:
    """(c) on one rank: Ulysses at llama-8b heads over ``SEQ_S`` with the
    window, ``attn="flash"``, forward and backward of a seeded dO (the
    main path, counts set to 0 just before and read just after), then
    one-process ``flash_attention`` on the same heads: the output and
    dq, dk, dv must be bitwise the same."""
    import torch
    import torch.distributed as dist
    from tpushare_torch.kernels import flash, flash_bwd
    from tpushare_torch.workloads import parallel
    from tpushare_torch.workloads import ringattention as ra
    from tpushare_torch.workloads.attention import flash_attention
    from tpushare_torch.workloads.ulysses import ulysses_attention

    n = dist.get_world_size()
    mesh = parallel.make_mesh("cuda", (n,), ("sp",))
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEQ_ULYSSES_SEED)

    def randn(h):
        return torch.randn(1, h, SEQ_S, 128, generator=gen,
                           device=dev).to(torch.bfloat16)

    q, k, v, do = randn(32), randn(8), randn(8), randn(32)
    local = [ra.shard_seq(t, mesh).clone().requires_grad_()
             for t in (q, k, v)]
    dol = ra.shard_seq(do, mesh).contiguous()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # -- the main path --
    flash.LAUNCHES = flash_bwd.LAUNCHES_DQ = flash_bwd.LAUNCHES_DKDV = 0
    t0 = time.perf_counter()
    o = ulysses_attention(*local, mesh, causal=True, attn="flash",
                          window=SEQ_WINDOW)
    o.backward(dol)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"flash_fwd": flash.LAUNCHES,
                "flash_bwd_dq": flash_bwd.LAUNCHES_DQ,
                "flash_bwd_dkdv": flash_bwd.LAUNCHES_DKDV}
    # -- end of the main path --
    peak = torch.cuda.max_memory_allocated()
    # the same call again, warm (the first pays for the collectives'
    # set-up)
    again = [t.detach().clone().requires_grad_() for t in local]
    t0 = time.perf_counter()
    ulysses_attention(*again, mesh, causal=True, attn="flash",
                      window=SEQ_WINDOW).backward(dol)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    of = flash_attention(*full, causal=True, window=SEQ_WINDOW)
    of.backward(do)
    end.record()
    end.synchronize()
    one_ms = start.elapsed_time(end)
    pairs = {"out": (o, of)}
    pairs.update({f"d{x}": (a.grad, b.grad)
                  for x, a, b in zip("qkv", local, full)})
    same, diff = {}, {}
    for name, (mine, whole) in pairs.items():
        want = ra.shard_seq(whole, mesh)
        same[name] = bool(torch.equal(mine, want))
        diff[name] = (mine.float() - want.float()).abs().max().item()
    return {"launches": launches, "bitwise": same, "max_abs_diff": diff,
            "wall_s": wall_s, "warm_s": warm_s, "one_ms": one_ms,
            "peak": peak}


def seq_pipeline_judge(runs: list, ref: dict) -> tuple[dict, list]:
    """The pipeline ranks' readings against the one-process trainer's and
    what breaks a limit: ``shard_train_judge``'s losses and leaves (each
    rank's leaves mapped to the whole model's names), the forward's
    logits (``PP_LOGIT_TOL``), the launches a rank, and the leaves every
    rank holds, which must come out equal on every rank."""
    readings, failures = shard_train_judge(runs, None, ref["losses"])
    readings["logit_max_abs_diff"] = max(run["logit_err"] for run in runs)
    readings["replicated_equal"] = len(
        {run["replicated_digest"] for run in runs}) == 1
    if not readings["logit_max_abs_diff"] <= PP_LOGIT_TOL:
        failures.append(f"pipelined logits vs one process max|d| "
                        f"{readings['logit_max_abs_diff']:.4g} (limit "
                        f"{PP_LOGIT_TOL})")
    if not readings["replicated_equal"]:
        failures.append("the embedding, final norm and head differ between "
                        "the pp ranks")
    ticks = PP_MICROBATCHES * (PP_LAYERS // len(runs))
    want = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"),
                         3 * ticks)
    for r, run in enumerate(runs):
        if run["launches"] != want or run["fwd_launches"] != ticks:
            failures.append(f"pipeline rank {r} launches {run['launches']},"
                            f" forward {run['fwd_launches']}; expected "
                            f"{want}, {ticks}")
    return readings, failures


def _plant_pp_embed_sum():
    """The embedding gradient's sum over "pp" dropped (stage 0 alone
    holds its real gradient; the other ranks step on zero)."""
    from unittest import mock

    from tpushare_torch.workloads import pipeline
    return mock.patch.object(pipeline, "_sum_embed_grad",
                             lambda x, mesh, axis: x)


@contextlib.contextmanager
def _plant_ring_local_lse():
    """The ring's backward hands K2 and K3 each visiting chunk's own LSE
    (K1 over that chunk alone) in place of the merged one, so each
    chunk's P sums to 1 on its own."""
    from unittest import mock

    from tpushare_torch.kernels import flash, flash_bwd

    def own_lse(kernel):
        def run(qs, k, v, do, lse, delta, causal, window=None):
            q = (qs.float() * qs.shape[-1] ** 0.5).to(qs.dtype)
            lse = flash.flash_fwd(q, k, v, causal)[1]
            return kernel(qs, k, v, do, lse, delta, causal, window)
        return run

    with mock.patch.object(flash_bwd, "flash_bwd_dq",
                           own_lse(flash_bwd.flash_bwd_dq)), \
            mock.patch.object(flash_bwd, "flash_bwd_dkdv",
                              own_lse(flash_bwd.flash_bwd_dkdv)):
        yield


# faults for ``--plant`` in the seq phase, planted in each of its ranks
# around the part named, to read what that part's check sees of them
SEQ_PLANTS = {"pp-embed-sum": _plant_pp_embed_sum,
              "ring-local-lse": _plant_ring_local_lse}
SEQ_PLANT_PARTS = {"pp-embed-sum": "pipeline",
                   "ring-local-lse": "ring_grad"}


def seq_pipeline_rank(ref_path: str, plant: str | None) -> dict:
    """(d) on one rank: the stage's tree from the seeded init, the
    pipelined forward's logits against the one-process forward's, then
    three ``make_pipelined_train_step`` steps (the main path, counts set
    to 0 just before and read just after), each ``PP_REF_LEAVES`` leaf
    this rank holds after steps 1 and 3 against the one-process
    trainer's as (max, sum, count) of |difference|, and a digest of the
    leaves every rank holds (the embedding, final norm and head)."""
    import hashlib

    import torch
    from tpushare_torch.kernels import flash, flash_bwd
    from tpushare_torch.workloads import model, parallel, pipeline

    ref = torch.load(ref_path, mmap=True)
    fault = SEQ_PLANTS[plant]() if plant else contextlib.nullcontext()
    cfg = pp_config()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh("cuda", (SEQ_RANKS,), ("pp",))
    stage = parallel.axis_rank(mesh, "pp")
    lo = stage * (PP_LAYERS // SEQ_RANKS)
    tokens = pp_tokens(dev)
    torch.cuda.reset_peak_memory_stats()
    with fault:
        t0 = time.perf_counter()
        whole = model.init_params(cfg, torch.Generator(device=dev)
                                  .manual_seed(0))
        params = pipeline.stage_params(whole, cfg, mesh)
        del whole
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        flash.LAUNCHES = 0
        with torch.inference_mode():
            logits = pipeline.pipelined_forward(
                params, tokens[:, :-1], cfg, mesh, PP_MICROBATCHES)
        fwd_launches = flash.LAUNCHES
        logit_err = (logits - ref["logits"].to(dev)).abs().max().item()
        spread = logits.abs().max().item()
        del logits
        params = model.train_params(params)
        tx, step = pipeline.make_pipelined_train_step(
            cfg, mesh, PP_MICROBATCHES, learning_rate=SHARD_LR)
        opt = tx.init(params)
        losses, step_s, snap = [], [], {}
        torch.cuda.synchronize()
        # -- the main path --
        flash.LAUNCHES = flash_bwd.LAUNCHES_DQ = flash_bwd.LAUNCHES_DKDV = 0
        for done in (1, 2, 3):
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, tokens)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
            if done not in (1, 3):
                continue
            got = {}
            for name, w in model.named_leaves(params):
                if name.startswith("layers."):
                    _, i, leaf = name.split(".")
                    name = f"layers.{lo + int(i)}.{leaf}"
                if name not in PP_REF_LEAVES:
                    continue
                d = (w.detach().float()
                     - ref["snap"][done][name].to(dev).float()).abs()
                got[name] = (d.max().item(), d.sum().item(), d.numel())
            snap[done] = got
        launches = {"flash_fwd": flash.LAUNCHES,
                    "flash_bwd_dq": flash_bwd.LAUNCHES_DQ,
                    "flash_bwd_dkdv": flash_bwd.LAUNCHES_DKDV}
        # -- end of the main path --
    digest = hashlib.sha256()
    for name in ("embed", "final_norm", "lm_head"):
        digest.update(params[name].detach().reshape(-1).view(torch.uint8)
                      .cpu().numpy().tobytes())
    return {"stage": stage, "layers": [lo, lo + PP_LAYERS // SEQ_RANKS],
            "logit_err": logit_err, "logit_spread": spread,
            "fwd_launches": fwd_launches, "launches": launches,
            "losses": losses, "step_s": step_s, "init_s": init_s,
            "snap": snap, "replicated_digest": digest.hexdigest(),
            "peak": torch.cuda.max_memory_allocated()}


def seq_rank(parts: list, ref_path: str | None, plant: str | None) -> dict:
    """One rank of the seq phase's world: the ``parts`` of (a) "ring",
    (e) "ring_grad", (c) "ulysses" and (d) "pipeline", in that order,
    each leaving the card's memory as it found it; ``plant`` goes to the
    part :data:`SEQ_PLANT_PARTS` names."""
    import gc

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for part in ("ring", "ring_grad", "ulysses", "pipeline"):
        if part not in parts:
            continue
        mine = plant if SEQ_PLANT_PARTS.get(plant) == part else None
        if part == "ring":
            out[part] = seq_ring_rank()
        elif part == "ring_grad":
            out[part] = seq_ring_grad_rank(mine)
        elif part == "ulysses":
            out[part] = seq_ulysses_rank()
        else:
            out[part] = seq_pipeline_rank(ref_path, mine)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# the calls whose CUDA-tensor support on gloo the seq phase reads (ranks
# that share the card run on gloo)
GLOO_PROBES = ("all_reduce", "send_recv", "batch_isend_irecv",
               "all_to_all_single")


def gloo_probe_rank(op: str) -> str:
    """One rank of a two-rank gloo world on this card: ``op`` on CUDA
    tensors, with what each rank should receive. Returns "ok", or what
    went wrong; a crash shows in the child's exit code."""
    import torch
    import torch.distributed as dist

    r = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
    if op == "all_reduce":
        dist.all_reduce(x)
        want = torch.arange(4.0) * 2 + 10
    elif op == "send_recv":
        got = torch.zeros_like(x)
        if r == 0:
            dist.send(x, 1)
            dist.recv(got, 1)
        else:
            dist.recv(got, 0)
            dist.send(x, 0)
        x, want = got, torch.arange(4.0) + 10 * (1 - r)
    elif op == "batch_isend_irecv":
        got = torch.zeros_like(x)
        ops = [dist.P2POp(dist.isend, x, 1 - r),
               dist.P2POp(dist.irecv, got, 1 - r)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        x, want = got, torch.arange(4.0) + 10 * (1 - r)
    else:
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x)
        x = got
        want = torch.tensor([2.0 * r, 2 * r + 1, 10 + 2 * r, 11 + 2 * r])
    torch.cuda.synchronize()
    return "ok" if torch.equal(x.cpu(), want) else f"wrong data {x.tolist()}"


def gloo_probe(op: str) -> int:
    """The child of :func:`gloo_probes`: two ranks run ``op``."""
    from tpushare_torch.workloads import parallel
    out = parallel.run_ranks(gloo_probe_rank, 2, op, device_type="cuda",
                             timeout=60, env={"TPUSHARE_PROBE": op})
    print(CHILD_PREFIX + json.dumps(out), flush=True)
    return 0


def gloo_probes() -> dict:
    """Which of :data:`GLOO_PROBES` gloo carries for CUDA tensors between
    two ranks on this card, each in a child process of its own (a call
    that gloo does not take may crash its ranks), all at once."""
    # both ranks on one card, whatever the machine has: gloo
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    procs = {op: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--gloo-probe", op],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for op in GLOO_PROBES}
    found = {}
    for op, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=180)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        lines = [ln for ln in out.splitlines() if ln.startswith(CHILD_PREFIX)]
        if proc.returncode == 0 and len(lines) == 1:
            ranks = json.loads(lines[0][len(CHILD_PREFIX):])
            found[op] = "ok" if set(ranks) == {"ok"} else "; ".join(ranks)
        else:
            tail = (err.strip().splitlines() or ["no output"])[-1]
            found[op] = f"exit {proc.returncode}: {tail[:300]}"
    return found


def serve_child(spec: dict) -> int:
    """The child of the shard phase's replica: ``serve.build_server``
    (rank 0 of ``--tp`` ranks, with ``--engine``) under the grant in the
    environment, ``spec["plant"]`` (:data:`SHARD_ENGINE_PLANTS`) planted
    in rank 1 when given. A warm-up request, then :func:`engine_traffic`
    with every rank's launch counts and peaks reset just before it and
    read just after; then, from the same ranks, the path without the
    engine (``TPReplica.decode``), each of ``spec["prompts"]`` alone for
    ``SHARD_DECODE_STEPS`` tokens with the counts reset and read around
    it (and rank 0's engine decode steps counted over the traffic); then the first-token logits of each prompt, timed (a prefill
    alone), saved to ``spec["logits"]``. Prints one ``CHILD_RESULT``
    line. A request that the ranks' token agreement fails (its message,
    :data:`TP_AGREE_MESSAGE`, in the error) is reported as ``refused``
    when a fault was planted; any other failure fails the child."""
    from unittest import mock

    import torch
    from tpushare_torch.workloads import parallel, serve

    torch.backends.cuda.matmul.allow_tf32 = False
    plant = spec.get("plant")
    t0 = time.perf_counter()
    with (mock.patch.object(serve, "_tp_rank_main", _planted_tp_rank_main)
          if plant else contextlib.nullcontext()):
        httpd, front = serve.build_server(spec["argv"])
    replica = front.engine.replica
    out = {"build_s": time.perf_counter() - t0,
           "built_stats": replica.stats(),
           "transport": parallel.transport("cuda", len(replica._procs) + 1)}
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    # rank 0's decode steps; every rank runs each of them
    steps = [0]
    decode = front.engine.decode_quantum

    def counted(k):
        steps[0] += k
        return decode(k)

    def reset():
        replica.reset_stats()
        steps[0] = 0

    def read():
        stats = replica.stats()
        out["engine_decode_steps"] = steps[0]
        return stats

    front.engine.decode_quantum = counted
    try:
        try:
            # a warm-up request meets the cold caches; it is not counted
            post(url, {"tokens": [spec["prompts"][0]], "steps": 2})
            out["traffic"] = engine_traffic(url, spec["vocab"], reset, read)
        except (urllib.error.HTTPError, AssertionError) as e:
            said = (e.read().decode() if isinstance(e, urllib.error.HTTPError)
                    else str(e))
            if not (plant and TP_AGREE_MESSAGE in said):
                raise
            out["refused"] = f"{type(e).__name__}: {e} {said}"
        if "refused" not in out:
            replica.reset_stats()
            rows, request_s = [], []
            for p in spec["prompts"]:
                t = time.perf_counter()
                row = replica.decode(torch.tensor([p]), SHARD_DECODE_STEPS)
                rows.append(row[0].tolist())
                request_s.append(time.perf_counter() - t)
            out["decode"] = {"counts": replica.stats(), "rows": rows,
                             "request_s": request_s, "prefill_s": []}
            logits = []
            for p in spec["prompts"]:
                t = time.perf_counter()
                logits.append(replica.prefill_logits(torch.tensor([p])).cpu())
                out["decode"]["prefill_s"].append(time.perf_counter() - t)
            torch.save(torch.cat(logits), spec["logits"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        front.stop()
        front.join(timeout=120)
    print(CHILD_PREFIX + json.dumps(out), flush=True)
    return 0


def _planted_tp_rank_main(argv, rank, world, addr, cards) -> None:
    """``serve._tp_rank_main`` with the shard phase's planted fault
    (``tp-engine-table``) in rank 1."""
    from tpushare_torch.workloads import serve
    with (_plant_tp_engine_table() if rank == 1
          else contextlib.nullcontext()):
        serve._tp_rank_main(argv, rank, world, addr, cards)


def _plant_tp_engine_table():
    """One rank runs every decode quantum on the slot table rolled by one
    slot (each slot takes its neighbour's last token, position, flags,
    budget and sampling key) while the others run rank 0's."""
    from unittest import mock

    from tpushare_torch.workloads.engine import DecodeEngine
    real = DecodeEngine.load_slot_table

    def rolled(self, longs, floats):
        real(self, longs.roll(1, dims=1), floats.roll(1, dims=1))

    return mock.patch.object(DecodeEngine, "load_slot_table", rolled)


# faults for ``--plant`` in the shard phase's tp engine replica, planted
# in one of its ranks (rank 1), to read what its checks see of them
SHARD_ENGINE_PLANTS = {"tp-engine-table": _plant_tp_engine_table}


def run_child_cmd(args: list, env: dict, timeout: float = 900) -> dict:
    """This script with ``args`` in a child process with ``env``; returns
    what the child reports on its ``CHILD_RESULT`` line."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), *args], env=env,
        capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(CHILD_PREFIX)]
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"child {args[0]} exited {proc.returncode}:"
                           f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[0][len(CHILD_PREFIX):])


def run_child(argv: list, env: dict) -> dict:
    """``player.run(argv)`` in a child process of this script (``--child``)
    with ``env``; returns what the child reports."""
    return run_child_cmd(["--child", json.dumps(argv)], env, timeout=600)


CHILD_PREFIX = "CHILD_RESULT "


def child(argv: list) -> int:
    """The child of :func:`run_child`: reset the launch counts, run the
    player, and print one ``CHILD_RESULT`` JSON line with its record, the
    launch counts, the peak allocation and, in train mode, a sha256 of
    every parameter and AdamW state tensor after the run."""
    import hashlib

    import torch
    from tpushare_torch.kernels import flash, flash_bwd
    from tpushare_torch.workloads import player
    from tpushare_torch.workloads.checkpoint import train_state_dict

    flash.LAUNCHES = flash.LAUNCHES_PIPELINED = 0
    flash_bwd.LAUNCHES_DQ = flash_bwd.LAUNCHES_DKDV = 0
    t0 = time.perf_counter()
    record = player.run(argv, return_state=True)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash.LAUNCHES,
                "flash_fwd_pipelined": flash.LAUNCHES_PIPELINED,
                "flash_bwd_dq": flash_bwd.LAUNCHES_DQ,
                "flash_bwd_dkdv": flash_bwd.LAUNCHES_DKDV}
    digest = None
    opt_state = record.pop("opt_state", None)
    params = record.pop("params")
    if opt_state is not None:
        h = hashlib.sha256()
        for name, t in sorted(train_state_dict(params, opt_state).items()):
            h.update(name.encode())
            h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                     .cpu().numpy().tobytes())
        digest = h.hexdigest()
    from tpushare_torch.workloads.hbm import grant_fraction
    print(CHILD_PREFIX + json.dumps({
        **record, "launches": launches, "digest": digest,
        "setup_s": wall - sum(record["step_s"]),
        "memory_fraction": grant_fraction(),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}),
        flush=True)
    return 0


def compare(parent: Path, out_dir: Path) -> int:
    """Parent against change on one card: ``parent/chip_smoke.py`` and
    this tree's, each ``--phases build,kernels`` in its own process, in
    the order parent, change, change, parent (each tree builds its own
    kernels into its own ``build/``). Writes each run's log and numbers
    under ``out_dir`` and prints, per kernel and shape, the four device
    times and the change over the parent (mean of two against mean of
    two)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (label, root) in enumerate((("parent", parent), ("change", ROOT),
                                       ("change", ROOT),
                                       ("parent", parent))):
        out = (out_dir / f"compare{i}_{label}.json").resolve()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(root / "chip_smoke.py"), "--phases",
             "build,kernels", "--out", str(out)], cwd=root,
            capture_output=True, text=True, timeout=900)
        (out_dir / f"compare{i}_{label}.log").write_text(proc.stdout
                                                         + proc.stderr)
        log(f"compare: {label} run {i} exited {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0:
            log(proc.stdout[-3000:] + proc.stderr[-3000:])
            return 1
        runs.append((label, json.loads(out.read_text())))
    table = {}
    for label, res in runs:
        for r in res.get("kernel_shapes", []):
            table.setdefault(("flash_fwd", r["shape"]), []).append(
                (label, r["ms"]))
            if "pipelined" in r:
                table.setdefault(("flash_fwd_pipelined", r["shape"]),
                                 []).append((label, r["pipelined"]["ms"]))
        for r in res.get("bwd_kernel_shapes", []):
            for key in ("dq", "dkdv"):
                table.setdefault((f"flash_bwd_{key}", r["shape"]),
                                 []).append((label, r[key]["ms"]))
    rows = []
    for (kernel, shape), times in table.items():
        par = [t for lab, t in times if lab == "parent"]
        chg = [t for lab, t in times if lab == "change"]
        if len(par) != 2 or len(chg) != 2:
            continue
        speedup = statistics.mean(par) / statistics.mean(chg)
        rows.append({"kernel": kernel, "shape": shape, "parent_ms": par,
                     "change_ms": chg, "speedup": speedup})
        log(f"compare {kernel} [{shape}]: parent {par[0]:.4f} / "
            f"{par[1]:.4f} ms, change {chg[0]:.4f} / {chg[1]:.4f} ms: "
            f"{speedup:.2f}x")
    (out_dir / "compare.json").write_text(json.dumps(rows, indent=1))
    return 0


PHASES = ("card", "build", "kernels", "train", "moe", "serve", "shard",
          "seq", "entry", "vit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a partial run prints no final result)")
    ap.add_argument("--compare", metavar="PARENT",
                    help="run PARENT/chip_smoke.py (a checkout of the "
                    "parent commit) and this tree's, build and kernels "
                    "phases, parent, change, change, parent, and print "
                    "the times side by side (writes under "
                    "build/compare)")
    ap.add_argument("--plant", metavar="FAULTS",
                    help="comma-separated subset of " + ",".join(
                        [*PLANTS, *SHARD_PLANTS, *SHARD_ENGINE_PLANTS,
                         *SEQ_PLANTS])
                    + ": build, then run the moe replica and its token "
                    "check (or the shard phase's dp x tp trainer, or the "
                    "seq phase's pipeline, and its check) once with each "
                    "fault planted, and print what the check reads (exits "
                    "0 only if it refuses each)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--serve-child", help=argparse.SUPPRESS)
    ap.add_argument("--gloo-probe", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    faults = [f for f in (args.plant or "").split(",") if f]
    unknown = (set(faults) - set(PLANTS) - set(SHARD_PLANTS)
               - set(SHARD_ENGINE_PLANTS) - set(SEQ_PLANTS))
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    if not (ROOT / "tpushare_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no tpushare_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.child is not None:
        return child(json.loads(args.child))
    if args.serve_child is not None:
        return serve_child(json.loads(args.serve_child))
    if args.gloo_probe is not None:
        return gloo_probe(args.gloo_probe)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    if args.compare:
        return compare(Path(args.compare).resolve(),
                       ROOT / "build" / "compare")
    if faults:
        return planted(faults, args.out)

    smoke = Smoke()
    ok = True
    for name in ("card", *[p for p in PHASES[1:] if p in phases]):
        t0 = time.perf_counter()
        try:
            getattr(smoke, name)()
        except Exception:  # noqa: BLE001 -- report every phase's failure
            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            ok = False
            break
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(smoke.results, indent=1))
    if not ok:
        return 1
    if tuple(phases) != PHASES:
        log("chip_smoke: partial run, no result line")
        return 0
    log(json.dumps({"kernels": smoke.kernel_line()}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
