"""Start-up check of the PyTorch/CUDA port (graphtrans_tpu_torch) on one
NVIDIA card.

usage: python3 chip_smoke.py [--trace trace.json] [--baseline DIR]

``--baseline DIR`` names a checkout of an earlier commit (its
graphtrans_tpu_torch/ tree; for one run, never committed): phases 2, 6a,
7a-13a then build its K1, K1-bwd, K2, K3, K3-bwd, K4, K5 and K9 (forward,
serving and training), K2-bwd, K4-bwd, K5-bwd, K6-bwd, K7, K7-bwd, K8,
K6, K8-dx, K9-bwd, K10, K10-bwd and K12 from its own sources and time
them beside this tree's, in turns (earlier, this, this, earlier; K12 in
the alternating rounds of 13a), on the same inputs; phases 2, 6a, 7a, 8a,
12a and 13a hold K1, K1-bwd, K7, K7-bwd, K6-bwd (dx and demb; dw within
K6_TOL), K8's forward and K8-dx to its bits, and 12a reports K6's largest
difference from it (0: its bits); phase 14a times its K2 and K2-bwd bf16
instances beside this tree's and the f32 instances, in turns, prints their
errors against the plain bf16 versions, and holds this tree's f32 K2 and
K2-bwd to its bits.

Phases, each printing one line (any failure raises and exits non-zero):
  0. the card (nvidia-smi name and power limit) and torch; TF32 off;
  1. builds the CUDA kernels from graphtrans_tpu_torch/csrc (nvcc, sm_90a);
  2. holds each kernel against its plain PyTorch version at the serving
     shapes (molpcba snapshot batches of 64, and one 4096-graph synthetic
     batch), and times kernel, plain version, bound and library yardstick;
  3. serves every graph of the molpcba snapshot (all three splits, batches
     of 64) through graphtrans_tpu_torch.predict at the published config's
     full width with random weights, counting kernel launches, and checks
     the logits through the kernels against the plain versions on the card;
  4. times the forward of one 4096-graph molpcba-shaped batch, and one
     snapshot batch of 64 from collation to logits on the host;
  5. profiles that 4096-graph forward with torch.profiler: device busy time,
     idle share and device time by layer (``--trace`` also writes the
     chrome trace);
  6. training: (a) holds the backward kernels K1-bwd and K2-bwd, and K2
     with dropout, against autograd through their plain versions at the
     serving and 4096-graph shapes, and times them beside bound, plain
     backward and library yardstick; (b) trains the published config at
     full width on the snapshot through ``python -m
     graphtrans_tpu_torch.main`` (2 epochs, batches of 64), counting kernel
     launches, checking finite epoch losses and moved parameters, and holds
     one train step through the kernels against the plain versions on the
     card; (c) times the train step on the 4096-graph batch, with peak
     memory and a torch.profiler split by layer;
  7. code2 serving (the published GCN-virtual config, flat layout, packing
     tiers 1024/512, 384, 128): (a) holds K3 (flash_hil_seg) and K7 (spmm)
     against their plain versions at the code2 snapshot's shapes and at the
     512-graph bench shape, and times them (K7 as the GCN layer calls it,
     with the batch's DstOrder, whose one-time cost prints apart, its
     device time from the profiler, and a batch's worth: a new DstOrder
     and 5 calls, in turns with the parent's 5 calls); K2 at the bench batch's 384 and
     128 tiers, held and timed beside bound, plain version and SDPA; (b)
     serves the code2 snapshot's
     valid and test splits through ``python -m graphtrans_tpu_torch.predict``
     (batches of 16), counting K2, K3 and K7 launches, checking records and
     F1, and holds the logits through the kernels against the plain
     versions on the card; (c) times and profiles the forward of one
     512-graph code2-shaped batch;
  8. code2 training: (a) holds K3 with dropout and the backward kernels
     K3-bwd and K7-bwd against their plain versions and autograd at the
     snapshot's train-batch shape and the 512-graph shape, and times them
     beside bound, plain backward and library yardstick (with
     ``--baseline``, K3-bwd also beside the earlier design's); K2 with
     dropout and K2-bwd at the bench batch's 384 and 128 tiers; (b) trains the
     published code2 config at full width on the snapshot through ``python
     -m graphtrans_tpu_torch.main`` (2 epochs, batches of 16), counting
     launches, checking finite losses and moved parameters, and holds one
     step through the kernels against the plain versions on the card; (c)
     times the train step on the 512-graph batch, with peak memory and a
     torch.profiler split by layer;
  9. the Transformer-only model (configs/{molpcba,code2}/transformer/
     pooling=cls.yml: no GNN, a dense batch with a CLS column, d_model 256,
     4 heads, 5 layers): (a) holds K4 (attention_dense) and K5
     (flash_attention) against their plain versions at its snapshot and
     bench shapes (K4 at blocks 49 and 33 on its tile instance, block 0 at
     rows of 257 and 384 on its long one, hd 64 and 32; K5 also in both tag
     forms at hd 32, 64 and 128, rates 0 and 0.3, with m and l against the
     plain scores), with the rows the function leaves zero, and times them
     beside bound, plain version and SDPA (with ``--baseline``, beside the
     earlier design's; K5 at bench512 also at hd 32 and 128, and at hd 64
     with n = 0, 1, 64, 128, 256 valid keys a row); (b) serves both ymls on the
     snapshot through ``python -m graphtrans_tpu_torch.predict`` (molpcba:
     three splits, K4 on rows of two 49-token graphs, every launch on its
     tile instance; code2: valid and train take K5, test takes neither),
     counting launches per split, and
     holds the logits through the kernels against the plain versions on the
     card; (c) times and profiles the forward of 4096 molecules and of 512
     ASTs in the flat unpacked layout;
 10. training the Transformer-only model: (a) holds K4 and K5 with
     attention dropout 0.3 and their backward kernels K4-bwd and K5-bwd
     against the plain versions (the same masks) and autograd at the
     snapshot's and bench shapes (K4 also at rows of 257 and 384, hd 64),
     and K11 (byte_dropout) forward and backward against its plain version
     at the bench512 activations' widths, and times them beside bound,
     plain version and library yardstick, with m and l against the plain
     scores (with ``--baseline``, K4-bwd and K5-bwd and the training
     forwards also beside the earlier design's); (b) trains both ymls at full
     width on the snapshot through ``python -m graphtrans_tpu_torch.main`` (2
     epochs), counting launches per yml (molpcba K4, on its tile instance,
     and K4-bwd, code2 K5 and K5-bwd), checking finite losses and moved
     parameters, and holds one
     step through the kernels against the plain versions; (c) times the
     train step of 4096 molecules and of 512 ASTs with peak memory and a
     torch.profiler split, then again with K11 switched on;
 11. the attention-backend switch: (a) holds K9 (attention_smalls) and
     K9-bwd at rates 0 and 0.3 on the molpcba snapshot's rows of 49, 4096
     molecules' rows of 33 (smalls) and packed rows of 99 (packed_smalls),
     code2's rows of 1001 and packed blocks of 150 (K9's long forward),
     with m and l against the plain scores, and K10 (transformer_layer, one
     whole encoder layer) and K10-bwd at [1366, 99, 256] and the snapshot's
     rows of 98,
     against their plain versions and autograd, timed beside bound, plain
     version and library yardstick (K9-bwd also at code2's rows cut to 257,
     its wide instance; with ``--baseline``, K9, K9-bwd, K10 and K10-bwd
     also beside the earlier design's); (b) serves the molpcba
     Transformer-only yml through predict under --attn_backend smalls and
     packed_smalls and
     under packed_layer set in process (launches per backend, K4's
     forward inside K10 on its tile instance, logits
     against the plain versions and against auto), trains it 2 epochs
     through main under smalls and packed_layer (launches, losses, moved
     parameters, one step against the plain route), and serves the code2
     GraphTrans yml under --attn_backend flash (K5 on its 384-wide tier,
     logits against auto); (c) times and profiles the 4096-molecule forward
     and train step under auto, smalls, packed_smalls and packed_layer;
 12. NCI1 (configs/NCI1/gnn-transformer/no-virtual/gd=128+gdp=0.1+tdp=0.1+
     l=3+cosine.yml: GCN 5 x 128 without a virtual node on the strided
     layout, JK=last, 3 encoder layers of 128 on packed rows of 128, 2
     classes; the synthetic TU fallback, 400 graphs): (a) holds K6
     (dense_agg: its instance with emb and its emb-less one, which takes
     emb None for NCI1's zero edge embeddings) and K6-bwd (its full and
     dx-only instances) against their plain versions and autograd at the
     yml's batch of 128 and a 4096-graph batch, relu on and off, with and
     without w, and times them at the main path's arguments beside bound,
     plain version and the JAX package's one-hot bmm formulation (both K6
     instances, K6-bwd's dx-only instance, which the NCI1 step launches,
     and its full instance, each against the parent's kernel in turns
     under ``--baseline``), and K6's two launches (channel slices of 32 and
     K7's vector rule) in turns from 129 to 4097 graphs;
     (b) serves the three splits through ``python -m
     graphtrans_tpu_torch.predict`` (records, accuracy, 5 K6 and 3 K2
     launches a batch, every K6 launch emb-less, logits against the plain
     versions) and the Transformer-only NCI1 yml's test split (K4), trains
     both ymls 2 epochs through ``python -m graphtrans_tpu_torch.main``
     (launches, every K6 launch emb-less and every K6-bwd launch the
     dx-only instance, losses, moved parameters) and
     holds one NCI1 step through the kernels against the plain route; (c) times and profiles the forward and the train step
     of the 4096-graph batch, and times the step at the yml's batch;
 13. code2 GCN through the block plans (K8) and K12: (a) holds K8
     (blocked_gather_message_scatter: its forward over the batch's
     SlotOrder, the same bits with a new order and without the src-major
     plan), K8-demb and K8-dx against their plain versions and autograd
     at the code2 snapshot's train batch of 16 and the 512-graph batch,
     both collated with plans at chunk_capacity(edge cap, node cap), and
     K12 (segment_sum_mxu, a standalone op: its one call, counted) at
     [196608, 128], and times them beside bound, plain version and
     yardstick (K8's forward and K8-dx as the GCN layer calls them, each
     with its SlotOrder timed apart (K8-dx's of the src-major plan,
     reading the dst-major copies through fwd_slot), a batch's worth, a
     new order and 5 calls, and its device time from the profiler, each in
     turns with the parent's kernel under ``--baseline``, whose bits they
     must give; K7 and K7-bwd at the same batch; index_add_ for K12,
     the two, and with ``--baseline`` the parent's K12, in alternating
     turns over K12_ROUNDS rounds; K12's device time from the profiler,
     and the same bits in a second call); (b) serves the code2 valid and
     test splits through ``predict.predict_split`` with the model of
     ``predict.build_model`` under ``set_block_spmm(model, "on")`` (no
     batch overflows its plans; 5 K8 and no K7 launches a batch, the edge
     encoder once a layer, on the dst-major plan's slots), holds the
     logits of all three splits against the plain versions and the K7
     route, and takes one train step of ``main.build_run``'s model (5 K8,
     5 K8-demb, 5 K8-dx; the edge encoder once a layer, on the dst-major
     plan's slots, the rows K8-dx reads through fwd_slot bitwise equal to
     the src-major copy on every real slot) against the plain versions and
     the K7 route; (c) times the 512-graph forward and train step on the
     blocked route, with peak memory, beside the K7 route, and profiles
     both routes' forward and the blocked step;
 14. (a) K1, K1-bwd, K2 and K2-bwd in bf16 against their plain bf16
     versions at serve64 and bench4096 (K2's pair: bf16 rows, a warp a
     16-query tile, bf16 mma.sync), timed as the bf16 step calls them
     beside the f32 instance in turns, bound, plain version and, for K2
     and K2-bwd, SDPA in bf16; (b) trains the molpcba GraphTrans yml in
     bf16 through main (every K1, K1-bwd, K2 and K2-bwd launch the bf16
     instance); (c) a bf16 step against the plain versions; (d) the
     4096-graph train step in f32 and bf16 in turns, profiled.
 15. (a) K2's long instance (code2's tier of 384), K3, K7 and their
     backwards in bf16 (the bf16 long forward and pair: tiles inside one
     graph's run, K2's partners staged once, K3's through a ring of
     chunks; bf16 mma.sync; K7 and K7-bwd with float32 sums) against
     their plain bf16 versions at the code2 snapshot's train batch of 16
     and bench512 (padding 0, m = -inf, l = 0), timed as the bf16 step
     calls them beside the f32 instance in turns (the forwards and the
     pairs also beside, with ``--baseline``, the parent's bf16 forward and
     pair; K2 and K3 by ``queued_ms``, a call at a time behind a sleep,
     cold L2, so that the host's pace does not set their time at the batch
     of 16; the forwards also back to back), bound, plain version and, for
     K2 and K3, SDPA in bf16; the forwards' and the pairs' residency
     (registers, shared bytes, blocks an SM, waves; no spills, or it
     fails); with ``--baseline`` the forwards' and the pairs' largest
     difference from the parent's (the pairs' on this forward's out, m and
     l, within BF16_GRAD_TOL), and the f32 long launches of K2, K3, K5 and
     K9 and the f32 K7 and K7-bwd held to the parent's bits; (b) trains the
     code2 GraphTrans yml in bf16 through main (every K2, K3 and K7 launch
     and every backward launch the bf16 instance, counted by instance);
     (c) the saved float32 masters served by predict, and a bf16 step
     against the plain versions under deterministic algorithms; (d) the
     512-graph code2 train step in f32 and bf16 in turns (with
     ``--baseline`` also the bf16 step on the parent's K2 and K3
     forwards), profiled, with the K2 and K3 forwards' share.
 16. the Transformer-only model in bf16 (heads of 64): (a) K4's bf16
     instances (tile at bench4096's packed rows of 3 x 33, long at
     code2's rows cut to 383), K5's (bench512's rows of 1001) and their
     backwards (the bf16 key-list bodies; K4-bwd's short instance the
     whole backward of a graph block in one kernel) against their plain
     bf16 versions at rates 0 and 0.3 (queries without a key and padding
     keys exactly 0, m = -inf, l = 0), each timed as the bf16 step calls
     it, a call at a time behind a sleep with a cold L2, in turns with the
     f32 instance, beside bound, plain version and SDPA in bf16 under the
     same bool mask (forward and backward), with each kernel's residency
     (no spills, or it fails); with ``--baseline`` K2's and K3's bf16
     instances (heads of 32) held to the parent's bits; (b) trains the
     molpcba and code2 Transformer-only ymls in bf16 through main (every
     K4, K4-bwd, K5 and K5-bwd launch the bf16 instance, counted by
     instance, the attention routes by layer call; finite losses, every
     parameter moved, the saved state float32) and holds one bf16 step of
     each through the kernels against the plain bf16 versions under
     deterministic algorithms; (c) the cells tf-train4096-bf16 and
     tf-train512-bf16: each step in f32 and bf16 in turns, profiled.
Then the script's wall seconds, a {"kernels": [...]} line, the nvidia-smi
line, and the contract line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(
    REPO, "configs/molpcba/gnn-transformer/JK=cat/pooling=cls+gin+norm_input.yml")
CODE2_CONFIG = os.path.join(
    REPO, "configs/code2/gnn-transformer/JK=cat/pooling=cls+norm_input.yml")
TF_MOL_CONFIG = os.path.join(REPO,
                             "configs/molpcba/transformer/pooling=cls.yml")
TF_CODE2_CONFIG = os.path.join(REPO,
                               "configs/code2/transformer/pooling=cls.yml")
NCI1_CONFIG = os.path.join(
    REPO, "configs/NCI1/gnn-transformer/no-virtual/"
    "gd=128+gdp=0.1+tdp=0.1+l=3+cosine.yml")
TF_NCI1_CONFIG = os.path.join(REPO, "configs/NCI1/transformer/pooling=cls.yml")
SNAPSHOT = os.path.join(REPO, "data_snapshots")
BATCH = 64
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
TF32_TC_FLOPS = 495e12      # H100 SXM TF32 on the tensor cores, dense
K1_TOL, K2_TOL, LOGITS_TOL = 1e-5, 2e-5, 1e-4
# gradients; a gradient summed over the whole batch (K1's dT and dscale,
# parameter gradients) is held to GRAD_TOL * max(1, max |reference|)
GRAD_TOL = 5e-4
GIN_LAYERS_PER_FORWARD, ENCODER_LAYERS_PER_FORWARD = 5, 4
PROFILED_FORWARDS = 5
TRAIN_EPOCHS, DROPOUT = 2, 0.3
TIMED_STEPS, PROFILED_STEPS = 10, 3
# the molpcba forward and train step measured before the code2 slice on
# this card type (PERF.md, bench4096), printed beside this run's
EARLIER_FORWARD_MS, EARLIER_STEP_MS = 46.094, 166.506
# code2 (phase 7): the yml's batch size, the bench batch, the kernels' bounds
CODE2_BATCH, CODE2_BENCH = 16, 512
K3_TOL = 2e-5
K7_TOL = 1e-5      # times max(1, max |reference|)
GCN_LAYERS_PER_FORWARD = 5
# NCI1 (phase 12): the throughput batch; K6 forward against its plain version
NCI1_BENCH, K6_TOL = 4096, 1e-5
# phase 13: K8's forward and K12 against their plain versions, times
# max(1, max |reference|)
K8_TOL = 1e-5
K12_ROUNDS = 7   # alternating turns of K12 and index_add_ in phase 13a
# kernel-name fragments -> the layer that launches them (phase 5)
LAYERS = (
    ("attention_smalls_fwd", "K9 attention_smalls"),
    ("attention_smalls_bwd", "K9-bwd attention_smalls_bwd"),
    ("layer_gemm", "K10 transformer_layer (products)"),
    ("layer_norm_fwd_kernel", "K10 transformer_layer (LayerNorm, sums)"),
    ("layer_norm_bwd_kernel", "K10 transformer_layer (LayerNorm, sums)"),
    ("layer_colsum", "K10 transformer_layer (LayerNorm, sums)"),
    ("layer_sum", "K10 transformer_layer (LayerNorm, sums)"),
    ("attention_dense_bwd", "K4-bwd attention_dense_bwd (K10's too)"),
    ("flash_attention_bwd", "K5-bwd flash_attention_bwd"),
    ("byte_dropout", "K11 byte_dropout"),
    ("flash_hil_bwd", "K3-bwd flash_hil_seg_bwd"),
    ("spmm_bwd", "K7-bwd spmm_bwd"),
    ("blocked_fwd", "K8 blocked_gather_message_scatter"),
    ("blocked_dx", "K8-dx blocked_gather_message_scatter_dx"),
    ("block_demb", "K8-demb blocked_gather_message_scatter_demb"),
    ("segment_sum_kernel", "K12 segment_sum_mxu"),
    ("radixsort", "sort (index backward, K7-bwd's src order, K8's slot "
     "order)"),
    ("flash_hil_fwd", "K3 flash_hil_seg"),
    ("flash_attention_fwd", "K5 flash_attention"),
    ("spmm_fwd", "K7 spmm (aggregation)"),
    ("dense_agg_fwd", "K6 dense_agg (aggregation)"),
    ("dense_agg_bwd", "K6-bwd dense_agg_bwd"),
    ("gin_agg_fwd", "K1 gin_agg (aggregation)"),
    ("attention_seg_fwd", "K2 attention_seg"),
    ("attention_dense_fwd", "K4 attention_dense (K10's too)"),
    ("gin_agg_bwd", "K1-bwd gin_agg_bwd"),
    ("sum_rows", "K6-bwd dense_agg_bwd (dw slices)"),
    ("attention_seg_bwd", "K2-bwd attention_seg_bwd"),
    ("multi_tensor", "AdamW (foreach)"),
    ("gemm", "matmul (Linear layers)"),
    ("nvjet", "matmul (Linear layers)"),
    ("layer_norm", "LayerNorm"),
    ("index", "gather / index_select / index_add / index_copy"),
    ("embedding", "embedding lookup"),
    ("reduce", "reductions (sums over rows)"),
    ("cat", "concatenation"),
)


def _smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median device ms per call over ``reps`` runs of ``iters`` calls,
    timed with CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / iters)
    return statistics.median(per)


BASELINE_KERNELS = ("attention_packed", "attention_smalls", "block_spmm",
                    "dense_agg", "flash_attention", "flash_hil", "gin_agg",
                    "scatter_mxu", "spmm", "transformer_layer")


def load_baseline(root):
    """The port package (graphtrans_tpu_torch) of the checkout at ``root``,
    imported under its own name so that it builds its own csrc/ into its
    own build directory: its kernel modules of BASELINE_KERNELS by name,
    or None without ``root``."""
    import importlib
    import importlib.util

    if root is None:
        return None
    pkg = os.path.join(os.path.abspath(root), "graphtrans_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "baseline_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules["baseline_port"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["baseline_port"])
    mods = {name: importlib.import_module(f"baseline_port.ops.kernels.{name}")
            for name in BASELINE_KERNELS}
    secs = importlib.import_module("baseline_port.ops.kernels._build").build(
        BASELINE_KERNELS)
    print(f"[1] built the earlier {', '.join(BASELINE_KERNELS)} from {root} "
          f"in {secs:.1f} s")
    return mods


def rounds_ms(fns, iters: int, timer=time_ms):
    """ms of each of ``fns`` timed in turns by ``timer``: each in order,
    then in reverse order, the mean of its two times; None where ``fns`` has
    None."""
    live = [f for f in fns if f is not None]
    got = {}
    for f in live + live[::-1]:
        got.setdefault(id(f), []).append(timer(f, iters=iters))
    return [None if f is None else statistics.mean(got[id(f)]) for f in fns]


def turns_ms(new, old, iters: int):
    """(this ms, earlier ms): ``new`` and ``old`` timed in turns (old, new,
    new, old), each the mean of its two ``time_ms``; earlier None without
    ``old``."""
    if old is None:
        return time_ms(new, iters=iters), None
    o1, n1, n2, o2 = (time_ms(f, iters=iters) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def same_bits(what: str, new, old, checked: list):
    """With ``old`` (the parent's kernel, under ``--baseline``): raise
    unless ``new()`` and ``old()`` give the same bits on the same inputs,
    output by output, and add ``what`` to ``checked``."""
    if old is None:
        return
    a, b = new(), old()
    a, b = ((t if isinstance(t, (tuple, list)) else (t,)) for t in (a, b))
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            diff = (None if x is None or y is None
                    else (x - y).abs().max().item())
            raise AssertionError(f"{what}: output {i} differs from the "
                                 f"parent's kernel's on the same inputs "
                                 f"(max |diff| {diff})")
    checked.append(what)


L2_FLUSH_BYTES = 256 << 20  # over five times the H100's 50 MB L2


def device_ms(fn, names, per_call: int = 1, iters: int = 20,
              tries: int = 4):
    """Device ms per call of ``fn`` from torch.profiler: the self device
    time of the kernels whose names hold any of ``names``, over ``iters``
    profiled calls after a warm-up, each call after a write of
    L2_FLUSH_BYTES, so that its inputs come from HBM (a cold L2, as on the
    main path, where other layers run between two calls). Unlike
    ``time_ms`` it leaves out the host's pacing of back-to-back calls (a
    wrapper's checks and launches). ``per_call`` is the kernels a call
    launches, each under a name of its own. The profiler drops some
    records (why is not known), so a profile that recorded another number
    of launches than ``per_call * iters`` is taken again, up to ``tries``
    profiles; where none is whole the time is None, not measured, and the
    mean over the launches recorded prints apart, as no reading."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    counts, means = [], []
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(n in e.key for n in names)]
        count = sum(e.count for e in seen)
        if count == per_call * iters:
            return sum(e.self_device_time_total for e in seen) / 1e3 / iters
        counts.append(count)
        if len(seen) == per_call:
            means.append(sum(e.self_device_time_total / e.count
                             for e in seen) / 1e3)
    print(f"    (profiler: {counts} launches of {names} recorded in "
          f"{tries} profiles of {per_call * iters}: device time not "
          f"measured; apart, not a reading: the mean over those recorded "
          f"{', '.join(f'{m:.4f}' for m in means) or '-'} ms)")
    return None


def queued_ms(fn, iters: int = 20) -> float:
    """Device ms a call of ``fn``: the median over ``iters`` calls of CUDA
    events recorded around each call, each call queued behind a sleep
    kernel (``torch.cuda._sleep``, about 0.5 ms) and a write of
    L2_FLUSH_BYTES, so that the host's work a call (the wrapper's checks
    and launch) is done before the card reaches it and its inputs come
    from HBM: what the card spends on the call, where back-to-back calls
    are paced by the host and the profiler drops records."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def queued_turns(new, old):
    """(this, earlier) ``queued_ms`` of ``new`` and ``old`` (None without
    it), in turns (old, new, new, old)."""
    if old is None:
        return queued_ms(new), None
    o1, n1, n2, o2 = (queued_ms(f) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def host_us(new, old, iters: int = 200):
    """(this, earlier): host µs a call of ``new`` and ``old`` (None without
    it), in turns (old, new, new, old): the wall time of ``iters``
    back-to-back calls that wait for nothing on the card (their launches
    queue), after a warm-up. Where a call's device time is shorter, this
    is what paces a run of calls."""
    def one(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        return secs / iters * 1e6
    if old is None:
        return one(new), None
    o1, n1, n2, o2 = (one(f) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def alternating_ms(fns, rounds: int, iters: int):
    """Each of ``fns`` timed with ``time_ms`` once a round, in the same
    order every round, over ``rounds`` rounds: a list of ms per fn."""
    per = [[] for _ in fns]
    for _ in range(rounds):
        for k, fn in enumerate(fns):
            per[k].append(time_ms(fn, iters=iters))
    return per


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _bound(nbytes: int, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tc_bound(nbytes: int, tc_flops: float, simt_flops: float,
              tc_peak: float = TF32_TC_FLOPS):
    """As _bound with ``tc_flops`` on the tensor cores at ``tc_peak`` (TF32
    by default: a 3xTF32 product counts three passes) and ``simt_flops`` on
    the f32 units: the two kinds of unit run side by side, so the bound is
    the larger of the bytes' time and each unit's."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(tc_flops / tc_peak, simt_flops / F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _args(extra=()):
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.utils.config import parse_with_config

    return parse_with_config(predict.build_parser(), [
        "--configs", CONFIG, "--data_root", SNAPSHOT, "--batch_size",
        str(BATCH), "--seed", str(SEED), *extra])


def k1_inputs(batch, d: int, gen: torch.Generator, device):
    """K1's arguments as the first GIN layer gets them: random node rows
    (zero on padding rows), the bond tables, and the GIN scale 1+eps."""
    from graphtrans_tpu_torch.nn.encoders import BOND_FEATURE_DIMS
    from graphtrans_tpu_torch.ops.dense_mp import bond_table_index

    G, Sm = batch.num_graph_slots, batch.node_stride
    x = torch.randn(G * Sm, d, generator=gen)
    x[~torch.as_tensor(batch.node_mask)] = 0
    tb = batch.to(device)
    node_mask = tb.node_mask.reshape(G, Sm)
    tbl = torch.randn(sum(BOND_FEATURE_DIMS), d, generator=gen)
    w = torch.randn(tb.edge_src_dense.shape, generator=gen)
    return dict(
        x=x.reshape(G, Sm, d).to(device), src=tb.edge_src_dense,
        dst=tb.edge_dst_dense, emask=tb.edge_mask_dense,
        attr=bond_table_index(tb.edge_attr_dense, BOND_FEATURE_DIMS),
        tbl=tbl.to(device), w=w.to(device),
        scale=torch.tensor([1.1], device=device), node_mask=node_mask)


def k2_inputs(batch, d: int, gen: torch.Generator, device, pad_rows: int = 2):
    """K2's arguments on the packed rows of ``batch`` (random qkv), with
    ``pad_rows`` all-padding rows appended."""
    R, W = batch.pack_rows, batch.pack_w
    seg = torch.as_tensor(batch.pack_seg).reshape(R, W)
    seg = torch.cat([seg, torch.full((pad_rows, W), -1, dtype=seg.dtype)])
    qkv = torch.randn(R + pad_rows, W, 3 * d, generator=gen)
    return qkv.to(device), seg.to(device)


def check_k1(inp, with_w: bool):
    from graphtrans_tpu_torch.ops.kernels import gin_agg, gin_agg_plain

    args = (inp["x"], inp["src"], inp["dst"], inp["emask"], inp["attr"],
            inp["tbl"], inp["w"] if with_w else None,
            None if with_w else inp["scale"])
    got = gin_agg(*args)
    torch.cuda.synchronize()
    err = (got - gin_agg_plain(*args)).abs().max().item()
    if err > K1_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"max |diff| {err} > {K1_TOL}")
    if got[~inp["node_mask"]].any():
        raise AssertionError("K1: padding node rows are not zero")
    return err, args


def check_k2(qkv, seg, nhead: int):
    from graphtrans_tpu_torch.ops.kernels import (attention_seg,
                                                  attention_seg_plain)

    got = attention_seg(qkv, seg, nhead)
    torch.cuda.synchronize()
    err = (got - attention_seg_plain(qkv, seg, nhead)).abs().max().item()
    if err > K2_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"K2 disagrees with its plain version: "
                             f"max |diff| {err} > {K2_TOL}")
    if (got[seg < 0] != 0).any():
        raise AssertionError("K2: padding queries are not exactly zero")
    return err


def k1_bound(args):
    x, src, dst, emask, attr, tbl, w, scale = args
    G, Sm, d = x.shape
    nbytes = sum(t.numel() * t.element_size() for t in args if t is not None)
    nbytes += x.numel() * x.element_size()                  # out
    per_edge = attr.shape[1] + 3 + (1 if w is not None else 0)
    flops = int(emask.sum().item()) * d * per_edge
    if scale is not None:
        flops += 2 * G * Sm * d
    return _bound(nbytes, flops)


def k2_bound(qkv, seg, nhead: int, tensor_cores: bool = False):
    """K2 reads qkv and seg and writes out; the operations of _fwd_bound for
    the same-segment pairs of every head, f32 SIMT as the tile instance
    (rows of up to 128) computes them, or with ``tensor_cores`` 3xTF32 as
    the long instance's forward does."""
    R, W, d3 = qkv.shape
    hd = d3 // 3 // nhead
    _, counts = torch.unique(seg[seg >= 0], return_counts=True)
    pairs = int((counts.long() ** 2).sum().item())   # same-segment (q, k)
    e = qkv.element_size()
    nbytes = (qkv.numel() * e + seg.numel() * 4 + R * W * (d3 // 3) * e)
    return _fwd_bound(nbytes, pairs * nhead, hd, tensor_cores)


def k2_instances() -> str:
    """K2's and K2-bwd's launches since the last reset by instance ("tile",
    "long"), for a main path's launch line; raises if they do not add up to
    the launch counts."""
    from graphtrans_tpu_torch.ops import kernels

    for fn in (kernels.attention_seg, kernels.attention_seg_bwd):
        if sum(fn.instances.values()) != fn.launches:
            raise AssertionError(f"{fn.__name__}: instances {fn.instances} "
                                 f"do not add up to {fn.launches} launches")
    return (f"; K2 by instance {dict(kernels.attention_seg.instances)}, "
            f"K2-bwd {dict(kernels.attention_seg_bwd.instances)}")


def k6_bwd_instances() -> str:
    """K6-bwd's launches by instance, for the main-path launch lines."""
    from graphtrans_tpu_torch.ops.kernels import dense_agg_bwd

    n = {k: v for k, v in dense_agg_bwd.instances.items() if v}
    return f"; K6-bwd by instance {n}" if n else ""


def sdpa_mask_ms(qkv, mask, nhead: int, iters: int = 20,
                 timer=time_ms) -> float:
    """Yardstick only: torch's scaled_dot_product_attention with a boolean
    mask [B, 1, S or 1, S] on the same inputs (never called by the port),
    timed by ``timer``."""
    B, S, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(B, S, nhead, d // nhead).transpose(1, 2).contiguous()
               for t in qkv.split(d, dim=-1))
    f = torch.nn.functional.scaled_dot_product_attention
    return timer(lambda: f(q, k, v, attn_mask=mask), iters=iters)


def sdpa_ms(qkv, seg, nhead: int, timer=time_ms) -> float:
    """``sdpa_mask_ms`` with the segment mask of K2 and K3."""
    mask = ((seg[:, :, None] == seg[:, None, :])
            & (seg >= 0)[:, None, :])[:, None]
    return sdpa_mask_ms(qkv, mask, nhead, timer=timer)


def print_k1_launch(name: str, args, device, gin_agg, base=None):
    """K1's forward launch at ``args`` (fwd_geometry), its device time from
    the profiler, cold L2, and its host time a call (``host_us``), each
    beside the parent's with ``base``: the CUDA-event time printed after
    it is the larger of the two where calls run back to back."""
    from graphtrans_tpu_torch.ops.kernels import gin_agg as k1_mod

    mod = sys.modules[k1_mod.__module__]
    x, src, dst, emask, attr, tbl, w, scale = args
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    geo = mod.fwd_geometry(*x.shape[:2], src.shape[1], attr.shape[1],
                           tbl.shape[0], x.shape[2], w is not None, sms)
    old_fn = base and (lambda: base["gin_agg"].gin_agg(*args))
    dev = device_ms(lambda: gin_agg(*args), ("gin_agg_fwd",))
    host = host_us(lambda: gin_agg(*args), old_fn)
    line = (f"[2] {name} K1 launch: vec {geo.vec}, gpb {geo.gpb}, grid "
            f"{geo.grid} x {geo.threads}, {geo.smem} B; device time "
            f"{_ms(dev)} a launch (profiler, cold L2)")
    if base:
        line += f", the parent's {_ms(device_ms(old_fn, ('gin_agg_fwd',)))}"
    line += f"; host {host[0]:.1f} µs a call"
    if base:
        line += f" (the parent's {host[1]:.1f}, in turns)"
    print(line)


def phase2(device, d_gnn: int, d_model: int, nhead: int, big, base=None):
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.mol import load_mol_splits
    from graphtrans_tpu_torch.ops.kernels import (attention_seg,
                                                  attention_seg_plain,
                                                  gin_agg, gin_agg_plain)
    from graphtrans_tpu_torch.predict import serving_layout

    gen = torch.Generator().manual_seed(SEED)
    splits, num_tasks = load_mol_splits(SNAPSHOT, "ogbg-molpcba")
    layout = serving_layout(splits, _args(), num_tasks)
    serve = next(iterate_batches(splits["train"], **layout))
    k1_err = k2_err = 0.0
    for b in (serve, big):
        inp = k1_inputs(b, d_gnn, gen, device)
        for with_w in (False, True):
            k1_err = max(k1_err, check_k1(inp, with_w)[0])
        qkv, seg = k2_inputs(b, d_model, gen, device)
        k2_err = max(k2_err, check_k2(qkv, seg, nhead))
    print(f"[2] kernels agree with their plain versions at serving shapes: "
          f"K1 max |diff| {k1_err:.3g} (<= {K1_TOL}), K2 max |diff| "
          f"{k2_err:.3g} (<= {K2_TOL}), padding queries exactly 0")

    rows, same, k1_by_shape = [], [], {}
    for name, b in (("serve64", serve), ("bench4096", big)):
        inp = k1_inputs(b, d_gnn, gen, device)
        for with_w in (True, False):
            _, args = check_k1(inp, with_w)
            same_bits(f"K1 {name} ({'w' if with_w else 'scale'})",
                      lambda: gin_agg(*args),
                      base and (lambda: base["gin_agg"].gin_agg(*args)), same)
        # timed as the main path calls it: the GIN scale, no edge weight
        ms, earlier = turns_ms(
            lambda: gin_agg(*args),
            base and (lambda: base["gin_agg"].gin_agg(*args)), 20)
        k1 = dict(ms=ms, earlier_ms=earlier,
                  plain_ms=time_ms(lambda: gin_agg_plain(*args), iters=5),
                  library_ms=None)
        k1["bound_ms"], k1["bound_by"] = k1_bound(args)
        k1_by_shape[name] = k1
        print_k1_launch(name, args, device, gin_agg, base)
        qkv, seg = k2_inputs(b, d_model, gen, device, pad_rows=0)
        ms, earlier = turns_ms(
            lambda: attention_seg(qkv, seg, nhead),
            base and (lambda: base["attention_packed"].attention_seg(
                qkv, seg, nhead)), 20)
        k2 = dict(ms=ms, earlier_ms=earlier,
                  plain_ms=time_ms(
                      lambda: attention_seg_plain(qkv, seg, nhead), iters=5),
                  library_ms=sdpa_ms(qkv, seg, nhead))
        k2["bound_ms"], k2["bound_by"] = k2_bound(qkv, seg, nhead)
        k1["shape"] = "G={} Sm={} Em={} d={}".format(
            *inp["x"].shape[:2], inp["src"].shape[1], d_gnn)
        k2["shape"] = f"R={qkv.shape[0]} W={qkv.shape[1]} d={d_model} H={nhead}"
        for kname, t in (("K1 gin_agg", k1), ("K2 attention_seg", k2)):
            lib = ("-" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f}")
            earlier = ("" if "earlier_ms" not in t else
                       f" (the parent's {_ms(t['earlier_ms'])}, in turns)")
            print(f"[2] {name} {kname} [{t['shape']}]: kernel "
                  f"{t['ms']:.4f} ms{earlier}, plain {t['plain_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library "
                  f"{lib} ms")
        rows.append((k1, k2))
    print(f"[2] K1 gin_agg at both shapes, in turns with the parent's kernel: "
          + "; ".join(f"{n} {t['ms']:.4f} ms (the parent's "
                      f"{_ms(t['earlier_ms'])}, bound {t['bound_ms']:.4f})"
                      for n, t in k1_by_shape.items()))
    if base:
        print(f"[2] --baseline: K1's forward gives the parent's bits on the "
              f"same inputs at {same}")
    return dict(k1_err=k1_err, k2_err=k2_err, timed=rows[-1])


def phase3(device, tmp: str):
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.mol import load_mol_splits
    from graphtrans_tpu_torch.ops import kernels

    splits, num_tasks = load_mol_splits(SNAPSHOT, "ogbg-molpcba")
    kernels.reset_launches()                 # the main path starts here
    batches = records = 0
    t0 = time.perf_counter()
    for split in ("train", "valid", "test"):
        out = os.path.join(tmp, f"{split}.jsonl")
        res = predict.main(["--configs", CONFIG, "--data_root", SNAPSHOT,
                            "--split", split, "--batch_size", str(BATCH),
                            "--seed", str(SEED), "--out", out])
        recs = [json.loads(line) for line in open(out)]
        if (len(recs) != len(splits[split])
                or sorted(r["graph_id"] for r in recs)
                != list(range(len(splits[split])))):
            raise AssertionError(f"{split}: {len(recs)} records for "
                                 f"{len(splits[split])} graphs")
        if not all(len(r["logits"]) == num_tasks
                   and all(math.isfinite(v) for v in r["logits"])
                   for r in recs):
            raise AssertionError(f"{split}: logits not finite or not "
                                 f"{num_tasks} wide")
        batches += res["batches"]
        records += res["records"]
    secs = time.perf_counter() - t0
    launches = {"gin_agg": kernels.gin_agg.launches,
                "attention_seg": kernels.attention_seg.launches}
    by_instance = k2_instances()
    want = {"gin_agg": GIN_LAYERS_PER_FORWARD * batches,
            "attention_seg": ENCODER_LAYERS_PER_FORWARD * batches}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    print(f"[3] served {records} graphs of the molpcba snapshot in {batches} "
          f"batches of <= {BATCH} ({secs:.2f} s with model builds); "
          f"launches {launches} = 5 and 4 per batch{by_instance}")

    args = _args()
    layout = predict.serving_layout(splits, args, num_tasks)
    model = predict.build_model(args, num_tasks, device)
    err = 0.0
    with torch.inference_mode():
        for split in ("train", "valid", "test"):
            for b in iterate_batches(splits[split], **layout):
                tb = b.to(device)
                gm = tb.graph_mask
                got = model(tb)[gm]
                kernels.set_kernels(model, False)
                want = model(tb)[gm]
                kernels.set_kernels(model, True)
                err = max(err, (got - want).abs().max().item())
    if err > LOGITS_TOL:
        raise AssertionError(f"logits through the kernels differ from the "
                             f"plain versions by {err} > {LOGITS_TOL}")
    print(f"[3] logits through the kernels match the plain versions on the "
          f"card: max |diff| {err:.3g} (<= {LOGITS_TOL})")
    return launches


def _median_ms(fn, n: int):
    per = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per), min(per), max(per), out


def phase4(device, big, smi: str):
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.mol import load_mol_splits

    args = _args()
    model = predict.build_model(args, 128, device)
    splits, num_tasks = load_mol_splits(SNAPSHOT, "ogbg-molpcba")
    layout = predict.serving_layout(splits, args, num_tasks)
    graphs = splits["train"][:BATCH]
    small = next(iterate_batches(graphs, **layout))
    tb = big.to(device)
    n = int(big.graph_mask.sum())
    with torch.inference_mode():
        _median_ms(lambda: model(tb), 3)                    # warm-up
        ms, lo, hi, out = _median_ms(lambda: model(tb), 10)
        if not torch.isfinite(out[tb.graph_mask]).all():
            raise AssertionError("throughput batch: logits not finite")
        coll = _median_ms(lambda: next(iterate_batches(graphs, **layout)),
                          10)[0]
        req = _median_ms(lambda: model(small.to(device)).cpu(), 20)
    print(f"[4] forward of {n} graphs (stride {big.node_stride}, "
          f"{big.pack_rows} packed rows of {big.pack_w}): median {ms:.3f} ms "
          f"over 10 (min {lo:.3f}, max {hi:.3f}), {n / ms * 1e3:.0f} "
          f"graphs/s on {smi} (earlier: {EARLIER_FORWARD_MS} ms)")
    print(f"[4] one snapshot batch of {BATCH} graphs: collate {coll:.3f} ms "
          f"(host), copy in + forward + logits out median {req[0]:.3f} ms "
          f"over 20 (min {req[1]:.3f}, max {req[2]:.3f}) on {smi}")
    return model, tb


def _layer(name: str) -> str:
    low = name.lower()
    return next((layer for frag, layer in LAYERS if frag in low),
                "elementwise and other")


def phase5(model, tb, smi: str, trace):
    """Device time of the 4096-graph forward by layer, from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_FORWARDS):
                model(tb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FORWARDS
    if trace:
        prof.export_chrome_trace(trace)
    _print_split("[5]", "forward", prof, PROFILED_FORWARDS, wall, smi)


def _print_split(tag: str, what: str, prof, n: int, wall: float, smi: str,
                 graphs: int = 4096):
    """Device busy time, idle share and device time by layer of ``n``
    profiled runs of ``what`` on ``graphs`` graphs (wall ms per run), from
    torch.profiler."""
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               # a region such as Optimizer.step spans kernels counted apart
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(ms for _, ms, _ in kernels)
    if busy <= 0:
        raise AssertionError("the profiler saw no kernel time on the card")
    by_layer = collections.Counter()
    for name, ms, _ in kernels:
        by_layer[_layer(name)] += ms
    print(f"{tag} profiled {what} of {graphs} graphs: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f} on {smi}")
    for layer, ms in by_layer.most_common():
        print(f"{tag}   {layer:32s} {ms:9.3f} ms  {ms / busy:6.1%}")
    for name, ms, cnt in sorted(kernels, key=lambda k: -k[1])[:10]:
        print(f"{tag}   top {ms:9.3f} ms {cnt:5.0f}x  {name[:100]}")
    return busy, by_layer


# ---- phase 6: training -----------------------------------------------------


def _rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|): the error of a sum over
    the whole batch, in proportion to its size (bf16 taken as float)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max().item()
            / max(1.0, want.abs().max().item()))


def _plain_bwd_ms(fn, leaves, gout) -> float:
    """Device ms of a plain version's backward alone: ``autograd.grad``
    over one recorded forward of ``fn(*leaves)``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in leaves]
        out = fn(*leaves)
        return time_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                   retain_graph=True),
                       iters=5)


def check_k1_bwd(args, gout):
    """K1-bwd against autograd through the plain version: dx and dw
    absolute, dT and dscale (sums over every edge or node of the batch)
    relative to max(1, max |reference|)."""
    from graphtrans_tpu_torch.ops.kernels import gin_agg_bwd, gin_agg_bwd_plain

    got = gin_agg_bwd(*args, gout)
    torch.cuda.synchronize()
    want = gin_agg_bwd_plain(*args, gout)
    errs, abs_err = {}, 0.0
    for name, g, w in zip(("dx", "dT", "dw", "dscale"), got, want):
        if g is None:
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"K1-bwd: {name} not finite")
        diff = (g - w).abs().max().item()
        abs_err = max(abs_err, diff)
        errs[name] = (_rel_err(g, w) if name in ("dT", "dscale") else diff)
    if max(errs.values()) > GRAD_TOL:
        raise AssertionError(f"K1-bwd disagrees with autograd through its "
                             f"plain version: {errs} > {GRAD_TOL}")
    return max(errs.values()), abs_err


def check_k2_train(qkv, seg, nhead: int, rate: float, seed: int, gen):
    """K2 forward with dropout ``rate`` and K2-bwd against the plain
    version (the same mask) and its autograd."""
    from graphtrans_tpu_torch.ops.kernels import (attention_seg_bwd,
                                                  attention_seg_bwd_plain,
                                                  attention_seg_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_seg_with_stats)

    out, m, l = attention_seg_with_stats(qkv, seg, nhead, rate, seed)
    g = torch.randn(out.shape, generator=gen).to(qkv.device)
    dqkv = attention_seg_bwd(qkv, seg, nhead, g, (out, m, l), rate, seed)
    torch.cuda.synchronize()
    f_err = (out - attention_seg_plain(qkv, seg, nhead, rate, seed)
             ).abs().max().item()
    b_err = (dqkv - attention_seg_bwd_plain(qkv, seg, nhead, g, rate, seed)
             ).abs().max().item()
    if f_err > K2_TOL or b_err > GRAD_TOL or not torch.isfinite(dqkv).all():
        raise AssertionError(f"K2 at rate {rate}: forward |diff| {f_err} "
                             f"(<= {K2_TOL}), backward {b_err} (<= {GRAD_TOL})")
    if dqkv[seg < 0].any() or out[seg < 0].any():
        raise AssertionError("K2: padding tokens are not exactly zero")
    return f_err, b_err, g


def k1_bwd_bound(args, gout):
    x, src, dst, emask, attr, tbl, w, scale = args
    G, Sm, d = x.shape
    F = attr.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in args if t is not None)
    nbytes += (gout.numel() * gout.element_size()                  # gout, dx,
               + x.numel() * x.element_size()                      # dT
               + tbl.numel() * tbl.element_size())
    if w is not None:
        nbytes += w.numel() * w.element_size()                       # dw
    # per valid edge and channel: pre (F adds), the dmsg product, the dx
    # and F dT accumulations (+ the dw product and sum); per node cell the
    # scale*gout prologue and the dscale product and sum
    per_edge = 2 * F + 2 + (2 if w is not None else 0)
    flops = int(emask.sum().item()) * d * per_edge
    if scale is not None:
        flops += 3 * G * Sm * d
    return _bound(nbytes, flops)


def k2_bwd_bound(qkv, seg, nhead: int, tensor_cores: bool = False):
    """K2-bwd reads what K3-bwd reads (k3_bwd_bound), the forward's out, m
    and l among them; its products f32 SIMT as the tile instance (rows of
    up to 128) computes them, or with ``tensor_cores`` 3xTF32 as the long
    instance's long-row pair does."""
    return k3_bwd_bound(qkv, seg, nhead, tensor_cores)


def k3_bwd_bound(qkv, seg, nhead: int, tensor_cores: bool = True):
    """K3-bwd reads qkv, seg, the cotangent and the forward's out, m and l,
    and writes dqkv; per same-segment pair and head the score, dp = dO.v
    and the dq, dk and dv products (2*hd flops each) and the softmax and
    dropout arithmetic (8). By default the products are timed as the
    long-row backward runs them, 3xTF32 on the tensor cores
    (``tensor_cores=False``: the f32 SIMT bound, printed beside it)."""
    R, W, d3 = qkv.shape
    hd = d3 // 3 // nhead
    _, counts = torch.unique(seg[seg >= 0], return_counts=True)
    pairs = int((counts.long() ** 2).sum().item()) * nhead
    nbytes = (2 * qkv.numel() + seg.numel() + 2 * R * W * (d3 // 3)
              + 2 * R * W * nhead) * 4
    if not tensor_cores:
        return _bound(nbytes, pairs * (10 * hd + 8))
    return _tc_bound(nbytes, 3 * pairs * 10 * hd, pairs * 8)


def sdpa_bwd_ms(qkv, seg, nhead: int, g, rate: float,
                timer=time_ms) -> float:
    """``sdpa_bwd_mask_ms`` with the segment mask of K2 and K3."""
    mask = ((seg[:, :, None] == seg[:, None, :])
            & (seg >= 0)[:, None, :])[:, None]
    return sdpa_bwd_mask_ms(qkv, mask, nhead, g, rate, iters=10, timer=timer)


def sdpa_bwd_mask_ms(qkv, mask, nhead: int, g, rate: float,
                     iters: int = 3, timer=time_ms) -> float:
    """Yardstick only: the backward of torch's scaled_dot_product_attention
    with a boolean mask and the same dropout rate on the same inputs (never
    called by the port), timed by ``timer``."""
    B, S, d3 = qkv.shape
    d = d3 // 3
    heads = lambda t: t.reshape(B, S, nhead, d // nhead).transpose(1, 2)
    q, k, v = (heads(t).contiguous().requires_grad_()
               for t in qkv.split(d, dim=-1))
    gh = heads(g).contiguous()
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate)
        return timer(lambda: torch.autograd.grad(out, (q, k, v), gh,
                                                 retain_graph=True),
                     iters=iters)


def time_k2_train(qkv, seg, nhead: int, g, seed: int, base=None):
    """K2-bwd at the training dropout rate from the forward's saved
    statistics, beside plain backward, SDPA's backward, bound and (with
    ``base``) the parent's backward in turns; and K2's training forward
    (dropout, statistics) beside the parent's, and the serving forward."""
    from graphtrans_tpu_torch.ops.kernels import (attention_seg,
                                                  attention_seg_bwd,
                                                  attention_seg_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_seg_with_stats, seg_instance)

    saved = attention_seg_with_stats(qkv, seg, nhead, DROPOUT, seed)
    old = base and base["attention_packed"]
    ms, earlier = turns_ms(
        lambda: attention_seg_bwd(qkv, seg, nhead, g, saved, DROPOUT,
                                  seed),
        old and (lambda: old.attention_seg_bwd(qkv, seg, nhead, g, saved,
                                               DROPOUT, seed)), 20)
    k2 = dict(ms=ms, earlier_ms=earlier,
              plain_ms=_plain_bwd_ms(
                  lambda t: attention_seg_plain(t, seg, nhead, DROPOUT, seed),
                  [qkv], g),
              library_ms=sdpa_bwd_ms(qkv, seg, nhead, g, DROPOUT))
    long = seg_instance(qkv.shape[1]) == "long"
    k2["bound_ms"], k2["bound_by"] = k2_bwd_bound(qkv, seg, nhead, long)
    if long:
        k2["f32_simt_bound_ms"] = k2_bwd_bound(qkv, seg, nhead)[0]
    fwd_drop = turns_ms(
        lambda: attention_seg_with_stats(qkv, seg, nhead, DROPOUT, seed),
        old and (lambda: old.attention_seg(qkv, seg, nhead, DROPOUT, seed)),
        20)
    fwd_plain = time_ms(lambda: attention_seg(qkv, seg, nhead), iters=20)
    return k2, fwd_drop, fwd_plain


def phase6_kernels(device, d_gnn: int, d_model: int, nhead: int, big,
                   base=None):
    """(a) K1-bwd and K2-bwd (and K2 with dropout) against autograd through
    the plain versions at the serving and 4096-graph shapes; times, K2 and
    K2-bwd beside ``base``'s (the parent's) in turns."""
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.mol import load_mol_splits
    from graphtrans_tpu_torch.ops.kernels import gin_agg_bwd, gin_agg_plain
    from graphtrans_tpu_torch.ops.kernels.gin_agg import bwd_geometry
    from graphtrans_tpu_torch.predict import serving_layout

    gen = torch.Generator().manual_seed(SEED + 6)
    splits, num_tasks = load_mol_splits(SNAPSHOT, "ogbg-molpcba")
    serve = next(iterate_batches(splits["train"],
                                 **serving_layout(splits, _args(), num_tasks)))
    k1_err = k1_abs = k2_ferr = k2_err = 0.0
    rows, same = [], []
    for name, b in (("serve64", serve), ("bench4096", big)):
        inp = k1_inputs(b, d_gnn, gen, device)
        gout = torch.randn(inp["x"].shape, generator=gen).to(device)
        for with_w, with_scale in ((False, True), (True, False), (True, True)):
            args = (inp["x"], inp["src"], inp["dst"], inp["emask"],
                    inp["attr"], inp["tbl"], inp["w"] if with_w else None,
                    inp["scale"] if with_scale else None)
            err, err_abs = check_k1_bwd(args, gout)
            k1_err, k1_abs = max(k1_err, err), max(k1_abs, err_abs)
            same_bits(f"K1-bwd {name} (w {with_w}, scale {with_scale})",
                      lambda: gin_agg_bwd(*args, gout),
                      base and (lambda: base["gin_agg"].gin_agg_bwd(
                          *args, gout)), same)
        qkv, seg = k2_inputs(b, d_model, gen, device)
        for rate, seed in ((0.0, 0), (DROPOUT, 1234567 + len(rows))):
            f, e, _ = check_k2_train(qkv, seg, nhead, rate, seed, gen)
            k2_ferr, k2_err = max(k2_ferr, f), max(k2_err, e)

        # timed as the main path calls them: K1 with the GIN scale and no
        # edge weight, K2 at the training dropout rate
        args = (inp["x"], inp["src"], inp["dst"], inp["emask"], inp["attr"],
                inp["tbl"], None, inp["scale"])
        fixed = args[1:5]
        ms, earlier = turns_ms(
            lambda: gin_agg_bwd(*args, gout),
            base and (lambda: base["gin_agg"].gin_agg_bwd(*args, gout)), 20)
        k1 = dict(ms=ms, earlier_ms=earlier,
                  plain_ms=_plain_bwd_ms(
                      lambda x, t, sc: gin_agg_plain(x, *fixed, t, None, sc),
                      [args[0], args[5], args[7]], gout),
                  library_ms=None)
        k1["bound_ms"], k1["bound_by"] = k1_bwd_bound(args, gout)
        qkv, seg = k2_inputs(b, d_model, gen, device, pad_rows=0)
        seed = 7654321
        g = torch.randn(qkv.shape[0], qkv.shape[1], d_model,
                        generator=gen).to(device)
        k2, fwd_drop, fwd_plain = time_k2_train(qkv, seg, nhead, g, seed,
                                                base)
        k1["shape"] = "G={} Sm={} Em={} d={}".format(
            *inp["x"].shape[:2], inp["src"].shape[1], d_gnn)
        k2["shape"] = (f"R={qkv.shape[0]} W={qkv.shape[1]} d={d_model} "
                       f"H={nhead} rate={DROPOUT}")
        for kname, t in (("K1-bwd gin_agg_bwd", k1),
                         ("K2-bwd attention_seg_bwd", k2)):
            lib = ("-" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f}")
            print(f"[6a] {name} {kname} [{t['shape']}]: kernel "
                  f"{t['ms']:.4f} ms, plain backward {t['plain_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library "
                  f"{lib} ms")
        geo = bwd_geometry(
            *inp["x"].shape[:2], inp["src"].shape[1], inp["attr"].shape[1],
            inp["tbl"].shape[0], d_gnn, False,
            torch.cuda.get_device_properties(device).multi_processor_count)
        dev = device_ms(lambda: gin_agg_bwd(*args, gout), ("gin_agg_bwd",),
                        per_call=2)
        print(f"[6a] {name} K1-bwd: the parent's {_ms(k1['earlier_ms'])}, "
              f"in turns; launch: vec {geo.vec}, gpb {geo.gpb}, grid "
              f"{geo.grid} x {geo.threads}, {geo.smem} B; device time "
              f"{_ms(dev)} a call (profiler, cold L2: main and tail "
              f"kernels) against {k1['ms']:.4f} ms from CUDA events")
        print(f"[6a] {name} K2-bwd: the parent's {_ms(k2['earlier_ms'])}, "
              f"in turns; K2 forward with dropout {DROPOUT} and saved "
              f"statistics (training) {fwd_drop[0]:.4f} ms (the parent's "
              f"{_ms(fwd_drop[1])}), without dropout {fwd_plain:.4f} ms")
        rows.append((k1, k2))
    print(f"[6a] backward kernels agree with autograd through their plain "
          f"versions: K1-bwd max err {k1_err:.3g} (<= {GRAD_TOL}; dT and "
          f"dscale relative to max(1, max|ref|); max |diff| {k1_abs:.3g}), "
          f"K2 with dropout {DROPOUT}: forward {k2_ferr:.3g} (<= {K2_TOL}), "
          f"K2-bwd {k2_err:.3g} (<= {GRAD_TOL}); padding tokens exactly 0")
    if base:
        print(f"[6a] --baseline: K1-bwd gives the parent's bits (dx, dT, dw, "
              f"dscale) on the same inputs at {same}")
    return dict(k1_err=k1_err, k2_err=k2_err, timed=rows[-1])


def _train_args(extra=()):
    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch.utils.config import parse_with_config

    return parse_with_config(train_main.build_parser(), [
        "--configs", CONFIG, "--data_root", SNAPSHOT, "--epochs",
        str(TRAIN_EPOCHS), "--batch_size", str(BATCH), "--seed", str(SEED),
        *extra])


def _trainer(args, num_tasks: int, device, kernels_on: bool = True,
             data=None, bsp: str = "off"):
    """The entry point's model (weights from --seed) and train step with
    the dataset's loss (``data``: what ``predict.load_splits`` returns for
    code2 or a TU dataset, which sizes the model's encoders); ``bsp``, the
    model's ``set_block_spmm`` mode."""
    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch.ops.block_plan import set_block_spmm
    from graphtrans_tpu_torch.ops.kernels import set_kernels

    model, _, step = train_main.build_run(args, num_tasks, device, 1, data)
    return set_block_spmm(set_kernels(model, kernels_on), bsp), step


def phase6_train(device, tmp: str):
    """(b) The training entry at full width on the snapshot, its kernel
    launches, and one step through the kernels against the plain versions."""
    import io

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.data.mol import load_mol_splits
    from graphtrans_tpu_torch.ops import kernels
    from graphtrans_tpu_torch.predict import serving_layout

    argv = ["--configs", CONFIG, "--data_root", SNAPSHOT, "--epochs",
            str(TRAIN_EPOCHS), "--batch_size", str(BATCH), "--seed",
            str(SEED), "--save_path", tmp]
    out = io.StringIO()
    kernels.reset_launches()                 # the training path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = train_main.main(argv)
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_instance = k2_instances()
    for line in out.getvalue().splitlines():
        print(f"[6b] main: {line}")
    steps = sum(r["steps"] for r in res["epochs"])
    want = {**dict.fromkeys(launches, 0),        # every other wrapper: 0
            "gin_agg": 5 * steps, "gin_agg_bwd": 5 * steps,
            "attention_seg": 4 * steps, "attention_seg_bwd": 4 * steps,
            "flash_hil_seg": 0, "flash_hil_seg_bwd": 0, "spmm": 0,
            "spmm_bwd": 0, "attention_dense": 0, "attention_dense_bwd": 0,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "byte_dropout": 0}
    if steps == 0 or launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
        raise AssertionError(f"epoch losses not finite: {res['epochs']}")
    args = _train_args()
    splits, num_tasks = load_mol_splits(SNAPSHOT, "ogbg-molpcba")
    init, _ = _trainer(args, num_tasks, device)
    trained = torch.load(res["saved"], map_location=device, weights_only=True)
    params = dict(init.named_parameters())
    still = [n for n, p in params.items() if torch.equal(p, trained[n])]
    if len(still) > len(params) // 20:
        raise AssertionError(f"parameters did not move: {still}")
    print(f"[6b] trained {TRAIN_EPOCHS} epochs ({steps} steps of <= {BATCH} "
          f"graphs, {secs:.2f} s with the model build) through "
          f"graphtrans_tpu_torch.main: losses "
          f"{[round(r['loss'], 6) for r in res['epochs']]}, "
          f"{len(params) - len(still)} of {len(params)} parameter tensors "
          f"moved; launches {launches} = 5, 5, 4 and 4 per step"
          f"{by_instance}")

    layout = serving_layout(splits, args, num_tasks, BATCH)
    batch = next(iterate_batches(
        splits["train"], order=shuffled_order(len(splits["train"]), SEED, 0),
        **layout)).to(device)
    got = []
    for on in (True, False):
        model, step = _trainer(args, num_tasks, device, kernels_on=on)
        loss = step(batch).item()
        got.append((loss, {n: p.grad for n, p in model.named_parameters()}))
    (lk, gk), (lp, gp) = got
    g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
    g_abs = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    if abs(lk - lp) > LOGITS_TOL or g_err > GRAD_TOL:
        raise AssertionError(f"train step through the kernels: loss "
                             f"|diff| {abs(lk - lp)} (<= {LOGITS_TOL}), "
                             f"gradients {g_err} (<= {GRAD_TOL})")
    print(f"[6b] one train step (dropout {args.gnn_dropout}/"
          f"{args.transformer_dropout}, same seeds) through the kernels vs "
          f"the plain versions on the card: loss {lk:.6f} vs {lp:.6f} "
          f"(|diff| {abs(lk - lp):.3g} <= {LOGITS_TOL}), gradients max "
          f"|diff| {g_abs:.3g}, relative to max(1, max|ref|) {g_err:.3g} "
          f"(<= {GRAD_TOL})")
    return launches


def phase6_step4096(device, big, smi: str):
    """(c) The train step on the 4096-graph batch: time, peak memory and
    the device time by layer."""
    args = _train_args()
    model, step = _trainer(args, 128, device)
    tb = big.to(device)
    n = int(big.graph_mask.sum())
    _median_ms(lambda: step(tb), 3)                         # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    if not torch.isfinite(loss):
        raise AssertionError("4096-graph train step: loss not finite")
    print(f"[6c] train step of {n} graphs (forward, backward, AdamW; "
          f"dropout {args.gnn_dropout}/{args.transformer_dropout}): median "
          f"{ms:.3f} ms over {TIMED_STEPS} (min {lo:.3f}, max {hi:.3f}), "
          f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on {smi} "
          f"(earlier: {EARLIER_STEP_MS} ms)")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(tb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    _print_split("[6c]", "train step", prof, PROFILED_STEPS, wall, smi)


# ---- phase 7: code2 serving ----------------------------------------------


def _code2_args():
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.utils.config import parse_with_config

    return parse_with_config(predict.build_parser(), [
        "--configs", CODE2_CONFIG, "--data_root", SNAPSHOT, "--batch_size",
        str(CODE2_BATCH), "--seed", str(SEED)])


def k3_inputs(batch, d: int, gen: torch.Generator, device):
    """K3's arguments on the widest packing tier of ``batch`` (random
    qkv)."""
    R, W = batch.pack_rows, batch.pack_w
    seg = torch.as_tensor(batch.pack_seg).reshape(R, W)
    return torch.randn(R, W, 3 * d, generator=gen).to(device), seg.to(device)


def k7_inputs(batch, d: int, gen: torch.Generator, device):
    """K7's arguments as a GCN layer gets them: random node rows (zero on
    padding rows) and edge embeddings, the batch's dst-sorted edges and the
    GCN norm deg^-1/2[src] deg^-1/2[dst] as edge weight."""
    from graphtrans_tpu_torch.ops.segment import out_degree

    tb = batch.to(device)
    x = torch.randn(batch.num_node_slots, d, generator=gen).to(device)
    x = x.masked_fill(~tb.node_mask[:, None], 0.0)
    emb = torch.randn(tb.edge_src.shape[0], d, generator=gen).to(device)
    dis = (out_degree(tb.edge_src, x.shape[0], tb.edge_mask) + 1.0) ** -0.5
    w = dis[tb.edge_src.long()] * dis[tb.edge_dst.long()]
    return (x, emb, tb.edge_src, tb.edge_dst, tb.edge_mask, w)


def check_k3(qkv, seg, nhead: int):
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg,
                                                  flash_hil_seg_plain)

    got = flash_hil_seg(qkv, seg, nhead)
    torch.cuda.synchronize()
    err = (got - flash_hil_seg_plain(qkv, seg, nhead)).abs().max().item()
    if err > K3_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"K3 disagrees with its plain version: "
                             f"max |diff| {err} > {K3_TOL}")
    if (got[seg < 0] != 0).any():
        raise AssertionError("K3: padding queries are not exactly zero")
    return err


def check_k7(args):
    from graphtrans_tpu_torch.ops.kernels import spmm, spmm_plain

    got = spmm(*args)
    torch.cuda.synchronize()
    want = spmm_plain(*args)
    err = _rel_err(got, want)
    if err > K7_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"K7 disagrees with its plain version: "
                             f"{err} of max(1, max|ref|) > {K7_TOL}")
    return err


def k3_bound(qkv, seg, nhead: int, tensor_cores: bool = True):
    """K3 reads and writes what K2 does (k2_bound); by default its products
    are timed as the long forward runs them, 3xTF32 on the tensor cores
    (``tensor_cores=False``: the f32 SIMT bound, printed beside it)."""
    return k2_bound(qkv, seg, nhead, tensor_cores)


def k7_bound(args):
    """x and the output once, and per valid edge its emb row, src, dst and
    weight (the padding tail's emb rows are never needed); 4 flops per
    valid edge and channel (add, relu, scale, sum). Rows of x's element
    size (bf16: 2 bytes)."""
    x, emb, src, dst, emask, w = args
    N, d = x.shape
    e = x.element_size()
    valid = int(emask.sum().item())
    nbytes = 2 * N * d * e + valid * (d * e + 3 * 4) + emask.numel()
    return _bound(nbytes, 4 * valid * d)


def k2_tier_inputs(batch, tier: str, d: int, gen: torch.Generator, device):
    """K2's arguments on one packing tier of ``batch`` (random qkv): code2's
    "pack2" (rows of 384) and "pack3" (rows of 128)."""
    R, W = getattr(batch, f"{tier}_rows"), getattr(batch, f"{tier}_w")
    seg = torch.as_tensor(getattr(batch, f"{tier}_seg")).reshape(R, W)
    return torch.randn(R, W, 3 * d, generator=gen).to(device), seg.to(device)


def _simt(t) -> str:
    """The f32 SIMT bound printed beside a tensor-core bound, where kept."""
    return ("" if "f32_simt_bound_ms" not in t else
            f"; products on the tensor cores in 3xTF32, "
            f"{t['f32_simt_bound_ms']:.4f} ms at the f32 SIMT peak")


def time_k2_tiers(tag: str, device, d_model: int, nhead: int, bench,
                  gen: torch.Generator, base, train: bool):
    """K2 (serving) or K2-bwd (training, dropout 0.3) at the code2 bench
    batch's two K2 tiers: held against the plain version, then timed beside
    the parent's (with ``base``, in turns), plain version, bound and SDPA."""
    from graphtrans_tpu_torch.ops.kernels import (attention_seg,
                                                  attention_seg_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        seg_instance)

    old = base and base["attention_packed"]
    rows = {}
    for tier in ("pack2", "pack3"):
        qkv, seg = k2_tier_inputs(bench, tier, d_model, gen, device)
        R, W = seg.shape
        shape = f"R={R} W={W} d={d_model} H={nhead}"
        if train:
            f_err, b_err, g = check_k2_train(qkv, seg, nhead, DROPOUT,
                                             2**31 - 3, gen)
            t, fwd_drop, fwd_plain = time_k2_train(qkv, seg, nhead, g,
                                                   7654321, base)
            print(f"[{tag}] bench{CODE2_BENCH} K2-bwd attention_seg_bwd "
                  f"({seg_instance(W)}) [{shape} rate={DROPOUT}]: kernel "
                  f"{t['ms']:.4f} ms (the parent's {_ms(t['earlier_ms'])}, "
                  f"in turns), plain backward {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}{_simt(t)}), "
                  f"library "
                  f"{t['library_ms']:.4f} ms (SDPA backward, bool seg mask, "
                  f"dropout {DROPOUT}); training forward {fwd_drop[0]:.4f} "
                  f"ms (the parent's {_ms(fwd_drop[1])}); within "
                  f"{f_err:.3g} (forward) and {b_err:.3g} (backward) of the "
                  f"plain version")
        else:
            err = check_k2(qkv, seg, nhead)
            ms, earlier = turns_ms(
                lambda: attention_seg(qkv, seg, nhead),
                old and (lambda: old.attention_seg(qkv, seg, nhead)), 20)
            t = dict(ms=ms, earlier_ms=earlier,
                     plain_ms=time_ms(
                         lambda: attention_seg_plain(qkv, seg, nhead),
                         iters=5),
                     library_ms=sdpa_ms(qkv, seg, nhead))
            long = seg_instance(W) == "long"
            t["bound_ms"], t["bound_by"] = k2_bound(qkv, seg, nhead, long)
            if long:
                t["f32_simt_bound_ms"] = k2_bound(qkv, seg, nhead)[0]
            print(f"[{tag}] bench{CODE2_BENCH} K2 attention_seg "
                  f"({seg_instance(W)}) [{shape}]: kernel {t['ms']:.4f} ms "
                  f"(the parent's {_ms(t['earlier_ms'])}, in turns), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}{_simt(t)}), library "
                  f"{t['library_ms']:.4f} ms "
                  f"(SDPA, bool seg mask); max |diff| {err:.3g} (<= "
                  f"{K2_TOL}), padding queries exactly 0")
        rows[W] = t
    return rows


def time_k7(name: str, a, base):
    """K7 on its arguments ``a`` (relu_add, the GCN norm) as the GCN layer
    calls it, with the batch's DstOrder built once beforehand (its cost
    timed apart): ms in turns with the parent's kernel under ``--baseline``
    (whose bits it must give: the same order of terms), device ms from the
    profiler with a cold L2 (each None where not measured), and the shapes
    whose bits were checked. Also a batch's worth, in turns: a new
    DstOrder and GCN_LAYERS_PER_FORWARD calls, against the parent's as
    many calls."""
    from graphtrans_tpu_torch.ops.kernels import DstOrder, spmm

    N = a[0].shape[0]
    order_ms = time_ms(lambda: DstOrder(a[3], a[4], N).runs(), iters=20)
    rows = DstOrder(a[3], a[4], N)
    rows.runs()                          # built once per batch, not timed
    new = lambda: spmm(*a, rows=rows)
    old = base and (lambda: base["spmm"].spmm(*a))

    def batch():
        per = DstOrder(a[3], a[4], N)
        for _ in range(GCN_LAYERS_PER_FORWARD):
            spmm(*a, rows=per)

    def old_batch():
        for _ in range(GCN_LAYERS_PER_FORWARD):
            old()

    checked = []
    same_bits(f"K7 {name}", new, old, checked)
    ms, earlier = turns_ms(new, old, 20)
    batch_ms, earlier_batch = turns_ms(batch, old and old_batch, 10)
    return dict(ms=ms, earlier_ms=earlier, library_ms=None, order_ms=order_ms,
                batch_ms=batch_ms, earlier_batch_ms=earlier_batch,
                device_ms=device_ms(new, ("spmm_fwd",)),
                earlier_device_ms=old and device_ms(
                    old, ("spmm_fwd", "spmm_kernel"))), checked


def phase7_kernels(device, d_gnn: int, d_model: int, nhead: int, bench,
                   base=None):
    """(a) K3 and K7 against their plain versions at the code2 snapshot's
    shapes (the train split's first batch of 16: W=1024 rows; the test
    split's: W=512) and at the 512-graph bench shape; times at the train
    batch's shape and at the bench shape."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg,
                                                  flash_hil_seg_plain,
                                                  spmm_plain)

    gen = torch.Generator().manual_seed(SEED + 7)
    args = _code2_args()
    splits, num_tasks, _ = predict.load_splits(args)
    serve = [next(iterate_batches(splits[s], **predict.serving_layout(
        splits, args, num_tasks, split=s))) for s in ("train", "test")]
    k3_err = k7_err = 0.0
    for b in serve + [bench]:
        qkv, seg = k3_inputs(b, d_model, gen, device)
        k3_err = max(k3_err, check_k3(qkv, seg, nhead))
        for message in ("relu_add", "add"):
            a = k7_inputs(b, d_gnn, gen, device)
            k7_err = max(k7_err, check_k7(a + (message,)))
    print(f"[7a] K3 and K7 agree with their plain versions at the code2 "
          f"snapshot (W={serve[0].pack_w}, {serve[1].pack_w}) and 512-graph "
          f"shapes: K3 max |diff| {k3_err:.3g} (<= {K3_TOL}), padding "
          f"queries exactly 0; K7 max |diff| / max(1, max|ref|) "
          f"{k7_err:.3g} (<= {K7_TOL})")

    same_k7 = []      # shapes where K7 gave the parent's bits
    for name, b in (("serve16", serve[0]), (f"bench{CODE2_BENCH}", bench)):
        qkv, seg = k3_inputs(b, d_model, gen, device)
        R, W, d3 = qkv.shape
        ms, earlier = turns_ms(
            lambda: flash_hil_seg(qkv, seg, nhead),
            base and (lambda: base["flash_hil"].flash_hil_seg(qkv, seg,
                                                              nhead)), 20)
        k3 = dict(ms=ms, earlier_ms=earlier,
                  plain_ms=time_ms(
                      lambda: flash_hil_seg_plain(qkv, seg, nhead), iters=5),
                  library_ms=sdpa_ms(qkv, seg, nhead))
        k3["bound_ms"], k3["bound_by"] = k3_bound(qkv, seg, nhead)
        k3["f32_simt_bound_ms"] = k3_bound(qkv, seg, nhead, False)[0]
        a = k7_inputs(b, d_gnn, gen, device)
        k7, same = time_k7(name, a, base)
        same_k7.extend(same)
        k7["plain_ms"] = time_ms(lambda: spmm_plain(*a), iters=5)
        k7["bound_ms"], k7["bound_by"] = k7_bound(a)
        k3["shape"] = f"R={R} W={W} d={d3 // 3} H={nhead}"
        k7["shape"] = (f"N={a[0].shape[0]} E={a[2].shape[0]} valid="
                       f"{int(a[4].sum().item())} d={d_gnn}")
        for kname, t, lib in (
                ("K3 flash_hil_seg", k3, f"{k3['library_ms']:.4f} ms (SDPA, "
                 "bool seg mask)"),
                ("K7 spmm", k7, "- (no single PyTorch call computes the "
                 "gather, relu message, weight and scatter-sum)")):
            earlier = ("" if "earlier_ms" not in t else
                       f" (the parent's {_ms(t['earlier_ms'])}, in turns)")
            print(f"[7a] {name} {kname} [{t['shape']}]: kernel "
                  f"{t['ms']:.4f} ms{earlier}, plain {t['plain_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}{_simt(t)}), "
                  f"library {lib}")
        print(f"[7a] {name} K7 spmm as the GCN layer calls it (the batch's "
              f"DstOrder): device time {_ms(k7['device_ms'])} a launch from "
              f"the profiler, cold L2 (the parent's "
              f"{_ms(k7['earlier_device_ms'])}); the DstOrder (row pointer, "
              f"live edges before each row, runs; once per batch) "
              f"{k7['order_ms']:.4f} ms")
        print(f"[7a] {name} K7 a batch's worth, as the GCN forward runs it "
              f"(a new DstOrder and {GCN_LAYERS_PER_FORWARD} calls): "
              f"{k7['batch_ms']:.4f} ms (the parent's "
              f"{GCN_LAYERS_PER_FORWARD} calls {_ms(k7['earlier_batch_ms'])},"
              f" in turns)")
    if base:
        print(f"[7a] --baseline: K7 gives the parent's bits on the same "
              f"inputs at {same_k7}")
    k2 = time_k2_tiers("7a", device, d_model, nhead, bench, gen, base, False)
    return dict(k3_err=k3_err, k7_err=k7_err, timed=(k3, k7), k2=k2)


def phase7_serve(device, tmp: str):
    """(b) The code2 snapshot's valid and test splits through the serving
    entry point, launches per batch, and the logits through the kernels
    against the plain versions on the card (all three splits)."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops import kernels
    from graphtrans_tpu_torch.ops.kernels.attention_packed import W_MAX

    args = _code2_args()
    splits, num_tasks, code = predict.load_splits(args)
    kernels.reset_launches()                 # the main path starts here
    want = collections.Counter()
    results = {}
    t0 = time.perf_counter()
    for split in ("valid", "test"):
        out = os.path.join(tmp, f"code2_{split}.jsonl")
        res = predict.main(["--configs", CODE2_CONFIG, "--data_root",
                            SNAPSHOT, "--split", split, "--batch_size",
                            str(CODE2_BATCH), "--seed", str(SEED), "--out",
                            out])
        recs = [json.loads(line) for line in open(out)]
        if (len(recs) != len(splits[split])
                or sorted(r["graph_id"] for r in recs)
                != list(range(len(splits[split])))):
            raise AssertionError(f"code2 {split}: {len(recs)} records for "
                                 f"{len(splits[split])} graphs")
        if not all(len(r["tokens"]) == code.max_seq_len
                   and 0 <= min(r["tokens"]) and max(r["tokens"]) < num_tasks
                   and isinstance(r["seq"], list) for r in recs):
            raise AssertionError(f"code2 {split}: malformed records")
        if not 0.0 <= res["F1"] <= 1.0:
            raise AssertionError(f"code2 {split}: F1 {res['F1']}")
        layout = predict.serving_layout(splits, args, num_tasks, split=split)
        widths = [layout[k] for k in ("seq_pack_w", "seq_pack_w2",
                                      "seq_pack_w3") if layout.get(k)]
        wide = sum(w > W_MAX for w in widths)
        n = res["batches"]
        want.update(spmm=GCN_LAYERS_PER_FORWARD * n,
                    flash_hil_seg=ENCODER_LAYERS_PER_FORWARD * wide * n,
                    attention_seg=ENCODER_LAYERS_PER_FORWARD
                    * (len(widths) - wide) * n)
        results[split] = (res, widths)
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_instance = k2_instances()
    want = dict(dict.fromkeys(launches, 0), **want)   # every other: 0
    want = dict(want, gin_agg=0, gin_agg_bwd=0, attention_seg_bwd=0,
                flash_hil_seg_bwd=0, spmm_bwd=0, attention_dense=0,
                attention_dense_bwd=0, flash_attention=0,
                flash_attention_bwd=0, byte_dropout=0)
    if launches != want or not (launches["flash_hil_seg"] > 0
                                and launches["spmm"] > 0):
        raise AssertionError(f"code2 launches {launches}, expected {want}")
    batches = sum(r["batches"] for r, _ in results.values())
    for split, (res, widths) in results.items():
        print(f"[7b] served the code2 {split} split ({res['records']} graphs, "
              f"{res['batches']} batches of <= {CODE2_BATCH}, tiers {widths}):"
              f" F1 {res['F1']:.6f} (precision {res['precision']:.6f}, "
              f"recall {res['recall']:.6f}), random weights")
    print(f"[7b] launches {launches} over {batches} batches ({secs:.2f} s "
          f"with model builds): per batch K7 {launches['spmm'] / batches:g}, "
          f"K3 {launches['flash_hil_seg'] / batches:g}, K2 "
          f"{launches['attention_seg'] / batches:g}{by_instance}")

    model = predict.build_model(args, num_tasks, device, code)
    err, n_wide = 0.0, 0
    with torch.inference_mode():
        for split in ("train", "valid", "test"):
            layout = predict.serving_layout(splits, args, num_tasks,
                                            split=split)
            for b in iterate_batches(splits[split], **layout):
                tb = b.to(device)
                gm = tb.graph_mask
                got = model(tb)[gm]
                kernels.set_kernels(model, False)
                plain = model(tb)[gm]
                kernels.set_kernels(model, True)
                if not torch.isfinite(got).all():
                    raise AssertionError("code2 logits not finite")
                err = max(err, (got - plain).abs().max().item())
                n_wide += b.pack_w > W_MAX
    if err > LOGITS_TOL:
        raise AssertionError(f"code2 logits through the kernels differ from "
                             f"the plain versions by {err} > {LOGITS_TOL}")
    print(f"[7b] code2 logits through the kernels match the plain versions "
          f"on the card over all three splits ({n_wide} batches with a "
          f"widest tier past {W_MAX}): max |diff| {err:.3g} (<= "
          f"{LOGITS_TOL})")
    return launches


def phase7_forward(device, bench, num_tasks: int, smi: str):
    """(c) The forward of the 512-graph code2 batch at the published
    width: median of 10 after 3 warm-ups, then a torch.profiler split; and
    one snapshot batch of 16 from collation to tokens on the host."""
    import types

    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.models.gnn_transformer import (
        build_gnn_transformer)
    from graphtrans_tpu_torch.nn.init import init_weights

    args = _code2_args()
    splits, snap_tasks, code = predict.load_splits(args)
    layout = predict.serving_layout(splits, args, snap_tasks, split="test")
    graphs = splits["test"][:CODE2_BATCH]
    snap = predict.build_model(args, snap_tasks, device, code)
    with torch.inference_mode():
        small = next(iterate_batches(graphs, **layout))
        _median_ms(lambda: snap(small.to(device)).argmax(-1).cpu(), 3)
        coll = _median_ms(lambda: next(iterate_batches(graphs, **layout)),
                          10)[0]
        req = _median_ms(lambda: snap(small.to(device)).argmax(-1).cpu(), 20)
    print(f"[7c] one code2 snapshot batch ({int(small.graph_mask.sum())} "
          f"test graphs of the first {CODE2_BATCH}): collate {coll:.3f} ms "
          f"(host), copy in + forward + tokens out median {req[0]:.3f} ms "
          f"over 20 (min {req[1]:.3f}, max {req[2]:.3f}) on {smi}")

    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    model = build_gnn_transformer(args, num_tasks, device, data=sizes)
    init_weights(model, torch.Generator().manual_seed(SEED)).eval()
    tb = bench.to(device)
    n = int(bench.graph_mask.sum())
    with torch.inference_mode():
        _median_ms(lambda: model(tb), 3)                    # warm-up
        ms, lo, hi, out = _median_ms(lambda: model(tb), 10)
        if not torch.isfinite(out[tb.graph_mask]).all():
            raise AssertionError("code2 bench batch: logits not finite")
    tiers = [(getattr(bench, f"{t}_rows"), getattr(bench, f"{t}_w"))
             for t in ("pack", "pack2", "pack3")]
    print(f"[7c] code2 forward of {n} graphs ({int(bench.node_mask.sum())} "
          f"nodes, {int(bench.edge_mask.sum())} edges; packed rows x width "
          f"{tiers}): median {ms:.3f} ms over 10 (min {lo:.3f}, max "
          f"{hi:.3f}), {n / ms * 1e3:.0f} graphs/s on {smi}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_FORWARDS):
                model(tb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FORWARDS
    _print_split("[7c]", "code2 forward", prof, PROFILED_FORWARDS, wall, smi,
                 graphs=n)


# ---- phase 8: code2 training ---------------------------------------------


def check_k3_train(qkv, seg, nhead: int, rate: float, seed: int, gen):
    """K3 forward with dropout ``rate`` (saving its statistics) and K3-bwd
    against the plain version (the same mask) and its autograd."""
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg_bwd,
                                                  flash_hil_seg_bwd_plain,
                                                  flash_hil_seg_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    saved = flash_hil_seg_with_stats(qkv, seg, nhead, rate, seed)
    out = saved[0]
    g = torch.randn(out.shape, generator=gen).to(qkv.device)
    dqkv = flash_hil_seg_bwd(qkv, seg, nhead, g, saved, rate, seed)
    torch.cuda.synchronize()
    f_err = (out - flash_hil_seg_plain(qkv, seg, nhead, rate, seed)
             ).abs().max().item()
    b_err = _rel_err(dqkv, flash_hil_seg_bwd_plain(qkv, seg, nhead, g, rate,
                                                   seed))
    if f_err > K3_TOL or b_err > GRAD_TOL or not torch.isfinite(dqkv).all():
        raise AssertionError(f"K3 at rate {rate}: forward |diff| {f_err} "
                             f"(<= {K3_TOL}), backward {b_err} of max(1, "
                             f"max|ref|) (<= {GRAD_TOL})")
    if dqkv[seg < 0].any() or out[seg < 0].any():
        raise AssertionError("K3: padding tokens are not exactly zero")
    return f_err, b_err


def check_k7_bwd(args, gen):
    """K7-bwd (dx, d_emb) against autograd through the plain version;
    masked edges' d_emb rows exactly zero."""
    from graphtrans_tpu_torch.ops.kernels import (SrcOrder, spmm_bwd,
                                                  spmm_bwd_plain)

    x, emb, src, dst, emask, w, message = args
    g = torch.randn(x.shape, generator=gen).to(x.device)
    got = spmm_bwd(x, emb, src, dst, emask, g,
                   SrcOrder(src, emask, x.shape[0]), w, message)
    torch.cuda.synchronize()
    want = spmm_bwd_plain(x, emb, src, dst, emask, g, w, message)
    err = max(_rel_err(a, b) for a, b in zip(got, want))
    if err > GRAD_TOL or not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"K7-bwd disagrees with autograd through its "
                             f"plain version: {err} of max(1, max|ref|) > "
                             f"{GRAD_TOL}")
    if got[1][~emask].any():
        raise AssertionError("K7-bwd: masked edges' d_emb rows are not zero")
    return err


def time_k7_bwd(a, g, order, base):
    """K7-bwd on K7's arguments ``a`` (relu_add, the GCN norm) as the main
    path calls it: (ms, the parent's ms in turns or None, (device ms, the
    parent's) from the profiler with a cold L2, each None where not
    measured, what gave the parent's bits). With ``base`` its outputs must
    have the parent's bits: each row's terms are added in the same (perm)
    order."""
    from graphtrans_tpu_torch.ops.kernels import spmm_bwd

    new = lambda: spmm_bwd(*a[:5], g, order, a[5])
    old = base and (lambda: base["spmm"].spmm_bwd(*a[:5], g, order, a[5]))
    checked = []
    same_bits(f"K7-bwd N={a[0].shape[0]}", new, old, checked)
    ms, earlier = turns_ms(new, old, 20)
    dev = (device_ms(new, ("spmm_bwd",)),
           old and device_ms(old, ("spmm_bwd",)))
    return ms, earlier, dev, checked


def print_k7_bwd_turns(tag: str, by_shape: dict, same: list, base):
    """One line: K7-bwd at each shape beside the parent's, and the shapes
    whose outputs had the parent's bits under ``--baseline``."""
    print(f"[{tag}] K7-bwd spmm_bwd at both shapes, in turns with the "
          f"parent's kernel: " + "; ".join(
              f"{n} {t['ms']:.4f} ms (the parent's {_ms(t['earlier_ms'])}, "
              f"bound {t['bound_ms']:.4f}; device time "
              f"{_ms(t['device_ms'])} a launch from the profiler, cold L2, "
              f"the parent's {_ms(t['earlier_device_ms'])})"
              for n, t in by_shape.items()))
    if base:
        print(f"[{tag}] --baseline: K7-bwd gives the parent's bits (dx and "
              f"d_emb) on the same inputs at {same}")


def k7_bwd_bound(args):
    """x and g read once, as k7_bound reads x once (the kernel gathers g
    per edge only because it walks the edges by source); per valid edge
    its emb row and its perm, dst and weight entries; d_emb for every edge
    slot and dx written once; 4 flops per valid edge and channel (add,
    compare, scale, sum)."""
    x, emb, src, dst, emask, w = args[:6]
    N, d = x.shape
    E = emask.numel()
    e = x.element_size()
    valid = int(emask.sum().item())
    nbytes = 3 * N * d * e + valid * (d * e + 3 * 4) + E * d * e
    return _bound(nbytes, 4 * valid * d)


def phase8_kernels(device, d_gnn: int, d_model: int, nhead: int, bench,
                   base=None):
    """(a) K3 with dropout, K3-bwd and K7-bwd against their plain versions
    at the code2 snapshot's train-batch shape and at the 512-graph bench
    shape; times beside bound, plain backward and library yardstick, K3-bwd
    also beside ``base``'s (the earlier design) in turns."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops.kernels import (SrcOrder, flash_hil_seg,
                                                  flash_hil_seg_bwd,
                                                  flash_hil_seg_plain,
                                                  spmm_bwd, spmm_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    gen = torch.Generator().manual_seed(SEED + 8)
    args = _code2_args()
    splits, num_tasks, _ = predict.load_splits(args)
    train16 = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks, CODE2_BATCH, split="train", seed=SEED)))
    k3_ferr = k3_err = k7_err = 0.0
    for b in (train16, bench):
        qkv, seg = k3_inputs(b, d_model, gen, device)
        for rate, seed in ((0.0, 0), (DROPOUT, 2**31 - 9)):
            f, e = check_k3_train(qkv, seg, nhead, rate, seed, gen)
            k3_ferr, k3_err = max(k3_ferr, f), max(k3_err, e)
        for message in ("relu_add", "add"):
            a = k7_inputs(b, d_gnn, gen, device)
            k7_err = max(k7_err, check_k7_bwd(a + (message,), gen))
    print(f"[8a] K3 with dropout {DROPOUT} within {k3_ferr:.3g} of its plain "
          f"version (<= {K3_TOL}); K3-bwd {k3_err:.3g} and K7-bwd "
          f"{k7_err:.3g} of max(1, max|ref|) from autograd through the plain "
          f"versions (<= {GRAD_TOL}); padding tokens and masked edges' "
          f"d_emb rows exactly 0 (train16 W={train16.pack_w}, bench"
          f"{CODE2_BENCH})")

    same, k7_by_shape = [], {}
    for name, b in (("train16", train16), (f"bench{CODE2_BENCH}", bench)):
        qkv, seg = k3_inputs(b, d_model, gen, device)
        R, W, d3 = qkv.shape
        seed = 7654321
        g = torch.randn(R, W, d_model, generator=gen).to(device)
        saved = flash_hil_seg_with_stats(qkv, seg, nhead, DROPOUT, seed)
        ms, earlier = turns_ms(
            lambda: flash_hil_seg_bwd(qkv, seg, nhead, g, saved, DROPOUT,
                                      seed),
            base and (lambda: base["flash_hil"].flash_hil_seg_bwd(
                qkv, seg, nhead, g, saved, DROPOUT, seed)), 20)
        k3b = dict(ms=ms, earlier_ms=earlier,
                   plain_ms=_plain_bwd_ms(
                       lambda t: flash_hil_seg_plain(t, seg, nhead, DROPOUT,
                                                     seed), [qkv], g),
                   library_ms=sdpa_bwd_ms(qkv, seg, nhead, g, DROPOUT))
        k3b["bound_ms"], k3b["bound_by"] = k3_bwd_bound(qkv, seg, nhead)
        simt = k3_bwd_bound(qkv, seg, nhead, tensor_cores=False)[0]
        old = base and base["flash_hil"]
        fwd = {what: turns_ms(fn, old and (lambda: fn(old)), 20)
               for what, fn in (
                   ("serving", lambda m=None: (m.flash_hil_seg if m else
                                               flash_hil_seg)(qkv, seg,
                                                              nhead)),
                   ("training", lambda m=None: (
                       m.flash_hil_seg_with_stats if m else
                       flash_hil_seg_with_stats)(qkv, seg, nhead, DROPOUT,
                                                 seed)))}
        a = k7_inputs(b, d_gnn, gen, device)
        g7 = torch.randn(a[0].shape, generator=gen).to(device)
        N7 = a[0].shape[0]
        order_ms = time_ms(lambda: SrcOrder(a[2], a[4], N7).runs(), iters=20)
        order = SrcOrder(a[2], a[4], N7)
        order.runs()                     # built once per batch, not timed
        ms, earlier, dev, k7_same = time_k7_bwd(a, g7, order, base)
        same.extend(k7_same)
        k7b = dict(ms=ms, earlier_ms=earlier, device_ms=dev[0],
                   earlier_device_ms=dev[1],
                   plain_ms=_plain_bwd_ms(
                       lambda x, e: spmm_plain(x, e, *a[2:]), list(a[:2]),
                       g7),
                   library_ms=None)
        k7b["bound_ms"], k7b["bound_by"] = k7_bwd_bound(a)
        k7_by_shape[name] = k7b
        k3b["shape"] = f"R={R} W={W} d={d3 // 3} H={nhead} rate={DROPOUT}"
        k7b["shape"] = (f"N={a[0].shape[0]} E={a[2].shape[0]} valid="
                        f"{int(a[4].sum().item())} d={d_gnn}")
        print(f"[8a] {name} K3-bwd flash_hil_seg_bwd [{k3b['shape']}]: "
              f"kernel {k3b['ms']:.4f} ms against "
              f"{_ms(k3b['earlier_ms'])} for the earlier design, in turns; "
              f"bound {k3b['bound_ms']:.4f} ms with the products on the "
              f"tensor cores in 3xTF32, {simt:.4f} ms at the f32 SIMT peak")
        for kname, t, lib in (
                ("K3-bwd flash_hil_seg_bwd", k3b,
                 f"{k3b['library_ms']:.4f} ms (SDPA backward, bool seg "
                 f"mask, dropout {DROPOUT})"),
                ("K7-bwd spmm_bwd", k7b, "- (no single PyTorch call)")):
            print(f"[8a] {name} {kname} [{t['shape']}]: kernel "
                  f"{t['ms']:.4f} ms, plain backward {t['plain_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library "
                  f"{lib}")
        print(f"[8a] {name} K3 forward: serving {fwd['serving'][0]:.4f} ms "
              f"(the parent's {_ms(fwd['serving'][1])}, in turns), with "
              f"dropout {DROPOUT} and saved statistics (training) "
              f"{fwd['training'][0]:.4f} ms (the parent's "
              f"{_ms(fwd['training'][1])}); K7-bwd's SrcOrder (sort and "
              f"searchsorted, and its runs, once per batch) {order_ms:.4f} ms")
    print_k7_bwd_turns("8a", k7_by_shape, same, base)
    k2 = time_k2_tiers("8a", device, d_model, nhead, bench, gen, base, True)
    return dict(k3_err=k3_err, k7_err=k7_err, timed=(k3b, k7b), k2=k2)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms while a kernel route is held against the
    plain route. The plain route's index_add_ (and index_select's backward)
    otherwise sum with atomics in no fixed order, and the virtual node's
    batch-statistics BatchNorm over 16 graph rows (the JAX package's
    single-pass variance, E[x^2] - E[x]^2) magnifies that rounding to ~1e-3
    of its MLP's gradients: the plain route against itself differed by
    5.7e-4 and 1.2e-3 of max(1, max|ref|) on two snapshot batches, and by 0
    in this mode."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def _code2_train_args():
    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch.utils.config import parse_with_config

    return parse_with_config(train_main.build_parser(), [
        "--configs", CODE2_CONFIG, "--data_root", SNAPSHOT, "--epochs",
        str(TRAIN_EPOCHS), "--batch_size", str(CODE2_BATCH), "--seed",
        str(SEED)])


def phase8_train(device, tmp: str):
    """(b) code2 training through the entry point at full width on the
    snapshot, its kernel launches, and one step through the kernels
    against the plain versions."""
    import io

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.ops import kernels

    argv = ["--configs", CODE2_CONFIG, "--data_root", SNAPSHOT, "--epochs",
            str(TRAIN_EPOCHS), "--batch_size", str(CODE2_BATCH), "--seed",
            str(SEED), "--save_path", tmp]
    out = io.StringIO()
    kernels.reset_launches()                 # the code2 training path
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = train_main.main(argv)
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_instance = k2_instances()
    for line in out.getvalue().splitlines():
        print(f"[8b] main: {line}")
    steps = sum(r["steps"] for r in res["epochs"])
    # every train batch packs into three tiers (1024, 384, 128): the
    # encoder's 4 layers run K3 on one and K2 on two; 5 GCN layers run K7
    want = {**dict.fromkeys(launches, 0),        # every other wrapper: 0
            "gin_agg": 0, "gin_agg_bwd": 0,
            "attention_seg": 8 * steps, "attention_seg_bwd": 8 * steps,
            "flash_hil_seg": 4 * steps, "flash_hil_seg_bwd": 4 * steps,
            "spmm": 5 * steps, "spmm_bwd": 5 * steps,
            "attention_dense": 0, "attention_dense_bwd": 0,
            "flash_attention": 0, "flash_attention_bwd": 0, "byte_dropout": 0}
    if steps == 0 or launches != want:
        raise AssertionError(f"code2 training launches {launches}, "
                             f"expected {want}")
    if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
        raise AssertionError(f"epoch losses not finite: {res['epochs']}")
    args = _code2_train_args()
    splits, num_tasks, code = predict.load_splits(args)
    init, _ = _trainer(args, num_tasks, device, data=code)
    trained = torch.load(res["saved"], map_location=device, weights_only=True)
    params = dict(init.named_parameters())
    still = [n for n, p in params.items() if torch.equal(p, trained[n])]
    if still:
        raise AssertionError(f"parameters did not move: {still}")
    print(f"[8b] trained code2 {TRAIN_EPOCHS} epochs ({steps} steps of <= "
          f"{CODE2_BATCH} graphs, {secs:.2f} s with the model build) through "
          f"graphtrans_tpu_torch.main: losses "
          f"{[round(r['loss'], 6) for r in res['epochs']]}, all "
          f"{len(params)} parameter tensors moved; launches {launches} = "
          f"K2 8, K3 4, K7 5 per step, each with its backward{by_instance}")

    layout = predict.serving_layout(splits, args, num_tasks, CODE2_BATCH,
                                    split="train", seed=SEED)
    batch = next(iterate_batches(
        splits["train"], order=shuffled_order(len(splits["train"]), SEED, 0),
        **layout)).to(device)

    def one_step(kernels_on: bool, fixed_order: bool):
        with deterministic() if fixed_order else contextlib.nullcontext():
            model, step = _trainer(args, num_tasks, device,
                                   kernels_on=kernels_on, data=code)
            loss = step(batch).item()
            return loss, {n: p.grad for n, p in model.named_parameters()}

    # the plain route against itself, without and with a fixed order: the
    # spread the comparison below would otherwise have to absorb
    spread = [max(_rel_err(a[n], b[n]) for n in a) for a, b in (
        (one_step(False, False)[1], one_step(False, False)[1]),
        (one_step(False, True)[1], one_step(False, True)[1]))]
    print(f"[8b] the plain route against itself: gradients differ by "
          f"{spread[0]:.3g} of max(1, max|ref|) with index_add_'s atomics, "
          f"{spread[1]:.3g} under deterministic algorithms")
    got = [one_step(True, True), one_step(False, True)]
    (lk, gk), (lp, gp) = got
    g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
    g_abs = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    if abs(lk - lp) > LOGITS_TOL or g_err > GRAD_TOL:
        raise AssertionError(f"code2 train step through the kernels: loss "
                             f"|diff| {abs(lk - lp)} (<= {LOGITS_TOL}), "
                             f"gradients {g_err} (<= {GRAD_TOL})")
    print(f"[8b] one code2 train step (W={batch.pack_w}/{batch.pack2_w}/"
          f"{batch.pack3_w}, attention dropout {args.transformer_dropout}, "
          f"same seeds, deterministic algorithms) through the kernels vs the "
          f"plain versions on the card: loss {lk:.6f} vs {lp:.6f} (|diff| "
          f"{abs(lk - lp):.3g} <= {LOGITS_TOL}), gradients max |diff| {g_abs:.3g}, relative to "
          f"max(1, max|ref|) {g_err:.3g} (<= {GRAD_TOL})")
    return launches


def phase8_step512(device, bench, num_tasks: int, smi: str):
    """(c) The code2 train step on the 512-graph batch at the published
    width: median of 10 after 3 warm-ups, peak memory, and the device time
    by layer."""
    import types

    args = _code2_train_args()
    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    model, step = _trainer(args, num_tasks, device, data=sizes)
    tb = bench.to(device)
    n = int(bench.graph_mask.sum())
    _median_ms(lambda: step(tb), 3)                         # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    if not torch.isfinite(loss):
        raise AssertionError("code2 512-graph train step: loss not finite")
    print(f"[8c] code2 train step of {n} graphs (forward, backward, AdamW; "
          f"attention dropout {args.transformer_dropout}): median {ms:.3f} ms "
          f"over {TIMED_STEPS} (min {lo:.3f}, max {hi:.3f}), "
          f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on {smi} "
          f"(forward alone: phase 7c)")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(tb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    _print_split("[8c]", "code2 train step", prof, PROFILED_STEPS, wall, smi,
                 graphs=n)


# ---- phase 9: the Transformer-only model, serving --------------------------


def _tf_args(config: str, extra=()):
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.utils.config import parse_with_config

    return parse_with_config(predict.build_parser(), [
        "--configs", config, "--data_root", SNAPSHOT, "--seed", str(SEED),
        *extra])


def dense_valid(batch, max_input_len: int = 1000) -> torch.Tensor:
    """The key mask [G, S+1] the Transformer-only encoder gets for
    ``batch``: ``nodes_to_dense``'s valid and the CLS column."""
    from graphtrans_tpu_torch.ops.dense import nodes_to_dense

    tb = batch.to("cpu")
    S = min(batch.max_nodes_dense, max_input_len)
    _, valid = nodes_to_dense(torch.zeros(batch.num_node_slots, 1),
                              tb.node_graph, tb.node_pos, tb.node_mask,
                              batch.num_graph_slots, S)
    return torch.cat([valid, torch.ones(len(valid), 1, dtype=torch.bool)], 1)


def k4_inputs(valid, d: int, gen: torch.Generator, device):
    """K4's arguments as the encoder packs rows of ``valid`` [G, S]: 128 // S
    graphs a row with block S where that is 2 or more, else block 0; random
    qkv."""
    from graphtrans_tpu_torch.nn.transformer import graphs_per_row

    G, S = valid.shape
    gb = graphs_per_row(S)
    valid = torch.cat([valid, valid.new_zeros(-G % gb, S)]).reshape(-1, gb * S)
    qkv = torch.randn(len(valid), gb * S, 3 * d, generator=gen)
    return qkv.to(device), valid.to(device), S if gb > 1 else 0


def k5_inputs(valid, d: int, gen: torch.Generator, device,
              masked_rows: int = 1):
    """K5's arguments for the rows of ``valid`` [B, S] with ``masked_rows``
    rows without a valid key appended; random qkv."""
    valid = torch.cat([valid, valid.new_zeros(masked_rows, valid.shape[1])])
    qkv = torch.randn(*valid.shape, 3 * d, generator=gen)
    return qkv.to(device), valid.to(device)


def _live(valid, block: int) -> torch.Tensor:
    """[B, S]: the query has a key it may attend (K4's mask, or K5's
    key-padding mask with block 0)."""
    B, S = valid.shape
    if block == 0:
        return valid.any(-1, keepdim=True).expand(B, S)
    return valid.reshape(B, S // block, block).any(-1).repeat_interleave(
        block, dim=1)


def _check_rows(name: str, got, live):
    """A query with no key outputs exact zeros; every other query (padding
    queries included) a non-zero row."""
    if got[~live].any():
        raise AssertionError(f"{name}: queries without a key are not "
                             f"exactly zero")
    if not (got[live].abs().sum(-1) > 0).all():
        raise AssertionError(f"{name}: a query with keys output zeros")


def check_k4(qkv, valid, nhead: int, block: int):
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  attention_dense_plain)

    got = attention_dense(qkv, valid, nhead, block)
    torch.cuda.synchronize()
    err = (got - attention_dense_plain(qkv, valid, nhead, block)
           ).abs().max().item()
    if err > K2_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"K4 (block {block}) disagrees with its plain "
                             f"version: max |diff| {err} > {K2_TOL}")
    _check_rows("K4", got, _live(valid, block))
    return err


def check_k5(qkv, valid, nhead: int):
    from graphtrans_tpu_torch.ops.kernels import (flash_attention,
                                                  flash_attention_plain,
                                                  key_padding_segs)

    segs = key_padding_segs(valid)
    got = flash_attention(qkv, *segs, nhead)
    torch.cuda.synchronize()
    err = (got - flash_attention_plain(qkv, *segs, nhead)).abs().max().item()
    if err > K2_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"K5 disagrees with its plain version: max "
                             f"|diff| {err} > {K2_TOL}")
    _check_rows("K5", got, _live(valid, 0))
    return err


def _attention_bytes(qkv, valid, mask_bytes: int) -> int:
    """q read and out written for every query, K and V read for the valid
    keys only (no query needs an invalid key's), and the mask's bytes."""
    B, S, d3 = qkv.shape
    return (2 * B * S + 2 * int(valid.sum().item())) * (d3 // 3) * 4 \
        + mask_bytes


def _fwd_bound(nbytes: int, pairs: int, hd: int, tensor_cores: bool):
    """Per (query, key) pair the score and the weighted sum (2*hd flops
    each) and the softmax (4). With ``tensor_cores`` the products are timed
    as the long forward runs them, 3xTF32 (three TF32 passes) on the tensor
    cores, the softmax on the f32 units; the two kinds of unit run side by
    side, so the bound is the larger of the bytes' time and each unit's."""
    if not tensor_cores:
        return _bound(nbytes, pairs * (4 * hd + 4))
    return _tc_bound(nbytes, 3 * pairs * 4 * hd, pairs * 4)


def k4_bound(qkv, valid, nhead: int, block: int, tensor_cores: bool = False):
    """The bytes of _attention_bytes with key_valid read as the kernel reads
    it (torch's bool, one byte a key); the operations of _fwd_bound for the
    pairs of a block and head (f32 SIMT unless ``tensor_cores``)."""
    B, S, d3 = qkv.shape
    hd = d3 // 3 // nhead
    if block:
        pairs = int((valid.reshape(B, S // block, block).sum(-1) * block)
                    .sum().item())
    else:
        pairs = int(valid.sum().item()) * S
    nbytes = _attention_bytes(qkv, valid, valid.numel() * valid.element_size())
    return _fwd_bound(nbytes, pairs * nhead, hd, tensor_cores)


def k5_bound(qkv, valid, nhead: int, tensor_cores: bool = True):
    """As k4_bound for the key-padding form (every query of a row attends
    its valid keys), with the mask read as segq and segk (int32); by
    default against the tensor cores that the long forward's products run
    on (``tensor_cores=False``: the f32 SIMT bound, printed beside it)."""
    B, S, d3 = qkv.shape
    hd = d3 // 3 // nhead
    pairs = int(valid.sum().item()) * S
    nbytes = _attention_bytes(qkv, valid, 2 * valid.numel() * 4)
    return _fwd_bound(nbytes, pairs * nhead, hd, tensor_cores)


def check_stats(name: str, m, l, qkv, meet, nhead: int) -> float:
    """m and l of a forward against the plain scores in float64 (``meet``
    bool [B, S, S]: the pairs that meet): m the max scaled score of a
    query's keys, l the sum of exp(s - m) over them (within K2_TOL, l
    relative to max(1, l)); a query without a key has m = -inf and l = 0
    exactly. Returns the largest of the two errors."""
    B, S, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    q, k, _ = (t.double().reshape(B, S, nhead, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5
    s = s.masked_fill(~meet[:, None], float("-inf"))
    mx = s.amax(-1).transpose(1, 2)
    has = meet.any(-1)[:, :, None].expand_as(mx)
    lsum = torch.exp(s - torch.where(has.transpose(1, 2), mx.transpose(1, 2),
                                     0.0)[..., None]).sum(-1).transpose(1, 2)
    del s
    m_err = (m.double()[has] - mx[has]).abs().max().item()
    l_err = ((l.double()[has] - lsum[has]).abs()
             / lsum[has].clamp_min(1.0)).max().item()
    if max(m_err, l_err) > K2_TOL or (m[~has] != float("-inf")).any() \
            or l[~has].any():
        raise AssertionError(f"{name}: m |diff| {m_err}, l relative |diff| "
                             f"{l_err} (<= {K2_TOL}), or a query without a "
                             f"key has m != -inf or l != 0")
    return max(m_err, l_err)


def k4_meet(valid, block: int):
    """K4's pairs [B, S, S]: a valid key of the query's graph block (block
    0: the row)."""
    S = valid.shape[1]
    grp = torch.arange(S, device=valid.device) // (block or S)
    return valid[:, None, :] & (grp[:, None] == grp[None, :])


def seg_meet(segq, segk):
    return (segq[:, :, None] == segk[:, None, :]) & (segk >= 0)[:, None, :]


def _block_mask(valid, block: int):
    B, S = valid.shape
    mask = valid[:, None, None, :]
    if block:
        grp = torch.arange(S, device=valid.device) // block
        mask = mask & (grp[:, None] == grp[None, :])
    return mask


def k5_tags(valid, form: str):
    """K5's tags for rows of ``valid`` [B, S]: the key-padding form, or the
    segment form on the same rows (each row's valid tokens cut into
    segments of 40, padding tokens -1)."""
    from graphtrans_tpu_torch.ops.kernels import key_padding_segs

    if form == "key_padding":
        return key_padding_segs(valid)
    S = valid.shape[1]
    seg = (torch.arange(S, device=valid.device) // 40).expand_as(valid)
    seg = torch.where(valid, seg, -1).to(torch.int32).contiguous()
    return seg, seg


def check_long_forward(cases: dict, gen, device, seed: int):
    """K5's long forward at code2's rows (``cases``: name -> key mask [B, S];
    its first 5 rows and a fully masked one) in both tag forms, at hd 32, 64
    and 128 (4 heads) and rates 0 and 0.3: the output against the plain version
    (within K2_TOL; queries without a key exactly 0) and m and l against
    the plain scores. Returns (output |diff|, statistics |diff|)."""
    from graphtrans_tpu_torch.ops.kernels import flash_attention_plain
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    nhead = 4
    f_err = s_err = 0.0
    for name, valid in cases.items():
        for hd in (32, 64, 128):
            qkv, v = k5_inputs(valid[:5], nhead * hd, gen, device)
            for form in ("key_padding", "seg"):
                segs = k5_tags(v, form)
                meet = seg_meet(*segs)
                for rate in (0.0, DROPOUT):
                    out, m, l = flash_attention_with_stats(
                        qkv, *segs, nhead, rate, seed)
                    torch.cuda.synchronize()
                    err = (out - flash_attention_plain(
                        qkv, *segs, nhead, rate, seed)).abs().max().item()
                    if err > K2_TOL or not torch.isfinite(out).all():
                        raise AssertionError(
                            f"K5 {name} hd {hd} {form} rate {rate}: max "
                            f"|diff| {err} > {K2_TOL}")
                    live = meet.any(-1)
                    if out[~live].any():
                        raise AssertionError(f"K5 {name} hd {hd} {form}: a "
                                             f"query without a key is not 0")
                    f_err = max(f_err, err)
                    s_err = max(s_err, check_stats(
                        f"K5 {name} hd {hd} {form} rate {rate}", m, l, qkv,
                        meet, nhead))
    return f_err, s_err


def time_long_forward(valid, gen, device, base):
    """K5's long forward on the rows of ``valid`` (bench512's key masks,
    4 heads): at hd 32 and 128 beside ``base``'s forward in turns; and at
    hd 64 with every row's keys cut to n valid ones (n - 1 nodes and the
    CLS column; n = 0, 1, 64, 128, 256), which prices a block's set-up and
    each chunk of 64 keys. Prints both."""
    from graphtrans_tpu_torch.ops.kernels import (flash_attention,
                                                  key_padding_segs)

    for hd in (32, 128):
        qkv, v = k5_inputs(valid, 4 * hd, gen, device, masked_rows=0)
        segs = key_padding_segs(v)
        ms, earlier = turns_ms(
            lambda: flash_attention(qkv, *segs, 4),
            base and (lambda: base["flash_attention"].flash_attention(
                qkv, *segs, 4)), 5)
        print(f"[9a] bench512 S {v.shape[1]} K5 flash_attention at hd {hd} "
              f"(d {4 * hd}): kernel {ms:.4f} ms against {_ms(earlier)} for "
              f"the earlier design, in turns")
        del qkv
    qkv, v = k5_inputs(valid, 256, gen, device, masked_rows=0)
    B, S = v.shape
    per = {}
    for n in (0, 1, 64, 128, 256):
        cut = torch.zeros_like(v)
        if n:
            cut[:, :n - 1] = True
            cut[:, -1] = True
        segs = key_padding_segs(cut)
        per[n] = time_ms(lambda: flash_attention(qkv, *segs, 4), iters=5)
    print(f"[9a] K5 flash_attention at [B={B} S={S} d=256 H=4] with n valid "
          f"keys a row (chunks of 64 by rank): "
          + ", ".join(f"n {n}: {ms:.4f} ms" for n, ms in per.items()))


def phase9_kernels(device, mol_bench, code2_bench, base=None):
    """(a) K4 and K5 against their plain versions at the Transformer-only
    model's shapes: K4 at block 49 (the molpcba snapshot), 33 (4096
    molecules) and 0 (code2 rows cut to 256 and 383 nodes: S 257 and 384,
    the long instance), at hd 64 and 32; K5 at the code2 snapshot's first
    train batch (S 1001), its valid split (S 513) and 512 ASTs (S 1001),
    and on the snapshot's rows at hd 32, 64 and 128 in both tag forms at
    rates 0 and 0.3 with m and l; with the rows the function leaves zero.
    Times kernel (beside ``base``'s, the earlier design, in turns), plain
    version, bound and SDPA."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  attention_dense_plain,
                                                  flash_attention,
                                                  flash_attention_plain,
                                                  key_padding_segs)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        dense_fwd_geometry)

    gen = torch.Generator().manual_seed(SEED + 9)
    first = {}
    for name, config, split in (("mol", TF_MOL_CONFIG, "train"),
                                ("code2_train", TF_CODE2_CONFIG, "train"),
                                ("code2_valid", TF_CODE2_CONFIG, "valid")):
        args = _tf_args(config)
        splits, num_tasks, _ = predict.load_splits(args)
        first[name] = next(iterate_batches(splits[split], **predict.
                                           serving_layout(splits, args,
                                                          num_tasks,
                                                          split=split)))
    mol_args = _tf_args(TF_MOL_CONFIG)
    d, nhead = mol_args.d_model, mol_args.nhead
    k4_cases = {"serve256 block 49": dense_valid(first["mol"]),
                "bench4096 block 33": dense_valid(mol_bench),
                "bench512 cut to 256, block 0": dense_valid(code2_bench, 256),
                "bench512 cut to 383, block 0": dense_valid(code2_bench, 383)}
    k5_cases = {"train16 S 1001": dense_valid(first["code2_train"]),
                "valid16 S 513": dense_valid(first["code2_valid"]),
                "bench512 S 1001": dense_valid(code2_bench)}
    k4_err = k5_err = 0.0
    timed = {}
    same = []         # cases whose bits equal the parent's (--baseline)
    for name, valid in k4_cases.items():
        qkv, v, block = k4_inputs(valid, d, gen, device)
        if int(name.split()[-1]) != block or qkv.shape[1] % max(block, 1):
            raise AssertionError(f"K4 {name}: packed as block {block}, "
                                 f"rows of {qkv.shape[1]}")
        k4_err = max(k4_err, check_k4(qkv, v, nhead, block))
        narrow = torch.randn(*qkv.shape[:2], 3 * nhead * 32,
                             generator=gen).to(device)      # hd 32
        k4_err = max(k4_err, check_k4(narrow, v, nhead, block))
        del narrow
        ms, earlier = turns_ms(
            lambda: attention_dense(qkv, v, nhead, block),
            base and (lambda: base["attention_packed"].attention_dense(
                qkv, v, nhead, block)), 20)
        same_bits(f"K4 {name}", lambda: attention_dense(qkv, v, nhead, block),
                  base and (lambda: base["attention_packed"].attention_dense(
                      qkv, v, nhead, block)), same)
        t = dict(ms=ms, earlier_ms=earlier,
                 instance=dense_fwd_geometry(*qkv.shape[:2], block,
                                             d // nhead, nhead, False,
                                             0.0).instance,
                 plain_ms=time_ms(lambda: attention_dense_plain(
                     qkv, v, nhead, block), iters=3),
                 library_ms=sdpa_mask_ms(qkv, _block_mask(v, block), nhead,
                                         iters=3))
        t["bound_ms"], t["bound_by"] = k4_bound(qkv, v, nhead, block)
        t["tc_bound_ms"] = k4_bound(qkv, v, nhead, block, True)[0]
        t["shape"] = f"B={qkv.shape[0]} S={qkv.shape[1]} d={d} H={nhead}"
        timed[("K4 attention_dense", name)] = t
    for name, valid in k5_cases.items():
        qkv, v = k5_inputs(valid, d, gen, device)
        k5_err = max(k5_err, check_k5(qkv, v, nhead))
        qkv, v = qkv[:-1].contiguous(), v[:-1]     # timed as the model runs
        segs = key_padding_segs(v)
        ms, earlier = turns_ms(
            lambda: flash_attention(qkv, *segs, nhead),
            base and (lambda: base["flash_attention"].flash_attention(
                qkv, *segs, nhead)), 5)
        t = dict(ms=ms, earlier_ms=earlier, instance="long",
                 plain_ms=time_ms(lambda: flash_attention_plain(
                     qkv, *segs, nhead), iters=1),
                 library_ms=sdpa_mask_ms(qkv, _block_mask(v, 0), nhead,
                                         iters=3))
        t["bound_ms"], t["bound_by"] = k5_bound(qkv, v, nhead)
        t["f32_simt_bound_ms"] = k5_bound(qkv, v, nhead, False)[0]
        t["shape"] = (f"B={qkv.shape[0]} S={qkv.shape[1]} d={d} H={nhead} "
                      f"valid keys {int(v.sum().item())}")
        timed[("K5 flash_attention", name)] = t
    time_long_forward(k5_cases["bench512 S 1001"], gen, device, base)
    forms_err, stats_err = check_long_forward(
        {k: v for k, v in k5_cases.items() if not k.startswith("bench")}, gen,
        device, 2**31 - 9)
    k5_err = max(k5_err, forms_err)
    print(f"[9a] K4 and K5 agree with their plain versions: K4 max |diff| "
          f"{k4_err:.3g} at {list(k4_cases)} (hd 64 and 32), K5 {k5_err:.3g} "
          f"at {list(k5_cases)} and, on the snapshot's rows, at hd 32, 64 "
          f"and 128 in both tag forms at rates 0 and {DROPOUT} (<= "
          f"{K2_TOL}), with m and l within {stats_err:.3g} of the plain "
          f"scores; queries without a key exactly 0, every other query "
          f"(padding queries included) non-zero")
    if base:
        print(f"[9a] --baseline: the same bits as the parent's kernel on the "
              f"same inputs at {same}")
    for (kname, name), t in timed.items():
        print(f"[9a] {name} {kname} ({t['instance']} instance) "
              f"[{t['shape']}]: kernel {t['ms']:.4f} ms against "
              f"{_ms(t['earlier_ms'])} for the earlier design, in turns")
        extra = (f"; {t['f32_simt_bound_ms']:.4f} ms at the f32 SIMT peak, "
                 f"products on the tensor cores in 3xTF32"
                 if "f32_simt_bound_ms" in t else
                 f"; {t['tc_bound_ms']:.4f} ms with the products on the "
                 f"tensor cores in 3xTF32")
        print(f"[9a] {name} {kname} [{t['shape']}]: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}{extra}), library {t['library_ms']:.4f} ms "
              f"(SDPA, bool mask); kernel/SDPA "
              f"{t['ms'] / t['library_ms']:.3f}")
    k4 = timed[("K4 attention_dense", "bench4096 block 33")]
    k5 = timed[("K5 flash_attention", "bench512 S 1001")]
    pick = lambda t: {k: t[k] for k in ("ms", "earlier_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}
    return dict(k4_err=k4_err, k5_err=k5_err, timed=(pick(k4), pick(k5)))


# The kernel each served split's attention must launch, from the JAX
# package's TPU rule for the split's row width: molpcba's rows of 48 + CLS
# pack 2 graphs with block 49 (K4); code2's train (1000 + CLS) and valid
# (512 + CLS) rows take K5, its test rows (448 + CLS) the plain softmax.
TF_SERVE_KERNEL = {(TF_MOL_CONFIG, "train"): "attention_dense",
                   (TF_MOL_CONFIG, "valid"): "attention_dense",
                   (TF_MOL_CONFIG, "test"): "attention_dense",
                   (TF_CODE2_CONFIG, "valid"): "flash_attention",
                   (TF_CODE2_CONFIG, "train"): "flash_attention",
                   (TF_CODE2_CONFIG, "test"): None}


def phase9_serve(device, tmp: str):
    """(b) Both Transformer-only ymls through the serving entry point on
    the snapshot (molpcba: all three splits; code2: valid and train, where
    K5 runs, and test, whose rows of 449 take the plain softmax), launches
    counted from 0 for each split; then the logits through the kernels
    against the plain versions on the card, every batch of every split."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.nn.transformer import graphs_per_row
    from graphtrans_tpu_torch.ops import kernels

    totals = collections.Counter()
    for config, split_names in ((TF_MOL_CONFIG, ("train", "valid", "test")),
                                (TF_CODE2_CONFIG, ("valid", "train", "test"))):
        args = _tf_args(config)
        splits, num_tasks, code = predict.load_splits(args)
        for split in split_names:
            out = os.path.join(tmp, f"tf_{split}.jsonl")
            kernels.reset_launches()         # this split's serving path
            t0 = time.perf_counter()
            res = predict.main(["--configs", config, "--data_root", SNAPSHOT,
                                "--split", split, "--seed", str(SEED),
                                "--out", out])
            secs = time.perf_counter() - t0
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
            recs = [json.loads(line) for line in open(out)]
            if (len(recs) != len(splits[split])
                    or sorted(r["graph_id"] for r in recs)
                    != list(range(len(splits[split])))):
                raise AssertionError(f"{args.dataset} {split}: {len(recs)} "
                                     f"records for {len(splits[split])}")
            if code is None:
                ok = all(len(r["logits"]) == num_tasks
                         and all(math.isfinite(x) for x in r["logits"])
                         for r in recs)
            else:
                ok = (all(len(r["tokens"]) == code.max_seq_len
                          and 0 <= min(r["tokens"])
                          and max(r["tokens"]) < num_tasks for r in recs)
                      and 0.0 <= res["F1"] <= 1.0)
            if not ok:
                raise AssertionError(f"{args.dataset} {split}: malformed "
                                     f"records or F1")
            layout = predict.serving_layout(splits, args, num_tasks,
                                            split=split)
            S = layout["dense_cap"] + 1
            gb = graphs_per_row(S)
            kernel = TF_SERVE_KERNEL[(config, split)]
            want = ({kernel: args.num_encoder_layers * res["batches"]}
                    if kernel else {})
            if launches != want:
                raise AssertionError(f"{args.dataset} {split}: launches "
                                     f"{launches}, expected {want}")
            if kernels.attention_dense.instances["long"]:
                raise AssertionError(f"{args.dataset} {split}: K4 forward "
                                     f"launches off the tile instance: "
                                     f"{kernels.attention_dense.instances}")
            totals.update(launches)
            totals.update({f"attention_dense {k}": v for k, v in
                           kernels.attention_dense.instances.items()})
            f1 = "" if code is None else f", F1 {res['F1']:.6f}"
            print(f"[9b] served the {args.dataset} {split} split through "
                  f"graphtrans_tpu_torch.predict ({res['records']} graphs, "
                  f"{res['batches']} batches of <= {args.batch_size}, rows of "
                  f"{S} tokens, {gb} a packed row, kernel {kernel}{f1}; "
                  f"{secs:.2f} s with the model build): launches {launches}")
    if not (totals["attention_dense"] > 0 and totals["flash_attention"] > 0):
        raise AssertionError(f"K4 or K5 never launched: {dict(totals)}")

    for config in (TF_MOL_CONFIG, TF_CODE2_CONFIG):
        args = _tf_args(config)
        splits, num_tasks, code = predict.load_splits(args)
        model = predict.build_model(args, num_tasks, device, code)
        err = 0.0
        with torch.inference_mode():
            for split in ("train", "valid", "test"):
                layout = predict.serving_layout(splits, args, num_tasks,
                                                split=split)
                for b in iterate_batches(splits[split], **layout):
                    tb = b.to(device)
                    gm = tb.graph_mask
                    got = model(tb)[gm]
                    kernels.set_kernels(model, False)
                    plain = model(tb)[gm]
                    kernels.set_kernels(model, True)
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{args.dataset}: logits not "
                                             f"finite")
                    err = max(err, (got - plain).abs().max().item())
        if err > LOGITS_TOL:
            raise AssertionError(f"{args.dataset} Transformer-only logits "
                                 f"through the kernels differ from the plain "
                                 f"versions by {err} > {LOGITS_TOL}")
        print(f"[9b] {args.dataset} Transformer-only logits through the "
              f"kernels match the plain versions on the card over all three "
              f"splits: max |diff| {err:.3g} (<= {LOGITS_TOL})")
    return totals


def phase9_forward(device, mol_bench, code2_bench, code2_tasks: int,
                   smi: str):
    """(c) The Transformer-only forward of 4096 molecules and of 512 ASTs
    in the flat unpacked layout at the published widths: median of 10
    after 3 warm-ups, graphs/s, peak memory, and a torch.profiler split."""
    import types

    from graphtrans_tpu_torch.models import build_model
    from graphtrans_tpu_torch.nn.init import init_weights

    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    for name, config, bench, tasks in (
            ("molpcba", TF_MOL_CONFIG, mol_bench, 128),
            ("code2", TF_CODE2_CONFIG, code2_bench, code2_tasks)):
        args = _tf_args(config)
        model = build_model(args, tasks, device, data=sizes)
        init_weights(model, torch.Generator().manual_seed(SEED)).eval()
        tb = bench.to(device)
        n = int(bench.graph_mask.sum())
        torch.cuda.reset_peak_memory_stats(device)
        with torch.inference_mode():
            _median_ms(lambda: model(tb), 3)                # warm-up
            ms, lo, hi, out = _median_ms(lambda: model(tb), 10)
        if not torch.isfinite(out[tb.graph_mask]).all():
            raise AssertionError(f"{name} Transformer-only bench batch: "
                                 f"logits not finite")
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        S = min(bench.max_nodes_dense, args.max_input_len) + 1
        print(f"[9c] {name} Transformer-only forward of {n} graphs (flat, "
              f"rows of {S} tokens, {args.num_encoder_layers} layers, "
              f"d_model {args.d_model}): median {ms:.3f} ms over 10 (min "
              f"{lo:.3f}, max {hi:.3f}), {n / ms * 1e3:.0f} graphs/s, peak "
              f"memory {peak:.2f} GiB on {smi}")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.inference_mode():
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_FORWARDS):
                    model(tb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FORWARDS
        _print_split("[9c]", f"{name} Transformer-only forward", prof,
                     PROFILED_FORWARDS, wall, smi, graphs=n)


# ---- phase 10: the Transformer-only model, training ------------------------


def check_k4_train(qkv, valid, nhead: int, block: int, rate: float,
                   seed: int, gen):
    """K4 with dropout ``rate`` and K4-bwd against the plain version (the
    same mask) and its autograd; a block without a valid key gives zero
    dq, dk and dv, and a padding key zero dk and dv."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense_bwd,
                                                  attention_dense_bwd_plain,
                                                  attention_dense_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_dense_with_stats)

    d = qkv.shape[2] // 3
    g = torch.randn(*qkv.shape[:2], d, generator=gen).to(qkv.device)
    saved = attention_dense_with_stats(qkv, valid, nhead, block, rate, seed)
    dqkv = attention_dense_bwd(qkv, valid, nhead, g, block, rate, seed, saved)
    torch.cuda.synchronize()
    f_err = (saved[0] - attention_dense_plain(qkv, valid, nhead, block, rate,
                                              seed)).abs().max().item()
    b_err = _rel_err(dqkv, attention_dense_bwd_plain(qkv, valid, nhead, g,
                                                      block, rate, seed))
    if f_err > K2_TOL or b_err > GRAD_TOL or not torch.isfinite(dqkv).all():
        raise AssertionError(f"K4 (block {block}) at rate {rate}: forward "
                             f"|diff| {f_err} (<= {K2_TOL}), backward "
                             f"{b_err} (<= {GRAD_TOL})")
    check_stats(f"K4 (block {block}) at rate {rate}", saved[1][:64],
                saved[2][:64], qkv[:64], k4_meet(valid[:64], block), nhead)
    dead = ~_live(valid, block)   # dropout may zero a live query's row
    if saved[0][dead].any() or dqkv[dead].any() or dqkv[..., d:][~valid].any():
        raise AssertionError("K4 with dropout: a dead block's output or "
                             "gradient, or a padding key's, is not zero")
    return f_err, b_err, g


def check_k5_train(qkv, valid, nhead: int, rate: float, seed: int, gen,
                   rows: int):
    """K5 with dropout and K5-bwd on all rows of ``qkv`` against the plain
    version and its autograd on the first ``rows`` (the plain backward of
    all 513 bench rows would hold [513, H, 1001, 1001] probabilities);
    queries without a key and padding keys get zero gradients."""
    from graphtrans_tpu_torch.ops.kernels import (flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain,
                                                  key_padding_segs)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    d = qkv.shape[2] // 3
    segs = key_padding_segs(valid)
    g = torch.randn(*qkv.shape[:2], d, generator=gen).to(qkv.device)
    saved = flash_attention_with_stats(qkv, *segs, nhead, rate, seed)
    dqkv = flash_attention_bwd(qkv, *segs, nhead, g, rate, seed, saved)
    torch.cuda.synchronize()
    head = [t[:rows] for t in (qkv, *segs)]
    f_err = (saved[0][:rows] - flash_attention_plain(*head, nhead, rate, seed)
             ).abs().max().item()
    b_err = _rel_err(dqkv[:rows], flash_attention_bwd_plain(
        *head, nhead, g[:rows], rate, seed))
    if f_err > K2_TOL or b_err > GRAD_TOL or not torch.isfinite(dqkv).all():
        raise AssertionError(f"K5 at rate {rate}: forward |diff| {f_err} "
                             f"(<= {K2_TOL}), backward {b_err} "
                             f"(<= {GRAD_TOL})")
    check_stats(f"K5 at rate {rate}", saved[1][:8], saved[2][:8], qkv[:8],
                seg_meet(*(t[:8] for t in segs)), nhead)
    dead = ~_live(valid, 0)       # dropout may zero a live query's row
    if saved[0][dead].any() or dqkv[dead].any() or dqkv[..., d:][~valid].any():
        raise AssertionError("K5 with dropout: a query without a key, or a "
                             "padding key, has a non-zero output or "
                             "gradient")
    return f_err, b_err, g


def k4_bwd_bound(qkv, valid, nhead: int, block: int, mask_bytes=None,
                 tensor_cores: bool = False):
    """K4-bwd reads q and dO for every query, K and V for the valid keys,
    out, m and l of the forward and the mask (``mask_bytes``: torch's bool,
    one byte a key, unless given), and writes dqkv; per (query, key) pair
    of a block and head: the score, dp = dO.v and the dq, dk and dv
    products (2*hd each), and the softmax and dropout arithmetic (8). With
    ``tensor_cores`` the products are timed as the long-row backward runs
    them, 3xTF32 (three TF32 passes) on the tensor cores, the rest on the
    f32 units; the two kinds of unit run side by side, so the bound is the
    larger of the bytes' time and each unit's."""
    B, S, d3 = qkv.shape
    d, hd = d3 // 3, d3 // 3 // nhead
    keys = int(valid.sum().item())
    pairs = (int((valid.reshape(B, S // block, block).sum(-1) * block).sum()
                 .item()) if block else keys * S) * nhead
    nbytes = ((3 * B * S + 2 * keys) * d + B * S * d3 + 2 * B * S * nhead) \
        * 4 + (valid.numel() if mask_bytes is None else mask_bytes)
    if not tensor_cores:
        return _bound(nbytes, pairs * (10 * hd + 8))
    return _tc_bound(nbytes, 3 * pairs * 10 * hd, pairs * 8)


def k5_bwd_bound(qkv, valid, nhead: int, tensor_cores: bool = True):
    """As k4_bwd_bound for the key-padding form, the mask read as segq and
    segk (int32); by default against the tensor cores that the long-row
    backward's products run on (``tensor_cores=False``: the f32 SIMT
    bound, printed beside it)."""
    return k4_bwd_bound(qkv, valid, nhead, 0, 2 * valid.numel() * 4,
                        tensor_cores)


def _chunked_plain_bwd_ms(fn, qkv, g, rows: int) -> float:
    """The plain version's backward over all rows of ``qkv``, measured
    ``rows`` rows at a time (each chunk's autograd graph fits the card)."""
    total = 0.0
    for r0 in range(0, qkv.shape[0], rows):
        total += _plain_bwd_ms(lambda t: fn(t, r0), [qkv[r0:r0 + rows]],
                               g[r0:r0 + rows])
    return total


def phase10_kernels(device, mol_bench, code2_bench, base=None):
    """(a) K4 and K5 with attention dropout 0.3 and their backward kernels
    against the plain versions and autograd at the Transformer-only
    model's training shapes, and K11 against its plain version at the
    widths of the bench512 activations; times beside bound, plain version
    and library yardstick (K4-bwd and K5-bwd also beside ``base``'s, the
    earlier design, in turns)."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops.kernels import (
        attention_dense_bwd, attention_dense_plain, byte_dropout,
        byte_dropout_plain, flash_attention_bwd, flash_attention_plain,
        key_padding_segs)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_dense_with_stats, dense_bwd_geometry)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    gen = torch.Generator().manual_seed(SEED + 10)
    first = {}
    for name, config, split in (("mol", TF_MOL_CONFIG, "train"),
                                ("code2_train", TF_CODE2_CONFIG, "train"),
                                ("code2_valid", TF_CODE2_CONFIG, "valid")):
        args = _tf_args(config)
        splits, num_tasks, _ = predict.load_splits(args)
        first[name] = next(iterate_batches(splits[split], **predict.
                                           serving_layout(splits, args,
                                                          num_tasks,
                                                          split=split)))
    args = _tf_args(TF_MOL_CONFIG)
    d, nhead = args.d_model, args.nhead
    seed = 2**31 - 11
    k4_cases = {"serve256 block 49": dense_valid(first["mol"]),
                "bench4096 block 33": dense_valid(mol_bench),
                "bench512 cut to 256, block 0": dense_valid(code2_bench, 256),
                "bench512 cut to 383, block 0": dense_valid(code2_bench, 383)}
    k5_cases = {"train16 S 1001": dense_valid(first["code2_train"]),
                "valid16 S 513": dense_valid(first["code2_valid"]),
                "bench512 S 1001": dense_valid(code2_bench)}
    k4_err = k4_ferr = k5_err = k5_ferr = 0.0
    timed = {}
    same = []         # cases whose bits equal the parent's (--baseline)
    for name, valid in k4_cases.items():
        qkv, v, block = k4_inputs(valid, d, gen, device)
        if int(name.split()[-1]) != block:
            raise AssertionError(f"K4 {name}: packed as block {block}")
        narrow = torch.randn(*qkv.shape[:2], 3 * nhead * 32,
                             generator=gen).to(device)      # hd 32
        f, e, _ = check_k4_train(narrow, v, nhead, block, DROPOUT, seed, gen)
        k4_ferr, k4_err = max(k4_ferr, f), max(k4_err, e)
        del narrow
        f, e, g = check_k4_train(qkv, v, nhead, block, DROPOUT, seed, gen)
        k4_ferr, k4_err = max(k4_ferr, f), max(k4_err, e)
        saved = attention_dense_with_stats(qkv, v, nhead, block, DROPOUT,
                                           seed)
        ms, earlier = turns_ms(
            lambda: attention_dense_bwd(qkv, v, nhead, g, block, DROPOUT,
                                        seed, saved),
            base and (lambda: base["attention_packed"].attention_dense_bwd(
                qkv, v, nhead, g, block, DROPOUT, seed, saved)), 10)
        old = base and base["attention_packed"]
        same_bits(f"K4-bwd {name}",
                  lambda: attention_dense_bwd(qkv, v, nhead, g, block,
                                              DROPOUT, seed, saved),
                  old and (lambda: old.attention_dense_bwd(
                      qkv, v, nhead, g, block, DROPOUT, seed, saved)), same)
        same_bits(f"K4 training forward {name}",
                  lambda: attention_dense_with_stats(qkv, v, nhead, block,
                                                     DROPOUT, seed),
                  old and (lambda: old.attention_dense_with_stats(
                      qkv, v, nhead, block, DROPOUT, seed)), same)
        t = dict(ms=ms, earlier_ms=earlier,
                 instance=dense_bwd_geometry(*qkv.shape[:2], block,
                                             d // nhead, nhead).instance,
                 plain_ms=_plain_bwd_ms(lambda x: attention_dense_plain(
                     x, v, nhead, block, DROPOUT, seed), [qkv], g),
                 library_ms=sdpa_bwd_mask_ms(qkv, _block_mask(v, block),
                                             nhead, g, DROPOUT))
        t["bound_ms"], t["bound_by"] = k4_bwd_bound(qkv, v, nhead, block)
        t["fwd_ms"], t["fwd_earlier_ms"] = turns_ms(
            lambda: attention_dense_with_stats(qkv, v, nhead, block, DROPOUT,
                                               seed),
            base and (lambda: base["attention_packed"].
                      attention_dense_with_stats(qkv, v, nhead, block,
                                                 DROPOUT, seed)), 10)
        t["shape"] = (f"B={qkv.shape[0]} S={qkv.shape[1]} d={d} H={nhead} "
                      f"rate={DROPOUT}")
        timed[("K4-bwd attention_dense_bwd", name)] = t
    for name, valid in k5_cases.items():
        bench = name.startswith("bench")
        qkv, v = k5_inputs(valid, d, gen, device)
        f, e, _ = check_k5_train(qkv, v, nhead, DROPOUT, seed, gen,
                                 64 if bench else len(qkv))
        k5_ferr, k5_err = max(k5_ferr, f), max(k5_err, e)
        qkv, v = qkv[:-1].contiguous(), v[:-1]     # timed as the model runs
        segs = key_padding_segs(v)
        g = torch.randn(*qkv.shape[:2], d, generator=gen).to(device)
        saved = flash_attention_with_stats(qkv, *segs, nhead, DROPOUT, seed)
        plain = lambda x, r0: flash_attention_plain(
            x, *(s[r0:r0 + 64] for s in segs), nhead, DROPOUT, seed)
        ms, earlier = turns_ms(
            lambda: flash_attention_bwd(qkv, *segs, nhead, g, DROPOUT, seed,
                                        saved),
            base and (lambda: base["flash_attention"].flash_attention_bwd(
                qkv, *segs, nhead, g, DROPOUT, seed, saved)), 3)
        t = dict(ms=ms, earlier_ms=earlier, instance="long",
                 plain_ms=_chunked_plain_bwd_ms(plain, qkv, g, 64),
                 library_ms=sdpa_bwd_mask_ms(
                     qkv, _block_mask(v, 0), nhead, g, DROPOUT))
        t["bound_ms"], t["bound_by"] = k5_bwd_bound(qkv, v, nhead)
        t["f32_simt_bound_ms"] = k5_bwd_bound(qkv, v, nhead, False)[0]
        t["fwd_ms"], t["fwd_earlier_ms"] = turns_ms(
            lambda: flash_attention_with_stats(qkv, *segs, nhead, DROPOUT,
                                               seed),
            base and (lambda: base["flash_attention"].
                      flash_attention_with_stats(qkv, *segs, nhead, DROPOUT,
                                                 seed)), 3)
        t["shape"] = (f"B={qkv.shape[0]} S={qkv.shape[1]} d={d} H={nhead} "
                      f"rate={DROPOUT} valid keys {int(v.sum().item())}")
        timed[("K5-bwd flash_attention_bwd", name)] = t
    print(f"[10a] with attention dropout {DROPOUT}: K4 forward within "
          f"{k4_ferr:.3g} and K5 forward within {k5_ferr:.3g} of their plain "
          f"versions (<= {K2_TOL}), m and l within {K2_TOL} of the plain "
          f"scores; K4-bwd from them {k4_err:.3g} at {list(k4_cases)} (hd 64 "
          f"and 32) "
          f"and K5-bwd {k5_err:.3g} at {list(k5_cases)} (bench512: the "
          f"first 64 rows) of max(1, max|ref|) from autograd through the "
          f"plain versions (<= {GRAD_TOL}); dead blocks, queries without a "
          f"key and padding keys get exactly 0")
    if base:
        print(f"[10a] --baseline: the same bits as the parent's kernels on "
              f"the same inputs at {same}")
    for (kname, name), t in timed.items():
        if "instance" in t:
            print(f"[10a] {name} {kname} ({t['instance']} instance) "
                  f"[{t['shape']}]: kernel {t['ms']:.4f} ms against "
                  f"{_ms(t['earlier_ms'])} for the earlier design, in turns; "
                  f"the training forward {t['fwd_ms']:.4f} ms against "
                  f"{_ms(t['fwd_earlier_ms'])}, in turns")
        simt = ("" if "f32_simt_bound_ms" not in t else
                f"; products on the tensor cores in 3xTF32; "
                f"{t['f32_simt_bound_ms']:.4f} ms at the f32 SIMT peak")
        print(f"[10a] {name} {kname} [{t['shape']}]: kernel {t['ms']:.4f} ms "
              f"(training forward {t['fwd_ms']:.4f} ms), plain backward "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}{simt}), library {t['library_ms']:.4f} ms "
              f"(SDPA backward, bool mask, dropout {DROPOUT})")

    tokens = int(code2_bench.num_graph_slots) * (
        min(code2_bench.max_nodes_dense, 1000) + 1)
    t11 = int(round(DROPOUT * 256))
    k11 = {}
    for width in (d, 2 * d):
        x = torch.randn(tokens, width, generator=gen).to(device)
        gx = torch.randn(tokens, width, generator=gen).to(device)
        xg = x.clone().requires_grad_()
        got = byte_dropout(xg, seed, t11)
        got.backward(gx)
        xp = x.clone().requires_grad_()
        want = byte_dropout_plain(xp, seed, t11)
        want.backward(gx)
        if not (torch.equal(got.detach(), want.detach())
                and torch.equal(xg.grad, xp.grad)):
            raise AssertionError(f"K11 at [{tokens}, {width}] disagrees with "
                                 f"its plain version")
        del got, want, xg, xp, gx
        kept = (byte_dropout(x, seed, t11) != 0).float().mean().item()
        k11[width] = dict(
            ms=time_ms(lambda: byte_dropout(x, seed, t11), iters=10),
            plain_ms=time_ms(lambda: byte_dropout_plain(x, seed, t11),
                             iters=2),
            library_ms=time_ms(lambda: torch.nn.functional.dropout(
                x, DROPOUT, training=True), iters=10),
            shape=f"[{tokens}, {width}] t={t11}", kept=kept)
        k11[width]["bound_ms"], k11[width]["bound_by"] = _bound(
            2 * x.numel() * 4, 12 * x.numel())
        del x
    for width, t in k11.items():
        print(f"[10a] K11 byte_dropout {t['shape']} (kept {t['kept']:.4f}, "
              f"expected {(256 - t11) / 256:.4f}): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), library {t['library_ms']:.4f} ms "
              f"(F.dropout at {DROPOUT}: the same work, another mask)")
    print(f"[10a] K11 forward and backward equal their plain versions to the "
          f"bit at [{tokens}, {d}] and [{tokens}, {2 * d}]")
    return dict(k4_err=k4_err, k5_err=k5_err, k11_err=0.0,
                timed=(timed[("K4-bwd attention_dense_bwd",
                              "bench4096 block 33")],
                       timed[("K5-bwd flash_attention_bwd",
                              "bench512 S 1001")],
                       k11[2 * d]))


def _tf_train_args(config: str, extra=()):
    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch.utils.config import parse_with_config

    return parse_with_config(train_main.build_parser(), [
        "--configs", config, "--data_root", SNAPSHOT, "--epochs",
        str(TRAIN_EPOCHS), "--seed", str(SEED), *extra])


# The kernels each yml's training step must launch, by the JAX package's TPU
# rule for the train split's rows: molpcba's rows of 48 + CLS pack 2 graphs
# with block 49 (K4); code2's rows of 1000 + CLS take K5.
TF_TRAIN_KERNELS = {TF_MOL_CONFIG: ("attention_dense", "attention_dense_bwd"),
                    TF_CODE2_CONFIG: ("flash_attention",
                                      "flash_attention_bwd")}


def phase10_train(device, tmp: str):
    """(b) Both Transformer-only ymls through the training entry at full
    width on the snapshot (2 epochs, the ymls' batch sizes), launches
    counted from 0 for each, finite losses and every parameter moved; then
    one step through the kernels against the plain versions."""
    import io

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.ops import kernels

    totals = collections.Counter()
    for config, want_kernels in TF_TRAIN_KERNELS.items():
        args = _tf_train_args(config)
        splits, num_tasks, code = predict.load_splits(args)
        save = os.path.join(tmp, os.path.basename(os.path.dirname(
            os.path.dirname(config))))
        out = io.StringIO()
        kernels.reset_launches()             # this yml's training path
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = train_main.main(["--configs", config, "--data_root",
                                   SNAPSHOT, "--epochs", str(TRAIN_EPOCHS),
                                   "--seed", str(SEED), "--save_path", save])
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        for line in out.getvalue().splitlines():
            print(f"[10b] main: {line}")
        steps = sum(r["steps"] for r in res["epochs"])
        want = {k: args.num_encoder_layers * steps for k in want_kernels}
        if steps == 0 or launches != want:
            raise AssertionError(f"{args.dataset} Transformer-only training "
                                 f"launches {launches}, expected {want}")
        if kernels.attention_dense.instances["long"]:
            raise AssertionError(f"{args.dataset} training: K4 forward "
                                 f"launches off the tile instance: "
                                 f"{kernels.attention_dense.instances}")
        totals.update(launches)
        totals.update({f"attention_dense {k}": v for k, v in
                       kernels.attention_dense.instances.items()})
        totals.update({f"attention_dense_bwd {k}": v for k, v in
                       kernels.attention_dense_bwd.instances.items()})
        if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
            raise AssertionError(f"epoch losses not finite: {res['epochs']}")
        init, _ = _trainer(args, num_tasks, device, data=code)
        trained = torch.load(res["saved"], map_location=device,
                             weights_only=True)
        params = dict(init.named_parameters())
        still = [n for n, p in params.items() if torch.equal(p, trained[n])]
        if still:
            raise AssertionError(f"parameters did not move: {still}")
        print(f"[10b] trained the {args.dataset} Transformer-only yml "
              f"{TRAIN_EPOCHS} epochs ({steps} steps of <= {args.batch_size} "
              f"graphs, attention dropout {args.transformer_dropout}, "
              f"{secs:.2f} s with the model build) through "
              f"graphtrans_tpu_torch.main: losses "
              f"{[round(r['loss'], 6) for r in res['epochs']]}, all "
              f"{len(params)} parameter tensors moved; launches {launches} = "
              f"{args.num_encoder_layers} a step each")

        layout = predict.serving_layout(splits, args, num_tasks,
                                        args.batch_size, split="train",
                                        seed=SEED)
        batch = next(iterate_batches(
            splits["train"], order=shuffled_order(len(splits["train"]), SEED,
                                                  0), **layout)).to(device)
        got = []
        with deterministic():
            for on in (True, False):
                model, step = _trainer(args, num_tasks, device,
                                       kernels_on=on, data=code)
                loss = step(batch).item()
                got.append((loss, {n: p.grad for n, p in
                                   model.named_parameters()}))
        (lk, gk), (lp, gp) = got
        g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
        g_abs = max((gk[n] - gp[n]).abs().max().item() for n in gk)
        if abs(lk - lp) > LOGITS_TOL or g_err > GRAD_TOL:
            raise AssertionError(f"{args.dataset} Transformer-only step "
                                 f"through the kernels: loss |diff| "
                                 f"{abs(lk - lp)} (<= {LOGITS_TOL}), gradients "
                                 f"{g_err} (<= {GRAD_TOL})")
        print(f"[10b] one {args.dataset} Transformer-only train step "
              f"(attention dropout {args.transformer_dropout}, same seeds) "
              f"through the kernels vs the plain versions on the card: loss "
              f"{lk:.6f} vs {lp:.6f} (|diff| {abs(lk - lp):.3g} <= "
              f"{LOGITS_TOL}), gradients max |diff| {g_abs:.3g}, relative to "
              f"max(1, max|ref|) {g_err:.3g} (<= {GRAD_TOL})")
    return totals


def phase10_step(device, mol_bench, code2_bench, code2_tasks: int, smi: str):
    """(c) The Transformer-only train step on 4096 molecules and on 512
    ASTs at the published widths: median of 10 after 3 warm-ups, graphs/s,
    peak memory and a torch.profiler split; then the same step with K11
    switched on (nn/dropout.py:FUSED), its launches and time."""
    import types

    from graphtrans_tpu_torch.nn import dropout as tdrop
    from graphtrans_tpu_torch.ops import kernels

    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    k11_launches = 0
    for name, config, bench, tasks in (
            ("molpcba", TF_MOL_CONFIG, mol_bench, 128),
            ("code2", TF_CODE2_CONFIG, code2_bench, code2_tasks)):
        args = _tf_train_args(config)
        model, step = _trainer(args, tasks, device,
                               data=sizes if name == "code2" else None)
        tb = bench.to(device)
        n = int(bench.graph_mask.sum())
        S = min(bench.max_nodes_dense, args.max_input_len) + 1
        torch.cuda.reset_peak_memory_stats(device)
        _median_ms(lambda: step(tb), 3)                     # warm-up
        ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        if not torch.isfinite(loss):
            raise AssertionError(f"{name} Transformer-only step: loss not "
                                 f"finite")
        print(f"[10c] {name} Transformer-only train step of {n} graphs "
              f"(rows of {S} tokens, {args.num_encoder_layers} layers, "
              f"d_model {args.d_model}, attention dropout "
              f"{args.transformer_dropout}; forward, backward, AdamW): median "
              f"{ms:.3f} ms over {TIMED_STEPS} (min {lo:.3f}, max {hi:.3f}), "
              f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on "
              f"{smi}")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(tb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
        _print_split("[10c]", f"{name} Transformer-only train step", prof,
                     PROFILED_STEPS, wall, smi, graphs=n)
        tdrop.FUSED = True
        try:
            kernels.reset_launches()
            loss = step(tb)
            torch.cuda.synchronize()
            per_step = kernels.byte_dropout.launches
            k11_launches += per_step
            _median_ms(lambda: step(tb), 2)                 # warm-up
            fms, flo, fhi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
        finally:
            tdrop.FUSED = False
        if per_step == 0 or not torch.isfinite(loss):
            raise AssertionError(f"{name} step with K11 on: {per_step} K11 "
                                 f"launches, loss {loss}")
        print(f"[10c] {name} the same step with K11 switched on "
              f"(nn/dropout.py:FUSED): {per_step} byte_dropout launches a "
              f"step (forward and backward), median {fms:.3f} ms over "
              f"{TIMED_STEPS} (min {flo:.3f}, max {fhi:.3f}) against "
              f"{ms:.3f} ms off")
        del model, step, tb
        torch.cuda.empty_cache()
    return k11_launches


# ---- phase 11: the attention-backend switch (K9, K10) ----------------------


def check_k9(qkv, valid, nhead: int, block: int, rate: float, seed: int, gen,
             rows: int):
    """K9 (with dropout ``rate``) and K9-bwd on all rows of ``qkv`` against
    the plain version (the same mask) and its autograd on the first
    ``rows``; queries without a key and padding keys get zero outputs and
    gradients."""
    from graphtrans_tpu_torch.ops.kernels import (attention_smalls_bwd,
                                                  attention_smalls_bwd_plain,
                                                  attention_smalls_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_smalls import (
        attention_smalls_with_stats)

    d = qkv.shape[2] // 3
    g = torch.randn(*qkv.shape[:2], d, generator=gen).to(qkv.device)
    saved = attention_smalls_with_stats(qkv, valid, nhead, block, rate, seed)
    dqkv = attention_smalls_bwd(qkv, valid, nhead, g, block, rate, seed,
                                saved)
    torch.cuda.synchronize()
    head = (qkv[:rows], valid[:rows], nhead, block)
    f_err = (saved[0][:rows] - attention_smalls_plain(*head, rate, seed)
             ).abs().max().item()
    b_err = _rel_err(dqkv[:rows], attention_smalls_bwd_plain(
        *head[:3], g[:rows], block, rate, seed))
    if f_err > K2_TOL or b_err > GRAD_TOL or not torch.isfinite(dqkv).all():
        raise AssertionError(f"K9 (block {block}) at rate {rate}: forward "
                             f"|diff| {f_err} (<= {K2_TOL}), backward "
                             f"{b_err} (<= {GRAD_TOL})")
    few = min(rows, 8 if qkv.shape[1] > 512 else 64)
    check_stats(f"K9 (block {block}) at rate {rate}", saved[1][:few],
                saved[2][:few], qkv[:few], k4_meet(valid[:few], block), nhead)
    dead = ~_live(valid, block)   # dropout may zero a live query's row
    if saved[0][dead].any() or dqkv[dead].any() or dqkv[..., d:][~valid].any():
        raise AssertionError("K9: a query without a key, or a padding key, "
                             "has a non-zero output or gradient")
    return f_err, b_err, g


def layer_inputs(valid, d: int, ff: int, nhead: int, gen, device):
    """K10's arguments as the packed encoder gets them for rows of
    ``valid`` [G, S]: random x [B, gb*S, d], the packed key mask, the block,
    and one layer's twelve parameters as torch initialises them
    (``TransformerEncoderLayer.fused_params``)."""
    from graphtrans_tpu_torch.nn.transformer import TransformerEncoderLayer

    qkv, v, block = k4_inputs(valid, d, gen, device)
    x = torch.randn(*qkv.shape[:2], d, generator=gen).to(device)
    torch.manual_seed(SEED)
    layer = TransformerEncoderLayer(d, nhead, ff, DROPOUT, device=device)
    params = [p.detach() for p in layer.fused_params()]
    return x, v, block, params


def check_k10(x, valid, params, nhead: int, block: int, rate: float,
              seed: int, gen):
    """K10 and K10-bwd against the plain layer (the same masks) and its
    autograd: the output, dx and all twelve parameter gradients, the
    backward on the kernel's relu decisions (``relu_side``: a
    pre-activation within f32 rounding of 0 may take either side in two
    correct computations, and moves a row of the gradients when it does)."""
    from graphtrans_tpu_torch.ops.kernels import (transformer_layer_bwd,
                                                  transformer_layer_bwd_plain,
                                                  transformer_layer_plain)
    from graphtrans_tpu_torch.ops.kernels.transformer_layer import (
        relu_side, transformer_layer_saved)

    g = torch.randn(*x.shape, generator=gen).to(x.device)
    y, saved = transformer_layer_saved(x, valid, params, nhead, block, rate,
                                       seed)
    grads = transformer_layer_bwd(x, valid, params, nhead, block, g, rate,
                                  seed, saved)
    torch.cuda.synchronize()
    mask = relu_side(saved, (*x.shape[:2], params[6].shape[0]))
    want = transformer_layer_plain(x, valid, params, nhead, block, rate, seed)
    f_err = (y - want).abs().max().item()
    m_err = (transformer_layer_plain(x, valid, params, nhead, block, rate,
                                     seed, mask) - want).abs().max().item()
    refs = transformer_layer_bwd_plain(x, valid, params, nhead, block, g, rate,
                                       seed, mask)
    b_err = max(_rel_err(a, b) for a, b in zip(grads, refs))
    if (f_err > K2_TOL or m_err > K2_TOL or b_err > GRAD_TOL
            or not all(torch.isfinite(t).all() for t in grads)):
        raise AssertionError(f"K10 (block {block}) at rate {rate}: forward "
                             f"|diff| {f_err} (on the kernel's relu side "
                             f"{m_err}; <= {K2_TOL}), backward {b_err} (<= "
                             f"{GRAD_TOL})")
    return f_err, b_err, g, saved


def library_layer(x, valid, params, nhead: int, block: int, rate: float):
    """Yardstick only: K10's layer through torch's library calls (cuBLAS
    F.linear, SDPA with a bool block mask, F.dropout, F.layer_norm), never
    called by the port."""
    F = torch.nn.functional
    wqkv, bqkv, wout, bout, s1, b1, w1, bf1, w2, bf2, s2, b2 = params
    B, S, d = x.shape
    q, k, v = (t.reshape(B, S, nhead, d // nhead).transpose(1, 2)
               for t in F.linear(x, wqkv, bqkv).split(d, dim=-1))
    a = F.scaled_dot_product_attention(q, k, v,
                                       attn_mask=_block_mask(valid, block),
                                       dropout_p=rate)
    a = F.linear(a.transpose(1, 2).reshape(B, S, d), wout, bout)
    y1 = F.layer_norm(x + F.dropout(a, rate), (d,), s1, b1, 1e-5)
    f = F.dropout(F.relu(F.linear(y1, w1, bf1)), rate)
    return F.layer_norm(y1 + F.dropout(F.linear(f, w2, bf2), rate), (d,), s2,
                        b2, 1e-5)


def k10_bound(x, valid, params, nhead: int, block: int,
              backward: bool = False, tensor_cores: bool = True):
    """The forward reads x, the mask and the parameters and writes y; its
    products need 2 T (3d^2 + d^2 + 2 d ff) flops, the attention the
    same-block pairs' (K4's). The backward reads x, the cotangent, the
    parameters and what the forward kept (qkv, ao, m, l, both LayerNorms'
    xhat and 1/sigma, y1, the FF activation) and writes dx and the twelve
    gradients, with twice the forward's product flops and K4-bwd's pair
    flops. By default the products are timed as layer_gemm runs them,
    3xTF32 (three TF32 passes) on the tensor cores, the attention on the
    f32 units (``tensor_cores=False``: all at the f32 SIMT peak, printed
    beside it)."""
    B, S, d = x.shape
    T, ff, hd = B * S, params[6].shape[0], d // nhead
    pbytes = sum(p.numel() for p in params) * 4
    gemm = 2 * T * (3 * d * d + d * d + 2 * d * ff)
    pairs = int((valid.reshape(B, S // block, block).sum(-1) * block).sum()
                .item())
    if backward:
        kept = 3 * d + d + 2 * nhead + d + 1 + d + ff + d + 1    # a token's
        nbytes = (3 * T * d + T * kept) * 4 + 2 * pbytes + valid.numel()
        gemm, attn = 2 * gemm, pairs * nhead * (10 * hd + 8)
    else:
        nbytes = 2 * T * d * 4 + pbytes + valid.numel()
        attn = pairs * nhead * (4 * hd + 4)
    if not tensor_cores:
        return _bound(nbytes, gemm + attn)
    return _tc_bound(nbytes, 3 * gemm, attn)


def phase11_kernels(device, mol_bench, code2_bench, base=None):
    """(a) K9 and K9-bwd (attention_smalls) at rates 0 and 0.3 on the
    molpcba snapshot's rows of 49 (smalls), 4096 molecules' rows of 33
    (smalls) and packed rows of 99 (packed_smalls, block 33), and code2's
    rows of 1001 (smalls); K10 and K10-bwd (transformer_layer) at 4096
    molecules' [1366, 99, 256], ff 512, block 33 and the snapshot's rows of
    98, block 49; against their plain versions and autograd, and timed
    beside bound, plain version and library yardstick (K9 and K9-bwd also
    beside ``base``'s, the earlier design, in turns; K9-bwd at each of its
    instances: short at rows of 33 and 49 and packed block 33, wide at
    code2's rows cut to 257 and at packed blocks of 150, long at rows of
    1001; K9's forward takes its tile instance up to 128 tokens and its
    long one at rows of 1001 and blocks of 150), with m and l against the
    plain scores."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops.kernels import (
        attention_smalls, attention_smalls_bwd, attention_smalls_plain,
        transformer_layer, transformer_layer_bwd, transformer_layer_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_smalls import (
        attention_smalls_with_stats, bwd_geometry, fwd_geometry)
    from graphtrans_tpu_torch.ops.kernels.transformer_layer import (
        transformer_layer_saved)

    gen = torch.Generator().manual_seed(SEED + 11)
    args = _tf_args(TF_MOL_CONFIG)
    splits, num_tasks, _ = predict.load_splits(args)
    serve = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks, split="train")))
    d, nhead, ff = args.d_model, args.nhead, args.dim_feedforward
    seed = 2**31 - 13
    # name: (key mask [G, S], pack as packed_smalls does, rows the plain
    # backward is held on)
    k9_cases = {"serve256 smalls S 49": (dense_valid(serve), False, None),
                "bench4096 smalls S 33": (dense_valid(mol_bench), False, None),
                "bench4096 packed_smalls block 33": (dense_valid(mol_bench),
                                                     True, None),
                "bench512 cut to 256, smalls S 257": (
                    dense_valid(code2_bench, 256), False, 64),
                "bench512 smalls S 1001": (dense_valid(code2_bench), False,
                                           64),
                "bench512 cut to 149, packed block 150": (
                    dense_valid(code2_bench, 149), 2, 64)}
    errs = collections.defaultdict(float)
    timed = {}
    same = []         # cases whose bits equal the parent's (--baseline)
    for name, (valid, packed, rows) in k9_cases.items():
        if packed is True:
            qkv, v, block = k4_inputs(valid, d, gen, device)
        elif packed:     # ``packed`` graphs a row, blocks wider than 128
            G, block = valid.shape
            v = torch.cat([valid, valid.new_zeros(-G % packed, block)])
            v = v.reshape(-1, packed * block).to(device)
            qkv = torch.randn(*v.shape, 3 * d, generator=gen).to(device)
        else:
            qkv = torch.randn(*valid.shape, 3 * d, generator=gen).to(device)
            v, block = valid.to(device), 0
        for rate in (0.0, DROPOUT):
            f, e, g = check_k9(qkv, v, nhead, block, rate, seed, gen,
                               rows or len(qkv))
            errs["k9"], errs["k9_bwd"] = (max(errs["k9"], f),
                                          max(errs["k9_bwd"], e))
        saved = attention_smalls_with_stats(qkv, v, nhead, block, DROPOUT,
                                            seed)
        plain = lambda x, r0: attention_smalls_plain(
            x, v[r0:r0 + 64], nhead, block, DROPOUT, seed)
        ms, earlier = turns_ms(
            lambda: attention_smalls(qkv, v, nhead, block),
            base and (lambda: base["attention_smalls"].attention_smalls(
                qkv, v, nhead, block)),
            5 if rows else 20)
        bwd_ms, bwd_earlier = turns_ms(
            lambda: attention_smalls_bwd(qkv, v, nhead, g, block, DROPOUT,
                                         seed, saved),
            base and (lambda: base["attention_smalls"].attention_smalls_bwd(
                qkv, v, nhead, g, block, DROPOUT, seed, saved)),
            3 if rows else 10)
        old = base and base["attention_smalls"]
        same_bits(f"K9 {name}",
                  lambda: attention_smalls(qkv, v, nhead, block),
                  old and (lambda: old.attention_smalls(qkv, v, nhead,
                                                        block)), same)
        same_bits(f"K9 training forward {name}",
                  lambda: attention_smalls_with_stats(qkv, v, nhead, block,
                                                      DROPOUT, seed),
                  old and (lambda: old.attention_smalls_with_stats(
                      qkv, v, nhead, block, DROPOUT, seed)), same)
        same_bits(f"K9-bwd {name}",
                  lambda: attention_smalls_bwd(qkv, v, nhead, g, block,
                                               DROPOUT, seed, saved),
                  old and (lambda: old.attention_smalls_bwd(
                      qkv, v, nhead, g, block, DROPOUT, seed, saved)), same)
        t = dict(ms=ms, earlier_ms=earlier,
                 instance=fwd_geometry(*qkv.shape[:2], block, d // nhead,
                                       nhead, False, 0.0).instance,
                 bwd_instance=bwd_geometry(*qkv.shape[:2], block,
                                           d // nhead, nhead).instance,
                 plain_ms=time_ms(lambda: attention_smalls_plain(
                     qkv, v, nhead, block), iters=1 if rows else 3),
                 library_ms=sdpa_mask_ms(qkv, _block_mask(v, block), nhead,
                                         iters=3),
                 bwd_ms=bwd_ms, bwd_earlier_ms=bwd_earlier,
                 bwd_plain_ms=(_chunked_plain_bwd_ms(plain, qkv, g, 64)
                               if rows else _plain_bwd_ms(
                                   lambda x: attention_smalls_plain(
                                       x, v, nhead, block, DROPOUT, seed),
                                   [qkv], g)),
                 bwd_library_ms=sdpa_bwd_mask_ms(qkv, _block_mask(v, block),
                                                 nhead, g, DROPOUT))
        t["bound_ms"], t["bound_by"] = k4_bound(qkv, v, nhead, block)
        t["tc_bound_ms"] = k4_bound(qkv, v, nhead, block, True)[0]
        t["bwd_bound_ms"], t["bwd_bound_by"] = k4_bwd_bound(
            qkv, v, nhead, block,
            tensor_cores=t["bwd_instance"] == "long")
        t["bwd_f32_simt_bound_ms"] = k4_bwd_bound(qkv, v, nhead, block)[0]
        t["shape"] = (f"B={qkv.shape[0]} S={qkv.shape[1]} d={d} H={nhead} "
                      f"block {block}")
        timed[name] = t
        del qkv, v, g, saved
    print(f"[11a] K9 agrees with its plain version within {errs['k9']:.3g} "
          f"(<= {K2_TOL}), m and l with the plain scores within {K2_TOL}, "
          f"and K9-bwd with autograd through it within "
          f"{errs['k9_bwd']:.3g} of max(1, max|ref|) (<= {GRAD_TOL}) at rates "
          f"0 and {DROPOUT}, at {list(k9_cases)} (S 257, 300 and 1001: the "
          f"first 64 rows);"
          f" queries without a key and padding keys get exactly 0")
    for name, t in timed.items():
        print(f"[11a] {name} K9 attention_smalls ({t['instance']} instance) "
              f"[{t['shape']}]: kernel {t['ms']:.4f} ms against "
              f"{_ms(t['earlier_ms'])} for the earlier design, in turns")
        print(f"[11a] {name} K9-bwd attention_smalls_bwd ("
              f"{t['bwd_instance']} instance) [{t['shape']}, dropout "
              f"{DROPOUT}]: kernel {t['bwd_ms']:.4f} ms against "
              f"{_ms(t['bwd_earlier_ms'])} for the earlier design, in turns")
        print(f"[11a] {name} K9 attention_smalls [{t['shape']}]: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}; "
              f"{t['tc_bound_ms']:.4f} ms with the products on the tensor "
              f"cores in 3xTF32), library "
              f"{t['library_ms']:.4f} ms (SDPA, bool mask); K9-bwd (dropout "
              f"{DROPOUT}) {t['bwd_ms']:.4f} ms, plain backward "
              f"{t['bwd_plain_ms']:.4f} ms, bound {t['bwd_bound_ms']:.4f} ms "
              f"({t['bwd_bound_by']}"
              + (f"; products on the tensor cores in 3xTF32; "
                 f"{t['bwd_f32_simt_bound_ms']:.4f} ms at the f32 SIMT peak"
                 if t["bwd_instance"] == "long" else "")
              + f"), library {t['bwd_library_ms']:.4f} ms (SDPA backward)")

    k10_cases = {"bench4096 [1366, 99] block 33": dense_valid(mol_bench),
                 "serve256 rows of 98 block 49": dense_valid(serve)}
    ltimed = {}
    for name, valid in k10_cases.items():
        x, v, block, params = layer_inputs(valid, d, ff, nhead, gen, device)
        for rate in (0.0, DROPOUT):
            f, e, g, _ = check_k10(x, v, params, nhead, block, rate, seed,
                                   gen)
            errs["k10"], errs["k10_bwd"] = (max(errs["k10"], f),
                                            max(errs["k10_bwd"], e))
        _, saved = transformer_layer_saved(x, v, params, nhead, block,
                                           DROPOUT, seed)
        old = base and base["transformer_layer"]
        with torch.no_grad():
            ms, earlier = turns_ms(
                lambda: transformer_layer(x, v, params, nhead, block),
                old and (lambda: old.transformer_layer(x, v, params, nhead,
                                                       block)), 5)
            t = dict(ms=ms, earlier_ms=earlier,
                     plain_ms=time_ms(lambda: transformer_layer_plain(
                         x, v, params, nhead, block), iters=3),
                     library_ms=time_ms(lambda: library_layer(
                         x, v, params, nhead, block, 0.0), iters=5))
        bwd_ms, bwd_earlier = turns_ms(
            lambda: transformer_layer_bwd(x, v, params, nhead, block, g,
                                          DROPOUT, seed, saved),
            old and (lambda: old.transformer_layer_bwd(
                x, v, params, nhead, block, g, DROPOUT, seed, saved)), 5)
        with torch.no_grad():
            same_bits(f"K10 {name}",
                      lambda: transformer_layer(x, v, params, nhead, block),
                      old and (lambda: old.transformer_layer(
                          x, v, params, nhead, block)), same)
        same_bits(f"K10-bwd {name}",
                  lambda: transformer_layer_bwd(x, v, params, nhead, block,
                                                g, DROPOUT, seed, saved),
                  old and (lambda: old.transformer_layer_bwd(
                      x, v, params, nhead, block, g, DROPOUT, seed, saved)),
                  same)
        t.update(
            bwd_ms=bwd_ms, bwd_earlier_ms=bwd_earlier,
            bwd_plain_ms=_plain_bwd_ms(
                lambda xx, *ps: transformer_layer_plain(
                    xx, v, ps, nhead, block, DROPOUT, seed), [x, *params], g),
            bwd_library_ms=_plain_bwd_ms(
                lambda xx, *ps: library_layer(xx, v, ps, nhead, block,
                                              DROPOUT), [x, *params], g))
        t["bound_ms"], t["bound_by"] = k10_bound(x, v, params, nhead, block)
        t["bwd_bound_ms"], t["bwd_bound_by"] = k10_bound(
            x, v, params, nhead, block, backward=True)
        t["simt_bound_ms"] = k10_bound(x, v, params, nhead, block,
                                       tensor_cores=False)[0]
        t["bwd_simt_bound_ms"] = k10_bound(x, v, params, nhead, block,
                                           backward=True,
                                           tensor_cores=False)[0]
        t["shape"] = (f"B={x.shape[0]} S={x.shape[1]} d={d} ff={ff} "
                      f"H={nhead} block {block}")
        ltimed[name] = t
        del x, v, g, saved
    print(f"[11a] K10 agrees with its plain layer within {errs['k10']:.3g} "
          f"(<= {K2_TOL}) and K10-bwd (dx and the twelve parameter "
          f"gradients, on the kernel's relu decisions) with autograd through "
          f"it within {errs['k10_bwd']:.3g} of max(1, max|ref|) (<= "
          f"{GRAD_TOL}) at rates 0 and {DROPOUT}, at {list(k10_cases)}")
    if base:
        print(f"[11a] --baseline: the same bits as the parent's kernels on "
              f"the same inputs at {same}")
    for name, t in ltimed.items():
        print(f"[11a] {name} K10 transformer_layer [{t['shape']}]: kernel "
              f"chain {t['ms']:.4f} ms against {_ms(t['earlier_ms'])} for "
              f"the earlier design, in turns; K10-bwd (dropout {DROPOUT}) "
              f"{t['bwd_ms']:.4f} ms against {_ms(t['bwd_earlier_ms'])}")
        print(f"[11a] {name} K10 transformer_layer [{t['shape']}]: kernel "
              f"chain {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}; products on the "
              f"tensor cores in 3xTF32; {t['simt_bound_ms']:.4f} ms at the "
              f"f32 SIMT peak), library "
              f"{t['library_ms']:.4f} ms (F.linear, SDPA, F.layer_norm); "
              f"K10-bwd (dropout {DROPOUT}) {t['bwd_ms']:.4f} ms, plain "
              f"backward {t['bwd_plain_ms']:.4f} ms, bound "
              f"{t['bwd_bound_ms']:.4f} ms ({t['bwd_bound_by']}; "
              f"{t['bwd_simt_bound_ms']:.4f} ms at the f32 SIMT peak), "
              f"library backward {t['bwd_library_ms']:.4f} ms")
    pick = lambda t, pre: dict(ms=t[pre + "ms"], plain_ms=t[pre + "plain_ms"],
                               bound_ms=t[pre + "bound_ms"],
                               bound_by=t[pre + "bound_by"],
                               library_ms=t[pre + "library_ms"])
    k9 = timed["bench4096 smalls S 33"]
    k10 = ltimed["bench4096 [1366, 99] block 33"]
    return dict(errs=errs, timed=tuple(
        dict(pick(t, pre), earlier_ms=t[pre + "earlier_ms"])
        for t, pre in ((k9, ""), (k9, "bwd_"), (k10, ""), (k10, "bwd_"))))


# The wrapper each backend's molpcba Transformer-only layers launch: rows of
# 48 + CLS take K9 unpacked (smalls), K9 on packed rows of 2 x 49
# (packed_smalls) or K10 on them (packed_layer).
TF_BACKEND_KERNEL = {"smalls": "attention_smalls",
                     "packed_smalls": "attention_smalls",
                     "packed_layer": "transformer_layer"}


@contextlib.contextmanager
def programmatic_backend(name: str):
    """packed_fused and packed_layer are no choices of --attn_backend, as in
    the JAX package, where a caller sets them with set_attn_backend before
    main runs: the entry points apply their flag through their module's
    set_attn_backend, which this points at ``name`` for one run."""
    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict

    orig = train_main.set_attn_backend
    forced = lambda model, _: orig(model, name)
    train_main.set_attn_backend = predict.set_attn_backend = forced
    try:
        yield
    finally:
        train_main.set_attn_backend = predict.set_attn_backend = orig


def _backend_argv(backend: str):
    return [] if backend == "packed_layer" else ["--attn_backend", backend]


def packed_k4_instances(args, splits, num_tasks) -> set:
    """The instances of K4's forward on each split's graph-packed rows
    (packed_layer's layer launches it there, counted as K10's chain):
    dense_fwd_geometry at the split's row width and block."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.nn.transformer import graphs_per_row
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        dense_fwd_geometry)

    found = set()
    for split in splits:
        S = predict.serving_layout(splits, args, num_tasks,
                                   split=split)["dense_cap"] + 1
        gb = graphs_per_row(S)
        found.add(dense_fwd_geometry(1, gb * S, S if gb > 1 else 0,
                                     args.d_model // args.nhead, args.nhead,
                                     True, 0.0).instance)
    return found


def phase11_serve(device, tmp: str):
    """(b) The molpcba Transformer-only yml through the serving entry point
    under smalls, packed_smalls (--attn_backend) and packed_layer (set in
    process), every split, launches counted from 0 for each; then per
    backend the logits through the kernels against the plain versions and
    against auto, every batch of every split; and the code2 GraphTrans yml
    under --attn_backend flash (K5 on its 384-wide segment tier), logits
    against auto."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.nn.transformer import set_attn_backend
    from graphtrans_tpu_torch.ops import kernels

    args = _tf_args(TF_MOL_CONFIG)
    splits, num_tasks, _ = predict.load_splits(args)
    totals = collections.Counter()
    for backend, kernel in TF_BACKEND_KERNEL.items():
        for split in ("train", "valid", "test"):
            out = os.path.join(tmp, f"{backend}_{split}.jsonl")
            kernels.reset_launches()         # this backend's serving path
            with (programmatic_backend(backend) if backend == "packed_layer"
                  else contextlib.nullcontext()):
                res = predict.main(["--configs", TF_MOL_CONFIG, "--data_root",
                                    SNAPSHOT, "--split", split, "--seed",
                                    str(SEED), "--out", out,
                                    *_backend_argv(backend)])
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
            recs = [json.loads(line) for line in open(out)]
            if not (len(recs) == len(splits[split])
                    and all(len(r["logits"]) == num_tasks
                            and all(math.isfinite(x) for x in r["logits"])
                            for r in recs)):
                raise AssertionError(f"{backend} {split}: malformed records")
            want = {kernel: args.num_encoder_layers * res["batches"]}
            if launches != want:
                raise AssertionError(f"{backend} {split}: launches "
                                     f"{launches}, expected {want}")
            totals.update(launches)
            totals.update({f"attention_smalls {k}": v for k, v in
                           kernels.attention_smalls.instances.items()})
        if backend == "packed_layer" and packed_k4_instances(
                args, splits, num_tasks) != {"tile"}:
            raise AssertionError("packed_layer: K4's forward inside K10 is "
                                 "off the tile instance")
        print(f"[11b] served the molpcba snapshot (3 splits) through "
              f"graphtrans_tpu_torch.predict under {backend}"
              f"{' (set in process)' if backend == 'packed_layer' else ''}:"
              f" launches {kernel} {totals[kernel]} so far, "
              f"{args.num_encoder_layers} a batch")

    model = predict.build_model(args, num_tasks, device)
    err = collections.defaultdict(float)
    with torch.inference_mode():
        for split in ("train", "valid", "test"):
            layout = predict.serving_layout(splits, args, num_tasks,
                                            split=split)
            for b in iterate_batches(splits[split], **layout):
                tb = b.to(device)
                gm = tb.graph_mask
                auto = model(tb)[gm]
                for backend in TF_BACKEND_KERNEL:
                    set_attn_backend(model, backend)
                    got = model(tb)[gm]
                    kernels.set_kernels(model, False)
                    plain = model(tb)[gm]
                    kernels.set_kernels(model, True)
                    set_attn_backend(model, "auto")
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{backend}: logits not finite")
                    err[backend, "plain"] = max(
                        err[backend, "plain"], (got - plain).abs().max().item())
                    err[backend, "auto"] = max(
                        err[backend, "auto"], (got - auto).abs().max().item())
    if max(err.values()) > LOGITS_TOL:
        raise AssertionError(f"molpcba Transformer-only logits under the "
                             f"backends: {dict(err)} > {LOGITS_TOL}")
    print(f"[11b] molpcba Transformer-only logits over all three splits, "
          f"through K9/K10 against the plain versions and against auto (K4) "
          f"on the card: " + ", ".join(
              f"{b} {err[b, 'plain']:.3g} / {err[b, 'auto']:.3g}"
              for b in TF_BACKEND_KERNEL) + f" (<= {LOGITS_TOL})")

    args = _code2_args()
    splits, num_tasks, code = predict.load_splits(args)
    out = os.path.join(tmp, "code2_flash.jsonl")
    kernels.reset_launches()                 # code2 under flash
    res = predict.main(["--configs", CODE2_CONFIG, "--data_root", SNAPSHOT,
                        "--split", "valid", "--batch_size", str(CODE2_BATCH),
                        "--seed", str(SEED), "--out", out, "--attn_backend",
                        "flash"])
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    if not (launches.get("flash_attention", 0) > 0
            and 0.0 <= res["F1"] <= 1.0):
        raise AssertionError(f"code2 under flash: launches {launches}, F1 "
                             f"{res['F1']}")
    model = predict.build_model(args, num_tasks, device, code)
    layout = predict.serving_layout(splits, args, num_tasks, split="valid")
    f_err = 0.0
    with torch.inference_mode():
        for b in iterate_batches(splits["valid"], **layout):
            tb = b.to(device)
            auto = model(tb)[tb.graph_mask]
            set_attn_backend(model, "flash")
            got = model(tb)[tb.graph_mask]
            set_attn_backend(model, "auto")
            f_err = max(f_err, (got - auto).abs().max().item())
    if f_err > LOGITS_TOL:
        raise AssertionError(f"code2 logits under flash differ from auto by "
                             f"{f_err} > {LOGITS_TOL}")
    print(f"[11b] served the code2 GraphTrans valid split under --attn_backend"
          f" flash ({res['batches']} batches, F1 {res['F1']:.6f}): launches "
          f"{launches} (K5 on the 384-wide tier, K3 on the wider one); "
          f"logits against auto max |diff| {f_err:.3g} (<= {LOGITS_TOL})")
    return totals


def phase11_train(device, tmp: str):
    """(b) The molpcba Transformer-only yml through the training entry at
    full width on the snapshot (2 epochs) under --attn_backend smalls and
    under packed_layer (set in process), launches counted from 0 for each,
    finite losses and every parameter moved; then one step through the
    kernels against the plain versions under each."""
    import io

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.nn.transformer import set_attn_backend
    from graphtrans_tpu_torch.ops import kernels

    totals = collections.Counter()
    for backend in ("smalls", "packed_layer"):
        kernel = TF_BACKEND_KERNEL[backend]
        args = _tf_train_args(TF_MOL_CONFIG)
        splits, num_tasks, _ = predict.load_splits(args)
        save = os.path.join(tmp, backend)
        out = io.StringIO()
        kernels.reset_launches()             # this backend's training path
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), (
                programmatic_backend(backend) if backend == "packed_layer"
                else contextlib.nullcontext()):
            res = train_main.main(["--configs", TF_MOL_CONFIG, "--data_root",
                                   SNAPSHOT, "--epochs", str(TRAIN_EPOCHS),
                                   "--seed", str(SEED), "--save_path", save,
                                   *_backend_argv(backend)])
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        steps = sum(r["steps"] for r in res["epochs"])
        want = {kernel: args.num_encoder_layers * steps,
                kernel + "_bwd": args.num_encoder_layers * steps}
        if steps == 0 or launches != want:
            raise AssertionError(f"training under {backend}: launches "
                                 f"{launches}, expected {want}")
        if backend == "packed_layer" and packed_k4_instances(
                args, splits, num_tasks) != {"tile"}:
            raise AssertionError("packed_layer training: K4's forward inside "
                                 "K10 is off the tile instance")
        totals.update(launches)
        totals.update({f"attention_smalls {k}": v for k, v in
                       kernels.attention_smalls.instances.items()})
        totals.update({f"attention_smalls_bwd {k}": v for k, v in
                       kernels.attention_smalls_bwd.instances.items()})
        if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
            raise AssertionError(f"epoch losses not finite: {res['epochs']}")
        init, _ = _trainer(args, num_tasks, device)
        trained = torch.load(res["saved"], map_location=device,
                             weights_only=True)
        params = dict(init.named_parameters())
        still = [n for n, p in params.items() if torch.equal(p, trained[n])]
        if still:
            raise AssertionError(f"parameters did not move: {still}")
        print(f"[11b] trained the molpcba Transformer-only yml "
              f"{TRAIN_EPOCHS} epochs under {backend} ({steps} steps, "
              f"{secs:.2f} s with the model build) through "
              f"graphtrans_tpu_torch.main: losses "
              f"{[round(r['loss'], 6) for r in res['epochs']]}, all "
              f"{len(params)} parameter tensors moved; launches {launches}")

        layout = predict.serving_layout(splits, args, num_tasks,
                                        args.batch_size, split="train",
                                        seed=SEED)
        batch = next(iterate_batches(
            splits["train"], order=shuffled_order(len(splits["train"]), SEED,
                                                  0), **layout)).to(device)
        got = []
        for on in (True, False):
            model, step = _trainer(args, num_tasks, device, kernels_on=on)
            set_attn_backend(model, backend)
            loss = step(batch).item()
            got.append((loss, {n: p.grad for n, p in
                               model.named_parameters()}))
        (lk, gk), (lp, gp) = got
        g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
        if abs(lk - lp) > LOGITS_TOL or g_err > GRAD_TOL:
            raise AssertionError(f"step under {backend} through the kernels: "
                                 f"loss |diff| {abs(lk - lp)}, gradients "
                                 f"{g_err}")
        print(f"[11b] one step under {backend} (dropout "
              f"{args.transformer_dropout}, same seeds) through the kernels "
              f"vs the plain versions: loss {lk:.6f} vs {lp:.6f}, gradients "
              f"within {g_err:.3g} of max(1, max|ref|) (<= {GRAD_TOL})")
    return totals


def phase11_cost(device, mol_bench, smi: str):
    """(c) What each backend costs on the card: the Transformer-only
    forward and train step of 4096 molecules under auto, smalls,
    packed_smalls and packed_layer, median of 10 after 3 warm-ups, peak
    memory and a torch.profiler split."""
    from graphtrans_tpu_torch.nn.init import init_weights
    from graphtrans_tpu_torch.nn.transformer import set_attn_backend

    tb = mol_bench.to(device)
    n = int(mol_bench.graph_mask.sum())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for backend in ("auto", "smalls", "packed_smalls", "packed_layer"):
        args = _tf_train_args(TF_MOL_CONFIG)
        model, step = _trainer(args, 128, device)
        set_attn_backend(model, backend)
        torch.cuda.reset_peak_memory_stats(device)
        model.eval()
        with torch.inference_mode():
            _median_ms(lambda: model(tb), 3)
            fms, flo, fhi, _ = _median_ms(lambda: model(tb), 10)
            fpeak = torch.cuda.max_memory_allocated(device) / 2**30
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_FORWARDS):
                    model(tb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FORWARDS
        print(f"[11c] {backend}: Transformer-only forward of {n} molecules: "
              f"median {fms:.3f} ms over 10 (min {flo:.3f}, max {fhi:.3f}), "
              f"{n / fms * 1e3:.0f} graphs/s, peak {fpeak:.2f} GiB on {smi}")
        _print_split("[11c]", f"{backend} forward", prof, PROFILED_FORWARDS,
                     wall, smi, graphs=n)
        model.train()
        torch.cuda.reset_peak_memory_stats(device)
        _median_ms(lambda: step(tb), 3)
        ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        if not torch.isfinite(loss):
            raise AssertionError(f"{backend} step: loss not finite")
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(tb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
        print(f"[11c] {backend}: train step of {n} molecules (dropout "
              f"{args.transformer_dropout}): median {ms:.3f} ms over "
              f"{TIMED_STEPS} (min {lo:.3f}, max {hi:.3f}), "
              f"{n / ms * 1e3:.0f} graphs/s, peak {peak:.2f} GiB on {smi}")
        _print_split("[11c]", f"{backend} train step", prof, PROFILED_STEPS,
                     wall, smi, graphs=n)
        del model, step
        torch.cuda.empty_cache()


# ---- phase 12: NCI1 (GCN on the strided layout, K6) -------------------------


def _nci1_args(config: str = None, train: bool = False, extra=()):
    """The NCI1 yml as the entry point parses it, with ``--runs 1`` (the
    yml's 20 runs arrive with slice 12). No NCI1 files are in the
    repository: the split is the synthetic fallback's, drawn from the yml's
    seed."""
    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.utils.config import parse_with_config

    entry = train_main if train else predict
    return parse_with_config(entry.build_parser(), [
        "--configs", config or NCI1_CONFIG, "--data_root", SNAPSHOT,
        "--runs", "1", *extra])


def k6_inputs(batch, d: int, gen: torch.Generator, device,
              emb: str = "none"):
    """K6's arguments as a GCN layer of NCI1 gets them: random node rows
    (zero on padding rows), no edge embeddings (``emb`` "none": the
    layer passes None for ``ZeroEdgeEncoder``'s zeros; "zeros": the zero
    tensor the parent's layer made; "random"), and the GCN norm as the
    edge weight."""
    from graphtrans_tpu_torch.ops.dense_mp import dense_degree, dense_gather

    G, Sm = batch.num_graph_slots, batch.node_stride
    x = torch.randn(G * Sm, d, generator=gen)
    x[~torch.as_tensor(batch.node_mask)] = 0
    tb = batch.to(device)
    src, dst, emask = tb.edge_src_dense, tb.edge_dst_dense, tb.edge_mask_dense
    dis = ((dense_degree(src, emask, Sm) + 1.0) ** -0.5)[..., None]
    norm = (dense_gather(dis, src, emask) * dense_gather(dis, dst, emask))
    Em = src.shape[1]
    e = {"none": None, "zeros": torch.zeros(G, Em, d),
         "random": torch.randn(G, Em, d, generator=gen)}[emb]
    return (x.reshape(G, Sm, d).to(device), src, dst, emask,
            None if e is None else e.to(device), norm[..., 0].contiguous())


def _zero_emb(args):
    """K6's arguments with a zero emb tensor where emb is None (what the
    parent's kernels take, and the plain versions' zeros)."""
    x, src = args[0], args[1]
    if args[4] is not None:
        return args
    zeros = torch.zeros(x.shape[0], src.shape[1], x.shape[2],
                        device=x.device)
    return args[:4] + (zeros,) + args[5:]


def check_k6(args, relu: bool, with_w: bool, gout):
    """K6 against its plain version (1e-5), and with emb None against the
    same kernel given a zero emb tensor (the same bits); K6-bwd's full
    instance against autograd through it (dx, demb, dw relative to max(1,
    max |reference|)); its dx-only instance gives None for demb and dw and
    the full instance's dx bits; padding node rows of the forward exactly
    0."""
    from graphtrans_tpu_torch.ops.dense_mp import dense_degree
    from graphtrans_tpu_torch.ops.kernels import (dense_agg, dense_agg_bwd,
                                                  dense_agg_bwd_plain,
                                                  dense_agg_plain)

    args = args[:5] + (args[5] if with_w else None,)
    got = dense_agg(*args, relu=relu)
    grads = dense_agg_bwd(*args, gout, relu=relu)
    dx_only = dense_agg_bwd(*args, gout, relu=relu, need_demb=False,
                            need_dw=False)
    torch.cuda.synchronize()
    f_err = (got - dense_agg_plain(*args, relu=relu)).abs().max().item()
    want = dense_agg_bwd_plain(*args, gout, relu=relu)
    b_err = max(_rel_err(g, w) for g, w in zip(grads, want) if w is not None)
    if (f_err > K6_TOL or b_err > GRAD_TOL or not torch.isfinite(got).all()
            or not all(torch.isfinite(g).all() for g in grads
                       if g is not None)):
        raise AssertionError(f"K6 (relu {relu}, w {with_w}): forward |diff| "
                             f"{f_err} (<= {K6_TOL}), backward {b_err} (<= "
                             f"{GRAD_TOL})")
    if dx_only[1:] != (None, None) or not torch.equal(dx_only[0], grads[0]):
        raise AssertionError(f"K6-bwd's dx-only instance (relu {relu}, w "
                             f"{with_w}) gave other outputs than dx, or "
                             f"other dx bits than the full instance")
    if args[4] is None:
        zero = _zero_emb(args)
        if not (torch.equal(got, dense_agg(*zero, relu=relu))
                and torch.equal(grads[0], dense_agg_bwd(
                    *zero, gout, relu=relu, need_demb=False)[0])):
            raise AssertionError(f"K6 (relu {relu}, w {with_w}): emb None "
                                 f"gave other bits than a zero emb tensor")
    reached = dense_degree(args[2], args[3], args[0].shape[1]) > 0
    if got[~reached].any() or (grads[1] is not None
                               and grads[1][~args[3]].any()):
        raise AssertionError("K6: rows no valid edge reaches, or masked "
                             "slots' demb, are not 0")
    return f_err, b_err


def k6_parent_diff(a, relu: bool, old):
    """With ``old`` (the parent's dense_agg module, under ``--baseline``):
    K6's largest |difference| from the parent kernel's output on the same
    inputs (the parent given zeros where emb is None), relative to max(1,
    max|parent's|); 0 means the same bits. None without ``old``."""
    from graphtrans_tpu_torch.ops.kernels import dense_agg

    if old is None:
        return None
    got = dense_agg(*a, relu=relu)
    ref = old.dense_agg(*_zero_emb(a), relu=relu)
    return 0.0 if torch.equal(got, ref) else _rel_err(got, ref)


def k6_bwd_parent_bits(what: str, a, gout, relu: bool, old, checked: list):
    """With ``old`` (the parent's dense_agg module, under ``--baseline``):
    raise unless K6-bwd's full instance gives the parent kernel's dx and
    demb bits and its dw within K6_TOL of max(1, max|parent's|), and the
    dx-only instance its dx bits (the parent given zeros where emb is
    None, and then no demb compared); returns the dw error (0 without
    w)."""
    from graphtrans_tpu_torch.ops.kernels import dense_agg_bwd

    if old is None:
        return 0.0
    dx, demb, dw = dense_agg_bwd(*a, gout, relu=relu)
    dx_only = dense_agg_bwd(*a, gout, relu=relu, need_demb=False,
                            need_dw=False)[0]
    pdx, pdemb, pdw = old.dense_agg_bwd(*_zero_emb(a), gout, relu=relu)
    pairs = [("dx", dx, pdx), ("dx-only dx", dx_only, pdx)]
    if demb is not None:
        pairs.append(("demb", demb, pdemb))
    for name, x, y in pairs:
        if not torch.equal(x, y):
            raise AssertionError(f"K6-bwd {what}: {name} differs from the "
                                 f"parent's kernel's on the same inputs "
                                 f"(max |diff| "
                                 f"{(x - y).abs().max().item()})")
    dw_err = 0.0 if dw is None else _rel_err(dw, pdw)
    if dw_err > K6_TOL:
        raise AssertionError(f"K6-bwd {what}: dw {dw_err} from the parent's "
                             f"kernel's (<= {K6_TOL})")
    checked.append(f"K6-bwd {what}")
    return dw_err


def k6_bound(args, gout=None, full: bool = True):
    """K6's (with ``gout``: K6-bwd's) bound: x (and gout) read and the
    output (dx) written once, the edge lists read once, and the emb row of
    each valid edge read once where emb is given (a masked slot's is never
    needed, as in ``k7_bound``; none in the emb-less instance); the full
    backward also writes demb in full (zeros on masked slots) and dw, the
    dx-only instance neither. Per valid edge and channel the forward's
    add, relu, weight product and sum; the backward's add, relu mask,
    weight product and dx sum, and in the full instance the dw product and
    sum."""
    x, src, dst, emask, emb, w = args
    edges = int(emask.sum().item()) * x.shape[-1]
    nbytes = 2 * x.numel() * 4 + (edges * 4 if emb is not None else 0) + sum(
        t.numel() * t.element_size() for t in (src, dst, emask, w)
        if t is not None)
    if gout is None:
        return _bound(nbytes, edges * (3 + (w is not None)))
    nbytes += gout.numel() * 4
    if not full:
        return _bound(nbytes, edges * (3 + (w is not None)))
    nbytes += emb.numel() * 4                                       # demb
    if w is not None:
        nbytes += w.numel() * 4                                     # dw
    return _bound(nbytes, edges * (4 + 3 * (w is not None)))


def onehot_agg(x, src, dst, emask, emb, w, relu: bool = True):
    """Yardstick only: the JAX package's default formulation of the strided
    sum (``graphtrans_tpu/ops/dense_mp.py:100-117``, ``:157-171``, what runs
    without ``--use_pallas``), as a pair of one-hot ``torch.bmm`` products
    around the message (never called by the port)."""
    iota = torch.arange(x.shape[1], device=x.device)
    oh_src = ((src[..., None] == iota) & emask[..., None]).float()
    oh_dst = ((dst[..., None] == iota) & emask[..., None]).float()
    m = torch.bmm(oh_src, x) + emb
    if relu:
        m = torch.relu(m)
    if w is not None:
        m = m * w[..., None]
    m = torch.where(emask[..., None], m, 0.0)
    return torch.bmm(oh_dst.transpose(1, 2), m)


K6_SWEEP = (129, 264, 528, 792, 1056, 2112)   # graphs of 12a's sweep


def phase12_kernels(device, d_gnn: int, bench, base=None):
    """(a) K6 (both instances: with emb and emb-less) and K6-bwd (both
    instances) against their plain versions at the yml's batch (the train
    split's first batch of 128) and the 4096-graph batch, with relu on and
    off and with and without w, random and no emb (emb None: the same bits
    as a zero emb tensor); under ``base``, K6's largest difference from
    the parent's kernel (0: its bits), K6-bwd's dx and demb bits of the
    parent's, its dw within K6_TOL. Times at the main path's arguments
    beside bound, plain version and the one-hot bmm yardstick: K6's
    emb-less instance, which the NCI1 layers launch, and its instance with
    emb, K6-bwd's dx-only instance, which the NCI1 step launches, and its
    full instance, each in turns with the parent's kernel (given zeros
    where emb is None; its K6-bwd always computes all three). At the
    4096-graph batch also K6's two launches (slices of 32 channels, and
    K7's vector rule) in turns over the first G graphs, for G in K6_SWEEP
    and 4097 (the split threshold, FWD_SPLIT_PER_SM)."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops.kernels import (dense_agg, dense_agg_bwd,
                                                  dense_agg_plain)

    k6mod = sys.modules["graphtrans_tpu_torch.ops.kernels.dense_agg"]
    gen = torch.Generator().manual_seed(SEED + 12)
    args = _nci1_args()
    splits, num_tasks, _ = predict.load_splits(args)
    serve = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks, split="train")))
    f_err = b_err = dw_err = 0.0
    rows, same, fwd_diff = [], [], {}
    old = base and base["dense_agg"]
    for name, b in (("serve128", serve), ("bench4096", bench)):
        main_args = k6_inputs(b, d_gnn, gen, device)
        rand_args = k6_inputs(b, d_gnn, gen, device, emb="random")
        gout = torch.randn(main_args[0].shape, generator=gen).to(device)
        for inp, kind in ((rand_args, "emb"), (main_args, "emb-less")):
            for relu, with_w in ((True, True), (True, False), (False, True),
                                 (False, False)):
                f, e = check_k6(inp, relu, with_w, gout)
                f_err, b_err = max(f_err, f), max(b_err, e)
                a = inp[:5] + (inp[5] if with_w else None,)
                what = f"{name} {kind} (relu {relu}, w {with_w})"
                diff = k6_parent_diff(a, relu, old)
                if diff is not None:
                    fwd_diff[what] = diff
                dw_err = max(dw_err, k6_bwd_parent_bits(what, a, gout, relu,
                                                        old, same))
        zero_args = _zero_emb(main_args)
        shape = "G={} Sm={} Em={} d={}".format(
            *main_args[0].shape[:2], main_args[1].shape[1], d_gnn)
        k6 = {}
        for inst, a, pa in (("emb-less", main_args, zero_args),
                            ("emb", rand_args, rand_args)):
            new_fn = lambda: dense_agg(*a)
            old_fn = old and (lambda: old.dense_agg(*pa))
            ms, earlier = turns_ms(new_fn, old_fn, 20)
            host, earlier_host = host_us(new_fn, old_fn)
            dev, earlier_dev = queued_turns(new_fn, old_fn)
            t = dict(ms=ms, earlier_ms=earlier, instance=inst, shape=shape,
                     host_us=host, earlier_host_us=earlier_host,
                     device_ms=dev, earlier_device_ms=earlier_dev,
                     plain_ms=time_ms(lambda: dense_agg_plain(*a), iters=5),
                     library_ms=time_ms(lambda: onehot_agg(*pa), iters=5))
            t["bound_ms"], t["bound_by"] = k6_bound(a)
            k6[inst] = t
        x, w = main_args[0], main_args[5]
        fixed, zeros = main_args[1:4], zero_args[4]
        old_bwd = old and (lambda: old.dense_agg_bwd(*zero_args, gout))
        timed = {}
        for inst, a, leaves, plain_fn, lib_fn, kw in (
                ("dx", main_args, [x],
                 lambda xl: dense_agg_plain(xl, *fixed, None, w),
                 lambda xl: onehot_agg(xl, *fixed, zeros, w),
                 dict(need_demb=False, need_dw=False)),
                ("dx+demb+dw", zero_args, [x, zeros, w],
                 lambda xl, el, wl: dense_agg_plain(xl, *fixed, el, wl),
                 lambda xl, el, wl: onehot_agg(xl, *fixed, el, wl), {})):
            ms, earlier = turns_ms(
                lambda: dense_agg_bwd(*a, gout, **kw), old_bwd, 20)
            t = dict(ms=ms, earlier_ms=earlier, instance=inst, shape=shape,
                     plain_ms=_plain_bwd_ms(plain_fn, leaves, gout),
                     library_ms=_plain_bwd_ms(lib_fn, leaves, gout))
            t["bound_ms"], t["bound_by"] = k6_bound(a, gout,
                                                    full=len(leaves) == 3)
            timed[inst] = t
        k6b = timed["dx"]
        for kname, t, plain in (
                ("K6 dense_agg, emb-less instance (emb None)", k6["emb-less"],
                 "plain"),
                ("K6 dense_agg, instance with emb (random emb)", k6["emb"],
                 "plain"),
                ("K6-bwd dense_agg_bwd, dx-only instance (emb None)", k6b,
                 "plain backward (dx)"),
                ("K6-bwd dense_agg_bwd, full instance (zero emb)",
                 timed["dx+demb+dw"], "plain backward (dx, demb, dw)")):
            turn = ("" if t["earlier_ms"] is None else
                    f" (the parent's kernel in turns, given zeros where emb "
                    f"is None{'; dx, demb and dw' if 'bwd' in kname else ''}"
                    f": {_ms(t['earlier_ms'])})")
            print(f"[12a] {name} {kname} [{shape}, relu, w = GCN norm]: "
                  f"kernel {t['ms']:.4f} ms{turn}, {plain} "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}), library (one-hot bmm pair, zero emb) "
                  f"{t['library_ms']:.4f} ms")
        for inst, t in k6.items():
            print(f"[12a] {name} K6 {inst}: device time {_ms(t['device_ms'])}"
                  f" a call queued behind a sleep, cold L2 (the parent's "
                  f"{_ms(t['earlier_device_ms'])}, in turns); host "
                  f"{t['host_us']:.1f} µs a call (the parent's "
                  + ("-" if t["earlier_host_us"] is None
                     else f"{t['earlier_host_us']:.1f}") + ", in turns)")
        rows.append((k6["emb-less"], k6b))
    sweep = []
    split_per_sm = k6mod.FWD_SPLIT_PER_SM
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    try:
        for G in K6_SWEEP + (main_args[0].shape[0],):
            a = tuple(None if t is None else t[:G].contiguous()
                      for t in main_args)

            def launch(split):
                def call():
                    k6mod.FWD_SPLIT_PER_SM = split
                    return dense_agg(*a)
                return call
            wide_ms, split_ms = turns_ms(launch(0), launch(10 ** 6), 20)
            wide_dev, split_dev = queued_turns(launch(0), launch(10 ** 6))
            sweep.append((G, split_ms, wide_ms, split_dev, wide_dev))
    finally:
        k6mod.FWD_SPLIT_PER_SM = split_per_sm
    print(f"[12a] K6's emb-less launches over the first G graphs of the "
          f"4096-graph batch (G: slices of 32 channels, a float a lane / "
          f"K7's vector rule: ms in turns; device ms a call queued behind "
          f"a sleep, cold L2, in turns; the port splits below "
          f"{split_per_sm} graphs an SM, {split_per_sm * sms} here): "
          + "; ".join(f"{G}: {a:.4f} / {b:.4f}, device {_ms(c)} / {_ms(e)}"
                      for G, a, b, c, e in sweep))
    print(f"[12a] K6 and K6-bwd agree with their plain versions (relu on "
          f"and off, w given and not, random emb and none): forward max "
          f"|diff| {f_err:.3g} (<= {K6_TOL}), backward max err {b_err:.3g} "
          f"(<= {GRAD_TOL} of max(1, max|ref|)); emb None gives a zero emb "
          f"tensor's bits; K6-bwd's dx-only instance gives the full "
          f"instance's dx bits; unreached rows and masked demb exactly 0")
    if base:
        bits = [k for k, v in fwd_diff.items() if v == 0.0]
        diff = {k: v for k, v in fwd_diff.items() if v != 0.0}
        print(f"[12a] --baseline: K6 gives the parent kernel's bits in "
              f"{len(bits)} of {len(fwd_diff)} cases"
              + (f"; largest difference {max(diff.values()):.3g} of max(1, "
                 f"max|parent's|) (<= {K6_TOL}), in "
                 f"{', '.join(diff)}" if diff else "")
              + f"; K6-bwd the parent's bits (dx, the dx-only instance's "
              f"dx and demb; dw within {dw_err:.3g} of max(1, max|ref|), "
              f"<= {K6_TOL}) at {len(same)} cases: {', '.join(same)}")
        if diff and max(diff.values()) > K6_TOL:
            raise AssertionError(f"K6 differs from the parent's kernel by "
                                 f"more than {K6_TOL}: {diff}")
    return dict(k6_err=f_err, k6b_err=b_err, timed=rows[-1],
                k6_serve=rows[0][0])


def phase12_serve(device, tmp: str):
    """(b) The NCI1 GraphTrans yml served through ``python -m
    graphtrans_tpu_torch.predict`` (three splits of the synthetic fallback,
    batches of 128, random weights at full width): records, accuracy and
    K6/K2 launches counted from 0, every K6 launch emb-less; the logits
    through the kernels against the plain versions; then the
    Transformer-only NCI1 yml's test split (K4). Returns the GraphTrans
    launches and K6's by instance."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops import kernels

    args = _nci1_args()
    splits, num_tasks, data = predict.load_splits(args)
    kernels.reset_launches()                 # the NCI1 serving path
    batches = records = 0
    accs = {}
    t0 = time.perf_counter()
    for split in ("train", "valid", "test"):
        out = os.path.join(tmp, f"nci1_{split}.jsonl")
        res = predict.main(["--configs", NCI1_CONFIG, "--data_root",
                            SNAPSHOT, "--runs", "1", "--split", split,
                            "--out", out])
        recs = [json.loads(line) for line in open(out)]
        if (len(recs) != len(splits[split])
                or sorted(r["graph_id"] for r in recs)
                != list(range(len(splits[split])))
                or not all(len(r["logits"]) == 2
                           and all(math.isfinite(v) for v in r["logits"])
                           for r in recs)
                or not 0.0 <= res["acc"] <= 1.0):
            raise AssertionError(f"NCI1 {split}: {len(recs)} records for "
                                 f"{len(splits[split])} graphs, acc "
                                 f"{res['acc']}")
        batches += res["batches"]
        records += res["records"]
        accs[split] = round(res["acc"], 6)
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    by_instance = k2_instances()
    want = {"dense_agg": args.gnn_num_layer * batches,
            "attention_seg": args.num_encoder_layers * batches}
    if launches != want:
        raise AssertionError(f"NCI1 serving launches {launches}, expected "
                             f"{want}")
    k6_by = dict(kernels.dense_agg.instances)
    if k6_by != {"emb": 0, "emb-less": launches["dense_agg"]}:
        raise AssertionError(f"NCI1 serving: K6 launches by instance "
                             f"{k6_by}, every one emb-less expected (no "
                             f"zero edge tensor)")
    print(f"[12b] served {records} synthetic NCI1 graphs (3 splits, "
          f"{batches} batches of <= {args.batch_size}; {secs:.2f} s with "
          f"model builds) through graphtrans_tpu_torch.predict: accuracy "
          f"{accs} (random weights); launches {launches} = "
          f"{args.gnn_num_layer} and {args.num_encoder_layers} a batch"
          f"{by_instance}; K6 by instance {k6_by}")

    layout = predict.serving_layout(splits, args, num_tasks)
    model = predict.build_model(args, num_tasks, device, data)
    err = 0.0
    with torch.inference_mode():
        for split in ("train", "valid", "test"):
            for b in iterate_batches(splits[split], **layout):
                tb = b.to(device)
                got = model(tb)[tb.graph_mask]
                kernels.set_kernels(model, False)
                want = model(tb)[tb.graph_mask]
                kernels.set_kernels(model, True)
                err = max(err, (got - want).abs().max().item())
    if err > LOGITS_TOL:
        raise AssertionError(f"NCI1 logits through the kernels differ from "
                             f"the plain versions by {err} > {LOGITS_TOL}")
    print(f"[12b] NCI1 logits through K6 and K2 match the plain versions on "
          f"the card: max |diff| {err:.3g} (<= {LOGITS_TOL})")

    tf = _nci1_args(TF_NCI1_CONFIG)
    kernels.reset_launches()                 # the Transformer-only NCI1 path
    out = os.path.join(tmp, "nci1_tf.jsonl")
    res = predict.main(["--configs", TF_NCI1_CONFIG, "--data_root", SNAPSHOT,
                        "--runs", "1", "--out", out])
    tf_launches = {k: v for k, v in kernels.launch_counts().items() if v}
    if (tf_launches != {"attention_dense": tf.num_encoder_layers
                        * res["batches"]}
            or res["records"] != len(splits["test"])
            or not 0.0 <= res["acc"] <= 1.0):
        raise AssertionError(f"NCI1 Transformer-only serving: launches "
                             f"{tf_launches}, {res}")
    S = predict.serving_layout(splits, tf, num_tasks)["dense_cap"] + 1
    print(f"[12b] served the NCI1 Transformer-only yml's test split "
          f"({res['records']} graphs, rows of {S} tokens, {128 // S} a "
          f"packed row, d_model {tf.d_model}): accuracy {res['acc']:.6f}; "
          f"launches "
          f"{tf_launches} = {tf.num_encoder_layers} a batch")
    return launches, k6_by


def phase12_train(device, tmp: str):
    """(b) The NCI1 GraphTrans yml trained 2 epochs through ``python -m
    graphtrans_tpu_torch.main`` (batches of 128), K6/K6-bwd/K2/K2-bwd
    launches counted from 0, finite losses and moved parameters, one step
    through the kernels against the plain route; then the Transformer-only
    NCI1 yml 2 epochs (K4, K4-bwd)."""
    import io

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.ops import kernels

    args = _nci1_args(train=True)
    splits, num_tasks, data = predict.load_splits(args)
    launches = {}
    for config, tag in ((NCI1_CONFIG, "GraphTrans"),
                        (TF_NCI1_CONFIG, "Transformer-only")):
        cargs = _nci1_args(config, train=True)
        out = io.StringIO()
        kernels.reset_launches()             # this yml's training path
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = train_main.main([
                "--configs", config, "--data_root", SNAPSHOT, "--runs", "1",
                "--epochs", str(TRAIN_EPOCHS), "--save_path",
                os.path.join(tmp, tag)])
        secs = time.perf_counter() - t0
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        by_instance = k2_instances() + k6_bwd_instances()
        for line in out.getvalue().splitlines():
            print(f"[12b] main: {line}")
        steps = sum(r["steps"] for r in res["epochs"])
        L = cargs.num_encoder_layers
        want = ({"dense_agg": cargs.gnn_num_layer * steps,
                 "dense_agg_bwd": cargs.gnn_num_layer * steps,
                 "attention_seg": L * steps, "attention_seg_bwd": L * steps}
                if config == NCI1_CONFIG else
                {"attention_dense": L * steps,
                 "attention_dense_bwd": L * steps})
        if steps == 0 or got != want:
            raise AssertionError(f"NCI1 {tag} training launches {got}, "
                                 f"expected {want}")
        k6b = kernels.dense_agg_bwd.instances
        if k6b["dx"] != got.get("dense_agg_bwd", 0):
            raise AssertionError(f"NCI1 {tag} training: K6-bwd launches by "
                                 f"instance {k6b}, every one dx-only "
                                 f"expected (no gradient of emb or w)")
        k6_by = kernels.dense_agg.instances
        if k6_by["emb-less"] != got.get("dense_agg", 0) or k6_by["emb"]:
            raise AssertionError(f"NCI1 {tag} training: K6 launches by "
                                 f"instance {k6_by}, every one emb-less "
                                 f"expected (no zero edge tensor)")
        if config == NCI1_CONFIG:
            by_instance += f"; K6 by instance {dict(k6_by)}"
        if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
            raise AssertionError(f"epoch losses not finite: {res['epochs']}")
        init, _ = _trainer(cargs, num_tasks, device, data=data)
        trained = torch.load(res["saved"], map_location=device,
                             weights_only=True)
        params = dict(init.named_parameters())
        still = [n for n, p in params.items() if torch.equal(p, trained[n])]
        if len(still) > len(params) // 20:
            raise AssertionError(f"parameters did not move: {still}")
        drop = (f"{cargs.gnn_dropout}/" if config == NCI1_CONFIG
                else "attention ") + str(cargs.transformer_dropout)
        print(f"[12b] trained the NCI1 {tag} yml {TRAIN_EPOCHS} epochs "
              f"({steps} steps of <= {cargs.batch_size} graphs, dropout "
              f"{drop}, {secs:.2f} s with the model build) through "
              f"graphtrans_tpu_torch.main: losses "
              f"{[round(r['loss'], 6) for r in res['epochs']]}, "
              f"{len(params) - len(still)} of {len(params)} parameter "
              f"tensors moved; launches {got}{by_instance}")
        launches.update(got)

    layout = predict.serving_layout(splits, args, num_tasks, args.batch_size,
                                    split="train", seed=args.seed or 0)
    batch = next(iterate_batches(
        splits["train"], order=shuffled_order(len(splits["train"]),
                                              args.seed or 0, 0),
        **layout)).to(device)
    got = []
    with deterministic():
        for on in (True, False):
            model, step = _trainer(args, num_tasks, device, kernels_on=on,
                                   data=data)
            loss = step(batch).item()
            got.append((loss, {n: p.grad for n, p in
                               model.named_parameters()}))
    (lk, gk), (lp, gp) = got
    g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
    g_abs = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    if abs(lk - lp) > LOGITS_TOL or g_err > GRAD_TOL:
        raise AssertionError(f"NCI1 train step through the kernels: loss "
                             f"|diff| {abs(lk - lp)} (<= {LOGITS_TOL}), "
                             f"gradients {g_err} (<= {GRAD_TOL})")
    print(f"[12b] one NCI1 train step (dropout {args.gnn_dropout}/"
          f"{args.transformer_dropout}, same seeds) through K6-bwd and K2-bwd "
          f"vs the plain versions on the card: loss {lk:.6f} vs {lp:.6f} "
          f"(|diff| {abs(lk - lp):.3g} <= {LOGITS_TOL}), gradients max "
          f"|diff| {g_abs:.3g}, relative to max(1, max|ref|) {g_err:.3g} "
          f"(<= {GRAD_TOL})")
    return launches


def phase12_cost(device, bench, smi: str):
    """(c) The NCI1 GraphTrans forward and train step on 4096 synthetic TU
    graphs at the yml's widths (median of 10 after 3 warm-ups, peak
    memory, a torch.profiler split by layer), and the train step at the
    yml's batch of 128."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.tu import TUData

    args = _nci1_args(train=True)
    data = TUData({}, 2, 16)                 # make_tu_dataset's 16 labels
    tb = bench.to(device)
    n = int(bench.graph_mask.sum())
    model = predict.build_model(_nci1_args(), 2, device, data)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        _median_ms(lambda: model(tb), 3)                    # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        ms, lo, hi, out = _median_ms(lambda: model(tb), 10)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        if not torch.isfinite(out[tb.graph_mask]).all():
            raise AssertionError("NCI1 4096-graph forward: not finite")
        print(f"[12c] NCI1 forward of {n} graphs (stride {bench.node_stride}, "
              f"{bench.edge_src_dense.shape[1]} edge slots, "
              f"{bench.pack_rows} packed rows of {bench.pack_w}): median "
              f"{ms:.3f} ms over 10 (min {lo:.3f}, max {hi:.3f}), "
              f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on "
              f"{smi}")
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_FORWARDS):
                model(tb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FORWARDS
    _print_split("[12c]", "NCI1 forward", prof, PROFILED_FORWARDS, wall, smi,
                 graphs=n)
    del model

    model, step = _trainer(args, 2, device, data=data)
    _median_ms(lambda: step(tb), 3)                         # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    if not torch.isfinite(loss):
        raise AssertionError("NCI1 4096-graph train step: loss not finite")
    print(f"[12c] NCI1 train step of {n} graphs (forward, backward, AdamW; "
          f"dropout {args.gnn_dropout}/{args.transformer_dropout}): median "
          f"{ms:.3f} ms over {TIMED_STEPS} (min {lo:.3f}, max {hi:.3f}), "
          f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on {smi}")
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(tb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    _print_split("[12c]", "NCI1 train step", prof, PROFILED_STEPS, wall, smi,
                 graphs=n)

    splits, num_tasks, _ = predict.load_splits(args)
    small = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks, args.batch_size, split="train"))).to(device)
    m = int(small.graph_mask.sum().item())
    _median_ms(lambda: step(small), 3)                      # warm-up
    sms, slo, shi, _ = _median_ms(lambda: step(small), TIMED_STEPS)
    print(f"[12c] NCI1 train step at the yml's batch ({m} graphs): median "
          f"{sms:.3f} ms over {TIMED_STEPS} (min {slo:.3f}, max {shi:.3f}), "
          f"{m / sms * 1e3:.0f} graphs/s on {smi}")
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(small)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    _print_split("[12c]", "NCI1 train step", prof, PROFILED_STEPS, wall, smi,
                 graphs=m)
    del model, step, tb
    torch.cuda.empty_cache()


# ---- phase 13: code2 GCN through the block plans (K8), and K12 -------------


def _bsp_layout(layout: dict) -> dict:
    """A code2 serving layout with K8's block plans at chunk_capacity of
    its caps."""
    from graphtrans_tpu_torch.ops.block_plan import chunk_capacity

    return dict(layout, bsp_chunks_cap=chunk_capacity(layout["edge_cap"],
                                                      layout["node_cap"]))


def _perms(batch):
    """Each plan's slot -> edge map (-1 on pad slots), rebuilt on the host
    (collate keeps the plans without it)."""
    from graphtrans_tpu_torch.ops.block_plan import build_block_plan

    C = batch.bsp_fwd["blk_out"].shape[0]
    return [torch.from_numpy(build_block_plan(
        batch.edge_src, batch.edge_dst, batch.edge_mask,
        batch.num_node_slots, C, major)["perm"]) for major in ("dst", "src")]


def k8_inputs(batch, d: int, gen: torch.Generator, device):
    """K8's arguments as a GCN layer gets them: random node rows (zero on
    padding rows), one random embedding row per edge laid out in each
    plan's chunk order (the dst-major copy, as the edge encoder makes it,
    and the src-major copy that the parent's K8-dx read; pad slots 0), the
    GCN norm per slot in each order (``bsp_slot_weight``), the batch's
    SlotOrder (``rows``) and its src-major one through ``fwd_slot``
    (``rows_b``, which K8-dx walks), their runs made."""
    from graphtrans_tpu_torch.nn.conv import bsp_slot_weight
    from graphtrans_tpu_torch.ops.kernels import slot_order, src_slot_order
    from graphtrans_tpu_torch.ops.segment import out_degree

    tb = batch.to(device)
    x = torch.randn(batch.num_node_slots, d, generator=gen).to(device)
    x = x.masked_fill(~tb.node_mask[:, None], 0.0)
    per_edge = torch.randn(tb.edge_src.shape[0], d, generator=gen).to(device)
    embs = []
    for perm in _perms(batch):
        perm = perm.to(device)
        real = perm >= 0
        emb = torch.zeros(perm.shape[0], d, device=device)
        emb[real] = per_edge[perm[real]]
        embs.append(emb)
    dis = (out_degree(tb.edge_src, x.shape[0], tb.edge_mask) + 1.0) ** -0.5
    rows, rows_b = slot_order(tb), src_slot_order(tb)
    rows.runs()                          # built once per batch, not timed
    rows_b.runs()
    return dict(x=x, ef=embs[0], eb=embs[1], pf=tb.bsp_fwd, pb=tb.bsp_bwd,
                wf=bsp_slot_weight(tb.bsp_fwd, dis, False).contiguous(),
                wb=bsp_slot_weight(tb.bsp_bwd, dis, True).contiguous(),
                rows=rows, rows_b=rows_b)


def check_k8(a, message: str, with_w: bool, gen):
    """K8 against its plain version (1e-5 of max(1, max|ref|)), the same
    bits with a new SlotOrder and without the src-major plan, its d_emb
    and dx kernels against autograd through the plain version (5e-4 of
    max(1, max|ref|)); slots that are not real get exact-zero d_emb rows;
    dx through the src-major order's ``fwd_slot`` (the dst-major copies,
    as the GCN layer calls it) the bits of dx reading the src-major
    copies. The plain versions sum with index_add_ under deterministic
    algorithms."""
    from graphtrans_tpu_torch.ops.kernels import (
        blocked_gather_message_scatter,
        blocked_gather_message_scatter_bwd_plain,
        blocked_gather_message_scatter_demb,
        blocked_gather_message_scatter_dx,
        blocked_gather_message_scatter_plain)

    x, ef, eb, pf, pb = (a[k] for k in ("x", "ef", "eb", "pf", "pb"))
    wf, wb = (a["wf"], a["wb"]) if with_w else (None, None)
    g = torch.randn(x.shape, generator=gen).to(x.device)
    out = blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb, message,
                                         rows=a["rows"])
    for again in (   # a new order; without a gradient, no src-major plan
            blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb,
                                           message),
            blocked_gather_message_scatter(x, ef, None, pf, None, wf, None,
                                           message, rows=a["rows"])):
        if not torch.equal(again, out):
            raise AssertionError(f"K8 ({message}, w {with_w}) gave other "
                                 f"bits with a new SlotOrder or without the "
                                 f"src-major plan")
    demb = blocked_gather_message_scatter_demb(x, g, ef, pf, wf, message)
    dx = blocked_gather_message_scatter_dx(x, g, ef, pb, wf, message,
                                           rows=a["rows_b"])
    if not torch.equal(dx, blocked_gather_message_scatter_dx(x, g, eb, pb,
                                                             wb, message)):
        raise AssertionError(f"K8-dx ({message}, w {with_w}) through "
                             f"fwd_slot gave other bits than with the "
                             f"src-major copies")
    torch.cuda.synchronize()
    with deterministic():
        want = blocked_gather_message_scatter_plain(x, ef, eb, pf, pb, wf,
                                                    wb, message)
        ref_dx, ref_demb = blocked_gather_message_scatter_bwd_plain(
            x, ef, eb, pf, pb, g, wf, wb, message)
    f_err = _rel_err(out, want)
    errs = {"demb": _rel_err(demb, ref_demb), "dx": _rel_err(dx, ref_dx)}
    if (f_err > K8_TOL or max(errs.values()) > GRAD_TOL
            or not all(torch.isfinite(t).all() for t in (out, demb, dx))):
        raise AssertionError(f"K8 ({message}, w {with_w}) disagrees with its "
                             f"plain version: forward {f_err} (<= {K8_TOL}), "
                             f"{errs} (<= {GRAD_TOL}) of max(1, max|ref|)")
    if demb[~(pf["mask"].reshape(-1) > 0)].any():
        raise AssertionError("K8-demb: slots that are not real are not 0")
    return f_err, errs


def _slots_moved(a):
    """(real slots, all slots) of the dst-major plan."""
    mask = a["pf"]["mask"]
    return int((mask > 0).sum().item()), mask.numel()


def k8_bound(a, part: str = "fwd"):
    """K8's (``part``: its d_emb's or dx's) bound: x (and g) read and the
    output written once; per real slot its emb row, its two rows-in-block
    and its weight; the mask of every slot (what tells a pad slot) and the
    chunks' block ids. d_emb writes all C*EB rows (zero on pad slots). Per
    real slot and channel the forward's add, relu, weight product and sum,
    d_emb's product, add and compare, dx's product, add, compare and sum,
    as k7_bound counts them."""
    x = a["x"]
    N, d = x.shape
    real, slots = _slots_moved(a)
    C = a["pf"]["blk_out"].numel()
    nbytes = (2 * N * d * 4 + real * (d * 4 + 3 * 4) + slots * 4 + 2 * C * 4)
    if part == "demb":
        nbytes += N * d * 4 + (slots - real) * d * 4   # g; the zero rows
        return _bound(nbytes, 3 * real * d)
    if part == "dx":
        nbytes += N * d * 4                              # g
    return _bound(nbytes, 4 * real * d)


def k12_bound(msg, dst, N: int):
    """msg and dst read once, the output written once; one add per edge
    and channel."""
    E, d = msg.shape
    return _bound(E * d * 4 + E * 4 + N * d * 4, E * d)


def time_k8(name: str, a, base):
    """K8's forward on its arguments ``a`` (relu_add, the GCN norm) as the
    GCN layer calls it, with the batch's SlotOrder (its cost timed apart):
    ms in turns with the parent's kernel under ``--baseline`` (with its own
    order made once, where it walks one; its bits it must give, relu_add
    with w and add without), device ms from the profiler with a cold L2
    (None where not measured), and the cases whose bits were checked. Also
    a batch's worth, in turns: a new SlotOrder and GCN_LAYERS_PER_FORWARD
    calls, against the parent's as many calls (and its new order)."""
    from graphtrans_tpu_torch.ops.kernels import (
        SlotOrder, blocked_gather_message_scatter)

    x, ef, eb, pf, pb, wf, wb, rows = (a[k] for k in (
        "x", "ef", "eb", "pf", "pb", "wf", "wb", "rows"))
    N, E = x.shape[0], rows.num_edges
    order_ms = time_ms(lambda: SlotOrder(pf, N, E).runs(), iters=20)
    new = lambda: blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb,
                                                 rows=rows)
    old8 = base and base["block_spmm"]
    own = {}              # the parent's own order, where it walks one
    if old8 and hasattr(old8, "SlotOrder"):
        own = dict(rows=old8.SlotOrder(pf, N, E))
        own["rows"].runs()
    old = old8 and (lambda: old8.blocked_gather_message_scatter(
        x, ef, eb, pf, pb, wf, wb, **own))
    checked = []
    same_bits(f"K8 {name} (relu_add, w)", new, old, checked)
    same_bits(f"K8 {name} (add)",
              lambda: blocked_gather_message_scatter(
                  x, ef, eb, pf, pb, message="add", rows=rows),
              old8 and (lambda: old8.blocked_gather_message_scatter(
                  x, ef, eb, pf, pb, message="add", **own)), checked)

    def batch():
        per = SlotOrder(pf, N, E)
        for _ in range(GCN_LAYERS_PER_FORWARD):
            blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb,
                                           rows=per)

    def old_batch():
        per = own and dict(rows=old8.SlotOrder(pf, N, E))
        for _ in range(GCN_LAYERS_PER_FORWARD):
            old8.blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb,
                                                **per)

    ms, earlier = turns_ms(new, old, 20)
    batch_ms, earlier_batch = turns_ms(batch, old and old_batch, 10)
    return dict(ms=ms, earlier_ms=earlier, order_ms=order_ms,
                batch_ms=batch_ms, earlier_batch_ms=earlier_batch,
                device_ms=device_ms(new, ("blocked_fwd",)),
                earlier_device_ms=old and device_ms(old, ("blocked_fwd",))
                ), checked


def time_k8_dx(name: str, a, g, base):
    """K8-dx on its arguments ``a`` as the GCN layer's backward calls it
    (relu_add, the GCN norm, the batch's src-major SlotOrder through
    ``fwd_slot``, whose cost is timed apart): ms in turns with the parent's
    kernel under ``--baseline`` (which reads the src-major copies, and
    whose bits it must give, relu_add with w and add without), device ms
    a call queued behind a sleep with a cold L2 (``queued_turns``; the
    profiler drops the parent's records), and the cases whose bits were
    checked. Also a training batch's worth, in turns: a new order and
    GCN_LAYERS_PER_FORWARD calls against the parent's as many calls."""
    from graphtrans_tpu_torch.ops.kernels import (
        SlotOrder, blocked_gather_message_scatter_dx)

    x, ef, eb, pb, wf, wb, rows_b = (a[k] for k in (
        "x", "ef", "eb", "pb", "wf", "wb", "rows_b"))
    N, E = x.shape[0], rows_b.num_edges
    order_ms = time_ms(lambda: SlotOrder(pb, N, E,
                                         slot_map=pb["fwd_slot"]).runs(),
                       iters=20)
    new = lambda: blocked_gather_message_scatter_dx(x, g, ef, pb, wf,
                                                    rows=rows_b)
    old8 = base and base["block_spmm"]
    old = old8 and (lambda: old8.blocked_gather_message_scatter_dx(
        x, g, eb, pb, wb))
    checked = []
    same_bits(f"K8-dx {name} (relu_add, w)", new, old, checked)
    same_bits(f"K8-dx {name} (add)",
              lambda: blocked_gather_message_scatter_dx(
                  x, g, ef, pb, message="add", rows=rows_b),
              old8 and (lambda: old8.blocked_gather_message_scatter_dx(
                  x, g, eb, pb, message="add")), checked)

    def batch():
        per = SlotOrder(pb, N, E, slot_map=pb["fwd_slot"])
        for _ in range(GCN_LAYERS_PER_FORWARD):
            blocked_gather_message_scatter_dx(x, g, ef, pb, wf, rows=per)

    def old_batch():
        for _ in range(GCN_LAYERS_PER_FORWARD):
            old()

    ms, earlier = turns_ms(new, old, 20)
    batch_ms, earlier_batch = turns_ms(batch, old and old_batch, 10)
    dev, earlier_dev = queued_turns(new, old)
    return dict(ms=ms, earlier_ms=earlier, order_ms=order_ms,
                batch_ms=batch_ms, earlier_batch_ms=earlier_batch,
                device_ms=dev, earlier_device_ms=earlier_dev), checked


def phase13_kernels(device, d_gnn: int, bench, base=None):
    """(a) K8, K8-demb and K8-dx against their plain versions at the code2
    snapshot's train batch of 16 and the 512-graph bench batch, both with
    block plans at chunk_capacity(edge cap, node cap) (relu_add with the
    GCN norm, add without), and K12 at [E, 128] over the bench batch's
    dst-sorted edges; times beside bound, plain version and yardstick (K7
    and K7-bwd at the same batch; index_add_ for K12)."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops import kernels
    from graphtrans_tpu_torch.ops.kernels import (
        DstOrder, SrcOrder, blocked_gather_message_scatter_bwd_plain,
        blocked_gather_message_scatter_demb,
        blocked_gather_message_scatter_demb_plain,
        blocked_gather_message_scatter_dx_plain,
        blocked_gather_message_scatter_plain, segment_sum_mxu,
        segment_sum_mxu_plain, spmm)

    gen = torch.Generator().manual_seed(SEED + 13)
    args = _code2_args()
    splits, num_tasks, _ = predict.load_splits(args)
    layout = _bsp_layout(predict.serving_layout(
        splits, args, num_tasks, CODE2_BATCH, split="train", seed=SEED))
    t0 = time.perf_counter()
    train16 = next(iterate_batches(splits["train"], **layout))
    coll = (time.perf_counter() - t0) * 1e3
    if train16.bsp_fwd is None or bench.bsp_fwd is None:
        raise AssertionError("a phase 13 batch overflowed its block plans")
    f_err, b_err = 0.0, {"demb": 0.0, "dx": 0.0}
    for b in (train16, bench):
        a = k8_inputs(b, d_gnn, gen, device)
        for message, with_w in (("relu_add", True), ("add", False)):
            f, e = check_k8(a, message, with_w, gen)
            f_err = max(f_err, f)
            b_err = {k: max(b_err[k], e[k]) for k in b_err}
    print(f"[13a] K8, K8-demb and K8-dx agree with their plain versions at "
          f"the code2 train batch of {CODE2_BATCH} (collated with plans in "
          f"{coll:.1f} ms) and the {CODE2_BENCH}-graph batch (relu_add with "
          f"the GCN norm, add without): forward {f_err:.3g} (<= {K8_TOL}), "
          f"d_emb {b_err['demb']:.3g}, dx {b_err['dx']:.3g} (<= {GRAD_TOL}) "
          f"of max(1, max|ref|); pad slots' d_emb exactly 0")

    rows, k7b_rows, same, k8_checked = {}, {}, [], []
    for name, b in (("train16", train16), (f"bench{CODE2_BENCH}", bench)):
        a = k8_inputs(b, d_gnn, gen, device)
        x, ef, eb, pf, pb, wf, wb = (a[k] for k in ("x", "ef", "eb", "pf",
                                                     "pb", "wf", "wb"))
        g = torch.randn(x.shape, generator=gen).to(device)
        fwd, k8_same = time_k8(name, a, base)
        k8_checked.extend(k8_same)
        fwd.update(plain_ms=time_ms(
            lambda: blocked_gather_message_scatter_plain(
                x, ef, eb, pf, pb, wf, wb), iters=5), library_ms=None)
        demb = dict(ms=time_ms(lambda: blocked_gather_message_scatter_demb(
                        x, g, ef, pf, wf), iters=20),
                    plain_ms=time_ms(
                        lambda: blocked_gather_message_scatter_demb_plain(
                            x, g, ef, pf, wf), iters=5),
                    library_ms=None)
        dx, dx_same = time_k8_dx(name, a, g, base)
        k8_checked.extend(dx_same)
        dx.update(plain_ms=time_ms(
            lambda: blocked_gather_message_scatter_dx_plain(
                x, g, eb, pb, wb), iters=5), library_ms=None)
        autograd_ms = time_ms(
            lambda: blocked_gather_message_scatter_bwd_plain(
                x, ef, eb, pf, pb, g, wf, wb), iters=5)
        old8 = base and base["block_spmm"]     # K8-demb unchanged
        same_bits(f"K8-demb {name}",
                  lambda: blocked_gather_message_scatter_demb(x, g, ef, pf,
                                                              wf),
                  old8 and (lambda: old8.blocked_gather_message_scatter_demb(
                      x, g, ef, pf, wf)), k8_checked)
        fwd["bound_ms"], fwd["bound_by"] = k8_bound(a)
        demb["bound_ms"], demb["bound_by"] = k8_bound(a, "demb")
        dx["bound_ms"], dx["bound_by"] = k8_bound(a, "dx")
        k7a = k7_inputs(b, d_gnn, gen, device)
        order = SrcOrder(k7a[2], k7a[4], k7a[0].shape[0])
        order.runs()
        rows = DstOrder(k7a[3], k7a[4], k7a[0].shape[0])
        rows.runs()
        k7_ms = time_ms(lambda: spmm(*k7a, rows=rows), iters=20)
        k7b_ms, k7b_earlier, dev, k7_same = time_k7_bwd(k7a, g, order, base)
        same.extend(k7_same)
        k7b_rows[name] = dict(ms=k7b_ms, earlier_ms=k7b_earlier,
                              bound_ms=k7_bwd_bound(k7a)[0], device_ms=dev[0],
                              earlier_device_ms=dev[1])
        real, slots = _slots_moved(a)
        shape = (f"N={x.shape[0]} C={pf['blk_out'].numel()} slots={slots} "
                 f"real={real} d={d_gnn}")
        for kname, t, plain in (("K8 fwd", fwd, "plain"),
                                ("K8-demb", demb, "plain"),
                                ("K8-dx", dx, "plain")):
            t["shape"] = shape
            turn = ("" if "earlier_ms" not in t else
                    f" (the parent's kernel in turns: "
                    f"{_ms(t['earlier_ms'])})")
            print(f"[13a] {name} {kname} [{shape}]: kernel {t['ms']:.4f} ms"
                  f"{turn}, {plain} {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library none "
                  f"(no single PyTorch call)")
        print(f"[13a] {name} K8 fwd: its SlotOrder {fwd['order_ms']:.4f} ms "
              f"once a batch (host-paced); a batch's worth, a new order and "
              f"{GCN_LAYERS_PER_FORWARD} calls, {fwd['batch_ms']:.4f} ms "
              f"(the parent's {GCN_LAYERS_PER_FORWARD} calls "
              f"{_ms(fwd['earlier_batch_ms'])}, in turns); device time "
              f"{_ms(fwd['device_ms'])} a launch from the profiler, cold L2 "
              f"(the parent's {_ms(fwd['earlier_device_ms'])})")
        print(f"[13a] {name} K8-dx: its src-major SlotOrder through "
              f"fwd_slot {dx['order_ms']:.4f} ms once a batch (host-paced); "
              f"a training batch's worth, a new order and "
              f"{GCN_LAYERS_PER_FORWARD} calls, {dx['batch_ms']:.4f} ms (the "
              f"parent's {GCN_LAYERS_PER_FORWARD} calls "
              f"{_ms(dx['earlier_batch_ms'])}, in turns); device time "
              f"{_ms(dx['device_ms'])} a call queued behind a sleep, cold "
              f"L2 (the parent's {_ms(dx['earlier_device_ms'])}, in turns)")
        print(f"[13a] {name} yardsticks at the same batch: K7 {k7_ms:.4f} ms "
              f"against K8 {fwd['ms']:.4f}; K7-bwd {k7b_ms:.4f} ms against "
              f"K8-demb + K8-dx {demb['ms'] + dx['ms']:.4f}; autograd through "
              f"K8's plain version {autograd_ms:.4f} ms")
        rows = dict(fwd=fwd, demb=demb, dx=dx)
    print_k7_bwd_turns("13a", k7b_rows, same, base)
    if base:
        print(f"[13a] --baseline: K8's forward, K8-demb and K8-dx (reading "
              f"the dst-major copies through fwd_slot; the parent's the "
              f"src-major copies) give the parent kernels' bits on the same "
              f"inputs at {len(k8_checked)} cases: {', '.join(k8_checked)}")

    # K12: the standalone op as its user calls it, once, counted from 0
    tb = bench.to(device)
    N = tb.num_node_slots
    msg = torch.randn(tb.edge_dst.shape[0], 128, generator=gen).to(device)
    dst = tb.edge_dst
    kernels.reset_launches()
    got = segment_sum_mxu(msg, dst, N)
    torch.cuda.synchronize()
    k12_launches = kernels.launch_counts()["segment_sum_mxu"]
    with deterministic():
        want = segment_sum_mxu_plain(msg, dst, N)
    k12_err = _rel_err(got, want)
    out = torch.zeros(N, 128, device=device)
    fns = [lambda: segment_sum_mxu(msg, dst, N),
           lambda: out.zero_().index_add_(0, dst.long(), msg)]
    if base:        # the parent's K12, in the same rounds
        fns.append(lambda: base["scatter_mxu"].segment_sum_mxu(msg, dst, N))
    turns = alternating_ms(fns, K12_ROUNDS, 20)
    k12 = dict(ms=statistics.median(turns[0]),
               earlier_ms=statistics.median(turns[2]) if base else None,
               plain_ms=time_ms(lambda: segment_sum_mxu_plain(msg, dst, N),
                                iters=5),
               library_ms=statistics.median(turns[1]),
               device_ms=device_ms(fns[0], ("segment_sum_kernel",)),
               earlier_device_ms=base and device_ms(fns[2], *(
                   (("segment_sum_kernel",), 1)
                   if hasattr(base["scatter_mxu"], "SPAN") else
                   (("piece_sum_kernel", "row_sum_kernel"), 2))))
    again = segment_sum_mxu(msg, dst, N)
    if k12_err > K8_TOL or k12_launches != 1 or not torch.isfinite(got).all():
        raise AssertionError(f"K12 disagrees with its plain version: "
                             f"{k12_err} (<= {K8_TOL}), {k12_launches} "
                             f"launches")
    if not torch.equal(got, again):
        raise AssertionError("K12 gave other bits in a second call")
    if segment_sum_mxu(msg[:, :100].contiguous(), dst, N) is not None:
        raise AssertionError("K12 took a shape the JAX function refuses")
    k12["bound_ms"], k12["bound_by"] = k12_bound(msg, dst, N)
    k12["shape"] = f"E={msg.shape[0]} d=128 N={N}"
    print(f"[13a] K12 segment_sum_mxu [{k12['shape']}]: {k12_err:.3g} of "
          f"max(1, max|ref|) from its plain version (<= {K8_TOL}), the same "
          f"bits in a second call, None at d=100; kernel {k12['ms']:.4f} ms "
          f"(the parent's {_ms(k12['earlier_ms'])}, in the same rounds), "
          f"plain {k12['plain_ms']:.4f} ms, bound {k12['bound_ms']:.4f} ms "
          f"({k12['bound_by']}), library {k12['library_ms']:.4f} ms "
          f"(index_add_ into zeros); device time {_ms(k12['device_ms'])} a "
          f"call from the profiler, cold L2 (the parent's "
          f"{_ms(k12['earlier_device_ms'])}); {k12_launches} launch in its "
          f"standalone call (no model path calls it)")
    whats = ["K12 segment_sum_mxu", "index_add_", "the parent's K12"]
    for what, per in zip(whats, turns):
        print(f"[13a] K12 in alternating turns ({K12_ROUNDS} rounds, "
              f"{', then '.join(whats[:len(turns)])}): {what} median "
              f"{statistics.median(per):.4f} ms, min {min(per):.4f}, max "
              f"{max(per):.4f}, spread "
              f"{(max(per) - min(per)) / statistics.median(per):.1%}: "
              f"{', '.join(f'{x:.4f}' for x in per)}")
    return dict(f_err=f_err, b_err=b_err, k12_err=k12_err,
                k12_launches=k12_launches, timed=(rows["fwd"], rows["demb"],
                                                  rows["dx"], k12))


def src_major_rows(encoder, batch):
    """What ``encoder`` (a ``LinearEdgeEncoder``) gives for the src-major
    plan's attributes with its weights of the moment: the copy the
    parent's step made for K8-dx. Calls its inner Linear, so that a
    forward hook on the encoder can call it."""
    with torch.no_grad():
        lin = encoder.lin
        return lin(batch.edge_attr_bsp_bwd.to(lin.weight.dtype))


def emb_through_fwd_slot(batch, copies) -> int:
    """The layers of a train step on ``batch`` (``copies``: (attributes,
    emb, the encoder's src-major rows at that moment) of each edge encoder
    call, in call order) whose encoder ran on the dst-major plan's
    attributes alone and whose rows read through the src-major plan's
    ``fwd_slot`` equal the src-major rows bit for bit on every real slot:
    what K8-dx reads is what the parent's read. 0 where any call encoded
    anything else."""
    if any(a is not batch.edge_attr_bsp_fwd for a, _, _ in copies):
        return 0
    fwd_slot = batch.bsp_bwd["fwd_slot"].long()
    real = batch.bsp_bwd["mask"].reshape(-1) > 0
    return sum(torch.equal(ef[fwd_slot[real]], eb.to(ef.dtype)[real])
               for _, ef, eb in copies)


def phase13_serve(device, tmp: str):
    """(b) The code2 flagship built by ``predict.build_model`` with
    ``set_block_spmm(model, "on")`` serves the snapshot's valid and test
    splits through ``predict.predict_split`` in batches of 16 with block
    plans (none overflows): 5 K8 and no K7 launch a batch; logits against
    the plain versions and the K7 route; then one train step of
    ``main.build_run``'s model and step (5 K8, 5 K8-demb, 5 K8-dx; the
    edge encoder once a layer, on the dst-major plan's attributes, its
    rows through fwd_slot the src-major copy's bits) against the plain
    versions and the K7 route."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.ops import kernels
    from graphtrans_tpu_torch.ops.kernels.attention_packed import W_MAX
    from graphtrans_tpu_torch.ops.block_plan import set_block_spmm

    args = _code2_args()
    splits, num_tasks, code = predict.load_splits(args)
    layouts = {s: _bsp_layout(predict.serving_layout(splits, args, num_tasks,
                                                     split=s))
               for s in ("train", "valid", "test")}
    overflow = sum(b.bsp_fwd is None for s in layouts
                   for b in iterate_batches(splits[s], **layouts[s]))
    if overflow:
        raise AssertionError(f"{overflow} code2 batches overflowed their "
                             f"block plans")
    model = set_block_spmm(predict.build_model(args, num_tasks, device, code),
                           "on")
    encoded = []                  # the edge encoders' calls while serving
    hooks = [c.edge_encoder.register_forward_hook(
        lambda m, inp, out: encoded.append(inp[0].shape[0]))
        for c in model.gnn_node.convs]
    kernels.reset_launches()                 # the blocked serving path
    want = collections.Counter()
    results = {}
    for split in ("valid", "test"):
        out = os.path.join(tmp, f"code2_bsp_{split}.jsonl")
        res = predict.predict_split(model, splits[split], layouts[split], out,
                                    device, code)
        recs = [json.loads(line) for line in open(out)]
        if (len(recs) != len(splits[split]) or not 0.0 <= res["F1"] <= 1.0
                or not all(len(r["tokens"]) == code.max_seq_len
                           for r in recs)):
            raise AssertionError(f"code2 {split} on the blocked route: "
                                 f"{len(recs)} records, {res}")
        widths = [layouts[split][k] for k in ("seq_pack_w", "seq_pack_w2",
                                              "seq_pack_w3")
                  if layouts[split].get(k)]
        wide = sum(w > W_MAX for w in widths)
        n = res["batches"]
        want.update(blocked_gather_message_scatter=GCN_LAYERS_PER_FORWARD * n,
                    flash_hil_seg=ENCODER_LAYERS_PER_FORWARD * wide * n,
                    attention_seg=ENCODER_LAYERS_PER_FORWARD
                    * (len(widths) - wide) * n)
        results[split] = res
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    by_instance = k2_instances()
    for h in hooks:
        h.remove()
    if launches != dict(want):
        raise AssertionError(f"code2 blocked serving launches {launches}, "
                             f"expected {dict(want)} (K7 none)")
    batches = sum(r["batches"] for r in results.values())
    if len(encoded) != GCN_LAYERS_PER_FORWARD * batches:
        raise AssertionError(f"code2 blocked serving: {len(encoded)} edge "
                             f"encoder calls in {batches} batches, one a "
                             f"layer (the dst-major plan's) expected")
    print(f"[13b] served the code2 valid and test splits on the blocked route "
          f"({sum(r['records'] for r in results.values())} graphs, {batches} "
          f"batches of <= {CODE2_BATCH}, no plan overflow in any split): F1 "
          f"{ {s: round(r['F1'], 6) for s, r in results.items()} }; launches "
          f"{launches}: K8 {launches['blocked_gather_message_scatter'] / batches:g}"
          f" a batch, K7 0{by_instance}; the edge encoder {len(encoded)} "
          f"times, {len(encoded) // batches} a batch: the dst-major plan's "
          f"slots only")

    err_plain = err_k7 = 0.0
    with torch.inference_mode():
        for split in ("train", "valid", "test"):
            for b in iterate_batches(splits[split], **layouts[split]):
                tb = b.to(device)
                gm = tb.graph_mask
                got = model(tb)[gm]
                plain = kernels.set_kernels(model, False)(tb)[gm]
                k7 = set_block_spmm(kernels.set_kernels(model, True),
                                    "off")(tb)[gm]
                set_block_spmm(model, "on")
                if not torch.isfinite(got).all():
                    raise AssertionError("code2 blocked logits not finite")
                err_plain = max(err_plain, (got - plain).abs().max().item())
                err_k7 = max(err_k7, (got - k7).abs().max().item())
    if err_plain > LOGITS_TOL or err_k7 > LOGITS_TOL:
        raise AssertionError(f"code2 blocked logits: {err_plain} from the "
                             f"plain versions, {err_k7} from the K7 route "
                             f"(<= {LOGITS_TOL})")
    print(f"[13b] code2 logits on the blocked route over all three splits: "
          f"max |diff| {err_plain:.3g} from the plain versions and "
          f"{err_k7:.3g} from the K7 route (<= {LOGITS_TOL})")

    targs = _code2_train_args()
    tlayout = _bsp_layout(predict.serving_layout(
        splits, targs, num_tasks, CODE2_BATCH, split="train", seed=SEED))
    host = next(iterate_batches(
        splits["train"], order=shuffled_order(len(splits["train"]), SEED, 0),
        **tlayout))
    batch = host.to(device)
    if batch.bsp_fwd is None:
        raise AssertionError("the code2 train batch overflowed its plans")
    got = {}
    step_launches = None
    with deterministic():
        for tag, on, bsp in (("kernels", True, "on"), ("plain", False, "on"),
                             ("k7", True, "off")):
            model, step = _trainer(targs, num_tasks, device, kernels_on=on,
                                   data=code, bsp=bsp)
            copies = []      # (attributes, emb, src-major rows) a call
            hooks = [c.edge_encoder.register_forward_hook(
                lambda m, inp, out: copies.append(
                    (inp[0], out.detach(), src_major_rows(m, batch))))
                for c in model.gnn_node.convs] if tag == "kernels" else []
            kernels.reset_launches()         # the blocked training path
            loss = step(batch).item()
            for h in hooks:
                h.remove()
            if tag == "kernels":
                step_launches = {k: v for k, v in
                                 kernels.launch_counts().items() if v}
                by_instance = k2_instances()
                enc_calls = len(copies)
                emb_same = emb_through_fwd_slot(batch, copies)
            got[tag] = (loss, {n: p.grad for n, p in
                               model.named_parameters()})
    want = {"blocked_gather_message_scatter": 5,
            "blocked_gather_message_scatter_demb": 5,
            "blocked_gather_message_scatter_dx": 5}
    if {k: step_launches.get(k, 0) for k in (*want, "spmm", "spmm_bwd")} != {
            **want, "spmm": 0, "spmm_bwd": 0}:
        raise AssertionError(f"code2 blocked step launches {step_launches}")
    lk, gk = got["kernels"]
    errs = {}
    for tag in ("plain", "k7"):
        lr, gr = got[tag]
        errs[tag] = (abs(lk - lr), max(_rel_err(gk[n], gr[n]) for n in gk))
        if errs[tag][0] > LOGITS_TOL or errs[tag][1] > GRAD_TOL:
            raise AssertionError(f"code2 blocked step against {tag}: loss "
                                 f"|diff| {errs[tag][0]}, gradients "
                                 f"{errs[tag][1]}")
    if emb_same != GCN_LAYERS_PER_FORWARD or enc_calls != emb_same:
        raise AssertionError(f"the step's edge encoders: {enc_calls} "
                             f"calls; {emb_same} layers of "
                             f"{GCN_LAYERS_PER_FORWARD} encoded the "
                             f"dst-major plan alone with rows through "
                             f"fwd_slot equal to the src-major copy's; "
                             f"K8-dx's relu decisions may differ from the "
                             f"parent's")
    print(f"[13b] the train step's edge encoders ran {enc_calls} times, "
          f"once a layer, on the dst-major plan's attributes only (no "
          f"src-major encoder run, no src-major weight); in each of its "
          f"{emb_same} layers the rows K8-dx reads through fwd_slot equal, "
          f"bit for bit on every real slot, the src-major copy the parent "
          f"made")
    print(f"[13b] one code2 train step on the blocked route (main.build_run, "
          f"set_block_spmm on, deterministic algorithms): launches "
          f"{step_launches}{by_instance}; loss {lk:.6f}; against the plain "
          f"versions loss "
          f"|diff| {errs['plain'][0]:.3g}, gradients {errs['plain'][1]:.3g}; "
          f"against the K7 route {errs['k7'][0]:.3g}, {errs['k7'][1]:.3g} "
          f"of max(1, max|ref|) (<= {LOGITS_TOL}, {GRAD_TOL})")
    return launches, step_launches


def phase13_cost(device, bench, num_tasks: int, smi: str):
    """(c) The code2 forward and train step on the 512-graph batch with
    block plans, on the blocked route and on the K7 route in the same call
    (median of 10 after 3 warm-ups, peak memory), and a torch.profiler
    split of both routes' forward (busy and Linear ms) and of the blocked
    step."""
    import types

    from graphtrans_tpu_torch.models.gnn_transformer import (
        build_gnn_transformer)
    from graphtrans_tpu_torch.nn.init import init_weights
    from graphtrans_tpu_torch.ops.block_plan import set_block_spmm

    args = _code2_args()
    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    model = build_gnn_transformer(args, num_tasks, device, data=sizes)
    init_weights(model, torch.Generator().manual_seed(SEED)).eval()
    t0 = time.perf_counter()
    tb = bench.to(device)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    n = int(bench.graph_mask.sum())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for mode in ("on", "off"):
        set_block_spmm(model, mode)
        with torch.inference_mode():
            _median_ms(lambda: model(tb), 3)                # warm-up
            torch.cuda.reset_peak_memory_stats(device)
            ms, lo, hi, out = _median_ms(lambda: model(tb), 10)
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            if not torch.isfinite(out[tb.graph_mask]).all():
                raise AssertionError("code2 bench forward: not finite")
        route = "blocked (K8)" if mode == "on" else "K7"
        print(f"[13c] code2 forward of {n} graphs, {route} route: median "
              f"{ms:.3f} ms over 10 (min {lo:.3f}, max {hi:.3f}), "
              f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on "
              f"{smi}")
        with torch.inference_mode():
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_FORWARDS):
                    model(tb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FORWARDS
        _print_split("[13c]", "code2 blocked forward" if mode == "on"
                     else "code2 forward, K7 route", prof, PROFILED_FORWARDS,
                     wall, smi, graphs=n)
    del model
    targs = _code2_train_args()
    for bsp in ("on", "off"):
        model, step = _trainer(targs, num_tasks, device, data=sizes, bsp=bsp)
        _median_ms(lambda: step(tb), 3)                     # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        if not torch.isfinite(loss):
            raise AssertionError("code2 bench train step: loss not finite")
        route = "blocked (K8)" if bsp == "on" else "K7"
        print(f"[13c] code2 train step of {n} graphs, {route} route: median "
              f"{ms:.3f} ms over {TIMED_STEPS} (min {lo:.3f}, max {hi:.3f}), "
              f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on "
              f"{smi}")
        if bsp == "on":
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_STEPS):
                    step(tb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
            _print_split("[13c]", "code2 blocked train step", prof,
                         PROFILED_STEPS, wall, smi, graphs=n)
        del model, step
    print(f"[13c] the bench batch with plans copied to the card in "
          f"{copy_ms:.1f} ms (host clock; plans, two chunk-ordered attribute "
          f"copies and the flat fields)")
    del tb
    torch.cuda.empty_cache()


# ---- phase 14: bf16 training of the molpcba GraphTrans -----------------------

BF16 = torch.bfloat16
BF16_TC_FLOPS = 989e12    # H100 SXM bf16 on the tensor cores, dense
# bf16 kernels against their plain bf16 versions, of max(1, max |plain|):
# outputs within two bf16 ulps at 1, gradients within four (two rounding
# points each, sums in other orders on either side)
BF16_OUT_TOL, BF16_GRAD_TOL = 7.8e-3, 1.6e-2
# the bf16 step through the kernels against the plain versions: loss,
# gradients of max(1, max |plain|) (the bound tests/test_torch_port_bf16.py
# holds the step to against the JAX package)
BF16_STEP_TOL = (2e-2, 5e-2)
BF16_STEPS_EPOCHS = 3   # the snapshot's 192 train graphs: a step an epoch


def _bf16(args):
    """K1's arguments with x, the table and w in bf16 (scale stays f32)."""
    x, src, dst, emask, attr, tbl, w, scale = args
    return (x.to(BF16), src, dst, emask, attr, tbl.to(BF16),
            None if w is None else w.to(BF16), scale)


def check_k1_bf16(inp, gout):
    """K1 and K1-bwd in bf16 against their plain bf16 versions, with w or
    the GIN scale, and both for the backward: relative errors (fwd, bwd)."""
    from graphtrans_tpu_torch.ops.kernels import (gin_agg, gin_agg_bwd,
                                                  gin_agg_bwd_plain,
                                                  gin_agg_plain)

    f_err = b_err = 0.0
    for with_w, with_scale in ((False, True), (True, False), (True, True)):
        args = _bf16((inp["x"], inp["src"], inp["dst"], inp["emask"],
                      inp["attr"], inp["tbl"], inp["w"] if with_w else None,
                      inp["scale"] if with_scale else None))
        got = gin_agg(*args)
        grads = gin_agg_bwd(*args, gout)
        torch.cuda.synchronize()
        if got.dtype != BF16 or got[~inp["node_mask"]].any():
            raise AssertionError("K1 bf16: not bf16, or padding rows not 0")
        f_err = max(f_err, _rel_err(got, gin_agg_plain(*args)))
        for name, g, w in zip(("dx", "dT", "dw", "dscale"), grads,
                              gin_agg_bwd_plain(*args, gout)):
            if g is None:
                continue
            if not torch.isfinite(g.float()).all() or g.dtype != w.dtype:
                raise AssertionError(f"K1-bwd bf16: {name} not finite, or "
                                     f"{g.dtype} against {w.dtype}")
            b_err = max(b_err, _rel_err(g, w))
    if f_err > BF16_OUT_TOL or b_err > BF16_GRAD_TOL:
        raise AssertionError(f"K1 bf16 against its plain version: forward "
                             f"{f_err} (<= {BF16_OUT_TOL}), backward {b_err} "
                             f"(<= {BF16_GRAD_TOL})")
    return f_err, b_err


def check_attn_bf16(name: str, fwd, bwd, plain, bwd_plain, qkv, seg,
                    nhead: int, gen, serve=None):
    """A bf16 attention pair (K2's long instance, K3) at rate 0 and the
    training rate against its plain bf16 version (the same masks):
    relative errors (forward, backward); outputs bf16, padding tokens
    exactly 0 with m = -inf and l = 0, and at rate 0 the serving launch's
    bits (``serve``)."""
    f_err = b_err = 0.0
    for rate, seed in ((0.0, 0), (DROPOUT, 24681357)):
        out, m, l = fwd(qkv, seg, nhead, rate, seed)
        g = torch.randn(out.shape, generator=gen).to(qkv.device, BF16)
        dqkv = bwd(qkv, seg, nhead, g, (out, m, l), rate, seed)
        same = serve is None or rate > 0 or torch.equal(serve(qkv, seg,
                                                               nhead), out)
        torch.cuda.synchronize()
        if out.dtype != BF16 or dqkv.dtype != BF16:
            raise AssertionError(f"{name} bf16: outputs are not bf16")
        pad = seg < 0
        if (out[pad].any() or dqkv[pad].any() or not same
                or not (m[pad] == -math.inf).all() or l[pad].any()):
            raise AssertionError(f"{name} bf16: padding tokens not 0 (or "
                                 f"their m not -inf, l not 0), or the "
                                 f"serving launch differs from the training "
                                 f"one")
        f_err = max(f_err, _rel_err(out, plain(qkv, seg, nhead, rate, seed)))
        b_err = max(b_err, _rel_err(dqkv, bwd_plain(qkv, seg, nhead, g, rate,
                                                    seed)))
    if f_err > BF16_OUT_TOL or b_err > BF16_GRAD_TOL:
        raise AssertionError(f"{name} bf16 against its plain version: "
                             f"forward {f_err} (<= {BF16_OUT_TOL}), backward "
                             f"{b_err} (<= {BF16_GRAD_TOL})")
    return f_err, b_err


def check_k2_bf16(qkv, seg, nhead: int, gen, mod=None):
    """K2 and K2-bwd in bf16, at rate 0 and the training rate, against
    their plain bf16 versions (the same masks): relative errors. ``mod`` is
    the kernels' module (the port's attention_packed by default; the
    parent's under ``--baseline``); the plain versions are the port's."""
    from graphtrans_tpu_torch.ops.kernels import (attention_seg_bwd_plain,
                                                  attention_seg_plain)
    from graphtrans_tpu_torch.ops.kernels import attention_packed

    mod = mod or attention_packed
    return check_attn_bf16("K2", mod.attention_seg_with_stats,
                           mod.attention_seg_bwd, attention_seg_plain,
                           attention_seg_bwd_plain, qkv, seg, nhead, gen,
                           mod.attention_seg)


def _seg_pairs(seg, nhead: int) -> int:
    """The same-segment (query, key) pairs of every head."""
    _, counts = torch.unique(seg[seg >= 0], return_counts=True)
    return int((counts.long() ** 2).sum().item()) * nhead


def k2_bf16_bound(qkv, seg, nhead: int):
    """K2's bf16 training launch reads qkv and seg and writes out, m and l;
    per same-segment pair its two products (4 hd flops) on the bf16 tensor
    cores, as the kernel runs them, and the softmax (4) on the f32 units."""
    R, W, d3 = qkv.shape
    hd = d3 // 3 // nhead
    pairs = _seg_pairs(seg, nhead)
    nbytes = (qkv.numel() * 2 + seg.numel() * 4 + R * W * (d3 // 3) * 2
              + 2 * R * W * nhead * 4)
    return _tc_bound(nbytes, pairs * 4 * hd, pairs * 4, BF16_TC_FLOPS)


def k2_bf16_bwd_bound(qkv, seg, nhead: int):
    """K2-bwd's bf16 instance reads qkv, seg, the cotangent and the
    forward's m and l (not its out: delta is summed from the pairs) and
    writes dqkv; per pair its five products (s, dp, dQ, dK, dV: 10 hd
    flops) on the bf16 tensor cores, as the kernel runs them, and 8 on the
    f32 units."""
    R, W, d3 = qkv.shape
    hd = d3 // 3 // nhead
    pairs = _seg_pairs(seg, nhead)
    nbytes = (2 * qkv.numel() * 2 + seg.numel() * 4 + R * W * (d3 // 3) * 2
              + 2 * R * W * nhead * 4)
    return _tc_bound(nbytes, pairs * 10 * hd, pairs * 8, BF16_TC_FLOPS)


def phase14_kernels(device, d_gnn: int, d_model: int, nhead: int, big,
                    base=None):
    """(a) K1, K1-bwd, K2 and K2-bwd in bf16 against their plain bf16
    versions at serve64 and bench4096, timed as the bf16 step calls them
    (K1 with the GIN scale, K2 at the training rate) beside the f32
    instance in turns, bound (bf16 bytes), plain version and, for K2 and
    K2-bwd, SDPA in bf16 with the bool segment mask. With ``base`` the
    parent's K2 and K2-bwd bf16 instances too: their errors, and their
    times in the same turns; and the f32 instances of K2 and K2-bwd held to
    the parent's bits."""
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.mol import load_mol_splits
    from graphtrans_tpu_torch.ops.kernels import (attention_seg_bwd, gin_agg,
                                                  gin_agg_bwd, gin_agg_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_seg_plain, attention_seg_with_stats)
    from graphtrans_tpu_torch.predict import serving_layout

    old = base and base["attention_packed"]
    gen = torch.Generator().manual_seed(SEED + 14)
    splits, num_tasks = load_mol_splits(SNAPSHOT, "ogbg-molpcba")
    serve = next(iterate_batches(splits["train"],
                                 **serving_layout(splits, _args(), num_tasks)))
    errs = dict.fromkeys(("k1", "k1b", "k2", "k2b"), 0.0)
    rows, checked = None, []
    for name, b in (("serve64", serve), ("bench4096", big)):
        inp = k1_inputs(b, d_gnn, gen, device)
        gout = torch.randn(inp["x"].shape, generator=gen).to(device, BF16)
        f, e = check_k1_bf16(inp, gout)
        errs["k1"], errs["k1b"] = max(errs["k1"], f), max(errs["k1b"], e)
        qkv, seg = k2_inputs(b, d_model, gen, device)
        f, e = check_k2_bf16(qkv.to(BF16), seg, nhead, gen)
        errs["k2"], errs["k2b"] = max(errs["k2"], f), max(errs["k2b"], e)
        line = (f"[14a] {name} K2 bf16 {f:.3g}, K2-bwd bf16 {e:.3g} of "
                f"max(1, max|plain bf16|)")
        if old:
            fo, eo = check_k2_bf16(qkv.to(BF16), seg, nhead, gen, old)
            line += f" (the parent's pair {fo:.3g}, {eo:.3g})"
        print(line)

        a32 = (inp["x"], inp["src"], inp["dst"], inp["emask"], inp["attr"],
               inp["tbl"], None, inp["scale"])
        a16, g32 = _bf16(a32), gout.float()
        fixed = a16[1:5]
        k1 = dict(plain_ms=time_ms(lambda: gin_agg_plain(*a16), iters=5),
                  library_ms=None)
        k1["ms"], k1["f32_ms"] = turns_ms(lambda: gin_agg(*a16),
                                          lambda: gin_agg(*a32), 20)
        k1["bound_ms"], k1["bound_by"] = k1_bound(a16)
        k1b = dict(plain_ms=_plain_bwd_ms(
            lambda x, t, sc: gin_agg_plain(x, *fixed, t, None, sc),
            [a16[0], a16[5], a16[7]], gout), library_ms=None)
        k1b["ms"], k1b["f32_ms"] = turns_ms(
            lambda: gin_agg_bwd(*a16, gout), lambda: gin_agg_bwd(*a32, g32),
            20)
        k1b["bound_ms"], k1b["bound_by"] = k1_bwd_bound(a16, gout)
        qkv, seg = k2_inputs(b, d_model, gen, device, pad_rows=0)
        q16, seed = qkv.to(BF16), 13572468
        g16 = torch.randn(qkv.shape[0], qkv.shape[1], d_model,
                          generator=gen).to(device, BF16)
        g32 = g16.float()
        k2 = dict(plain_ms=time_ms(lambda: attention_seg_plain(
            q16, seg, nhead, DROPOUT, seed), iters=5),
            library_ms=sdpa_ms(q16, seg, nhead))
        k2["ms"], k2["f32_ms"], k2["earlier_ms"] = rounds_ms([
            lambda: attention_seg_with_stats(q16, seg, nhead, DROPOUT, seed),
            lambda: attention_seg_with_stats(qkv, seg, nhead, DROPOUT, seed),
            old and (lambda: old.attention_seg_with_stats(
                q16, seg, nhead, DROPOUT, seed))], 20)
        k2["bound_ms"], k2["bound_by"] = k2_bf16_bound(q16, seg, nhead)
        s16 = attention_seg_with_stats(q16, seg, nhead, DROPOUT, seed)
        s32 = attention_seg_with_stats(qkv, seg, nhead, DROPOUT, seed)
        k2b = dict(plain_ms=_plain_bwd_ms(
            lambda t: attention_seg_plain(t, seg, nhead, DROPOUT, seed),
            [q16], g16), library_ms=sdpa_bwd_ms(q16, seg, nhead, g16,
                                                DROPOUT))
        k2b["ms"], k2b["f32_ms"], k2b["earlier_ms"] = rounds_ms([
            lambda: attention_seg_bwd(q16, seg, nhead, g16, s16, DROPOUT,
                                      seed),
            lambda: attention_seg_bwd(qkv, seg, nhead, g32, s32, DROPOUT,
                                      seed),
            old and (lambda: old.attention_seg_bwd(q16, seg, nhead, g16, s16,
                                                   DROPOUT, seed))], 20)
        k2b["bound_ms"], k2b["bound_by"] = k2_bf16_bwd_bound(q16, seg, nhead)
        if old:
            same_bits(f"K2 f32 training forward {name}",
                      lambda: attention_seg_with_stats(qkv, seg, nhead,
                                                       DROPOUT, seed),
                      lambda: old.attention_seg_with_stats(qkv, seg, nhead,
                                                           DROPOUT, seed),
                      checked)
            same_bits(f"K2-bwd f32 {name}",
                      lambda: attention_seg_bwd(qkv, seg, nhead, g32, s32,
                                                DROPOUT, seed),
                      lambda: old.attention_seg_bwd(qkv, seg, nhead, g32,
                                                    s32, DROPOUT, seed),
                      checked)
        shape = "G={} Sm={} Em={} d={}".format(*inp["x"].shape[:2],
                                                inp["src"].shape[1], d_gnn)
        k2shape = f"R={qkv.shape[0]} W={qkv.shape[1]} d={d_model} H={nhead}"
        for kname, t, sh in (("K1 gin_agg", k1, shape),
                             ("K1-bwd gin_agg_bwd", k1b, shape),
                             ("K2 attention_seg (rate 0.3, stats)", k2,
                              k2shape),
                             ("K2-bwd attention_seg_bwd (rate 0.3)", k2b,
                              k2shape)):
            t["shape"] = sh
            lib = ("-" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f}")
            parent = ("" if t.get("earlier_ms") is None else
                      f", the parent's bf16 {t['earlier_ms']:.4f}")
            print(f"[14a] {name} {kname} bf16 [{sh}]: kernel "
                  f"{t['ms']:.4f} ms (the f32 instance {t['f32_ms']:.4f}"
                  f"{parent}, in turns), plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library {lib} "
                  f"ms (SDPA in bf16, bool seg mask)")
        rows = (k1, k1b, k2, k2b)
    print(f"[14a] bf16 kernels agree with their plain bf16 versions, of "
          f"max(1, max|plain|): K1 {errs['k1']:.3g}, K2 {errs['k2']:.3g} "
          f"(<= {BF16_OUT_TOL}); K1-bwd {errs['k1b']:.3g}, K2-bwd "
          f"{errs['k2b']:.3g} (<= {BF16_GRAD_TOL}); padding tokens exactly 0")
    if old:
        print(f"[14a] --baseline: the f32 instances give the parent's bits "
              f"on the same inputs at {checked}")
    return dict(errs=errs, timed=rows)


def _bf16_want(steps: int) -> dict:
    """The bf16 step's launches by instance: 5 K1, 5 K1-bwd, 4 K2 and 4
    K2-bwd a step, all bf16."""
    return {"gin_agg": {"f32": 0, "bf16": 5 * steps},
            "gin_agg_bwd": {"f32": 0, "bf16": 5 * steps},
            "attention_seg": {"tile": 0, "long": 0, "tile_bf16": 4 * steps,
                              "long_bf16": 0},
            "attention_seg_bwd": {"tile": 0, "long": 0,
                                  "tile_bf16": 4 * steps, "long_bf16": 0}}


def phase14_train(device, tmp: str):
    """(b) The counts set to 0, ``main --precision bf16`` at the yml's
    batch (256) for BF16_STEPS_EPOCHS epochs on the snapshot, the counts
    read: every K1, K1-bwd, K2 and K2-bwd launch the bf16 instance; (c)
    finite losses, every parameter moved (float32 masters); one bf16 step
    through the kernels against the plain versions on the card under
    deterministic algorithms."""
    import io

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.data.mol import load_mol_splits
    from graphtrans_tpu_torch.ops import kernels
    from graphtrans_tpu_torch.predict import serving_layout

    argv = ["--configs", CONFIG, "--data_root", SNAPSHOT, "--epochs",
            str(BF16_STEPS_EPOCHS), "--seed", str(SEED), "--precision",
            "bf16", "--save_path", tmp]
    out = io.StringIO()
    kernels.reset_launches()                 # the bf16 path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = train_main.main(argv)
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_inst = {fn.__name__: dict(fn.instances) for fn in (
        kernels.gin_agg, kernels.gin_agg_bwd, kernels.attention_seg,
        kernels.attention_seg_bwd)}
    for line in out.getvalue().splitlines():
        print(f"[14b] main: {line}")
    steps = sum(r["steps"] for r in res["epochs"])
    want = {**dict.fromkeys(launches, 0), "gin_agg": 5 * steps,
            "gin_agg_bwd": 5 * steps, "attention_seg": 4 * steps,
            "attention_seg_bwd": 4 * steps}
    if steps == 0 or launches != want or by_inst != _bf16_want(steps):
        raise AssertionError(f"bf16 training launches {launches} by instance "
                             f"{by_inst}, expected {want}, "
                             f"{_bf16_want(steps)}")
    print(f"[14b] the bf16 step's launches ({steps} steps): {launches}; by "
          f"instance {by_inst}: 5 K1, 5 K1-bwd, 4 K2 and 4 K2-bwd a step, "
          f"every one the bf16 instance")
    if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
        raise AssertionError(f"bf16 epoch losses not finite: {res['epochs']}")
    args = _train_args(["--precision", "bf16"])
    splits, num_tasks = load_mol_splits(SNAPSHOT, "ogbg-molpcba")
    init, _ = _trainer(args, num_tasks, device)
    trained = torch.load(res["saved"], map_location=device, weights_only=True)
    params = dict(init.named_parameters())
    still = [n for n, p in params.items() if torch.equal(p, trained[n])]
    wrong = [n for n, p in trained.items() if p.dtype != torch.float32
             and p.is_floating_point()]
    if still or wrong:
        raise AssertionError(f"bf16 training: parameters that did not move "
                             f"{still}; state not float32 {wrong}")
    print(f"[14c] trained {steps} bf16 steps at the yml's batch size "
          f"({secs:.2f} s with the model build) through "
          f"graphtrans_tpu_torch.main --precision bf16: losses "
          f"{[round(r['loss'], 6) for r in res['epochs']]}, all "
          f"{len(params)} parameter tensors moved, the saved state float32")

    layout = serving_layout(splits, args, num_tasks, args.batch_size)
    batch = next(iterate_batches(
        splits["train"], order=shuffled_order(len(splits["train"]), SEED, 0),
        **layout)).to(device)
    got = []
    with deterministic():
        for on in (True, False):
            model, step = _trainer(args, num_tasks, device, kernels_on=on)
            loss = step(batch)
            got.append((loss.item(), loss.dtype,
                        {n: p.grad for n, p in model.named_parameters()}))
    (lk, dt, gk), (lp, _, gp) = got
    g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
    dtypes = {g.dtype for g in gk.values()} | {dt}
    if (abs(lk - lp) > BF16_STEP_TOL[0] * max(1.0, abs(lp))
            or g_err > BF16_STEP_TOL[1] or dtypes != {torch.float32}):
        raise AssertionError(f"bf16 step through the kernels: loss "
                             f"{lk} vs {lp}, gradients {g_err} (<= "
                             f"{BF16_STEP_TOL[1]}), dtypes {dtypes}")
    print(f"[14c] one bf16 step (dropout {args.gnn_dropout}/"
          f"{args.transformer_dropout}, same seeds, deterministic "
          f"algorithms) through the kernels vs the plain bf16 versions on "
          f"the card: loss {lk:.6f} vs {lp:.6f} (|diff| {abs(lk - lp):.3g} "
          f"<= {BF16_STEP_TOL[0]} of max(1, |ref|)), gradients "
          f"{g_err:.3g} of max(1, max|ref|) (<= {BF16_STEP_TOL[1]}); loss "
          f"and gradients float32")
    return launches, by_inst


def phase14_cost(device, big, smi: str):
    """(d) The 4096-graph train step in f32 and in bf16 in turns (f32,
    bf16, bf16, f32): median ms, peak memory; then each profiled: idle
    share and device time by layer."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    tb = big.to(device)
    n = int(big.graph_mask.sum())
    runs, profiled = {"f32": [], "bf16": []}, set()
    for prec in ("f32", "bf16", "bf16", "f32"):
        args = _train_args(["--precision", prec])
        model, step = _trainer(args, 128, device)
        _median_ms(lambda: step(tb), 3)                     # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        if not torch.isfinite(loss):
            raise AssertionError(f"4096-graph {prec} step: loss not finite")
        runs[prec].append(ms)
        print(f"[14d] {prec} train step of {n} graphs: median {ms:.3f} ms "
              f"over {TIMED_STEPS} (min {lo:.3f}, max {hi:.3f}), "
              f"{n / ms * 1e3:.0f} graphs/s, peak memory {peak:.2f} GiB on "
              f"{smi}")
        if prec not in profiled:
            profiled.add(prec)
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_STEPS):
                    step(tb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
            _print_split("[14d]", f"{prec} train step", prof, PROFILED_STEPS,
                         wall, smi)
        del model, step
        torch.cuda.empty_cache()
    f32, bf = statistics.mean(runs["f32"]), statistics.mean(runs["bf16"])
    print(f"[14d] train4096: bf16 {bf:.3f} ms against f32 {f32:.3f} ms in "
          f"turns ({f32 / bf:.3f}x) on {smi}")


# ---- phase 15: bf16 training of the code2 GraphTrans ------------------------


def _k7_bf16(a):
    """K7's arguments as the bf16 GCN layer gets them: x and emb bf16, the
    GCN norm bf16 (formed in x's dtype, widened by the wrapper)."""
    x, emb, src, dst, emask, w = a
    return (x.to(BF16), emb.to(BF16), src, dst, emask, w.to(BF16))


def check_k7_bf16(a, gen):
    """K7 and K7-bwd in bf16 (relu_add and add) against their plain bf16
    versions: relative errors (forward, backward); masked edges' d_emb
    rows exactly 0."""
    from graphtrans_tpu_torch.ops.kernels import (SrcOrder, spmm, spmm_bwd,
                                                  spmm_bwd_plain, spmm_plain)

    x, emb, src, dst, emask, w = a
    order = SrcOrder(src, emask, x.shape[0])
    f_err = b_err = 0.0
    for message in ("relu_add", "add"):
        g = torch.randn(x.shape, generator=gen).to(x.device, BF16)
        got = spmm(*a, message)
        grads = spmm_bwd(x, emb, src, dst, emask, g, order, w, message)
        torch.cuda.synchronize()
        if got.dtype != BF16 or any(t.dtype != BF16 for t in grads):
            raise AssertionError("K7 bf16: outputs are not bf16")
        if grads[1][~emask].any():
            raise AssertionError("K7-bwd bf16: masked edges' d_emb rows are "
                                 "not zero")
        f_err = max(f_err, _rel_err(got, spmm_plain(*a, message)))
        b_err = max(b_err, *(_rel_err(t, r) for t, r in zip(
            grads, spmm_bwd_plain(x, emb, src, dst, emask, g, w, message))))
    if f_err > BF16_OUT_TOL or b_err > BF16_GRAD_TOL:
        raise AssertionError(f"K7 bf16 against its plain version: forward "
                             f"{f_err} (<= {BF16_OUT_TOL}), backward {b_err} "
                             f"(<= {BF16_GRAD_TOL})")
    return f_err, b_err


def k3_bf16_bwd_bound(qkv, seg, nhead: int):
    """K3-bwd's bf16 instance reads what K2-bwd's does (k2_bf16_bwd_bound)
    and the forward's out (delta = dO . O, as the JAX kernel forms it)."""
    R, W, d3 = qkv.shape
    hd = d3 // 3 // nhead
    pairs = _seg_pairs(seg, nhead)
    nbytes = (2 * qkv.numel() * 2 + seg.numel() * 4
              + 2 * R * W * (d3 // 3) * 2 + 2 * R * W * nhead * 4)
    return _tc_bound(nbytes, pairs * 10 * hd, pairs * 8, BF16_TC_FLOPS)


def long16_residency(mod, entry: str, smem: int, which=None) -> dict:
    """The residency of a bf16 long kernel from its C entry ``entry`` in
    the library of kernel module ``mod`` (the forwards' training instance;
    the pairs' kernel ``which``: 0 dq and 1 dk/dv with dropout, 2 and 3
    without): registers and local (spilled) bytes a thread and blocks an
    SM at ``smem`` shared bytes a block. Raises if it spills."""
    import ctypes

    from graphtrans_tpu_torch.ops.kernels import _build

    lib = mod._load()
    fn = getattr(lib, entry)
    lead = [] if which is None else [int(which)]
    fn.argtypes = [ctypes.c_int] * (len(lead) + 1) + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    got = [ctypes.c_int(0) for _ in range(3)]
    _build.check(lib, fn(*lead, smem, *(ctypes.cast(ctypes.pointer(v),
                                                    ctypes.c_void_p)
                                        for v in got)), entry)
    r = dict(zip(("regs", "local_bytes", "blocks_per_sm"),
                 (v.value for v in got)), smem=smem)
    if r["local_bytes"]:
        raise AssertionError(f"{entry}({which}): {r['local_bytes']} local "
                             f"bytes a thread (spills)")
    return r


def long_f32_bits(device, gen, base, checked: list):
    """Under ``--baseline``: the f32 long launches of K5 (code2's rows of
    1001: a key prefix and the CLS key) and K9 (its long instance at S
    1001), forward and backward at the training rate, give the parent's
    bits on the same inputs."""
    from graphtrans_tpu_torch.ops.kernels import (attention_smalls_bwd,
                                                  flash_attention_bwd,
                                                  key_padding_segs)
    from graphtrans_tpu_torch.ops.kernels.attention_smalls import (
        attention_smalls_with_stats)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    B, S, d, H, seed = 16, 1001, 256, 4, 97531
    n = torch.randint(1, S - 1, (B,), generator=gen)
    valid = torch.arange(S)[None, :] < n[:, None]
    valid[:, -1] = True
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(device)
    g = torch.randn(B, S, d, generator=gen).to(device)
    valid = valid.to(device)
    segs = key_padding_segs(valid)
    old5, old9 = base["flash_attention"], base["attention_smalls"]
    s5 = flash_attention_with_stats(qkv, *segs, H, DROPOUT, seed)
    same_bits("K5 f32 training forward S=1001",
              lambda: flash_attention_with_stats(qkv, *segs, H, DROPOUT, seed),
              lambda: old5.flash_attention_with_stats(qkv, *segs, H, DROPOUT,
                                                      seed), checked)
    same_bits("K5-bwd f32 S=1001",
              lambda: flash_attention_bwd(qkv, *segs, H, g, DROPOUT, seed,
                                          saved=s5),
              lambda: old5.flash_attention_bwd(qkv, *segs, H, g, DROPOUT,
                                               seed, saved=s5), checked)
    s9 = attention_smalls_with_stats(qkv, valid, H, 0, DROPOUT, seed)
    same_bits("K9 f32 long training forward S=1001",
              lambda: attention_smalls_with_stats(qkv, valid, H, 0, DROPOUT,
                                                  seed),
              lambda: old9.attention_smalls_with_stats(qkv, valid, H, 0,
                                                       DROPOUT, seed), checked)
    same_bits("K9-bwd f32 long S=1001",
              lambda: attention_smalls_bwd(qkv, valid, H, g, 0, DROPOUT, seed,
                                           saved=s9),
              lambda: old9.attention_smalls_bwd(qkv, valid, H, g, 0, DROPOUT,
                                                seed, saved=s9), checked)


def phase15_kernels(device, d_gnn: int, d_model: int, nhead: int, bench,
                    base=None):
    """(a) K2's long instance (the code2 tier of 384), K3, K7 and their
    backwards in bf16 against their plain bf16 versions at the code2
    snapshot's first train batch of 16 (tiers 1024, 384, 128) and at
    bench512; timed as the bf16 step calls them (the attention at the
    training rate, K7 with the batch's orders) beside the f32 instance in
    turns, bound (bf16 bytes, or products on the bf16 tensor cores), plain
    bf16 version and, for K2's long instance and K3, SDPA in bf16 with the
    bool segment mask. With ``base`` the f32 long launches of K2, K3, K5
    and K9 and the f32 K7 and K7-bwd give the parent's bits."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.ops.kernels import (
        DstOrder, SrcOrder, attention_seg, attention_seg_bwd,
        attention_seg_bwd_plain, attention_seg_plain, flash_hil_seg,
        flash_hil_seg_bwd, flash_hil_seg_bwd_plain, flash_hil_seg_plain,
        spmm, spmm_bwd, spmm_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_seg_with_stats)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    from graphtrans_tpu_torch.ops.kernels import attention_packed, flash_hil

    gen = torch.Generator().manual_seed(SEED + 15)
    # the bf16 long kernels' residency entries: the forward's, the pair's
    resid16 = {"k2": (attention_packed, True,
                      "attention_seg_fwd_long_bf16_residency",
                      "attention_seg_bwd_long_bf16_residency"),
               "k3": (flash_hil, False, "flash_hil_fwd_bf16_residency",
                      "flash_hil_bwd_bf16_residency")}
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    smi = _smi()
    args = _code2_args()
    splits, num_tasks, _ = predict.load_splits(args)
    train16 = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks, split="train")))
    errs = dict.fromkeys(("k2", "k2b", "k3", "k3b", "k7", "k7b"), 0.0)
    checked, rows = [], None
    for name, b in (("train16", train16), (f"bench{CODE2_BENCH}", bench)):
        q2, s2 = k2_tier_inputs(b, "pack2", d_model, gen, device)
        q3, s3 = k3_inputs(b, d_model, gen, device)
        a7 = k7_inputs(b, d_gnn, gen, device)
        h2, h3, h7 = q2.to(BF16), q3.to(BF16), _k7_bf16(a7)
        got = {}
        got["k2"], got["k2b"] = check_attn_bf16(
            "K2 long", attention_seg_with_stats, attention_seg_bwd,
            attention_seg_plain, attention_seg_bwd_plain, h2, s2, nhead, gen,
            attention_seg)
        got["k3"], got["k3b"] = check_attn_bf16(
            "K3", flash_hil_seg_with_stats, flash_hil_seg_bwd,
            flash_hil_seg_plain, flash_hil_seg_bwd_plain, h3, s3, nhead, gen,
            flash_hil_seg)
        got["k7"], got["k7b"] = check_k7_bf16(h7, gen)
        for k, v in got.items():
            errs[k] = max(errs[k], v)
        print(f"[15a] {name}: K2 long bf16 {got['k2']:.3g}, K2-bwd long bf16 "
              f"{got['k2b']:.3g}, K3 bf16 {got['k3']:.3g}, K3-bwd bf16 "
              f"{got['k3b']:.3g}, K7 bf16 {got['k7']:.3g}, K7-bwd bf16 "
              f"{got['k7b']:.3g} of max(1, max|plain bf16|)")

        seed = 13572468
        timed = {}
        for key, (q, sg, fwd, bwd, plain, dkind) in {
                "k2": (q2, s2, attention_seg_with_stats, attention_seg_bwd,
                       attention_seg_plain, "attention_packed"),
                "k3": (q3, s3, flash_hil_seg_with_stats, flash_hil_seg_bwd,
                       flash_hil_seg_plain, "flash_hil")}.items():
            q16 = q.to(BF16)
            R, W, d3 = q.shape
            g16 = torch.randn(R, W, d3 // 3, generator=gen).to(device, BF16)
            g32 = g16.float()
            f = dict(plain_ms=time_ms(lambda: plain(q16, sg, nhead, DROPOUT,
                                                    seed), iters=3),
                     library_ms=sdpa_ms(q16, sg, nhead, queued_ms))
            old = base[dkind] if base else None
            ofwd = getattr(old, fwd.__name__) if old else None
            # in turns: this forward, the f32 instance and the parent's
            # bf16 forward (--baseline), each call queued behind a sleep
            # (at the batch of 16 the host takes longer to make a call than
            # the card to run it); back to back, as the host makes them,
            # beside
            fns = [lambda: fwd(q16, sg, nhead, DROPOUT, seed),
                   lambda: fwd(q, sg, nhead, DROPOUT, seed),
                   ofwd and (lambda: ofwd(q16, sg, nhead, DROPOUT, seed))]
            f["ms"], f["f32_ms"], f["parent_ms"] = rounds_ms(fns, 20,
                                                             queued_ms)
            f["paced_ms"] = time_ms(fns[0], iters=20)
            f["bound_ms"], f["bound_by"] = k2_bf16_bound(q16, sg, nhead)
            s16 = fwd(q16, sg, nhead, DROPOUT, seed)
            s32 = fwd(q, sg, nhead, DROPOUT, seed)
            mod, norm, entry, bwd_entry = resid16[key]
            f["residency"] = long16_residency(
                mod, entry, attention_packed.long16_fwd_bytes(W, norm))
            f["grid"] = (flash_hil.fwd_geometry(R, W, nhead, BF16) if key ==
                         "k3" else attention_packed.seg_bf16_geometry(
                             R, W, nhead, False)).grid
            if ofwd:
                # the largest difference of the training launch's output from
                # the parent's (K3's p follows the chunk starts)
                f["parent_diff"] = _rel_err(
                    s16[0], ofwd(q16, sg, nhead, DROPOUT, seed)[0])
            bw = dict(plain_ms=_plain_bwd_ms(
                lambda t: plain(t, sg, nhead, DROPOUT, seed), [q16], g16),
                library_ms=sdpa_bwd_ms(q16, sg, nhead, g16, DROPOUT,
                                       queued_ms))
            obwd = getattr(old, bwd.__name__) if old else None
            # in turns, each call queued behind a sleep: this pair, the f32
            # instance and the parent's bf16 pair (--baseline) on this
            # forward's out, m and l
            bw["ms"], bw["f32_ms"], bw["parent_ms"] = rounds_ms([
                lambda: bwd(q16, sg, nhead, g16, s16, DROPOUT, seed),
                lambda: bwd(q, sg, nhead, g32, s32, DROPOUT, seed),
                obwd and (lambda: obwd(q16, sg, nhead, g16, s16, DROPOUT,
                                       seed))], 20, queued_ms)
            bw["bound_ms"], bw["bound_by"] = (
                k2_bf16_bwd_bound if key == "k2" else k3_bf16_bwd_bound)(
                    q16, sg, nhead)
            # the pair's two kernels: the training instances' residency
            # (dq, dk/dv), and no spills in the instances without dropout
            bsmem = attention_packed.long16_bwd_bytes(W, norm)
            bw["residency"] = [long16_residency(mod, bwd_entry, bsmem, k)
                               for k in (0, 1)]
            for k in (2, 3):
                long16_residency(mod, bwd_entry, bsmem, k)
            bw["grid"] = (flash_hil.bwd_geometry(R, W, nhead) if key == "k3"
                          else attention_packed.seg_bf16_geometry(
                              R, W, nhead, True)).grid
            if base:
                same_bits(f"{key.upper()} f32 training forward {name}",
                          lambda: fwd(q, sg, nhead, DROPOUT, seed),
                          lambda: ofwd(q, sg, nhead, DROPOUT, seed), checked)
                same_bits(f"{key.upper()}-bwd f32 {name}",
                          lambda: bwd(q, sg, nhead, g32, s32, DROPOUT, seed),
                          lambda: obwd(q, sg, nhead, g32, s32, DROPOUT, seed),
                          checked)
                # the bf16 pair's sums follow the runs' chunk starts: its
                # largest difference from the parent's on this forward's
                # out, m and l, held to the plain version's tolerance
                bw["parent_diff"] = _rel_err(
                    bwd(q16, sg, nhead, g16, s16, DROPOUT, seed),
                    obwd(q16, sg, nhead, g16, s16, DROPOUT, seed))
                if bw["parent_diff"] > BF16_GRAD_TOL:
                    raise AssertionError(
                        f"{key.upper()}-bwd bf16 {name}: {bw['parent_diff']} "
                        f"of max(1, max|parent|) from the parent's (<= "
                        f"{BF16_GRAD_TOL})")
            shape = f"R={R} W={W} d={d3 // 3} H={nhead} rate={DROPOUT}"
            f["shape"] = bw["shape"] = shape
            timed[key], timed[key + "b"] = f, bw

        N = a7[0].shape[0]
        dst_rows = DstOrder(a7[3], a7[4], N)
        src_rows = SrcOrder(a7[2], a7[4], N)
        dst_rows.runs(), src_rows.runs()         # once per batch, not timed
        g7 = torch.randn(a7[0].shape, generator=gen).to(device, BF16)
        k7 = dict(plain_ms=time_ms(lambda: spmm_plain(*h7), iters=5),
                  library_ms=None)
        k7["ms"], k7["f32_ms"] = rounds_ms([
            lambda: spmm(*h7, rows=dst_rows),
            lambda: spmm(*a7, rows=dst_rows)], 20)
        k7["bound_ms"], k7["bound_by"] = k7_bound(h7)
        k7b = dict(plain_ms=_plain_bwd_ms(
            lambda x, e: spmm_plain(x, e, *h7[2:]), list(h7[:2]), g7),
            library_ms=None)
        k7b["ms"], k7b["f32_ms"] = rounds_ms([
            lambda: spmm_bwd(*h7[:5], g7, src_rows, h7[5]),
            lambda: spmm_bwd(*a7[:5], g7.float(), src_rows, a7[5])], 20)
        k7b["bound_ms"], k7b["bound_by"] = k7_bwd_bound(h7)
        if base:
            old = base["spmm"]
            same_bits(f"K7 f32 {name}", lambda: spmm(*a7, rows=dst_rows),
                      lambda: old.spmm(*a7), checked)
            same_bits(f"K7-bwd f32 {name}",
                      lambda: spmm_bwd(*a7[:5], g7.float(), src_rows, a7[5]),
                      lambda: old.spmm_bwd(*a7[:5], g7.float(), src_rows,
                                           a7[5]), checked)
        k7["shape"] = k7b["shape"] = (f"N={N} E={a7[2].shape[0]} valid="
                                      f"{int(a7[4].sum().item())} d={d_gnn}")
        timed["k7"], timed["k7b"] = k7, k7b
        for key, kname in (("k2", "K2 attention_seg, long instance"),
                           ("k2b", "K2-bwd attention_seg_bwd, long instance"),
                           ("k3", "K3 flash_hil_seg"),
                           ("k3b", "K3-bwd flash_hil_seg_bwd"),
                           ("k7", "K7 spmm (the batch's DstOrder)"),
                           ("k7b", "K7-bwd spmm_bwd (the batch's SrcOrder)")):
            t = timed[key]
            lib = ("-" if t["library_ms"] is None else
                   f"{t['library_ms']:.4f} ms (SDPA in bf16, bool seg mask"
                   f"{', backward' if key.endswith('b') else ''})")
            parent = ("" if t.get("parent_ms") is None else
                      f", the parent's bf16 "
                      f"{'pair' if key.endswith('b') else 'forward'} "
                      f"{t['parent_ms']:.4f}")
            queued = ("" if key == "k7" or key == "k7b" else
                      ", each call queued, cold L2")
            paced = ("" if t.get("paced_ms") is None else
                     f"; back to back, as the host makes the calls, "
                     f"{t['paced_ms']:.4f} ms a call")
            print(f"[15a] {name} {kname} bf16 [{t['shape']}]: kernel "
                  f"{t['ms']:.4f} ms (the f32 instance {t['f32_ms']:.4f}"
                  f"{parent}, in turns{queued}{paced}), plain bf16 "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}), library {lib} on {smi}")
            res = t.get("residency")
            for part, r in ([] if res is None else
                            zip(("dq kernel", "dk/dv kernel"), res)
                            if isinstance(res, list) else [("", res)]):
                blocks = math.prod(t["grid"])
                waves = blocks / (r["blocks_per_sm"] * n_sms)
                print(f"[15a] {name} {kname} bf16{' ' if part else ''}"
                      f"{part} residency (training launch): {r['regs']} "
                      f"registers a thread, {r['local_bytes']} local bytes "
                      f"a thread (no spills), {r['smem']} shared bytes a "
                      f"block, {r['blocks_per_sm']} blocks an SM, {blocks} "
                      f"blocks in {waves:.2f} waves")
            if t.get("parent_diff") is not None:
                print(f"[15a] {name} {kname} bf16: the training launch's "
                      f"output differs from the parent's by at most "
                      f"{t['parent_diff']:.3g} of max(1, max|parent|)")
        rows = timed
    if base:
        long_f32_bits(device, gen, base, checked)
        print(f"[15a] --baseline: the f32 instances give the parent's bits "
              f"on the same inputs at {checked}; the bf16 pairs within "
              f"{BF16_GRAD_TOL} of max(1, max|parent|) of the parent's")
    print(f"[15a] bf16 kernels agree with their plain bf16 versions, of "
          f"max(1, max|plain|): K2 long {errs['k2']:.3g}, K3 {errs['k3']:.3g}, "
          f"K7 {errs['k7']:.3g} (<= {BF16_OUT_TOL}); K2-bwd long "
          f"{errs['k2b']:.3g}, K3-bwd {errs['k3b']:.3g}, K7-bwd "
          f"{errs['k7b']:.3g} (<= {BF16_GRAD_TOL}); padding tokens and masked "
          f"edges' d_emb rows exactly 0")
    return dict(errs=errs, timed=rows)


def _code2_bf16_want(steps: int) -> dict:
    """The code2 bf16 step's launches by instance, every one bf16: a train
    batch packs into three tiers (1024, 384, 128), so the 4 encoder layers
    run K3 on one, K2's long instance on one and its tile instance on one,
    and the 5 GCN layers run K7; each with its backward."""
    k2 = {"tile": 0, "long": 0, "tile_bf16": 4 * steps,
          "long_bf16": 4 * steps}
    return {"attention_seg": k2, "attention_seg_bwd": dict(k2),
            "flash_hil_seg": {"f32": 0, "bf16": 4 * steps},
            "flash_hil_seg_bwd": {"f32": 0, "bf16": 4 * steps},
            "spmm": {"f32": 0, "bf16": 5 * steps},
            "spmm_bwd": {"f32": 0, "bf16": 5 * steps}}


def phase15_train(device, tmp: str, bench, bench_tasks: int):
    """(b) The counts set to 0, ``main --precision bf16`` on the code2
    JK=cat yml (batches of 16, TRAIN_EPOCHS epochs) over the snapshot, the
    counts read: every K2, K3 and K7 launch and every backward launch the
    bf16 instance; finite losses, every parameter moved, the saved state
    float32, which ``predict --weights`` serves in float32 (the f32
    instances); (c) one bf16 step through the kernels against the plain
    bf16 versions on the card under deterministic algorithms, at the
    512-graph batch (within BF16_STEP_TOL) and at the snapshot's first
    train batch of 16, beside the plain bf16 step's distance from the f32
    step."""
    import io
    import types

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.ops import kernels

    argv = ["--configs", CODE2_CONFIG, "--data_root", SNAPSHOT, "--epochs",
            str(TRAIN_EPOCHS), "--batch_size", str(CODE2_BATCH), "--seed",
            str(SEED), "--precision", "bf16", "--save_path", tmp]
    counted = (kernels.attention_seg, kernels.attention_seg_bwd,
               kernels.flash_hil_seg, kernels.flash_hil_seg_bwd,
               kernels.spmm, kernels.spmm_bwd)
    out = io.StringIO()
    kernels.reset_launches()                 # the code2 bf16 path
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = train_main.main(argv)
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_inst = {fn.__name__: dict(fn.instances) for fn in counted}
    for line in out.getvalue().splitlines():
        print(f"[15b] main: {line}")
    steps = sum(r["steps"] for r in res["epochs"])
    want = {**dict.fromkeys(launches, 0),
            "attention_seg": 8 * steps, "attention_seg_bwd": 8 * steps,
            "flash_hil_seg": 4 * steps, "flash_hil_seg_bwd": 4 * steps,
            "spmm": 5 * steps, "spmm_bwd": 5 * steps}
    if (steps == 0 or launches != want
            or by_inst != _code2_bf16_want(steps)):
        raise AssertionError(f"code2 bf16 training launches {launches} by "
                             f"instance {by_inst}, expected {want}, "
                             f"{_code2_bf16_want(steps)}")
    print(f"[15b] the code2 bf16 step's launches ({steps} steps): "
          f"{launches}; by instance {by_inst}: K2 8 (4 tile, 4 long), K3 4, "
          f"K7 5 a step, each with its backward, every one the bf16 "
          f"instance")
    if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
        raise AssertionError(f"bf16 epoch losses not finite: {res['epochs']}")
    args = _code2_train_args()
    args.precision = "bf16"
    splits, num_tasks, code = predict.load_splits(args)
    init, _ = _trainer(args, num_tasks, device, data=code)
    trained = torch.load(res["saved"], map_location=device, weights_only=True)
    params = dict(init.named_parameters())
    still = [n for n, p in params.items() if torch.equal(p, trained[n])]
    wrong = [n for n, p in trained.items() if p.dtype != torch.float32
             and p.is_floating_point()]
    if still or wrong:
        raise AssertionError(f"code2 bf16 training: parameters that did not "
                             f"move {still}; state not float32 {wrong}")
    kernels.reset_launches()
    served = predict.main([
        "--configs", CODE2_CONFIG, "--data_root", SNAPSHOT, "--split",
        "test", "--batch_size", str(CODE2_BATCH), "--weights", res["saved"],
        "--out", os.path.join(tmp, "code2_bf16.jsonl")])
    serve_inst = {fn.__name__: dict(fn.instances) for fn in counted[::2]}
    if (any(v.get("bf16", 0) or v.get("tile_bf16", 0) or v.get("long_bf16", 0)
            for v in serve_inst.values())
            or not 0.0 <= served["F1"] <= 1.0):
        raise AssertionError(f"predict on the bf16 run's weights: launches "
                             f"{serve_inst}, F1 {served['F1']}")
    print(f"[15c] trained code2 {TRAIN_EPOCHS} epochs ({steps} bf16 steps of "
          f"<= {CODE2_BATCH} graphs, {secs:.2f} s with the model build) "
          f"through graphtrans_tpu_torch.main --precision bf16: losses "
          f"{[round(r['loss'], 6) for r in res['epochs']]}, all "
          f"{len(params)} parameter tensors moved, the saved state float32; "
          f"predict --weights served its {served['records']} test graphs in "
          f"f32 (launches by instance {serve_inst}), F1 {served['F1']:.4f}")

    layout = predict.serving_layout(splits, args, num_tasks, CODE2_BATCH,
                                    split="train", seed=SEED)
    batch = next(iterate_batches(
        splits["train"], order=shuffled_order(len(splits["train"]), SEED, 0),
        **layout)).to(device)
    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    for name, b, tasks, data in (
            (f"bench{CODE2_BENCH}", bench.to(device), bench_tasks, sizes),
            (f"train{CODE2_BATCH}", batch, num_tasks, code)):
        got = {}
        with deterministic():
            for tag, prec, on in (("kernels", "bf16", True),
                                  ("plain", "bf16", False),
                                  ("f32", "f32", False)):
                args.precision = prec
                model, step = _trainer(args, tasks, device, kernels_on=on,
                                       data=data)
                loss = step(b)
                got[tag] = (loss.item(), loss.dtype,
                            {n: p.grad for n, p in model.named_parameters()})
        args.precision = "bf16"
        (lk, dt, gk), (lp, _, gp), (_, _, gf) = got.values()
        g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
        noise = max(_rel_err(gp[n], gf[n]) for n in gp)
        dtypes = {g.dtype for g in gk.values()} | {dt}
        # at 16 graphs the virtual node's BatchNorm over 16 graph rows
        # makes the bf16 step's gradients noise-sized (the plain bf16 route
        # is up to ~1.5 of max(1, max|ref|) from the f32 step): there the
        # kernels may move them by up to a quarter of that
        g_tol = (BF16_STEP_TOL[1] if name.startswith("bench")
                 else max(BF16_STEP_TOL[1], noise / 4))
        if (abs(lk - lp) > BF16_STEP_TOL[0] * max(1.0, abs(lp))
                or g_err > g_tol or dtypes != {torch.float32}):
            raise AssertionError(f"code2 bf16 step through the kernels at "
                                 f"{name}: loss {lk} vs {lp}, gradients "
                                 f"{g_err} (<= {g_tol}), dtypes {dtypes}")
        print(f"[15c] one code2 bf16 step at {name} (W={b.pack_w}/"
              f"{b.pack2_w}/{b.pack3_w}, attention dropout "
              f"{args.transformer_dropout}, same seeds, deterministic "
              f"algorithms) through the kernels vs the plain bf16 versions "
              f"on the card: loss {lk:.6f} vs {lp:.6f} (|diff| "
              f"{abs(lk - lp):.3g} <= {BF16_STEP_TOL[0]} of max(1, |ref|)), "
              f"gradients {g_err:.3g} of max(1, max|ref|) (<= {g_tol:.3g}); "
              f"the plain bf16 step's gradients {noise:.3g} from the f32 "
              f"step's; loss and gradients float32")
    return launches, by_inst


@contextlib.contextmanager
def parent_forwards(base):
    """The bf16 step with the parent's K2 and K3 forward kernels: this
    tree's forward entries (``attention_seg_with_stats``,
    ``flash_hil_seg_with_stats``, which the wrappers call) replaced by the
    parent's for the duration; the backward kernels stay this tree's."""
    from graphtrans_tpu_torch.ops.kernels import attention_packed, flash_hil

    saved = (attention_packed.attention_seg_with_stats,
             flash_hil.flash_hil_seg_with_stats)
    attention_packed.attention_seg_with_stats = (
        base["attention_packed"].attention_seg_with_stats)
    flash_hil.flash_hil_seg_with_stats = (
        base["flash_hil"].flash_hil_seg_with_stats)
    try:
        yield
    finally:
        (attention_packed.attention_seg_with_stats,
         flash_hil.flash_hil_seg_with_stats) = saved


def phase15_cost(device, bench, num_tasks: int, smi: str, base=None):
    """(d) The code2 train step on the 512-graph batch in f32 and in bf16
    in turns (f32, bf16, bf16, f32; with ``base`` f32, the parent, bf16,
    bf16, the parent, f32, "the parent" being the bf16 step on the parent's
    K2 and K3 forward kernels): median ms, peak memory; then each profiled:
    idle share, device time by layer, and the K2 and K3 forwards' share."""
    import types

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    tb = bench.to(device)
    n = int(bench.graph_mask.sum())
    order = (("f32", "parent", "bf16", "bf16", "parent", "f32") if base
             else ("f32", "bf16", "bf16", "f32"))
    runs, profiled = collections.defaultdict(list), set()
    for what in order:
        args = _code2_train_args()
        args.precision = "f32" if what == "f32" else "bf16"
        model, step = _trainer(args, num_tasks, device, data=sizes)
        with (parent_forwards(base) if what == "parent"
              else contextlib.nullcontext()):
            _median_ms(lambda: step(tb), 3)                     # warm-up
            torch.cuda.reset_peak_memory_stats(device)
            ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            if not torch.isfinite(loss):
                raise AssertionError(f"code2 512-graph {what} step: loss not "
                                     f"finite")
            runs[what].append(ms)
            label = ("bf16 (the parent's K2, K3 forwards)" if what == "parent"
                     else what)
            print(f"[15d] code2 {label} train step of {n} graphs: median "
                  f"{ms:.3f} ms over {TIMED_STEPS} (min {lo:.3f}, max "
                  f"{hi:.3f}), {n / ms * 1e3:.0f} graphs/s, peak memory "
                  f"{peak:.2f} GiB on {smi}")
            if what not in profiled:
                profiled.add(what)
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    for _ in range(PROFILED_STEPS):
                        step(tb)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
                busy, by_layer = _print_split("[15d]", f"code2 {label} train "
                                              f"step", prof, PROFILED_STEPS,
                                              wall, smi, graphs=n)
                print(f"[15d] code2 {label} train step: K2 forward "
                      f"{by_layer['K2 attention_seg']:.3f} ms "
                      f"({by_layer['K2 attention_seg'] / busy:.1%} of busy), "
                      f"K3 forward {by_layer['K3 flash_hil_seg']:.3f} ms "
                      f"({by_layer['K3 flash_hil_seg'] / busy:.1%})")
        del model, step
        torch.cuda.empty_cache()
    f32, bf = statistics.mean(runs["f32"]), statistics.mean(runs["bf16"])
    print(f"[15d] code2 train{CODE2_BENCH}: bf16 {bf:.3f} ms against f32 "
          f"{f32:.3f} ms in turns ({f32 / bf:.3f}x) on {smi}")
    if base:
        par = statistics.mean(runs["parent"])
        print(f"[15d] code2 train{CODE2_BENCH} bf16: {bf:.3f} ms against "
              f"{par:.3f} ms on the parent's K2 and K3 forwards in turns "
              f"({par / bf:.3f}x) on {smi}")


# ---- phase 16: bf16 training of the Transformer-only model ------------------


def list16_bound(qkv, valid, nhead: int, block: int, mask_bytes: int,
                 bwd: bool, reads_out: bool = False):
    """A bf16 key-list launch (K4's and K5's bf16 instances): the forward
    reads q for every query, K and V for the valid keys and the mask, and
    writes out (bf16), m and l; the backward reads q and dO for every query,
    K and V for the valid keys, m, l, the mask and (K5: delta = dO . O,
    ``reads_out``) the forward's out, and writes dqkv. Per (query, key)
    pair of a block and head the products (forward 4 hd flops, backward 10
    hd) on the bf16 tensor cores, as the kernels run them, and the softmax
    (4; backward 8) on the f32 units."""
    B, S, d3 = qkv.shape
    d, hd = d3 // 3, d3 // 3 // nhead
    keys = int(valid.sum().item())
    pairs = (int((valid.reshape(B, S // block, block).sum(-1) * block).sum()
                 .item()) if block else keys * S) * nhead
    stats = 2 * B * S * nhead * 4
    if not bwd:
        nbytes = (2 * B * S + 2 * keys) * d * 2 + mask_bytes + stats
        return _tc_bound(nbytes, pairs * 4 * hd, pairs * 4, BF16_TC_FLOPS)
    nbytes = ((2 * B * S + 2 * keys) * d + B * S * d3
              + (B * S * d if reads_out else 0)) * 2 + mask_bytes + stats
    return _tc_bound(nbytes, pairs * 10 * hd, pairs * 8, BF16_TC_FLOPS)


def check_list16(name: str, fwd, bwd, plain, bwd_plain, qkv, masks, live,
                 valid, nhead: int, gen, rows: int):
    """A bf16 key-list pair (K4's or K5's bf16 instance) at rate 0 and the
    training rate against its plain bf16 version (the same masks) on the
    first ``rows`` rows: relative errors (forward, backward); outputs bf16;
    queries without a key exactly 0 with m = -inf and l = 0, padding keys'
    dk and dv exactly 0; at rate 0 the serving launch's bits."""
    d = qkv.shape[-1] // 3
    f_err = b_err = 0.0
    for rate, seed in ((0.0, 0), (DROPOUT, 24681357)):
        out, m, l = fwd(qkv, *masks, nhead, rate, seed)
        g = torch.randn(out.shape, generator=gen).to(qkv.device, BF16)
        dqkv = bwd(qkv, *masks, nhead, g, rate, seed, (out, m, l))
        same = rate > 0 or torch.equal(
            fwd(qkv, *masks, nhead, rate, seed, stats=False)[0], out)
        torch.cuda.synchronize()
        if out.dtype != BF16 or dqkv.dtype != BF16:
            raise AssertionError(f"{name} bf16: outputs are not bf16")
        if (out[~live].any() or dqkv[~live].any()
                or dqkv[..., d:][~valid].any() or not same
                or not (m[~live] == -math.inf).all() or l[~live].any()):
            raise AssertionError(f"{name} bf16: a query without a key or a "
                                 f"padding key not 0 (or m not -inf, l not "
                                 f"0), or the serving launch differs from "
                                 f"the training one")
        head = [t[:rows] for t in (qkv, *masks)]
        f_err = max(f_err, _rel_err(out[:rows],
                                    plain(*head, nhead, rate, seed)))
        b_err = max(b_err, _rel_err(dqkv[:rows], bwd_plain(
            *head, nhead, g[:rows], rate, seed)))
    if f_err > BF16_OUT_TOL or b_err > BF16_GRAD_TOL:
        raise AssertionError(f"{name} bf16 against its plain version: "
                             f"forward {f_err} (<= {BF16_OUT_TOL}), backward "
                             f"{b_err} (<= {BF16_GRAD_TOL})")
    return f_err, b_err


def k2_k3_bf16_bits(device, big, bench, d_model: int, nhead: int, base,
                    gen, checked: list):
    """Under ``--baseline``: K2's bf16 instances (tile at bench4096, long on
    code2's tier of 384) and K3's, heads of 32, forward and backward at the
    training rate, give the parent's bits on the same inputs."""
    from graphtrans_tpu_torch.ops.kernels import (attention_seg_bwd,
                                                  flash_hil_seg_bwd)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_seg_with_stats)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    seed = 97531
    q2t, s2t = k2_inputs(big, d_model, gen, device)
    q2l, s2l = k2_tier_inputs(bench, "pack2", d_model, gen, device)
    q3, s3 = k3_inputs(bench, d_model, gen, device)
    for what, q, sg, fwd, bwd, mod in (
            ("K2 bf16 tile bench4096", q2t, s2t, attention_seg_with_stats,
             attention_seg_bwd, base["attention_packed"]),
            ("K2 bf16 long bench512", q2l, s2l, attention_seg_with_stats,
             attention_seg_bwd, base["attention_packed"]),
            ("K3 bf16 bench512", q3, s3, flash_hil_seg_with_stats,
             flash_hil_seg_bwd, base["flash_hil"])):
        q16 = q.to(BF16)
        g = torch.randn(*q.shape[:2], q.shape[2] // 3,
                        generator=gen).to(device, BF16)
        ofwd, obwd = getattr(mod, fwd.__name__), getattr(mod, bwd.__name__)
        saved = fwd(q16, sg, nhead, DROPOUT, seed)
        same_bits(f"{what} forward",
                  lambda: fwd(q16, sg, nhead, DROPOUT, seed),
                  lambda: ofwd(q16, sg, nhead, DROPOUT, seed), checked)
        same_bits(f"{what} backward",
                  lambda: bwd(q16, sg, nhead, g, saved, DROPOUT, seed),
                  lambda: obwd(q16, sg, nhead, g, saved, DROPOUT, seed),
                  checked)


def phase16_kernels(device, mol_flat, code2_flat, big, bench, base=None):
    """(a) K4's bf16 instances (tile at bench4096's packed rows of 3 x 33,
    long at code2's rows cut to 383) and K5's (bench512's rows of 1001),
    forward and backward, at rate 0 and the training rate against their
    plain bf16 versions at heads of 64 (the published width); each timed
    as the bf16 step calls it (the training rate, statistics), a call at a
    time behind a sleep with a cold L2 (``queued_ms``), in turns with the
    f32 instance and with SDPA in bf16 under the same bool mask (forward,
    and backward at the same rate), beside bound (bytes, or products on
    the bf16 tensor cores) and plain version; each kernel's residency
    (registers, local bytes, shared bytes, blocks an SM, waves; it fails
    on spills). With ``base`` K2's and K3's bf16 instances at heads of 32
    give the parent's bits."""
    from graphtrans_tpu_torch.ops.kernels import (
        attention_dense_bwd, attention_dense_bwd_plain,
        attention_dense_plain, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain, key_padding_segs)
    from graphtrans_tpu_torch.ops.kernels import attention_packed
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_dense_with_stats, list16_geometry)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    # the module (the package exports its wrapper under the same name)
    flash_mod = sys.modules[flash_attention_with_stats.__module__]

    gen = torch.Generator().manual_seed(SEED + 16)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    smi = _smi()
    d, nhead = _tf_args(TF_MOL_CONFIG).d_model, _tf_args(TF_MOL_CONFIG).nhead
    seed = 2**31 - 13
    errs = dict.fromkeys(("k4", "k4b", "k5", "k5b"), 0.0)
    timed = {}
    cases = (("K4 tile", "bench4096 block 33", dense_valid(mol_flat)),
             ("K4 long", "bench512 cut to 383, block 0",
              dense_valid(code2_flat, 383)),
             ("K5", "bench512 S 1001", dense_valid(code2_flat)))
    for kname, name, valid in cases:
        if kname == "K5":
            qkv, v = k5_inputs(valid, d, gen, device)
            block, masks = 0, key_padding_segs(v)
            live, mod, key = _live(v, 0), flash_mod, "k5"
            fwd, bwd = flash_attention_with_stats, flash_attention_bwd
            plain, bwd_plain = (flash_attention_plain,
                                flash_attention_bwd_plain)
            mask_bytes = 2 * v.numel() * 4
            entry, rows = "flash_attention_bf16_residency", 64
        else:
            qkv, v, block = k4_inputs(valid, d, gen, device)
            masks, live = (v,), _live(v, block)
            mod, key = attention_packed, "k4"
            fwd = lambda q, vv, H, r, s, stats=True, block=block: (
                attention_dense_with_stats(q, vv, H, block, r, s, stats))
            bwd = lambda q, vv, H, g, r, s, saved, block=block: (
                attention_dense_bwd(q, vv, H, g, block, r, s, saved))
            plain = lambda q, vv, H, r, s, block=block: (
                attention_dense_plain(q, vv, H, block, r, s))
            bwd_plain = lambda q, vv, H, g, r, s, block=block: (
                attention_dense_bwd_plain(q, vv, H, g, block, r, s))
            mask_bytes = v.numel()
            entry, rows = "attention_dense_bf16_residency", 256
        q16 = qkv.to(BF16)
        f, e = check_list16(kname, fwd, bwd, plain, bwd_plain, q16, masks,
                            live, v, nhead, gen, rows)
        errs[key], errs[key + "b"] = max(errs[key], f), max(errs[key + "b"], e)
        print(f"[16a] {name} {kname} bf16 {f:.3g}, backward bf16 {e:.3g} of "
              f"max(1, max|plain bf16|) (rates 0 and {DROPOUT}, the first "
              f"{min(rows, len(qkv))} of {len(qkv)} rows against the plain "
              f"version)")
        if kname == "K5":                 # timed as the model runs
            q16, qkv, v = q16[:-1].contiguous(), qkv[:-1].contiguous(), v[:-1]
            masks = key_padding_segs(v)
        B, S, d3 = qkv.shape
        g16 = torch.randn(B, S, d, generator=gen).to(device, BF16)
        g32 = g16.float()
        s16 = fwd(q16, *masks, nhead, DROPOUT, seed)
        s32 = fwd(qkv, *masks, nhead, DROPOUT, seed)
        mask4 = _block_mask(v, block)
        f = dict(plain_ms=sum(time_ms(lambda r0=r0: plain(
            q16[r0:r0 + rows], *(m[r0:r0 + rows] for m in masks), nhead,
            DROPOUT, seed), iters=1, reps=3) for r0 in range(0, B, rows)),
                 library_ms=sdpa_mask_ms(q16, mask4, nhead, timer=queued_ms))
        f["ms"], f["f32_ms"] = rounds_ms([
            lambda: fwd(q16, *masks, nhead, DROPOUT, seed),
            lambda: fwd(qkv, *masks, nhead, DROPOUT, seed)], 20, queued_ms)
        f["bound_ms"], f["bound_by"] = list16_bound(q16, v, nhead, block,
                                                    mask_bytes, False)
        bw = dict(plain_ms=_chunked_plain_bwd_ms(
            lambda t, r0: plain(t, *(m[r0:r0 + rows] for m in masks), nhead,
                                DROPOUT, seed), q16, g16, rows),
            library_ms=sdpa_bwd_mask_ms(q16, mask4, nhead, g16, DROPOUT,
                                        iters=10, timer=queued_ms))
        bw["ms"], bw["f32_ms"] = rounds_ms([
            lambda: bwd(q16, *masks, nhead, g16, DROPOUT, seed, s16),
            lambda: bwd(qkv, *masks, nhead, g32, DROPOUT, seed, s32)], 20,
            queued_ms)
        bw["bound_ms"], bw["bound_by"] = list16_bound(
            q16, v, nhead, block, mask_bytes, True, reads_out=kname == "K5")
        geo = list16_geometry(B, S, block, nhead, False)
        f["residency"] = [long16_residency(
            mod, entry, attention_packed.list16_bytes(False), 0)]
        bgeo = list16_geometry(B, S, block, nhead, True)
        bw["residency"] = [long16_residency(
            mod, entry, attention_packed.list16_bytes(True), k)
            for k in ((3,) if bgeo.instance == "short" else (1, 2))]
        f["grid"], bw["grid"] = geo.grid, bgeo.grid
        f["instance"], bw["instance"] = geo.instance, bgeo.instance
        shape = (f"B={B} S={S} d={d} H={nhead} rate={DROPOUT} valid keys "
                 f"{int(v.sum().item())}")
        f["shape"] = bw["shape"] = shape
        timed[kname], timed[kname + "-bwd"] = f, bw
        del qkv, q16, s16, s32, g16, g32
        torch.cuda.empty_cache()
    for kname, t in timed.items():
        part = "backward" if kname.endswith("-bwd") else "forward"
        print(f"[16a] {kname} bf16 {part} ({t['instance']}_bf16) "
              f"[{t['shape']}]: kernel {t['ms']:.4f} ms (the f32 instance "
              f"{t['f32_ms']:.4f}, in turns, each call queued, cold L2), "
              f"plain bf16 {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library "
              f"{t['library_ms']:.4f} ms (SDPA in bf16, bool mask"
              f"{', backward, dropout ' + str(DROPOUT) if part == 'backward' else ''}"
              f", queued) on {smi}")
        names = (("forward",) if part == "forward" else ("one kernel",)
                 if t["instance"] == "short" else ("dq kernel",
                                                   "dk/dv kernel"))
        for part_name, r in zip(names, t["residency"]):
            blocks = math.prod(t["grid"])
            waves = blocks / (r["blocks_per_sm"] * n_sms)
            print(f"[16a] {kname} bf16 {part_name} residency (training "
                  f"launch): {r['regs']} registers a thread, "
                  f"{r['local_bytes']} local bytes a thread (no spills), "
                  f"{r['smem']} shared bytes a block, {r['blocks_per_sm']} "
                  f"blocks an SM, {blocks} blocks in {waves:.2f} waves")
    print(f"[16a] bf16 kernels agree with their plain bf16 versions, of "
          f"max(1, max|plain|): K4 {errs['k4']:.3g}, K5 {errs['k5']:.3g} "
          f"(<= {BF16_OUT_TOL}); K4-bwd {errs['k4b']:.3g}, K5-bwd "
          f"{errs['k5b']:.3g} (<= {BF16_GRAD_TOL}); queries without a key "
          f"and padding keys exactly 0")
    if base:
        checked = []
        k2_k3_bf16_bits(device, big, bench, _args().d_model, _args().nhead,
                        base, gen, checked)
        print(f"[16a] --baseline: K2's and K3's bf16 instances (heads of 32) "
              f"give the parent's bits on the same inputs at {checked}")
    return dict(errs=errs, timed=timed)


def _tf_bf16_want(layers: int, steps: int, kernels: tuple) -> dict:
    """The Transformer-only bf16 step's launches by instance: ``layers``
    launches a step of each wrapper in ``kernels`` (K4's tile instance, or
    K5), every one bf16."""
    want = {"attention_dense": {"tile": 0, "long": 0, "tile_bf16": 0,
                                "long_bf16": 0},
            "attention_dense_bwd": {"short": 0, "wide": 0, "short_bf16": 0,
                                    "long_bf16": 0},
            "flash_attention": {"f32": 0, "bf16": 0},
            "flash_attention_bwd": {"f32": 0, "bf16": 0}}
    for name, inst in kernels:
        want[name][inst] = layers * steps
    return want


# the wrappers and instances each yml's bf16 step must launch (phase 16b):
# molpcba's train rows of 48 + CLS pack 2 graphs (K4's tile instance, its
# backward's short one), code2's rows of 1000 + CLS take K5
TF_BF16_KERNELS = {
    TF_MOL_CONFIG: (("attention_dense", "tile_bf16"),
                    ("attention_dense_bwd", "short_bf16")),
    TF_CODE2_CONFIG: (("flash_attention", "bf16"),
                      ("flash_attention_bwd", "bf16"))}


def phase16_train(device, tmp: str):
    """(b) Both Transformer-only ymls through ``main --precision bf16`` at
    full width on the snapshot (TRAIN_EPOCHS epochs, the ymls' batch
    sizes), the counts set to 0 before each and read after: every K4, K4-bwd,
    K5 and K5-bwd launch by instance, each the bf16 one, and the attention
    routes the encoder took (``attention_route``, by layer call); finite
    losses, every parameter moved, the saved state float32; then one bf16
    step through the kernels against the plain bf16 versions under
    deterministic algorithms at each yml's first train batch."""
    import io

    from graphtrans_tpu_torch import main as train_main
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches, shuffled_order
    from graphtrans_tpu_torch.nn import transformer as ttr
    from graphtrans_tpu_torch.ops import kernels

    counted = (kernels.attention_dense, kernels.attention_dense_bwd,
               kernels.flash_attention, kernels.flash_attention_bwd)
    totals = {}
    route_fn = ttr.attention_route
    for config, want_kernels in TF_BF16_KERNELS.items():
        args = _tf_train_args(config, ["--precision", "bf16"])
        routes = collections.Counter()

        def counting(*a, **k):
            r = route_fn(*a, **k)
            routes[r] += args.num_encoder_layers
            return r

        save = os.path.join(tmp, "bf16_" + os.path.basename(os.path.dirname(
            os.path.dirname(config))))
        out = io.StringIO()
        ttr.attention_route = counting
        kernels.reset_launches()             # this yml's bf16 training path
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                res = train_main.main([
                    "--configs", config, "--data_root", SNAPSHOT, "--epochs",
                    str(TRAIN_EPOCHS), "--seed", str(SEED), "--precision",
                    "bf16", "--save_path", save])
        finally:
            ttr.attention_route = route_fn
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        by_inst = {fn.__name__: dict(fn.instances) for fn in counted}
        for line in out.getvalue().splitlines():
            print(f"[16b] main: {line}")
        steps = sum(r["steps"] for r in res["epochs"])
        layers = args.num_encoder_layers
        want = {k: layers * steps for k, _ in want_kernels}
        want_inst = _tf_bf16_want(layers, steps, want_kernels)
        if steps == 0 or launches != want or by_inst != want_inst:
            raise AssertionError(f"{args.dataset} Transformer-only bf16 "
                                 f"training launches {launches} by instance "
                                 f"{by_inst}, expected {want}, {want_inst}")
        print(f"[16b] the {args.dataset} Transformer-only bf16 step's "
              f"launches ({steps} steps): {launches}; by instance {by_inst}: "
              f"every one the bf16 instance; attention routes by layer call "
              f"(forward): {dict(routes)}")
        if not all(math.isfinite(r["loss"]) for r in res["epochs"]):
            raise AssertionError(f"bf16 epoch losses not finite: "
                                 f"{res['epochs']}")
        splits, num_tasks, code = predict.load_splits(args)
        init, _ = _trainer(args, num_tasks, device, data=code)
        trained = torch.load(res["saved"], map_location=device,
                             weights_only=True)
        params = dict(init.named_parameters())
        still = [n for n, p in params.items() if torch.equal(p, trained[n])]
        wrong = [n for n, p in trained.items() if p.dtype != torch.float32
                 and p.is_floating_point()]
        if still or wrong:
            raise AssertionError(f"{args.dataset} bf16 training: parameters "
                                 f"that did not move {still}; state not "
                                 f"float32 {wrong}")
        print(f"[16b] trained the {args.dataset} Transformer-only yml "
              f"{TRAIN_EPOCHS} epochs in bf16 ({steps} steps of <= "
              f"{args.batch_size} graphs, attention dropout "
              f"{args.transformer_dropout}, {secs:.2f} s with the model "
              f"build) through graphtrans_tpu_torch.main --precision bf16: "
              f"losses {[round(r['loss'], 6) for r in res['epochs']]}, all "
              f"{len(params)} parameter tensors moved, the saved state "
              f"float32")
        totals[args.dataset] = dict(launches=launches, by_inst=by_inst,
                                    routes=dict(routes))

        layout = predict.serving_layout(splits, args, num_tasks,
                                        args.batch_size, split="train",
                                        seed=SEED)
        batch = next(iterate_batches(
            splits["train"], order=shuffled_order(len(splits["train"]), SEED,
                                                  0), **layout)).to(device)
        got = []
        with deterministic():
            for on in (True, False):
                model, step = _trainer(args, num_tasks, device,
                                       kernels_on=on, data=code)
                loss = step(batch)
                got.append((loss.item(), loss.dtype,
                            {n: p.grad for n, p in model.named_parameters()}))
        (lk, dt, gk), (lp, _, gp) = got
        g_err = max(_rel_err(gk[n], gp[n]) for n in gk)
        dtypes = {g.dtype for g in gk.values()} | {dt}
        if (abs(lk - lp) > BF16_STEP_TOL[0] * max(1.0, abs(lp))
                or g_err > BF16_STEP_TOL[1] or dtypes != {torch.float32}):
            raise AssertionError(f"{args.dataset} Transformer-only bf16 step "
                                 f"through the kernels: loss {lk} vs {lp}, "
                                 f"gradients {g_err} (<= "
                                 f"{BF16_STEP_TOL[1]}), dtypes {dtypes}")
        print(f"[16b] one {args.dataset} Transformer-only bf16 step "
              f"(attention dropout {args.transformer_dropout}, same seeds, "
              f"deterministic algorithms) through the kernels vs the plain "
              f"bf16 versions on the card: loss {lk:.6f} vs {lp:.6f} (|diff| "
              f"{abs(lk - lp):.3g} <= {BF16_STEP_TOL[0]} of max(1, |ref|)), "
              f"gradients {g_err:.3g} of max(1, max|ref|) (<= "
              f"{BF16_STEP_TOL[1]}); loss and gradients float32")
        del model, step, init, trained
        torch.cuda.empty_cache()
    return totals


def phase16_cost(device, mol_flat, code2_flat, code2_tasks: int, smi: str):
    """(c) The cells tf-train4096-bf16 and tf-train512-bf16: the
    Transformer-only train step on 4096 molecules and on 512 ASTs in f32
    and in bf16 in turns (f32, bf16, bf16, f32): median ms, graphs/s, peak
    memory; each precision profiled once: device busy ms, idle share and
    device time by layer."""
    import types

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)       # make_code_dataset's
    for cell, config, bench, tasks in (
            ("tf-train4096", TF_MOL_CONFIG, mol_flat, 128),
            ("tf-train512", TF_CODE2_CONFIG, code2_flat, code2_tasks)):
        tb = bench.to(device)
        n = int(bench.graph_mask.sum())
        runs, profiled = collections.defaultdict(list), set()
        for prec in ("f32", "bf16", "bf16", "f32"):
            args = _tf_train_args(config, ["--precision", prec])
            model, step = _trainer(args, tasks, device,
                                   data=sizes if "512" in cell else None)
            _median_ms(lambda: step(tb), 3)                 # warm-up
            torch.cuda.reset_peak_memory_stats(device)
            ms, lo, hi, loss = _median_ms(lambda: step(tb), TIMED_STEPS)
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            if not torch.isfinite(loss):
                raise AssertionError(f"{cell} {prec} step: loss not finite")
            runs[prec].append(ms)
            print(f"[16c] {cell}{'-bf16' if prec == 'bf16' else ''} "
                  f"Transformer-only {prec} train step of {n} graphs: median "
                  f"{ms:.3f} ms over {TIMED_STEPS} (min {lo:.3f}, max "
                  f"{hi:.3f}), {n / ms * 1e3:.0f} graphs/s, peak memory "
                  f"{peak:.2f} GiB on {smi}")
            if prec not in profiled:
                profiled.add(prec)
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    for _ in range(PROFILED_STEPS):
                        step(tb)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
                _print_split("[16c]", f"{cell} Transformer-only {prec} train "
                             f"step", prof, PROFILED_STEPS, wall, smi,
                             graphs=n)
            del model, step
            torch.cuda.empty_cache()
        f32, bf = statistics.mean(runs["f32"]), statistics.mean(runs["bf16"])
        print(f"[16c] {cell}: bf16 {bf:.3f} ms against f32 {f32:.3f} ms in "
              f"turns ({f32 / bf:.3f}x) on {smi}")
        del tb
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", default=None,
                   help="write phase 5's chrome trace to this file")
    p.add_argument("--baseline", default=None,
                   help="a checkout of an earlier commit whose K1, K1-bwd, "
                        "K2, K2-bwd, K3, K3-bwd, K4, K5, K4-bwd, K5-bwd, K6, "
                        "K6-bwd, K7, K7-bwd, K8, K8-dx, K9, K9-bwd, K10, "
                        "K10-bwd and K12 phases 2 and 6a-13a time beside "
                        "this tree's (K1, K1-bwd, K4, K4-bwd, K6-bwd, K7, "
                        "K7-bwd, K8, K8-dx, K9, K9-bwd, K10, K10-bwd also "
                        "bit for bit; K6 its largest difference), and "
                        "whose bf16 K2 pair phase 14a times (its f32 K2 "
                        "pair bit for bit), whose f32 long launches of "
                        "K2, K3, K5 and K9, f32 K7 and K7-bwd and bf16 long "
                        "pair phase 15a holds to its bits, and whose bf16 "
                        "long forwards phase 15a and 15d time beside this "
                        "tree's, and whose bf16 K2 and K3 instances phase "
                        "16a holds to their bits")
    opts = p.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from graphtrans_tpu_torch.data.synthetic import (code2_bench_batch,
                                                     mol_bench_batch,
                                                     tu_bench_batch)
    from graphtrans_tpu_torch.ops.kernels import _build

    device = torch.device("cuda", 0)
    smi = _smi()
    print(f"[0] card: {smi}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); {torch.cuda.device_count()} visible; "
          f"{CLOCKS}: {_smi(CLOCKS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[0] TF32 off for matmul and cuDNN: float32 work runs in float32")

    secs = _build.build()
    regs = "; ".join(line.split(":", 1)[-1].strip()
                     for log in _build.build_log.values()
                     for line in log.splitlines() if "registers" in line)
    print(f"[1] built {', '.join(_build.KERNELS)} with nvcc (sm_90a) in "
          f"{secs:.1f} s; ptxas: {regs}")
    base = load_baseline(opts.baseline)

    args = _args()
    t0 = time.perf_counter()
    big = mol_bench_batch(4096, SEED)
    print(f"[2] collated the 4096-graph batch in "
          f"{time.perf_counter() - t0:.1f} s")
    timing = phase2(device, args.gnn_emb_dim, args.d_model, args.nhead, big,
                    base)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase3(device, tmp)
    phase5(*phase4(device, big, smi), smi, opts.trace)
    train = phase6_kernels(device, args.gnn_emb_dim, args.d_model, args.nhead,
                           big, base)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = phase6_train(device, tmp)
    phase6_step4096(device, big, smi)

    t0 = time.perf_counter()
    bench, bench_tasks = code2_bench_batch(CODE2_BENCH, SEED)
    print(f"[7] collated the {CODE2_BENCH}-graph code2 batch in "
          f"{time.perf_counter() - t0:.1f} s")
    code2 = phase7_kernels(device, args.gnn_emb_dim, args.d_model,
                           args.nhead, bench, base)
    with tempfile.TemporaryDirectory() as tmp:
        code2_launches = phase7_serve(device, tmp)
    phase7_forward(device, bench, bench_tasks, smi)

    code2_train = phase8_kernels(device, args.gnn_emb_dim, args.d_model,
                                 args.nhead, bench, base)
    with tempfile.TemporaryDirectory() as tmp:
        code2_train_launches = phase8_train(device, tmp)
    phase8_step512(device, bench, bench_tasks, smi)

    t0 = time.perf_counter()
    mol_flat = mol_bench_batch(4096, SEED, flat=True)
    code2_flat, flat_tasks = code2_bench_batch(CODE2_BENCH, SEED, flat=True)
    print(f"[9] collated the flat 4096-molecule and {CODE2_BENCH}-AST batches "
          f"in {time.perf_counter() - t0:.1f} s")
    tf = phase9_kernels(device, mol_flat, code2_flat, base)
    with tempfile.TemporaryDirectory() as tmp:
        tf_launches = phase9_serve(device, tmp)
    phase9_forward(device, mol_flat, code2_flat, flat_tasks, smi)

    tf_train = phase10_kernels(device, mol_flat, code2_flat, base)
    with tempfile.TemporaryDirectory() as tmp:
        tf_train_launches = phase10_train(device, tmp)
    k11_launches = phase10_step(device, mol_flat, code2_flat, flat_tasks, smi)

    switch = phase11_kernels(device, mol_flat, code2_flat, base)
    with tempfile.TemporaryDirectory() as tmp:
        switch_launches = phase11_serve(device, tmp)
        switch_launches.update(phase11_train(device, tmp))
    phase11_cost(device, mol_flat, smi)

    t0 = time.perf_counter()
    nci1_bench = tu_bench_batch(NCI1_BENCH, SEED)
    print(f"[12] collated the {NCI1_BENCH}-graph NCI1 batch in "
          f"{time.perf_counter() - t0:.1f} s")
    nci1 = phase12_kernels(device, _nci1_args().gnn_emb_dim, nci1_bench, base)
    with tempfile.TemporaryDirectory() as tmp:
        nci1_launches, nci1_k6_instances = phase12_serve(device, tmp)
        nci1_train_launches = phase12_train(device, tmp)
    phase12_cost(device, nci1_bench, smi)

    t0 = time.perf_counter()
    bench_bsp, bsp_tasks = code2_bench_batch(CODE2_BENCH, SEED, bsp=True)
    print(f"[13] collated the {CODE2_BENCH}-graph code2 batch with both "
          f"block plans in {time.perf_counter() - t0:.1f} s")
    bsp = phase13_kernels(device, args.gnn_emb_dim, bench_bsp, base)
    with tempfile.TemporaryDirectory() as tmp:
        bsp_launches, bsp_step_launches = phase13_serve(device, tmp)
    phase13_cost(device, bench_bsp, bsp_tasks, smi)

    bf16 = phase14_kernels(device, args.gnn_emb_dim, args.d_model,
                           args.nhead, big, base)
    with tempfile.TemporaryDirectory() as tmp:
        bf16_launches, bf16_instances = phase14_train(device, tmp)
    phase14_cost(device, big, smi)

    code2_bf16 = phase15_kernels(device, args.gnn_emb_dim, args.d_model,
                                 args.nhead, bench, base)
    with tempfile.TemporaryDirectory() as tmp:
        _, c2_instances = phase15_train(device, tmp, bench, bench_tasks)
    phase15_cost(device, bench, bench_tasks, smi, base)

    tf_bf16 = phase16_kernels(device, mol_flat, code2_flat, big, bench, base)
    with tempfile.TemporaryDirectory() as tmp:
        tf_bf16_runs = phase16_train(device, tmp)
    phase16_cost(device, mol_flat, code2_flat, flat_tasks, smi)

    k1, k2 = timing["timed"]
    k1b, k2b = train["timed"]
    k3, k7 = code2["timed"]
    k3b, k7b = code2_train["timed"]
    k4, k5 = tf["timed"]
    k4b, k5b, k11 = tf_train["timed"]
    k9, k9b, k10, k10b = switch["timed"]
    k6, k6b = nci1["timed"]
    k8, k8d, k8x, k12 = bsp["timed"]
    k1h, k1bh, k2h, k2bh = bf16["timed"]
    c2 = code2_bf16["timed"]
    c2e = code2_bf16["errs"]
    t16, e16 = tf_bf16["timed"], tf_bf16["errs"]
    mol16 = tf_bf16_runs["ogbg-molpcba"]["by_inst"]
    code16 = tf_bf16_runs["ogbg-code2"]["by_inst"]
    keep = ("ms", "f32_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape", "residency", "grid")
    k16 = lambda key: {k: t16[key][k] for k in keep}
    k4_inst = lambda name: {k: mol16[name][k] + code16[name][k]
                            for k in mol16[name] if k.endswith("_bf16")}
    rows = [
        dict(name="gin_agg_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/gin_agg.cu",
             replaces="graphtrans_tpu/ops/pallas/gin_agg.py:237",
             launches=launches["gin_agg"], max_abs_err=timing["k1_err"], **k1),
        dict(name="attention_seg_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:420",
             launches=launches["attention_seg"], max_abs_err=timing["k2_err"],
             **k2),
        dict(name="gin_agg_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/gin_agg.cu",
             replaces="graphtrans_tpu/ops/pallas/gin_agg.py:287",
             launches=train_launches["gin_agg_bwd"],
             # dx, dw absolute; the grid sums dT, dscale relative to
             # max(1, max |reference|), as check_k1_bwd holds them
             max_abs_err=train["k1_err"], **k1b),
        dict(name="attention_seg_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:393",
             launches=train_launches["attention_seg_bwd"],
             max_abs_err=train["k2_err"], **k2b),
        dict(name="flash_hil_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_hil.cu",
             replaces="graphtrans_tpu/ops/pallas/flash_hil.py:319",
             launches=code2_launches["flash_hil_seg"],
             max_abs_err=code2["k3_err"], **k3),
        dict(name="spmm_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/spmm.cu",
             replaces="graphtrans_tpu/ops/pallas/spmm.py:104",
             launches=code2_launches["spmm"],
             # relative to max(1, max |reference|), as check_k7 holds it
             max_abs_err=code2["k7_err"], **k7),
        dict(name="flash_hil_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_hil.cu",
             replaces="graphtrans_tpu/ops/pallas/flash_hil.py:398/419",
             launches=code2_train_launches["flash_hil_seg_bwd"],
             # relative to max(1, max |reference|), as check_k3_train holds it
             max_abs_err=code2_train["k3_err"], **k3b),
        dict(name="spmm_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/spmm.cu",
             replaces="none (JAX trains through ops/scatter.py)",
             launches=code2_train_launches["spmm_bwd"],
             max_abs_err=code2_train["k7_err"], **k7b),
        dict(name="attention_dense_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_tile.cuh, "
                    "graphtrans_tpu_torch/csrc/attention_fwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:326",
             launches=tf_launches["attention_dense"],
             instances={k: tf_launches[f"attention_dense {k}"]
                        for k in ("tile", "long")},
             max_abs_err=tf["k4_err"], **k4),
        dict(name="flash_attention_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_attention.cu",
             header="graphtrans_tpu_torch/csrc/attention_fwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/flash_attention.py:228",
             launches=tf_launches["flash_attention"],
             max_abs_err=tf["k5_err"], **k5),
        dict(name="attention_dense_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_tile.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:393",
             launches=tf_train_launches["attention_dense_bwd"],
             instances={k: tf_train_launches[f"attention_dense_bwd {k}"]
                        for k in ("short", "wide")},
             # relative to max(1, max |reference|), as check_k4_train holds it
             max_abs_err=tf_train["k4_err"], **k4b),
        dict(name="flash_attention_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_attention.cu",
             header="graphtrans_tpu_torch/csrc/attention_bwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/flash_attention.py:326/350",
             launches=tf_train_launches["flash_attention_bwd"],
             max_abs_err=tf_train["k5_err"], **k5b),
        dict(name="byte_dropout", route="cuda",
             source="graphtrans_tpu_torch/csrc/dropout.cu",
             replaces="graphtrans_tpu/ops/pallas/dropout.py:89",
             launches=k11_launches, max_abs_err=tf_train["k11_err"], **k11),
        dict(name="attention_smalls_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_smalls.cu",
             header="graphtrans_tpu_torch/csrc/attention_tile.cuh, "
                    "graphtrans_tpu_torch/csrc/attention_fwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_smallS.py:176",
             launches=switch_launches["attention_smalls"],
             instances={k: switch_launches[f"attention_smalls {k}"]
                        for k in ("tile", "long")},
             max_abs_err=switch["errs"]["k9"], **k9),
        dict(name="attention_smalls_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_smalls.cu",
             header="graphtrans_tpu_torch/csrc/attention_tile.cuh, "
                    "graphtrans_tpu_torch/csrc/attention_bwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_smallS.py:227",
             launches=switch_launches["attention_smalls_bwd"],
             instances={k: switch_launches[f"attention_smalls_bwd {k}"]
                        for k in ("short", "wide", "long")},
             # relative to max(1, max |reference|), as check_k9 holds it
             max_abs_err=switch["errs"]["k9_bwd"], **k9b),
        dict(name="transformer_layer_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/transformer_layer.cu",
             replaces="graphtrans_tpu/ops/pallas/transformer_layer.py:340",
             launches=switch_launches["transformer_layer"],
             max_abs_err=switch["errs"]["k10"], **k10),
        dict(name="transformer_layer_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/transformer_layer.cu",
             replaces="graphtrans_tpu/ops/pallas/transformer_layer.py:420",
             launches=switch_launches["transformer_layer_bwd"],
             # relative to max(1, max |reference|), as check_k10 holds it
             max_abs_err=switch["errs"]["k10_bwd"], **k10b),
        dict(name="dense_agg_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/dense_agg.cu",
             replaces="graphtrans_tpu/ops/pallas/dense_agg.py:168",
             launches=nci1_launches["dense_agg"],
             # every NCI1 launch emb-less (12b); ms and bound are that
             # instance's at the 4096-graph batch
             instances=nci1_k6_instances, max_abs_err=nci1["k6_err"], **k6),
        dict(name="dense_agg_bwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/dense_agg.cu",
             replaces="graphtrans_tpu/ops/pallas/dense_agg.py:140",
             launches=nci1_train_launches["dense_agg_bwd"],
             # the NCI1 step's launches, every one the dx-only instance
             # (phase 12b); ms and bound are that instance's
             # relative to max(1, max |reference|), as check_k6 holds it
             max_abs_err=nci1["k6b_err"], **k6b),
        dict(name="blocked_gms_fwd", route="cuda",
             source="graphtrans_tpu_torch/csrc/spmm.cu",
             replaces="graphtrans_tpu/ops/pallas/block_spmm.py:184",
             launches=bsp_launches["blocked_gather_message_scatter"],
             # relative to max(1, max |reference|), as check_k8 holds it
             max_abs_err=bsp["f_err"], **k8),
        dict(name="blocked_gms_demb", route="cuda",
             source="graphtrans_tpu_torch/csrc/block_spmm.cu",
             replaces="graphtrans_tpu/ops/pallas/block_spmm.py:89",
             launches=bsp_step_launches["blocked_gather_message_scatter_demb"],
             max_abs_err=bsp["b_err"]["demb"], **k8d),
        dict(name="blocked_gms_dx", route="cuda",
             source="graphtrans_tpu_torch/csrc/spmm.cu",
             replaces="graphtrans_tpu/ops/pallas/block_spmm.py:108",
             launches=bsp_step_launches["blocked_gather_message_scatter_dx"],
             max_abs_err=bsp["b_err"]["dx"], **k8x),
        dict(name="gin_agg_fwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/gin_agg.cu",
             replaces="graphtrans_tpu/ops/pallas/gin_agg.py:237 (bf16)",
             launches=bf16_instances["gin_agg"]["bf16"],
             # of max(1, max |plain bf16|), as check_k1_bf16 holds it
             max_abs_err=bf16["errs"]["k1"], **k1h),
        dict(name="gin_agg_bwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/gin_agg.cu",
             replaces="graphtrans_tpu/ops/pallas/gin_agg.py:287 (bf16)",
             launches=bf16_instances["gin_agg_bwd"]["bf16"],
             max_abs_err=bf16["errs"]["k1b"], **k1bh),
        dict(name="attention_seg_fwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_tile.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:420 "
                      "(bf16)",
             launches=bf16_instances["attention_seg"]["tile_bf16"],
             max_abs_err=bf16["errs"]["k2"], **k2h),
        dict(name="attention_seg_bwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_tile.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:393 "
                      "(bf16)",
             launches=bf16_instances["attention_seg_bwd"]["tile_bf16"],
             max_abs_err=bf16["errs"]["k2b"], **k2bh),
        # the code2 bf16 step (phase 15): K2's long instance and K3 share
        # the bf16 long forward, their backwards the bf16 long pair
        dict(name="attention_seg_fwd_long_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_fwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:420 "
                      "(bf16, rows of 129-384)",
             launches=c2_instances["attention_seg"]["long_bf16"],
             max_abs_err=c2e["k2"], **c2["k2"]),
        dict(name="attention_seg_bwd_long_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_bwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:393 "
                      "(bf16, rows of 129-384)",
             launches=c2_instances["attention_seg_bwd"]["long_bf16"],
             max_abs_err=c2e["k2b"], **c2["k2b"]),
        dict(name="flash_hil_fwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_hil.cu",
             header="graphtrans_tpu_torch/csrc/attention_fwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/flash_hil.py:319 (bf16)",
             launches=c2_instances["flash_hil_seg"]["bf16"],
             max_abs_err=c2e["k3"], **c2["k3"]),
        dict(name="flash_hil_bwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_hil.cu",
             header="graphtrans_tpu_torch/csrc/attention_bwd.cuh",
             replaces="graphtrans_tpu/ops/pallas/flash_hil.py:398/419 (bf16)",
             launches=c2_instances["flash_hil_seg_bwd"]["bf16"],
             max_abs_err=c2e["k3b"], **c2["k3b"]),
        dict(name="spmm_fwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/spmm.cu",
             replaces="graphtrans_tpu/ops/pallas/spmm.py:104 (bf16)",
             launches=c2_instances["spmm"]["bf16"],
             max_abs_err=c2e["k7"], **c2["k7"]),
        dict(name="spmm_bwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/spmm.cu",
             replaces="none (JAX trains through ops/scatter.py; bf16)",
             launches=c2_instances["spmm_bwd"]["bf16"],
             max_abs_err=c2e["k7b"], **c2["k7b"]),
        # the Transformer-only bf16 step (phase 16): K4's two instances and
        # K5 share the bf16 key-list bodies; the launches are phase 16b's,
        # the row's times the main path's instance's (K4: its tile
        # instance; its long one beside, under "long_instance")
        dict(name="attention_dense_fwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_list16.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:326 "
                      "(bf16, hd 64)",
             launches=sum(k4_inst("attention_dense").values()),
             instances=k4_inst("attention_dense"),
             max_abs_err=e16["k4"], long_instance=k16("K4 long"),
             **k16("K4 tile")),
        dict(name="attention_dense_bwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/attention_packed.cu",
             header="graphtrans_tpu_torch/csrc/attention_list16.cuh",
             replaces="graphtrans_tpu/ops/pallas/attention_packed.py:393 "
                      "(bf16, hd 64)",
             launches=sum(k4_inst("attention_dense_bwd").values()),
             instances=k4_inst("attention_dense_bwd"),
             max_abs_err=e16["k4b"], long_instance=k16("K4 long-bwd"),
             **k16("K4 tile-bwd")),
        dict(name="flash_attention_fwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_attention.cu",
             header="graphtrans_tpu_torch/csrc/attention_list16.cuh",
             replaces="graphtrans_tpu/ops/pallas/flash_attention.py:228 "
                      "(bf16, hd 64)",
             launches=code16["flash_attention"]["bf16"]
             + mol16["flash_attention"]["bf16"],
             max_abs_err=e16["k5"], **k16("K5")),
        dict(name="flash_attention_bwd_bf16", route="cuda",
             source="graphtrans_tpu_torch/csrc/flash_attention.cu",
             header="graphtrans_tpu_torch/csrc/attention_list16.cuh",
             replaces="graphtrans_tpu/ops/pallas/flash_attention.py:326/350 "
                      "(bf16, hd 64)",
             launches=code16["flash_attention_bwd"]["bf16"]
             + mol16["flash_attention_bwd"]["bf16"],
             max_abs_err=e16["k5b"], **k16("K5-bwd")),
        dict(name="segment_sum_mxu", route="cuda",
             source="graphtrans_tpu_torch/csrc/scatter_mxu.cu",
             replaces="graphtrans_tpu/ops/pallas/scatter_mxu.py:69",
             # a standalone op: its one call in phase 13a, as a user calls it
             launches=bsp["k12_launches"], max_abs_err=bsp["k12_err"],
             **k12),
    ]
    print(f"[wall] {CLOCKS} at the end: {_smi(CLOCKS)}")
    print(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"(phases 0-16, the kernels' build included)")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
