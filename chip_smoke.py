"""Start-up check of the PyTorch/CUDA port (graphtrans_tpu_torch) on one
NVIDIA card.

usage: python3 chip_smoke.py [--trace trace.json]

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
     chrome trace).
Then a {"kernels": [...]} line, the nvidia-smi line, and the contract line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(
    REPO, "configs/molpcba/gnn-transformer/JK=cat/pooling=cls+gin+norm_input.yml")
SNAPSHOT = os.path.join(REPO, "data_snapshots")
BATCH = 64
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
K1_TOL, K2_TOL, LOGITS_TOL = 1e-5, 2e-5, 1e-4
GIN_LAYERS_PER_FORWARD, ENCODER_LAYERS_PER_FORWARD = 5, 4
PROFILED_FORWARDS = 5
# kernel-name fragments -> the layer that launches them (phase 5)
LAYERS = (
    ("gin_agg_fwd", "K1 gin_agg (aggregation)"),
    ("attention_seg_fwd", "K2 attention_seg"),
    ("gemm", "matmul (Linear layers)"),
    ("layer_norm", "LayerNorm"),
    ("index", "gather / index_select"),
    ("embedding", "embedding lookup"),
    ("reduce", "reductions (graph_sum)"),
    ("cat", "concatenation"),
)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def _bound(nbytes: int, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
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


def k2_bound(qkv, seg, nhead: int):
    R, W, d3 = qkv.shape
    hd = d3 // 3 // nhead
    _, counts = torch.unique(seg[seg >= 0], return_counts=True)
    pairs = int((counts.long() ** 2).sum().item())   # same-segment (q, k)
    nbytes = (qkv.numel() * 4 + seg.numel() * 4 + R * W * (d3 // 3) * 4)
    return _bound(nbytes, pairs * nhead * (4 * hd + 4))


def sdpa_ms(qkv, seg, nhead: int) -> float:
    """Yardstick only: torch's scaled_dot_product_attention with a boolean
    segment mask on the same inputs (never called by the port)."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(R, W, nhead, d // nhead).transpose(1, 2).contiguous()
               for t in qkv.split(d, dim=-1))
    mask = ((seg[:, :, None] == seg[:, None, :])
            & (seg >= 0)[:, None, :])[:, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: f(q, k, v, attn_mask=mask), iters=20)


def phase2(device, d_gnn: int, d_model: int, nhead: int, big):
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

    rows = []
    for name, b in (("serve64", serve), ("bench4096", big)):
        inp = k1_inputs(b, d_gnn, gen, device)
        _, args = check_k1(inp, with_w=False)
        k1 = dict(ms=time_ms(lambda: gin_agg(*args), iters=20),
                  plain_ms=time_ms(lambda: gin_agg_plain(*args), iters=5),
                  library_ms=None)
        k1["bound_ms"], k1["bound_by"] = k1_bound(args)
        qkv, seg = k2_inputs(b, d_model, gen, device, pad_rows=0)
        k2 = dict(ms=time_ms(lambda: attention_seg(qkv, seg, nhead), iters=20),
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
            print(f"[2] {name} {kname} [{t['shape']}]: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library {lib} ms")
        rows.append((k1, k2))
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
    want = {"gin_agg": GIN_LAYERS_PER_FORWARD * batches,
            "attention_seg": ENCODER_LAYERS_PER_FORWARD * batches}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    print(f"[3] served {records} graphs of the molpcba snapshot in {batches} "
          f"batches of <= {BATCH} ({secs:.2f} s with model builds); "
          f"launches {launches} = 5 and 4 per batch")

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
          f"graphs/s on {smi}")
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
    kernels = [(e.key, e.self_device_time_total / 1e3 / PROFILED_FORWARDS,
                e.count / PROFILED_FORWARDS)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if busy <= 0:
        raise AssertionError("the profiler saw no kernel time on the card")
    by_layer = collections.Counter()
    for name, ms, _ in kernels:
        by_layer[_layer(name)] += ms
    print(f"[5] profiled forward of 4096 graphs: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f} on {smi}")
    for layer, ms in by_layer.most_common():
        print(f"[5]   {layer:32s} {ms:9.3f} ms  {ms / busy:6.1%}")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:10]:
        print(f"[5]   top {ms:9.3f} ms {n:5.0f}x  {name[:100]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", default=None,
                   help="write phase 5's chrome trace to this file")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from graphtrans_tpu_torch.data.synthetic import mol_bench_batch
    from graphtrans_tpu_torch.ops.kernels import _build

    device = torch.device("cuda", 0)
    smi = _smi()
    print(f"[0] card: {smi}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[0] TF32 off for matmul and cuDNN: float32 work runs in float32")

    secs = _build.build()
    regs = "; ".join(line.split(":", 1)[-1].strip()
                     for log in _build.build_log.values()
                     for line in log.splitlines() if "registers" in line)
    print(f"[1] built {', '.join(_build.KERNELS)} with nvcc (sm_90a) in "
          f"{secs:.1f} s; ptxas: {regs}")

    args = _args()
    t0 = time.perf_counter()
    big = mol_bench_batch(4096, SEED)
    print(f"[2] collated the 4096-graph batch in "
          f"{time.perf_counter() - t0:.1f} s")
    timing = phase2(device, args.gnn_emb_dim, args.d_model, args.nhead, big)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase3(device, tmp)
    phase5(*phase4(device, big, smi), smi, opts.trace)

    k1, k2 = timing["timed"]
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
    ]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
