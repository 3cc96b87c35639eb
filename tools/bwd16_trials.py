"""Times variants of the bf16 long backward pair (K2-bwd's long instance and
K3-bwd) on the card, in turns, at the code2 snapshot's train batch of 16
and at the 512-graph bench batch.

    python3 tools/bwd16_trials.py [--parent DIR]

Each variant is a copy of ``graphtrans_tpu_torch`` under
``_checkout/bwd16_trials/`` (gitignored) with one edit to the sources,
built by its own ``_build`` (all ``nvcc`` processes started together):

- ``this``: the tree as it is;
- ``no_bits``: K2's dS sweep hashes each pair again, where this tree
  reads the keep bits its delta sweep saved;
- ``k3_four``: K3's pair compiled for four blocks an SM (at most 128
  registers a thread), where this tree asks for three; its shared memory
  allows four at W 1024;
- ``parent``: the package of the checkout ``--parent`` names, if given.

First it prints what ``ptxas`` reports for each variant's bf16 long
kernels (registers, stack, spills) and each backward kernel's residency.
Every variant's gradient is held to the plain bf16 version
(``BF16_GRAD_TOL``; padding exactly 0) and to this tree's. Each backward (the training launch,
dropout 0.3, on its forward's out, m and l) is timed as ``chip_smoke.py``
15a times it: the device time a call, each queued behind a sleep kernel
with L2 flushed (``chip_smoke.queued_ms``), with SDPA's backward in bf16
timed alike; and back to back (``chip_smoke.time_ms``). Needs a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import re
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

KERNELS = ("attention_packed", "flash_hil")
BWD = "csrc/attention_bwd.cuh"
EDITS = {
    "no_bits": [(BWD, "if (live) run_chunk(c, c, Int<1>{}, sums);",
                 "if (live) run_chunk(c, c, Int<0>{}, sums);"),
                (BWD, "run_chunk(c, c, Int<2>{}, grads);",
                 "run_chunk(c, c, Int<0>{}, grads);")],
    "k3_four": [("csrc/flash_hil.cu", """template <bool DROP>
__global__ void __launch_bounds__(attn::LONG16_THREADS, 3)
flash_hil_bwd_dq_bf16_kernel(""", """template <bool DROP>
__global__ void __launch_bounds__(attn::LONG16_THREADS, 4)
flash_hil_bwd_dq_bf16_kernel("""), ("csrc/flash_hil.cu", """template <bool DROP>
__global__ void __launch_bounds__(attn::LONG16_THREADS, 3)
flash_hil_bwd_dkv_bf16_kernel(""", """template <bool DROP>
__global__ void __launch_bounds__(attn::LONG16_THREADS, 4)
flash_hil_bwd_dkv_bf16_kernel(""")],
}
RESIDENCY = {"attention_packed": "attention_seg_bwd_long_bf16_residency",
             "flash_hil": "flash_hil_bwd_bf16_residency"}


def variant(name: str, edits) -> str:
    """A copy of this tree's package with ``edits`` applied (each must
    match once): the root that holds it."""
    root = os.path.join(ROOT, "_checkout", "bwd16_trials", name)
    pkg = os.path.join(root, "graphtrans_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "graphtrans_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        path = os.path.join(pkg, rel)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit of {rel} does not match "
                               f"once")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return root


def load(name: str, root: str) -> dict:
    """The kernel modules of the package under ``root``, imported as
    ``name`` so that they build into their own directory."""
    pkg = os.path.join(root, "graphtrans_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    return {k: importlib.import_module(f"{name}.ops.kernels.{k}")
            for k in (*KERNELS, "_build")}


def ptxas_lines(log: str) -> list:
    """ptxas's lines (registers, spills) for the bf16 backward kernels in a
    build's log."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = bool(re.search(r"bwd_d(q|kv)_bf16|fwd_(long_)?bf16",
                                  line))
        if keep and re.search(r"registers|spill|entry function", line):
            out.append(line.strip())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None,
                   help="a checkout of an earlier commit to time beside")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd16_trials: no CUDA card", file=sys.stderr)
        return 1
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.synthetic import code2_bench_batch
    from graphtrans_tpu_torch.ops.kernels import (attention_seg_bwd_plain,
                                                  flash_hil_seg_bwd_plain)

    device = torch.device("cuda", 0)
    roots = {"this": ROOT, **{n: variant(n, e) for n, e in EDITS.items()}}
    if opts.parent:
        roots["parent"] = os.path.abspath(opts.parent)
    mods = {n: load(f"bwd16_{n}", r) for n, r in roots.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        list(ex.map(lambda m: m["_build"].build(KERNELS), mods.values()))
    print(f"[trials] card: {cs._smi()}; built {len(mods)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for n, m in mods.items():
        for k in KERNELS:
            for line in ptxas_lines(m["_build"].build_log.get(k, "")):
                print(f"[trials] ptxas {n} {k}: {line}")
            if n == "parent":
                continue
            for which, what in enumerate(("dq, dropout", "dk/dv, dropout",
                                          "dq", "dk/dv")):
                smem = m["attention_packed"].long16_bwd_bytes(
                    384 if k == "attention_packed" else 1024,
                    k == "attention_packed")
                try:
                    r = cs.long16_residency(m[k], RESIDENCY[k], smem, which)
                except AssertionError as e:  # spills: reported, still timed
                    r = str(e)
                print(f"[trials] residency {n} {k} {what}: {r}")

    args = cs._code2_args()
    splits, num_tasks, _ = predict.load_splits(args)
    train16 = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks, split="train")))
    bench, _ = code2_bench_batch(cs.CODE2_BENCH, cs.SEED)
    gen = torch.Generator().manual_seed(cs.SEED + 24)
    H, seed = args.nhead, 13572468
    for bname, b in (("train16", train16), (f"bench{cs.CODE2_BENCH}", bench)):
        k2 = cs.k2_tier_inputs(b, "pack2", args.d_model, gen, device)
        k3 = cs.k3_inputs(b, args.d_model, gen, device)
        for kname, (q, sg), mod, fwd, bwd, plain in (
                ("K2-bwd long", k2, "attention_packed",
                 "attention_seg_with_stats", "attention_seg_bwd",
                 attention_seg_bwd_plain),
                ("K3-bwd", k3, "flash_hil", "flash_hil_seg_with_stats",
                 "flash_hil_seg_bwd", flash_hil_seg_bwd_plain)):
            q = q.to(torch.bfloat16)
            R, W, d3 = q.shape
            g = torch.randn(R, W, d3 // 3, generator=gen).to(device,
                                                               torch.bfloat16)
            saved = getattr(mods["this"][mod], fwd)(q, sg, H, cs.DROPOUT,
                                                    seed)
            names = [n for n in mods if n in ("this", "parent")
                     or n.startswith("k3") == kname.startswith("K3")]
            fns = {n: (lambda f=getattr(mods[n][mod], bwd):
                       f(q, sg, H, g, saved, cs.DROPOUT, seed))
                   for n in names}
            ref = fns["this"]()
            want = plain(q, sg, H, g, cs.DROPOUT, seed)
            err = {n: cs._rel_err(fns[n](), want) for n in names}
            diff = {n: cs._rel_err(fns[n](), ref) for n in names}
            pad = sg < 0
            for n in names:
                out = fns[n]()
                torch.cuda.synchronize()
                if err[n] > cs.BF16_GRAD_TOL or out[pad].any():
                    raise AssertionError(f"{bname} {kname} {n}: {err[n]} of "
                                         f"the plain bf16 version, or "
                                         f"padding not 0")
            lib = cs.sdpa_bwd_ms(q, sg, H, g, cs.DROPOUT, cs.queued_ms)
            got = {n: [] for n in names}
            for n in names + names[::-1]:
                got[n].append((cs.queued_ms(fns[n], 20),
                               cs.time_ms(fns[n], 20)))
            for n in names:
                dev, ev = (statistics.mean(x[i] for x in got[n])
                           for i in range(2))
                print(f"[trials] {bname} {kname} bf16 [R={R} W={W} rate="
                      f"{cs.DROPOUT}] {n}: {dev:.4f} ms a call (queued, cold "
                      f"L2), back to back {ev:.4f}; {err[n]:.3g} of max(1, "
                      f"max|plain|) from the plain bf16 version, "
                      f"{diff[n]:.3g} from this tree's; SDPA backward in "
                      f"bf16 {lib:.4f} ms (queued)", flush=True)
    print(f"[trials] on {cs._smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
