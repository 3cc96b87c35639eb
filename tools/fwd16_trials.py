"""Times variants of the bf16 long forward (K2's long instance and K3) on
the card, in turns, at the code2 snapshot's train batch of 16 and at the
512-graph bench batch.

    python3 tools/fwd16_trials.py [--parent DIR]

Each variant is a copy of ``graphtrans_tpu_torch`` under
``_checkout/fwd16_trials/`` (gitignored) with one edit to the sources,
built by its own ``_build`` (all ``nvcc`` processes started together):

- ``this``: the tree as it is;
- ``v_with_k``: K2's V committed chunk by chunk in the group of the
  chunk's K, where this tree commits all of V in one group behind K;
- ``z_tiles``: ceil(W / 64) tile slots a row, where this tree takes one
  more;
- ``parent``: the package of the checkout ``--parent`` names, if given.

Every variant's output is held to this tree's (the edits move no bit;
the parent's differs within the plain-version tolerance). Each forward
(the training launch, dropout 0.3) is timed four ways: CUDA events over
back-to-back calls (``chip_smoke.time_ms``, paced by the host where a
call takes less device time than the host needs to make it), the device
time a call, each queued behind a sleep kernel with L2 flushed
(``chip_smoke.queued_ms``), the host's ms a call, and the profiler's
kernel time a launch (warm L2). Needs a CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
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
FWD = "csrc/attention_fwd.cuh"
EDITS = {
    "v_with_k": [(FWD, """      for (int c = 0; c < chunks; ++c) {
        stage_keys(s.K + c * T * LD, nullptr, s.ktag + c * T, c * T, T);
        cp_commit();
      }
      stage_keys(nullptr, s.V, nullptr, 0, chunks * T);
      cp_commit();
      for (int c = 0; c < chunks; ++c) {  // m and l
        cp_wait_upto(chunks - c);""", """      for (int c = 0; c < chunks; ++c) {
        stage_keys(s.K + c * T * LD, s.V + c * T * LD, s.ktag + c * T, c * T,
                   T);
        cp_commit();
      }
      for (int c = 0; c < chunks; ++c) {  // m and l
        cp_wait_upto(chunks - 1 - c);""")],
    "z_tiles": [(FWD, "L.gz == (W + LONG_T - 1) / LONG_T + 1 &&",
                 "L.gz == (W + LONG_T - 1) / LONG_T &&"),
                ("ops/kernels/attention_packed.py",
                 "(R, nhead, -(-W // LONG_T) + 1), LONG16_THREADS,",
                 "(R, nhead, -(-W // LONG_T)), LONG16_THREADS,")],
}


def variant(name: str, edits) -> str:
    """A copy of this tree's package with ``edits`` applied (each must
    match once): the root that holds it."""
    root = os.path.join(ROOT, "_checkout", "fwd16_trials", name)
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


def host_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median host ms a call, the calls queued behind a sleep kernel."""
    per = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)  # ~10 ms: longer than the calls
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
    return statistics.median(per)


def profiled_ms(fn, iters: int = 20) -> float:
    """The profiler's device ms a launch of the kernels ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        if t > 0:
            us, n = us + t, n + e.count
    return us / n / 1e3 if n else float("nan")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None,
                   help="a checkout of an earlier commit to time beside")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwd16_trials: no CUDA card", file=sys.stderr)
        return 1
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.synthetic import code2_bench_batch

    device = torch.device("cuda", 0)
    roots = {"this": ROOT, **{n: variant(n, e) for n, e in EDITS.items()}}
    if opts.parent:
        roots["parent"] = os.path.abspath(opts.parent)
    mods = {n: load(f"fwd16_{n}", r) for n, r in roots.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        list(ex.map(lambda m: m["_build"].build(KERNELS), mods.values()))
    print(f"[trials] card: {cs._smi()}; built {len(mods)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    args = cs._code2_args()
    splits, num_tasks, _ = predict.load_splits(args)
    train16 = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks, split="train")))
    bench, _ = code2_bench_batch(cs.CODE2_BENCH, cs.SEED)
    gen = torch.Generator().manual_seed(cs.SEED + 23)
    H, seed = args.nhead, 13572468
    for bname, b in (("train16", train16), (f"bench{cs.CODE2_BENCH}", bench)):
        k2 = cs.k2_tier_inputs(b, "pack2", args.d_model, gen, device)
        k3 = cs.k3_inputs(b, args.d_model, gen, device)
        for kname, (q, sg), mod, fn in (
                ("K2 long", k2, "attention_packed", "attention_seg_with_stats"),
                ("K3", k3, "flash_hil", "flash_hil_seg_with_stats")):
            q = q.to(torch.bfloat16)
            names = [n for n in mods
                     if kname.startswith("K2") or n in ("this", "parent")]
            fns = {n: (lambda f=getattr(mods[n][mod], fn):
                       f(q, sg, H, cs.DROPOUT, seed)) for n in names}
            ref = fns["this"]()[0]
            diff = {n: cs._rel_err(fns[n]()[0], ref) for n in names}
            for n in names:
                if n != "parent" and diff[n] != 0.0:
                    raise AssertionError(f"{bname} {kname} {n}: output "
                                         f"differs from this tree's")
            got = {n: [] for n in names}
            for n in names + names[::-1]:
                got[n].append((cs.time_ms(fns[n], 20), cs.queued_ms(fns[n], 20),
                               host_ms(fns[n]), profiled_ms(fns[n])))
            R, W, _ = q.shape
            for n in names:
                ev, dev, host, prof = (statistics.mean(x[i] for x in got[n])
                                       for i in range(4))
                print(f"[trials] {bname} {kname} bf16 [R={R} W={W} rate="
                      f"{cs.DROPOUT}] {n}: device {dev:.4f} ms a call "
                      f"(queued, cold L2), profiler {prof:.4f} ms a launch, back to "
                      f"back {ev:.4f} ms a call, host {host:.4f} ms a call; "
                      f"output {diff[n]:.3g} of max(1, max|this|) from this "
                      f"tree's", flush=True)
    print(f"[trials] on {cs._smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
