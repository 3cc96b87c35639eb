"""Times the GraphTrans end-to-end cells for two checkouts of the port in
turns on one NVIDIA card: molpcba train4096 (phase 6c of chip_smoke.py:
K1, K1-bwd, K2, K2-bwd) and, where the tree has phase 14, train4096 in
bf16 beside f32 in turns (14d: the bf16 instances of the same kernels),
code2 bench512's forward and its train step (7c,
8c: K3, K3-bwd, K7, K7-bwd, K2), NCI1 bench4096's forward and train
steps (12c: K6, K6-bwd, K2), and code2 bench512's forward and train step
on the blocked route beside the K7 route (13c: K8, K8-demb, K8-dx).

usage: python3 chip_cells.py EARLIER THIS

EARLIER and THIS are roots of whole checkouts (each with its own
chip_smoke.py, graphtrans_tpu_torch/, configs/ and data_snapshots/). Each
runs in a process of its own, in the order EARLIER, THIS, THIS, EARLIER,
through its own chip_smoke.py phases and package, building its kernels at
its first run. A run prints chip_smoke.py's lines (median, spread, device
split) under a header that names the tree, the card and its clocks.
"""

import os
import subprocess
import sys


def run_cells(root: str):
    """The cells with the tree at ``root``, in this process."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from graphtrans_tpu_torch.data.synthetic import (code2_bench_batch,
                                                     mol_bench_batch,
                                                     tu_bench_batch)
    from graphtrans_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = cs._smi()
    print(f"== {root}: built in {_build.build():.1f} s; {smi}; "
          f"{cs.CLOCKS}: {cs._smi(cs.CLOCKS)}", flush=True)
    big = mol_bench_batch(4096, cs.SEED)
    cs.phase6_step4096(device, big, smi)
    if hasattr(cs, "phase14_cost"):
        cs.phase14_cost(device, big, smi)
    bench, tasks = code2_bench_batch(cs.CODE2_BENCH, cs.SEED)
    cs.phase7_forward(device, bench, tasks, smi)
    cs.phase8_step512(device, bench, tasks, smi)
    cs.phase12_cost(device, tu_bench_batch(cs.NCI1_BENCH, cs.SEED), smi)
    bsp, bsp_tasks = code2_bench_batch(cs.CODE2_BENCH, cs.SEED, bsp=True)
    cs.phase13_cost(device, bsp, bsp_tasks, smi)
    print(f"== {root}: done; {cs._smi(cs.CLOCKS)}", flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        run_cells(argv[1])
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_cells: no CUDA card", file=sys.stderr)
        return 1
    earlier, this = argv
    for root in (earlier, this, this, earlier):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc:
            print(f"chip_cells: the run of {root} ended with {rc}",
                  file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
