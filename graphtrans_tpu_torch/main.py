"""Training entry: the single-chip baseline training loop of the root
``main.py`` for the molecule datasets.

usage: python -m graphtrans_tpu_torch.main --configs <molpcba yml> \
           --data_root data_snapshots --epochs 2 --batch_size 64 --seed 0 \
           [--save_path DIR] [--device cuda|cpu]

It trains on the train split (the molpcba snapshot holds 192 molecules) in
the strided layout with one tier of packed transformer rows, shuffled each
epoch as the JAX package's ``GraphLoader`` shuffles, with AdamW and the
config's dropout, and prints one JSON line per epoch: epoch, steps, mean
loss, lr, seconds and graphs per second on the device it ran on. With
``--save_path`` it writes ``last_model.pt``, a state dict that
``python -m graphtrans_tpu_torch.predict --weights`` serves. It runs on the
card unless ``--device cpu`` is given, and raises without CUDA.

Weights are drawn from ``--seed`` (default 0), and so are the two dropout
generators (``nn/dropout.py:Generators``). With ``--scheduler plateau`` the
lr stays at ``--lr``: the plateau scheduler steps on a valid metric, and
evaluation arrives with slice 6, as do split metrics, multi-run, resume and
checkpoints, FLAG and ``onecycle``, and the parallel modes with slice 7. A
flag that asks for one of these raises NotImplementedError naming its
slice; ogbg-code2 training arrives with slice 4, and bf16
(``--precision``) after it. The run is f32.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from . import predict, resolve_device
from .data.loader import iterate_batches, shuffled_order
from .data.mol import load_mol_splits
from .models.gnn_transformer import build_gnn_transformer
from .nn.dropout import Generators
from .nn.init import init_weights
from .train.losses import binary_multitask_loss
from .train.optim import build_optimizer
from .trainers.base_trainer import make_train_step, train
from .utils.config import add_training_args, check_ported, parse_with_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    predict.add_model_args(p)
    add_training_args(p)
    p.set_defaults(batch_size=128)      # the root main.py's default
    return p


def build_run(args, num_tasks: int, device, steps_per_epoch: int):
    """The run's model (weights from ``--seed``), optimizer and train step,
    whose dropout generators are seeded from ``--seed`` too."""
    seed = args.seed or 0
    model = build_gnn_transformer(args, num_tasks, device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    optimizer = build_optimizer(model, args, steps_per_epoch)
    step = make_train_step(model, binary_multitask_loss, optimizer,
                           Generators.seeded(seed, device))
    return model, optimizer, step


def main(argv: Optional[list] = None) -> dict:
    args = parse_with_config(build_parser(), argv)
    check_ported(args)
    device = resolve_device(args.device)
    if args.dataset == "ogbg-code2":
        raise NotImplementedError(
            "ogbg-code2 training (the K3 and K7 backward kernels, the "
            "sequence loss) arrives with slice 4 (code2 training)")
    if not args.dataset.startswith("ogbg-mol"):
        raise NotImplementedError(f"dataset {args.dataset}: the port trains "
                                  "the ogbg-mol* datasets")
    seed = args.seed or 0
    splits, num_tasks = load_mol_splits(args.data_root, args.dataset,
                                        args.synthetic_num_graphs,
                                        args.synthetic_seed)
    graphs = splits["train"]
    layout = predict.serving_layout(splits, args, num_tasks, args.batch_size)
    model, optimizer, step = build_run(
        args, num_tasks, device, -(-len(graphs) // args.batch_size))
    records = []
    for epoch in range(1, args.epochs + 1):
        stats: dict = {}
        t0 = time.perf_counter()
        batches = iterate_batches(
            graphs, order=shuffled_order(len(graphs), seed, epoch - 1),
            **layout)
        loss = train(step, batches, device, stats=stats)
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        rec = {"epoch": epoch, "steps": stats.get("steps", 0), "loss": loss,
               "lr": optimizer.lr, "seconds": secs,
               "graphs_per_s": stats.get("graphs", 0) / max(secs, 1e-9),
               "device": (torch.cuda.get_device_name(device) if on_card
                          else "cpu")}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    saved = None
    if args.save_path:
        os.makedirs(args.save_path, exist_ok=True)
        saved = os.path.join(args.save_path, "last_model.pt")
        torch.save(model.state_dict(), saved)
    return {"epochs": records, "saved": saved}


if __name__ == "__main__":
    main()
