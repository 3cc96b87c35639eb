"""Training entry: the single-chip training loop of the root ``main.py``
for the molecule datasets, ogbg-code2 and the TU datasets (NCI1, NCI109),
GraphTrans and the Transformer-only model.

usage: python -m graphtrans_tpu_torch.main --configs <molpcba, code2 or NCI1 yml> \
           --data_root data_snapshots --epochs 2 --batch_size 64 --seed 0 \
           [--save_path DIR] [--device cuda|cpu] [--attn_backend ...]

It trains on the train split (each snapshot holds 192 training graphs),
shuffled each epoch as the JAX package's ``GraphLoader`` shuffles, with
AdamW and the config's dropout, and prints one JSON line per epoch: epoch,
steps, mean loss, lr, seconds and graphs per second on the device it ran
on. Molecules take the masked BCE loss, ogbg-code2 the per-position
sequence loss (``train/losses.py:seq_token_loss``), the TU datasets the
cross-entropy over one class per graph (``classification_loss``; their
split is drawn from ``--seed``). GraphTrans on molecules and TU graphs
trains in the strided layout with one tier of packed transformer rows
(NCI1's GCN sums in K6 and its backward); on ogbg-code2 in the flat
layout with the packing tiers of the train split's largest graph
(1024/384/128 on the snapshot) and row caps sampled from ``--seed`` (a
batch that overflows them is split). The Transformer-only model
(``model_type transformer``,
``configs/{molpcba,code2,NCI1}/transformer/pooling=cls.yml``) trains in the
flat unpacked layout at the train split's dense width, its attention in
K4 or K5 with their dropout (``predict.serving_layout``).
``--attn_backend`` (the root ``main.py``'s choices) picks the attention
route as ``predict`` does; the kernels' dropout seeds are drawn one per
layer per step. With ``--save_path`` it writes ``last_model.pt``, a state
dict that ``python -m graphtrans_tpu_torch.predict --weights`` serves. It
runs on the card unless ``--device cpu`` is given, and raises without
CUDA.

Weights are drawn from ``--seed`` (default 0), and so are the two dropout
generators (``nn/dropout.py:Generators``). With ``--scheduler plateau`` the
lr stays at ``--lr``: the plateau scheduler steps on a valid metric, and
evaluation arrives with slice 12, as do split metrics, multi-run, resume
and checkpoints, FLAG and ``onecycle``; the parallel modes arrive with
slice 13. A flag that asks for one of these raises NotImplementedError
naming its slice.

The run is f32 unless ``--precision bf16`` (the root ``main.py``'s flag):
then the forward and backward run in bfloat16 on a copy of the float32
master parameters, with the loss, BatchNorm's statistics, the gradients
and AdamW's state in float32 (``train/precision.py``, the JAX trainer's
cast); the kernels of the path run their bf16 instances (molpcba
GraphTrans: K1, K1-bwd, K2 and K2-bwd; code2 GraphTrans: K7, K7-bwd, K2,
K2-bwd, K3 and K3-bwd; the Transformer-only model: K4, K4-bwd, K5 and
K5-bwd at heads of 64, and the plain route), and cuBLAS sums the bf16
products in float32. bf16 runs the molpcba GraphTrans configs (GIN on
the strided layout), the code2 GraphTrans configs (GCN on the flat
layout) and the Transformer-only configs (molpcba, code2, NCI1 and
NCI109) under ``--attn_backend auto``; every other model, dataset and
backend, K11 and the blocked route raise NotImplementedError naming
slice 10 (``utils/config.py:check_ported``; ``set_block_spmm``'s route
in ``nn/conv.py``). ``--save_path`` writes the float32 masters, which
``predict --weights`` serves in float32.
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
from .models import build_model
from .nn.dropout import Generators
from .nn.init import init_weights
from .nn.transformer import set_attn_backend
from .train.losses import dataset_loss
from .train.optim import build_optimizer
from .trainers.base_trainer import make_train_step, train
from .utils.config import add_training_args, check_ported, parse_with_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    predict.add_model_args(p)
    add_training_args(p)
    p.set_defaults(batch_size=128)      # the root main.py's default
    return p


def build_run(args, num_tasks: int, device, steps_per_epoch: int,
              data=None):
    """The run's model (``--model_type``, weights from ``--seed``; ``data``
    as ``predict.load_splits`` returns it), optimizer and train step with
    the dataset's loss, whose dropout generators are seeded from
    ``--seed`` too."""
    seed = args.seed or 0
    model = build_model(args, num_tasks, device=device, data=data)
    init_weights(model, torch.Generator().manual_seed(seed))
    set_attn_backend(model, args.attn_backend)
    optimizer = build_optimizer(model, args, steps_per_epoch)
    step = make_train_step(model, dataset_loss(args.dataset), optimizer,
                           Generators.seeded(seed, device), args.precision)
    return model, optimizer, step


def main(argv: Optional[list] = None) -> dict:
    args = parse_with_config(build_parser(), argv)
    check_ported(args)
    device = resolve_device(args.device)
    seed = args.seed or 0
    splits, num_tasks, data = predict.load_splits(args)
    graphs = splits["train"]
    layout = predict.serving_layout(splits, args, num_tasks, args.batch_size,
                                    split="train", seed=seed)
    model, optimizer, step = build_run(
        args, num_tasks, device, -(-len(graphs) // args.batch_size), data)
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
               "precision": args.precision,
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
