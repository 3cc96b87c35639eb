"""Batch inference: predictions for one split of a molecule dataset as JSONL,
one ``{"graph_id", "logits"}`` record per graph (the counterpart of the
root ``predict.py``).

usage: python -m graphtrans_tpu_torch.predict --configs <molpcba yml> \
           --data_root data_snapshots --split test --batch_size 64 \
           --out preds.jsonl [--weights w.pt] [--seed 0] [--device cuda|cpu]

Weights come from ``--weights`` (a ``torch.save``d state dict of this
package's model, e.g. converted from the JAX package with
``utils/flax_weights.py``) or are drawn at random from ``--seed``. Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .data.batch import bucket_size
from .data.loader import dataset_caps, iterate_batches
from .data.mol import load_mol_splits
from .models.gnn_transformer import GNNTransformer, build_gnn_transformer
from .nn.init import init_weights
from .ops.kernels.attention_packed import W_MAX
from .utils.config import parse_with_config


def build_parser() -> argparse.ArgumentParser:
    """The flags of the root ``main.py``/``predict.py`` that serving reads,
    with their defaults (molecule datasets: batch size 32)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--split", default="test", choices=["train", "valid", "test"])
    p.add_argument("--out", default="predictions.jsonl")
    p.add_argument("--weights", default=None,
                   help="state dict saved with torch.save (default: random "
                        "weights from --seed)")
    return add_model_args(p)


def add_model_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Config, data, device and model flags, shared with the training
    entry (``main.py``)."""
    p.add_argument("--configs", default=None)
    p.add_argument("--data_root", default="data_root")
    p.add_argument("--dataset", default="ogbg-molpcba")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--eval_batch_size", type=int, default=None)
    p.add_argument("--synthetic_num_graphs", type=int, default=400)
    p.add_argument("--synthetic_seed", type=int, default=0)
    g = p.add_argument_group("model")
    g.add_argument("--model_type", default="gnn")
    g.add_argument("--graph_pooling", default="mean")
    g.add_argument("--gnn_type", default="gcn")
    g.add_argument("--gnn_virtual_node", action="store_true")
    g.add_argument("--gnn_num_layer", type=int, default=5)
    g.add_argument("--gnn_emb_dim", type=int, default=300)
    g.add_argument("--gnn_JK", default="last")
    g.add_argument("--gnn_residual", action="store_true")
    g.add_argument("--d_model", type=int, default=128)
    g.add_argument("--nhead", type=int, default=4)
    g.add_argument("--dim_feedforward", type=int, default=512)
    g.add_argument("--transformer_activation", default="relu")
    g.add_argument("--num_encoder_layers", type=int, default=4)
    g.add_argument("--max_input_len", type=int, default=1000)
    g.add_argument("--transformer_norm_input", action="store_true")
    g.add_argument("--num_encoder_layers_masked", type=int, default=0)
    g.add_argument("--transformer_prenorm", action="store_true")
    g.add_argument("--pos_encoder", action="store_true")
    return p


def serving_layout(splits: dict, args, num_tasks: int,
                   batch_size: Optional[int] = None) -> dict:
    """Batch layout of ``main.py:resolve_dense_layout``/``make_loaders`` for
    molecules: the strided layout (stride and per-graph edge slots bucketed
    from the largest graph of any split) and one tier of packed transformer
    rows of width ``bucket_size(stride + 1, 128)``, for batches of
    ``batch_size`` graphs (default: the evaluation batch size). Returns the
    keyword arguments of ``iterate_batches``."""
    graphs = sum(splits.values(), [])
    eval_bs = batch_size or args.eval_batch_size or args.batch_size
    _, edge_cap = dataset_caps(graphs, max(
        args.batch_size, args.eval_batch_size or args.batch_size))
    max_n = max(int(g["x"].shape[0]) for g in graphs)
    max_e = max(int(g["edge_index"].shape[1]) for g in graphs)
    stride = bucket_size(max_n, 16)
    if max_n > 128 or stride > args.max_input_len:
        raise NotImplementedError(
            f"graphs of {max_n} nodes take the flat layout, which arrives "
            "with slice 3 (code2)")
    pack_w = bucket_size(min(max_n, args.max_input_len) + 1, 128)
    if pack_w > W_MAX:
        raise NotImplementedError("multi-tier packing arrives with slice 3")
    return dict(batch_size=eval_bs, node_cap=(eval_bs + 1) * stride,
                edge_cap=edge_cap, num_tasks=num_tasks, y_dtype="float32",
                max_input_len=args.max_input_len, node_stride=stride,
                dense_edge_cap=bucket_size(max_e, 8), seq_pack_w=pack_w)


def build_model(args, num_tasks: int, device) -> GNNTransformer:
    """The config's model in eval mode, with ``--weights`` or random
    weights drawn from ``--seed``."""
    model = build_gnn_transformer(args, num_tasks, device=device)
    if args.weights:
        model.load_state_dict(torch.load(args.weights, map_location=device,
                                         weights_only=True))
    else:
        init_weights(model, torch.Generator().manual_seed(args.seed or 0))
    return model.eval()


def predict_split(model: GNNTransformer, graphs, layout: dict, out: str,
                  device) -> dict:
    """Write one JSON record per graph of ``graphs`` to ``out``."""
    n_rec = n_batch = 0
    with open(out, "w") as f, torch.inference_mode():
        for batch in iterate_batches(graphs, **layout):
            logits = model(batch.to(device)).float().cpu().numpy()
            for i in np.nonzero(batch.graph_mask)[0]:
                f.write(json.dumps({
                    "graph_id": int(batch.graph_ids[i]),
                    "logits": [float(v) for v in logits[i]]}) + "\n")
                n_rec += 1
            n_batch += 1
    return {"records": n_rec, "batches": n_batch, "out": out}


def main(argv: Optional[list] = None) -> dict:
    args = parse_with_config(build_parser(), argv)
    device = resolve_device(args.device)
    if not args.dataset.startswith("ogbg-mol"):
        raise NotImplementedError(f"dataset {args.dataset}: slice 1 serves "
                                  "the ogbg-mol* datasets")
    splits, num_tasks = load_mol_splits(args.data_root, args.dataset,
                                        args.synthetic_num_graphs,
                                        args.synthetic_seed)
    layout = serving_layout(splits, args, num_tasks)
    model = build_model(args, num_tasks, device)
    result = predict_split(model, splits[args.split], layout, args.out, device)
    print(f"wrote {result['records']} predictions ({result['batches']} "
          f"batches) to {args.out}")
    return result


if __name__ == "__main__":
    main()
