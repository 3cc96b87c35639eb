"""Batch inference: predictions for one split as JSONL (the counterpart of
the root ``predict.py``). Molecule and TU datasets give one
``{"graph_id", "logits"}`` record per graph (TU: one logit per class, and
the split's accuracy is printed); ogbg-code2 gives
``{"graph_id", "tokens", "seq"}`` (the argmax token of each of the
``max_seq_len`` positions, and the decoded subtokens up to the first
end-of-sequence) and prints the split's F1.

usage: python -m graphtrans_tpu_torch.predict --configs <molpcba, code2 or NCI1 yml> \
           --data_root data_snapshots --split test --batch_size 64 \
           --out preds.jsonl [--weights w.pt] [--seed 0] [--device cuda|cpu] \
           [--attn_backend auto|flash|smalls|chunked|dense|packed|packed_smalls]

The configs are GraphTrans (``configs/*/gnn-transformer/...``) or the
Transformer-only model (``configs/{molpcba,code2,NCI1}/transformer/
pooling=cls.yml``). NCI1 and NCI109 read TU files under ``--data_root``
and otherwise fall back to synthetic graphs (``data/tu.py``), split by
``--seed``.

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
from torch import nn

from . import models, resolve_device
from .data import dataset_kind
from .data.batch import bucket_size
from .data.code import CodeData, load_code_splits
from .data.evaluators import eval_acc, eval_f1_seq
from .data.loader import (dataset_caps, iterate_batches, pack_widths,
                          sample_pack_rows)
from .data.mol import load_mol_splits
from .data.tu import TUData, load_tu_splits
from .nn.init import init_weights
from .nn.transformer import CLI_BACKENDS, set_attn_backend
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
    p.add_argument("--runs", type=int, default=1,
                   help="accepted as the root predict.py's flag; serving "
                        "reads one model")
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
    p.add_argument("--num_vocab", type=int, default=5000,
                   help="ogbg-code2: target vocabulary size")
    p.add_argument("--max_seq_len", type=int, default=None,
                   help="ogbg-code2: target positions (default 5)")
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
    g.add_argument("--use_pallas", action="store_true",
                   help="accepted as the root main.py's flag; the port's "
                        "aggregations always run in their CUDA kernels on "
                        "the card")
    g.add_argument("--attn_backend", default="auto", choices=CLI_BACKENDS,
                   help="attention route, as the root main.py's flag: auto "
                        "(the JAX package's TPU rule), or force flash, "
                        "smalls, chunked, dense, packed or packed_smalls "
                        "(nn/transformer.py:attention_route)")
    return p


def load_splits(args):
    """(splits, num_tasks, data): the dataset's three splits (the snapshot
    under ``--data_root`` or the synthetic fallback); ``data`` is the
    ``data.code.CodeData`` of ogbg-code2 (vocabulary and node-encoder
    sizes), the ``data.tu.TUData`` of a TU dataset (split by ``--seed``),
    else None."""
    kind = dataset_kind(args.dataset)
    if kind == "mol":
        splits, num_tasks = load_mol_splits(args.data_root, args.dataset,
                                            args.synthetic_num_graphs,
                                            args.synthetic_seed)
        return splits, num_tasks, None
    if kind == "tu":
        tu = load_tu_splits(args.data_root, args.dataset,
                            args.synthetic_num_graphs, args.synthetic_seed,
                            args.seed)
        return tu.splits, tu.num_tasks, tu
    code = load_code_splits(args.data_root, args.dataset, args.num_vocab,
                            args.max_seq_len or 5, args.synthetic_num_graphs,
                            args.synthetic_seed)
    return code.splits, code.num_tasks, code


def serving_layout(splits: dict, args, num_tasks: int,
                   batch_size: Optional[int] = None,
                   split: Optional[str] = None, seed: int = 0) -> dict:
    """Batch layout of ``main.py:make_loaders`` for batches of
    ``batch_size`` graphs (default: the evaluation batch size) of
    ``split`` (default ``--split``). Returns the keyword arguments of
    ``iterate_batches``. ``seed`` is the loader's (``--seed`` for the
    shuffled train loader, 0 for evaluation): it draws code2's row caps.

    GraphTrans on molecules and TU graphs takes the strided layout (stride
    and per-graph edge slots bucketed from the largest graph of any split)
    and one tier of packed rows of width ``bucket_size(stride + 1, 128)``;
    on ogbg-code2 the flat layout (node and edge caps from every split)
    with the packing tiers of the split's largest graph
    (``loader.pack_widths``) and row caps sampled from the real packer
    (``loader.sample_pack_rows``). The
    Transformer-only model takes the flat layout on every dataset, unpacked:
    its dense width is ``bucket_size(n, 16)`` of the split's largest graph,
    capped at ``max_input_len``, as each loader of the JAX package sizes
    it (``graphtrans_tpu/data/loader.py:149``)."""
    graphs = sum(splits.values(), [])
    eval_bs = batch_size or args.eval_batch_size or args.batch_size
    node_cap, edge_cap = dataset_caps(graphs, max(
        args.batch_size, args.eval_batch_size or args.batch_size))
    kind = dataset_kind(args.dataset)
    code2 = kind == "code2"
    if code2 or args.model_type == "transformer":
        mine = splits[split or args.split]
        max_n = max(int(g["x"].shape[0]) for g in mine)
    if args.model_type == "transformer":
        targets = (dict(y_dtype="int32", max_seq_len=args.max_seq_len or 5)
                   if code2 else dict(y_dtype="int32") if kind == "tu"
                   else dict(y_dtype="float32"))
        return dict(batch_size=eval_bs, node_cap=node_cap, edge_cap=edge_cap,
                    num_tasks=num_tasks, max_input_len=args.max_input_len,
                    dense_cap=min(bucket_size(max_n, 16), args.max_input_len),
                    **targets)
    if code2:
        widths = pack_widths(max_n, args.max_input_len)
        rows = sample_pack_rows(mine, eval_bs, node_cap, edge_cap, widths,
                                args.max_input_len, seed)
        tiers = {}
        for t, (w, r) in enumerate(zip(widths, rows)):
            suffix = str(t + 1) if t else ""
            tiers[f"seq_pack_w{suffix}"] = w
            tiers[f"seq_pack_rows{suffix}"] = r
        return dict(batch_size=eval_bs, node_cap=node_cap, edge_cap=edge_cap,
                    num_tasks=num_tasks, y_dtype="int32",
                    max_seq_len=args.max_seq_len or 5,
                    max_input_len=args.max_input_len,
                    dense_cap=min(bucket_size(max_n, 16), args.max_input_len),
                    **tiers)
    max_n = max(int(g["x"].shape[0]) for g in graphs)
    max_e = max(int(g["edge_index"].shape[1]) for g in graphs)
    stride = bucket_size(max_n, 16)
    if max_n > 128 or stride > args.max_input_len:
        raise NotImplementedError(
            f"graphs of {max_n} nodes would take the flat layout, which the "
            "port runs for code2's GCN and the Transformer-only model only")
    pack_w = bucket_size(min(max_n, args.max_input_len) + 1, 128)
    return dict(batch_size=eval_bs, node_cap=(eval_bs + 1) * stride,
                edge_cap=edge_cap, num_tasks=num_tasks,
                y_dtype="int32" if kind == "tu" else "float32",
                max_input_len=args.max_input_len, node_stride=stride,
                dense_edge_cap=bucket_size(max_e, 8), seq_pack_w=pack_w)


def build_model(args, num_tasks: int, device, data=None) -> nn.Module:
    """The config's model (``--model_type``) in eval mode, with
    ``--weights`` or random weights drawn from ``--seed``, its attention on
    ``--attn_backend``; ``data`` as ``load_splits`` returns it."""
    model = models.build_model(args, num_tasks, device=device, data=data)
    set_attn_backend(model, args.attn_backend)
    if args.weights:
        model.load_state_dict(torch.load(args.weights, map_location=device,
                                         weights_only=True))
    else:
        init_weights(model, torch.Generator().manual_seed(args.seed or 0))
    return model.eval()


def predict_split(model: nn.Module, graphs, layout: dict, out: str,
                  device, data=None) -> dict:
    """Write one JSON record per graph of ``graphs`` to ``out``; with
    ``data`` a ``CodeData`` (ogbg-code2) the records hold tokens and
    subtokens, and the result the split's precision, recall and F1; with a
    ``TUData`` the result holds the split's accuracy (argmax of the
    logits against each graph's class)."""
    code = data if isinstance(data, CodeData) else None
    tu = isinstance(data, TUData)
    n_rec = n_batch = 0
    refs, preds = [], []
    with open(out, "w") as f, torch.inference_mode():
        for batch in iterate_batches(graphs, **layout):
            logits = model(batch.to(device)).float()
            if code is not None:
                tokens = logits.argmax(-1).cpu().numpy()        # [G, L]
            else:
                logits = logits.cpu().numpy()
            for i in np.nonzero(batch.graph_mask)[0]:
                gid = int(batch.graph_ids[i])
                rec = {"graph_id": gid}
                if code is not None:
                    rec["tokens"] = [int(t) for t in tokens[i]]
                    rec["seq"] = code.arr_to_seq(tokens[i])
                    refs.append(graphs[gid]["y_seq"])
                    preds.append(rec["seq"])
                else:
                    rec["logits"] = [float(v) for v in logits[i]]
                    if tu:
                        refs.append(int(graphs[gid]["y"].reshape(-1)[0]))
                        preds.append(int(logits[i].argmax()))
                f.write(json.dumps(rec) + "\n")
                n_rec += 1
            n_batch += 1
    result = {"records": n_rec, "batches": n_batch, "out": out}
    if code is not None:
        result.update(eval_f1_seq(refs, preds))
    if tu:
        result.update(eval_acc(np.array(refs), np.array(preds)))
    return result


def main(argv: Optional[list] = None) -> dict:
    args = parse_with_config(build_parser(), argv)
    device = resolve_device(args.device)
    splits, num_tasks, data = load_splits(args)
    layout = serving_layout(splits, args, num_tasks)
    model = build_model(args, num_tasks, device, data)
    result = predict_split(model, splits[args.split], layout, args.out,
                           device, data)
    print(f"wrote {result['records']} predictions ({result['batches']} "
          f"batches) to {args.out}")
    if "acc" in result:
        print(f"{args.split} acc {result['acc']:.6f}")
    if "F1" in result:
        print(f"{args.split} F1 {result['F1']:.6f} (precision "
              f"{result['precision']:.6f}, recall {result['recall']:.6f})")
    return result


if __name__ == "__main__":
    main()
