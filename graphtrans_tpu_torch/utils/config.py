"""Flat ``key: value`` YAML configs as argparse defaults.

The experiment configs under ``configs/`` are flat mappings of flag names to
scalars; this reader covers exactly that (the machine with the card has no
pyyaml). Keys match a parser option by dest with '-' read as '_'; keys the
parser does not know (``lr`` for ``predict``, say) are ignored. Values
given on the command line override the config, and the config overrides
the dataset's defaults (``DATASET_DEFAULTS``), which override the parser's
own: the three stages of the root ``main.py``."""

from __future__ import annotations

import argparse


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def read_flat_yaml(path: str) -> dict:
    out = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if line[0].isspace() or ":" not in line:
                raise ValueError(f"{path}:{n}: not a flat 'key: value' line")
            key, value = line.split(":", 1)
            out[key.strip()] = _scalar(value)
    return out


def add_training_args(parser: argparse.ArgumentParser):
    """The training flags of the root ``main.py`` that the port's training
    entry reads, with the same defaults, and the flags of its later slices,
    which ``check_ported`` turns away."""
    g = parser.add_argument_group("training")
    g.add_argument("--epochs", type=int, default=30)
    g.add_argument("--lr", type=float, default=0.001)
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--grad_clip", type=float, default=None)
    g.add_argument("--scheduler", type=str, default=None)
    g.add_argument("--gnn_dropout", type=float, default=0.0)
    g.add_argument("--transformer_dropout", type=float, default=0.3)
    g.add_argument("--save_path", default=None,
                   help="directory for last_model.pt (a state dict)")
    g = parser.add_argument_group("later slices")
    g.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    g.add_argument("--aug", default="baseline")
    g.add_argument("--runs", type=int, default=1)
    g.add_argument("--resume", default=None)
    for flag in ("dp_shards", "tp_shards", "hybrid_shards"):
        g.add_argument(f"--{flag}", type=int, default=1)
    g.add_argument("--sp", action="store_true")
    g.add_argument("--multihost", action="store_true")
    return parser


_LATER = (
    ("aug", lambda v: v != "baseline", "FLAG arrives with slice 12"),
    ("runs", lambda v: v != 1, "the multi-run loop arrives with slice 12"),
    ("resume", lambda v: v is not None,
     "checkpoints and resume arrive with slice 12"),
    ("dp_shards", lambda v: v != 1, "data parallelism arrives with slice 13"),
    ("tp_shards", lambda v: v != 1, "GSPMD arrives with slice 13"),
    ("hybrid_shards", lambda v: v != 1,
     "node-sharded training arrives with slice 13"),
    ("sp", bool, "sequence parallelism arrives with slice 13"),
    ("multihost", bool, "multi-host training arrives with slice 13"),
)


# the ``set_defaults`` of each dataset util's ``add_args`` in the JAX
# package (``data/mol.py:MolUtil``, ``data/code.py:CodeUtil``,
# ``data/tu.py:TUUtil``), by dataset name
_MOL = dict(batch_size=32, epochs=100, gnn_dropout=0.5)
_TU = dict(batch_size=128, epochs=10000, lr=0.0005, weight_decay=0.0001,
           gnn_dropout=0.5, gnn_emb_dim=128)
DATASET_DEFAULTS = {"ogbg-molhiv": _MOL, "ogbg-molpcba": _MOL,
                    "ogbg-code2": dict(max_seq_len=5),
                    "NCI1": _TU, "NCI109": _TU}


# the paths that run in bf16, by model: the GraphTrans model's (dataset
# kind, gnn_type) pairs of slice 10's first part (GIN on the molecule
# datasets, the strided layout: K1, K2) and its second (GCN on code2, the
# flat layout: K7, K2, K3); and the Transformer-only model's dataset kinds
# of its part 3a (K4, K5 and the plain route)
BF16_PATHS = {"gnn-transformer": (("mol", "gin"), ("code2", "gcn")),
              "transformer": ("mol", "code2", "tu")}


def _bf16_refusal(args):
    """Why ``--precision bf16`` cannot run this config yet, or None: slice
    10's parts 1, 2 and 3a run ``BF16_PATHS`` under ``--attn_backend
    auto``."""
    from ..data import dataset_kind

    model_type = getattr(args, "model_type", "gnn-transformer")
    paths = BF16_PATHS.get(model_type)
    if paths is None:
        return f"model_type {model_type}"
    kind = dataset_kind(getattr(args, "dataset", "ogbg-molpcba"))
    if model_type == "transformer":
        if kind not in paths:
            return f"dataset {args.dataset} on model_type transformer"
    elif kind not in dict(paths):
        return f"dataset {args.dataset}"
    else:
        gnn_type = getattr(args, "gnn_type", "gin")
        if (kind, gnn_type) not in paths:
            return f"gnn_type {gnn_type} on {kind}"
    if getattr(args, "attn_backend", "auto") != "auto":
        return f"--attn_backend {args.attn_backend}"
    return None


def _model_refusal(args):
    """Why the port has no model for this config yet, or None: the models
    and compositions of slice 11 (``models/gnn_transformer.py:_PORTED``;
    the Transformer-only model is ported)."""
    from ..data import dataset_kind
    from ..models.gnn_transformer import _PORTED

    model_type = getattr(args, "model_type", "gnn-transformer")
    if model_type == "transformer":
        return None
    if model_type != "gnn-transformer":
        return f"model_type {model_type}"
    kind = dataset_kind(getattr(args, "dataset", "ogbg-molpcba"))
    gnn_type = getattr(args, "gnn_type", "gin")
    if (kind, gnn_type) not in _PORTED:
        return f"gnn_type {gnn_type} on {kind}"
    return None


def check_ported(args):
    """Raise NotImplementedError, naming its slice, for a flag that asks
    for something the port does not do yet: a model the port lacks names
    slice 11 first, in either precision; then bf16 off slice 10's paths."""
    for key, asks, why in _LATER:
        value = getattr(args, key)
        if asks(value):
            raise NotImplementedError(f"--{key} {value}: {why}")
    why = _model_refusal(args)
    if why is not None:
        raise NotImplementedError(
            f"{why}: the model arrives with slice 11 (the remaining models)")
    if getattr(args, "precision", "f32") == "bf16":
        why = _bf16_refusal(args)
        if why is not None:
            raise NotImplementedError(
                f"--precision bf16 with {why}: bf16 arrives there with "
                f"slice 10 (its parts 1 and 2 run the molpcba and code2 "
                f"GraphTrans, part 3a the Transformer-only model, under "
                f"--attn_backend auto; part 3b brings the other backends "
                f"and K11)")


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """Parse ``argv`` with ``--configs <yml>`` values as defaults, over the
    defaults of the dataset the command line or the config names."""
    dests = {a.dest: a for a in parser._actions}
    pre, _ = parser.parse_known_args(argv)
    config = {}
    if getattr(pre, "configs", None):
        for key, value in read_flat_yaml(pre.configs).items():
            action = dests.get(key.replace("-", "_"))
            if action is None:
                continue
            if action.type is not None and value is not None:
                value = action.type(value)
            config[action.dest] = value
        parser.set_defaults(**config)
        pre, _ = parser.parse_known_args(argv)
    stage = DATASET_DEFAULTS.get(getattr(pre, "dataset", None), {})
    parser.set_defaults(**{k: v for k, v in stage.items() if k in dests})
    parser.set_defaults(**config)
    return parser.parse_args(argv)
