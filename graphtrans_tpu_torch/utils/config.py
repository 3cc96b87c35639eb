"""Flat ``key: value`` YAML configs as argparse defaults.

The experiment configs under ``configs/`` are flat mappings of flag names to
scalars; this reader covers exactly that (the machine with the card has no
pyyaml). Keys match a parser option by dest with '-' read as '_'; keys the
parser does not know (training settings such as ``lr``) are ignored. Values
given on the command line override the config."""

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


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """Parse ``argv`` with ``--configs <yml>`` values as defaults."""
    pre, _ = parser.parse_known_args(argv)
    if getattr(pre, "configs", None):
        dests = {a.dest: a for a in parser._actions}
        defaults = {}
        for key, value in read_flat_yaml(pre.configs).items():
            action = dests.get(key.replace("-", "_"))
            if action is None:
                continue
            if action.type is not None and value is not None:
                value = action.type(value)
            defaults[action.dest] = value
        parser.set_defaults(**defaults)
    return parser.parse_args(argv)
