"""Which configs ``check_ported`` lets through, over all 34 ymls under
``configs/`` in f32 and in bf16 under every attention backend of the
command line: a model option the port lacks (the GCN ``pos_encoder``
ymls) names slice 11 in both precisions; the eight bf16 ymls (the molpcba
and code2 GraphTrans and the four Transformer-only ymls) pass under every
backend; and in bf16 on the card a head width that no bf16 instance of
the config's attention routes takes names slice 10, where on the CPU the
plain versions take any."""

import pathlib

import pytest

from graphtrans_tpu_torch import main as tmain
from graphtrans_tpu_torch.nn.transformer import CLI_BACKENDS
from graphtrans_tpu_torch.utils.config import (bf16_head_dims, bf16_routes,
                                               check_ported,
                                               parse_with_config)

REPO = pathlib.Path(__file__).resolve().parents[1]
YMLS = sorted(str(p.relative_to(REPO))
              for p in (REPO / "configs").rglob("*.yml"))
BF16_YMLS = {
    "configs/molpcba/gnn-transformer/JK=cat/pooling=cls+gin+norm_input.yml",
    "configs/molpcba/gnn-transformer/no-virtual/JK=cat/"
    "pooling=cls+gin+norm_input.yml",
    "configs/code2/gnn-transformer/JK=cat/pooling=cls+norm_input.yml",
    "configs/code2/gnn-transformer/no-virtual/pooling=cls+norm_input.yml",
    "configs/molpcba/transformer/pooling=cls.yml",
    "configs/code2/transformer/pooling=cls.yml",
    "configs/NCI1/transformer/pooling=cls.yml",
    "configs/NCI109/transformer/pooling=cls.yml"}


def _args(config, *flags):
    return parse_with_config(tmain.build_parser(), [
        "--configs", str(REPO / config), "--runs", "1", *flags])


def _refusal(args):
    """check_ported's message, or None where it passes."""
    try:
        check_ported(args)
    except NotImplementedError as err:
        return str(err)
    return None


def test_the_34_ymls():
    assert len(YMLS) == 34 and BF16_YMLS <= set(YMLS)


@pytest.mark.parametrize("config", YMLS)
def test_check_ported_over_the_ymls(config):
    """A ``pos_encoder`` yml names slice 11 in f32 and bf16 (before this
    check it passed and failed at build, naming none); a bf16 yml passes
    in both precisions under every backend of the command line, on the card
    and on the CPU; every other yml raises in bf16, naming slice 10 where
    its model is ported and slice 11 where it is not."""
    pos = "pos_encoder" in config
    for precision in ("f32", "bf16"):
        for backend in CLI_BACKENDS:
            for device in ([], ["--device", "cpu"]):
                why = _refusal(_args(config, "--precision", precision,
                                     "--attn_backend", backend, *device))
                if pos:
                    assert why is not None and "slice 11" in why
                    assert "pos_encoder" in why or "gnn_type gin" in why
                elif config in BF16_YMLS:
                    assert why is None, (precision, backend, device, why)
                elif precision == "bf16":
                    assert why is not None
                    assert ("slice 11" in why) != ("slice 10" in why), why
                if why is not None and "slice 11" in why:
                    assert "slice 10" not in why


@pytest.mark.parametrize("config,nhead,hd,refused", [
    # molpcba Transformer-only at d 256: heads of 32 off K4 and K9 (64)
    ("configs/molpcba/transformer/pooling=cls.yml", 8, 32,
     {"auto", "smalls", "packed_smalls"}),
    # at heads of 128 off K5 (32, 64) too
    ("configs/molpcba/transformer/pooling=cls.yml", 2, 128,
     {"auto", "smalls", "packed_smalls", "flash"}),
    # code2 GraphTrans at d 128: heads of 64 off K2 and K3 (32); K5's
    # segment form takes 64, but flash also takes K3 above 384
    ("configs/code2/gnn-transformer/no-virtual/pooling=cls+norm_input.yml",
     2, 64, {"auto", "flash"}),
    ("configs/code2/gnn-transformer/no-virtual/pooling=cls+norm_input.yml",
     4, 32, set()),
])
def test_bf16_head_widths_no_instance_takes_name_slice_10(config, nhead, hd,
                                                          refused):
    """In bf16 on the card a head width that no bf16 instance of one of the
    config's attention routes (over rows of every width) takes raises
    NotImplementedError naming slice 10 under exactly the backends whose
    routes hold such an instance; the plain and chunked routes take any;
    on the CPU every backend passes; f32 is not checked."""
    for backend in CLI_BACKENDS:
        flags = ["--nhead", str(nhead), "--attn_backend", backend]
        why = _refusal(_args(config, "--precision", "bf16", *flags))
        if backend in refused:
            assert why is not None and "slice 10" in why, backend
            assert f"heads of {hd} " in why
        else:
            assert why is None, (backend, why)
        assert _refusal(_args(config, "--precision", "bf16", "--device",
                              "cpu", *flags)) is None
        assert _refusal(_args(config, *flags)) is None


def test_bf16_routes_cover_the_kernels_of_each_backend():
    """``bf16_routes`` over ROUTE_WIDTHS gives the JAX package's TPU routes
    of each model under each backend at the published widths, and
    ``bf16_head_dims`` the widths of the bf16 instances: K2 and K3 32, K4
    and K9 64, K5 32 and 64."""
    tf = _args("configs/molpcba/transformer/pooling=cls.yml")
    gt = _args("configs/code2/gnn-transformer/no-virtual/"
               "pooling=cls+norm_input.yml")
    want_tf = {"auto": {"k4", "k5", "plain"}, "flash": {"k5"},
               "smalls": {"k9"}, "chunked": {"chunked"}, "dense": {"plain"},
               "packed": {"plain"}, "packed_smalls": {"k9", "plain"}}
    want_gt = {"auto": {"k2", "k3"}, "flash": {"k3", "k5", "plain"}}
    for backend in CLI_BACKENDS:
        tf.attn_backend = gt.attn_backend = backend
        assert bf16_routes(tf) == want_tf[backend], backend
        assert bf16_routes(gt) == want_gt.get(backend, {"plain"}), backend
    assert bf16_head_dims() == {"k2": (32,), "k3": (32,), "k4": (64,),
                                "k5": (32, 64), "k9": (64,)}
