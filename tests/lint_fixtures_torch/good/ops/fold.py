"""Pinned custom op: the registry names the card-only parity test of the
one custom op, and nothing is stale."""
import torch

CUSTOM_OP_PARITY_TESTS = {
    "nf::fused_fold": "ops/parity_pin.py",
}


@torch.library.custom_op("nf::fused_fold", mutates_args=())
def _fused_fold_op(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def fused_fold_plain(x):
    return x * 2.0


def fused_fold(x):
    if x.device.type == "cpu":
        return fused_fold_plain(x)
    return torch.ops.nf.fused_fold(x)
