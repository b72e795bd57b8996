"""custom-op-parity-pinned violations: a custom op the registry never
names, plus a stale registry key whose op vanished."""
import torch

CUSTOM_OP_PARITY_TESTS = {
    "nf::vanished_fold": "ops/parity_pin.py",  # stale: the op is gone
}


@torch.library.custom_op("nf::fused_fold", mutates_args=())
def _fused_fold_op(x: torch.Tensor) -> torch.Tensor:  # not in the registry
    return x * 2.0


def fused_fold_plain(x):
    return x * 2.0


def fused_fold(x):
    if x.device.type == "cpu":
        return fused_fold_plain(x)
    return torch.ops.nf.fused_fold(x)
