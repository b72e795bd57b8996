"""nf-lint for the port: static analysis for capture-safety, device
syncs and protocol contracts.

Run it::

    python -m noahgameframe_tpu_torch.lint            # human-readable
    python -m noahgameframe_tpu_torch.lint --json     # machine-readable
    scripts/torch_nf_lint.py --rule capture-safety    # one rule only

The engine (``engine.py``) is the JAX package's, copied: stdlib-only —
no torch, no jax, no device — so it runs in CI, hooks and editors, and
the suppression tag ``# nf-lint: disable=<rule> -- <reason>`` is the
reference's letter for letter.  Rules live in ``rules_*.py`` and
register here.  The catalogue, in order, each rule beside its JAX
counterpart (``noahgameframe_tpu/lint/``):

- ``wall-clock`` — JAX's, unchanged.
- ``unseeded-rng`` — JAX's, plus torch's process-global generator: a
  ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` draw without ``generator=``, and
  ``torch.manual_seed``.
- ``pump-surface``, ``fsync-barrier``, ``drill-clockless``,
  ``journal-tap-guard`` — JAX's, unchanged (same files in the port).
- ``capture-safety`` — ``trace-safety``'s counterpart.  Roots are the
  port's (callgraph.py: cost-book dispatchers, graph or eager;
  ``add_phase``; ``torch.func.vmap``), not ``jax.jit``.  It flags
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``synchronize()``,
  ``int()``/``float()``/``bool()`` of a tensor-rooted value, ``print``,
  ``os.environ``, ``nonzero``/``masked_select`` and bool-mask indexing,
  and ``Tensor.view(dtype)`` under vmap; ``block_until_ready`` and
  ``np.asarray`` of a tracer have no port counterpart.
- ``recapture-hazard`` — ``recompile-hazard``'s counterpart.  There is
  no jit boundary with static arguments; what a captured step closes
  over instead (a ``self.<attr>`` a public method rebinds) must be named
  by ``Kernel._statics()`` or a ``capture_key()``.  Shapes from
  ``.tolist()`` or ``len(tensor)`` inside a captured step stay findings.
- ``struct-codec``, ``dispatch-handler`` — JAX's, unchanged; they scan
  every module, the split ``net/roles/game_*.py`` files included.
- ``serve-loop`` — JAX's, with ``GameRole``'s split files read as one
  method table.
- ``migrate-covers-store`` — JAX's, unchanged.
- ``mesh-not-captured`` — JAX's, over the port's roots.
- ``custom-op-parity-pinned`` — ``pallas-parity-pinned``'s counterpart:
  every ``torch.library.custom_op`` keyed in its module's
  ``CUSTOM_OP_PARITY_TESTS`` to a test that names its wrapper and plain
  version and carries the ``cuda`` marker (``interpret``'s place).
- ``room-axis-covered`` — JAX's, unchanged.
- ``train-lanes-covered`` — JAX's, reading the lanes dict that
  ``Kernel._step`` returns instead of ``_trace_step``'s ``out``.
"""

from __future__ import annotations

from .engine import (  # noqa: F401
    BAD_SUPPRESSION,
    Finding,
    PARSE_ERROR,
    PackageContext,
    Report,
    Rule,
    UNUSED_SUPPRESSION,
    load_baseline,
    run_lint,
    write_baseline,
)
from .rules_contracts import (
    DrillClocklessRule,
    FsyncBarrierRule,
    JournalTapGuardRule,
    PumpSurfaceRule,
)
from .rules_cuda import CustomOpParityPinnedRule
from .rules_determinism import UnseededRngRule, WallClockRule
from .rules_mesh import MeshNotCapturedRule
from .rules_rooms import RoomAxisCoveredRule
from .rules_serving import ServeLoopRule
from .rules_store import MigrateCoversStoreRule
from .rules_trace import CaptureSafetyRule, RecaptureHazardRule
from .rules_train import TrainLanesCoveredRule
from .rules_wire import DispatchHandlerRule, StructCodecRule

#: every shipped rule, in catalogue order (the JAX package's order, each
#: port rule in its counterpart's place)
ALL_RULES = (
    WallClockRule,
    UnseededRngRule,
    PumpSurfaceRule,
    FsyncBarrierRule,
    DrillClocklessRule,
    JournalTapGuardRule,
    CaptureSafetyRule,
    RecaptureHazardRule,
    StructCodecRule,
    DispatchHandlerRule,
    ServeLoopRule,
    MigrateCoversStoreRule,
    MeshNotCapturedRule,
    CustomOpParityPinnedRule,
    RoomAxisCoveredRule,
    TrainLanesCoveredRule,
)

RULES_BY_NAME = {cls.name: cls for cls in ALL_RULES}
