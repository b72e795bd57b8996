"""nf-lint of the PyTorch port (noahgameframe_tpu_torch/lint/).

Mirrors tests/test_lint.py and tests/test_determinism_lint.py case for
case, on the port's rules and fixtures (tests/lint_fixtures_torch/), and
adds:

- cross-package parity: the eleven rules whose logic is tied neither to
  the call graph's roots nor to the kernel's shape (determinism,
  contracts, wire, serve-loop, store, rooms) give, through the port's
  engine, exactly the JAX engine's findings and JSON counts on the JAX
  fixtures and on the JAX package itself;
- the port package gate (zero open findings, no stale baseline entry,
  every waiver reasoned) and injection probes through ``overrides=``
  (an ``.item()`` in ``ops/verlet.py:need_rebuild``, a sync in the combat
  phase's fold, a ``Tensor.view(dtype)`` on a vmapped path, a custom-op
  registry missing an op or holding a stale key);
- the port's refinements of "tensor-rooted", each held by a pair of
  snippets: quiet as written, flagged once the refinement no longer
  applies.

The lint never imports torch, so no thread pin is needed; the package
reports are shared per module.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

import noahgameframe_tpu.lint as jax_lint
from noahgameframe_tpu_torch.lint import ALL_RULES, RULES_BY_NAME, run_lint
from noahgameframe_tpu_torch.lint.callgraph import (
    ROOT_KINDS,
    capture_sites,
    captured_reachable,
)
from noahgameframe_tpu_torch.lint.engine import (
    BAD_SUPPRESSION,
    UNUSED_SUPPRESSION,
    PackageContext,
    write_baseline,
)
from noahgameframe_tpu_torch.lint.rules_contracts import (
    DrillClocklessRule,
    FsyncBarrierRule,
    JournalTapGuardRule,
    PumpSurfaceRule,
)
from noahgameframe_tpu_torch.lint.rules_determinism import (
    UnseededRngRule,
    WallClockRule,
)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "noahgameframe_tpu_torch"
JAX_PKG = REPO / "noahgameframe_tpu"
FIX = Path(__file__).resolve().parent / "lint_fixtures_torch"
JAX_FIX = Path(__file__).resolve().parent / "lint_fixtures"
BASELINE = REPO / "nf_lint_torch_baseline.json"

RULE_NAMES = [cls.name for cls in ALL_RULES]
#: the rules carried over from the JAX package unchanged in logic
CARRIED = ["wall-clock", "unseeded-rng", "pump-surface", "fsync-barrier",
           "drill-clockless", "journal-tap-guard", "struct-codec",
           "dispatch-handler", "serve-loop", "migrate-covers-store",
           "room-axis-covered"]

DETERMINISM_RULES = (WallClockRule, UnseededRngRule)
CONTRACT_RULES = (PumpSurfaceRule, FsyncBarrierRule, DrillClocklessRule,
                  JournalTapGuardRule)


def _open(report, rule=None):
    return [f for f in report.open_findings
            if rule is None or f.rule == rule]


def _show(findings):
    return "\n".join(f"{f.path}:{f.line}: [{f.rule}] {f.message}"
                     for f in findings)


@pytest.fixture(scope="module")
def pkg_report():
    """The port package under every rule, against the committed baseline."""
    return run_lint(PKG, baseline_path=BASELINE)


@pytest.fixture(scope="module")
def bad_report():
    return run_lint(FIX / "bad")


@pytest.fixture(scope="module")
def good_report():
    return run_lint(FIX / "good")


@pytest.fixture(scope="module")
def suppress_report():
    return run_lint(FIX / "suppress")


# --- per-rule fixture pairs ----------------------------------------------

@pytest.mark.parametrize("rule", RULE_NAMES)
def test_rule_fires_on_bad_fixture(rule, bad_report):
    assert _open(bad_report, rule), (
        f"rule {rule} found nothing in lint_fixtures_torch/bad — the "
        "check has been blunted")


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_rule_quiet_on_good_fixture(rule):
    report = run_lint(FIX / "good", rule_filter=[rule])
    assert not _open(report, rule), _show(_open(report, rule))


def test_good_fixture_is_fully_clean(good_report):
    assert not good_report.open_findings, _show(good_report.open_findings)


def test_capture_safety_catches_every_escape_class(bad_report):
    msgs = " | ".join(f.message for f in _open(bad_report, "capture-safety"))
    for marker in ("synchronize", "`print`", "os.environ", "`float()`",
                   "`.item()`", "`.cpu()`", "`.numpy()`", "`.tolist()`",
                   "`nonzero`", "boolean-mask", "view(dtype)"):
        assert marker in msgs, f"capture-safety no longer catches {marker}"


def test_recapture_hazard_catches_every_trap_class(bad_report):
    msgs = " | ".join(f.message
                      for f in _open(bad_report, "recapture-hazard"))
    for marker in ("rebinds `self.radius`", "arange(len(...))",
                   ".tolist())"):
        assert marker in msgs, f"recapture-hazard no longer catches {marker}"
    assert "self.bucket" not in msgs, "a keyed attribute was flagged"


def test_struct_codec_catches_every_mismatch_class(bad_report):
    msgs = " | ".join(f.message for f in _open(bad_report, "struct-codec"))
    for marker in ("paired constant", "comment claims", "invalid struct",
                   "values, 3 supplied", "values, 3 targets"):
        assert marker in msgs, f"struct-codec no longer catches: {marker}"


def test_serve_loop_follows_the_split_role(bad_report):
    """A loop in a GameRole mixin, reached from game.py's encode stage,
    is reported at the mixin's file."""
    hits = [f for f in _open(bad_report, "serve-loop")
            if f.path == "net/roles/game_sync.py"]
    assert hits and "'encode'-stage" in hits[0].message


# --- suppression protocol -------------------------------------------------

def test_same_line_and_wrapped_suppressions_apply(suppress_report):
    ok = [f for f in suppress_report.findings if f.path == "ok.py"]
    assert len(ok) == 2
    assert all(f.status == "suppressed" for f in ok)
    reasons = {f.reason for f in ok}
    assert "reviewed boot stamp" in reasons
    assert any("wrapped reason" in r for r in reasons)


def test_unused_suppression_is_a_finding(suppress_report):
    unused = [f for f in suppress_report.open_findings
              if f.rule == UNUSED_SUPPRESSION]
    assert [f.path for f in unused] == ["unused.py"]


def test_malformed_suppression_is_a_finding_and_does_not_suppress(
        suppress_report):
    mal = [f for f in suppress_report.findings if f.path == "malformed.py"]
    assert {f.rule for f in mal} == {BAD_SUPPRESSION, "wall-clock"}
    assert all(f.status == "open" for f in mal)


def test_rule_filter_does_not_misreport_other_waivers_as_unused():
    report = run_lint(FIX / "suppress", rule_filter=["struct-codec"])
    assert not [f for f in report.findings
                if f.rule == UNUSED_SUPPRESSION]


def test_unknown_rule_filter_raises():
    with pytest.raises(ValueError, match="no-such-rule"):
        run_lint(FIX / "good", rule_filter=["no-such-rule"])


# --- report + baseline ----------------------------------------------------

def test_json_report_shape(suppress_report):
    data = suppress_report.to_json()
    assert data["version"] == 1
    assert set(data) == {"version", "root", "rules", "counts", "findings",
                         "stale_baseline"}
    assert data["rules"] == RULE_NAMES
    c = data["counts"]
    assert c["total"] == len(data["findings"])
    assert c["open"] + c["suppressed"] + c["baselined"] == c["total"]
    assert c["open"] == 3 and c["suppressed"] == 2
    for entry in data["findings"]:
        assert {"rule", "path", "line", "message", "status"} <= set(entry)
    suppressed = [e for e in data["findings"]
                  if e["status"] == "suppressed"]
    assert all("reason" in e for e in suppressed)


def test_baseline_marks_known_findings_and_reports_stale(tmp_path,
                                                         bad_report):
    base = tmp_path / "base.json"
    write_baseline(base, bad_report.open_findings)

    again = run_lint(FIX / "bad", baseline_path=base)
    assert not again.open_findings
    assert all(f.status == "baselined" for f in again.findings)
    assert not again.stale_baseline

    clean = run_lint(FIX / "good", baseline_path=base)
    assert clean.stale_baseline
    assert not clean.open_findings


# --- cross-package parity of the carried-over rules ----------------------

def _rows(report):
    return sorted((f.rule, f.path, f.line, f.status, f.message)
                  for f in report.findings)


@pytest.mark.parametrize("side", ["bad", "good", "suppress"])
def test_carried_rules_equal_jax_on_jax_fixtures(side):
    ours = run_lint(JAX_FIX / side,
                    rules=[RULES_BY_NAME[n] for n in CARRIED])
    ref = jax_lint.run_lint(JAX_FIX / side,
                            rules=[jax_lint.RULES_BY_NAME[n]
                                   for n in CARRIED])
    assert _rows(ours) == _rows(ref)
    assert ours.to_json()["counts"] == ref.to_json()["counts"]
    if side == "bad":
        assert {f.rule for f in ours.open_findings} == set(CARRIED)


def test_carried_rules_equal_jax_on_the_jax_package():
    ours = run_lint(JAX_PKG, rules=[RULES_BY_NAME[n] for n in CARRIED])
    ref = jax_lint.run_lint(JAX_PKG, rules=[jax_lint.RULES_BY_NAME[n]
                                            for n in CARRIED])
    assert _rows(ours) == _rows(ref)
    assert ours.to_json()["counts"] == ref.to_json()["counts"]
    assert ref.findings, "the JAX package's reviewed waivers vanished"


# --- the package gate -----------------------------------------------------

def test_package_has_zero_unsuppressed_findings(pkg_report):
    assert not pkg_report.open_findings, _show(pkg_report.open_findings)
    assert not pkg_report.stale_baseline, pkg_report.stale_baseline
    assert pkg_report.rules == RULE_NAMES


def test_package_suppressions_all_carry_reasons(pkg_report):
    suppressed = [f for f in pkg_report.findings
                  if f.status == "suppressed"]
    assert suppressed, "expected the port's reviewed waivers to be visible"
    assert all(f.reason for f in suppressed)
    assert {f.rule for f in suppressed} >= {
        "capture-safety", "serve-loop", "mesh-not-captured",
        "recapture-hazard", "wall-clock"}


def test_committed_baseline_holds_no_findings():
    data = json.loads(BASELINE.read_text(encoding="utf-8"))
    assert data["version"] == 1 and data["findings"] == []


def test_lint_imports_neither_torch_nor_jax_nor_the_reference():
    for path in sorted((PKG / "lint").glob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                heads = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                heads = [(node.module or "").split(".")[0]]
            else:
                continue
            for head in heads:
                assert head not in ("torch", "jax", "noahgameframe_tpu",
                                    "numpy"), f"{path.name} imports {head}"


def test_port_roots_cover_every_kind():
    """The call graph finds the port's graph captures (the tick, the
    train, the rooms step through its forwarding helpers), its eager
    dispatchers, its phases and its vmap target."""
    ctx = PackageContext(PKG)
    sites = capture_sites(ctx)
    assert {s.kind for s in sites} == set(ROOT_KINDS)
    graph_targets = {getattr(t, "qual", None) for s in sites
                     if s.kind == "graph" for t in s.targets}
    assert {"Kernel._trace_train", "RoomBatch._room_step",
            "RoomBatch._room_train"} <= graph_targets
    reached = {tf.info.qual for tf in captured_reachable(ctx).values()}
    assert {"Kernel._step", "need_rebuild", "CombatModule._fold",
            "TickCtx.count"} <= reached


def _probe(rel, anchor, inserted, rule, where="before"):
    src = (PKG / rel).read_text(encoding="utf-8")
    assert anchor in src, f"{rel} anchor moved — update this probe"
    new = inserted + anchor if where == "before" else anchor + inserted
    report = run_lint(PKG, rule_filter=[rule],
                      overrides={rel: src.replace(anchor, new, 1)})
    return [f for f in _open(report, rule) if f.path == rel]


def test_injected_item_is_caught():
    """The acceptance probe: seed a host read into a captured tick
    helper (ops/verlet.need_rebuild, reached from the phases)."""
    hits = _probe("ops/verlet.py", "    d = pos[:, :2] - cache.anchor_pos",
                  "    pos.sum().item()\n", "capture-safety")
    assert any("`.item()`" in f.message for f in hits), (
        "injected host read was NOT caught — the capture-safety call "
        "graph lost the phase roots")


def test_injected_sync_in_phase_root_is_caught():
    """The same probe through the combat phase (game/combat.py's
    add_phase) into its fold helper."""
    hits = _probe("game/combat.py", "    def _fold(self, rows, cache, ctx):",
                  "\n        torch.cuda.synchronize()", "capture-safety",
                  where="after")
    assert any("synchronize" in f.message and "combat.py:122 (phase)"
               in f.message for f in hits), _show(hits)


def test_injected_view_dtype_on_a_vmapped_path_is_caught():
    hits = _probe("ops/verlet.py", "    d = pos[:, :2] - cache.anchor_pos",
                  "    bits = pos.view(torch.int32)\n", "capture-safety")
    assert any("view(dtype)" in f.message for f in hits), _show(hits)


def _registry_probe(old, new):
    rel = "ops/stencil_cuda.py"
    src = (PKG / rel).read_text(encoding="utf-8")
    assert old in src, "CUSTOM_OP_PARITY_TESTS entry moved"
    report = run_lint(PKG, rule_filter=["custom-op-parity-pinned"],
                      overrides={rel: src.replace(old, new, 1)})
    return [f.message for f in _open(report, "custom-op-parity-pinned")]


def test_registry_missing_an_op_is_caught():
    msgs = _registry_probe(
        '    "nf::slot_rows": "tests/test_torch_cuda.py",\n', "")
    assert any("`nf::slot_rows` is not named" in m for m in msgs), msgs


def test_registry_stale_key_is_caught():
    msgs = _registry_probe('    "nf::fused_neighborhood": ',
                           '    "nf::fused_neighbourhood": ')
    assert any("`nf::fused_neighbourhood` matches no" in m for m in msgs)
    assert any("`nf::fused_neighborhood` is not named" in m for m in msgs)


def test_registry_pin_without_the_cuda_marker_is_caught(tmp_path):
    for rel in ("ops/fold.py", "ops/parity_pin.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        text = (FIX / "good" / rel).read_text(encoding="utf-8")
        (tmp_path / rel).write_text(text.replace("mark.cuda", "cuda"),
                                    encoding="utf-8")
    report = run_lint(tmp_path, rule_filter=["custom-op-parity-pinned"])
    assert any("cuda` marker" in f.message for f in report.open_findings)


# --- what is and is not tensor-rooted (each refinement pinned) -----------

_ROOTED = [
    # (quiet as written, flagged once the refinement no longer applies)
    ("def f(x):\n    if isinstance(x, torch.Tensor):\n        return x\n"
     "    else:\n        return int(x)\n",
     "def f(x):\n    if isinstance(x, torch.Tensor):\n        return int(x)\n"
     "    else:\n        return x\n"),
    ("def f(x):\n    return x if isinstance(x, torch.Tensor) else int(x)\n",
     "def f(x):\n    return int(x) if isinstance(x, torch.Tensor) else x\n"),
    ("def f(i32, v):\n    i32[:, int(G.B)] = v\n    return i32\n",
     "def f(i32, v):\n    i32[:, int(v)] = v\n    return i32\n"),
    ("def f(xs, n: Optional[int]):\n    return xs[:int(n)]\n",
     "def f(xs, n):\n    return xs[:int(n)]\n"),
]


@pytest.mark.parametrize("quiet,flagged", _ROOTED,
                         ids=["else-branch", "ifexp", "enum-member",
                              "host-annotation"])
def test_tensor_rooted_refinements(quiet, flagged, tmp_path):
    def hits(body):
        src = ("import torch\n\n" + body +
               "\n\nclass M:\n    def __init__(self):\n"
               "        self.add_phase('p', lambda s, c: f(s, c))\n")
        report = run_lint(tmp_path, rule_filter=["capture-safety"],
                          overrides={"game/probe.py": src})
        return [f for f in _open(report) if "`int()`" in f.message]

    assert not hits(quiet), _show(hits(quiet))
    assert hits(flagged), flagged


# --- determinism and contracts over the port -----------------------------

@pytest.fixture(scope="module")
def contract_report():
    return run_lint(PKG, rules=list(DETERMINISM_RULES + CONTRACT_RULES))


def test_no_nondeterminism_in_package(contract_report):
    names = {cls.name for cls in DETERMINISM_RULES}
    offenses = [f for f in contract_report.open_findings
                if f.rule in names]
    assert not offenses, _show(offenses)


@pytest.mark.parametrize("rule_cls", CONTRACT_RULES, ids=lambda c: c.name)
def test_structural_contracts_hold(rule_cls, contract_report):
    offenses = [f for f in contract_report.open_findings
                if f.rule == rule_cls.name]
    assert not offenses, _show(offenses)


def _snippet(src, rules, tmp_path, rel="game/_lint_probe.py"):
    report = run_lint(tmp_path, rules=list(rules), overrides={rel: src})
    return [f for f in report.open_findings if f.path == rel]


@pytest.mark.parametrize("src", [
    "import time\ntime.time()",
    "import time as _time\n_time.time()",
    "from time import time\ntime()",
    "from time import time as now\nnow()",
    "import random\nrandom.random()",
    "import random as _r\n_r.randint(0, 9)",
    "import random\nrandom.Random()",
    "import numpy as np\nnp.random.rand(3)",
    "import numpy as np\nnp.random.default_rng()",
    "import numpy\nnumpy.random.normal()",
    "import torch\ntorch.rand(3)",
    "import torch as th\nth.randint(0, 9, (3,))",
    "import torch\ntorch.randperm(8)",
    "import torch\ntorch.manual_seed(0)",
    "import torch\ntorch.cuda.manual_seed_all(0)",
    "from torch import randn\nrandn(3)",
])
def test_linter_catches(src, tmp_path):
    assert _snippet(src, DETERMINISM_RULES, tmp_path), src


@pytest.mark.parametrize("src", [
    "import time\ntime.monotonic()",
    "import random\nr = random.Random(7)\nr.random()",
    "import numpy as np\nrng = np.random.default_rng(5)\nrng.normal()",
    "import numpy as np\ndef f(rng: np.random.Generator): ...",
    "import numpy as np\nnp.arange(4)",
    "import torch\ng = torch.Generator().manual_seed(3)\n"
    "torch.randn(3, generator=g)",
    "import torch\ntorch.bernoulli(torch.full((3,), 0.5), generator=None)",
    "import torch\ntorch.zeros(3)",
])
def test_linter_allows(src, tmp_path):
    assert not _snippet(src, DETERMINISM_RULES, tmp_path), src


_WB_BAD_PUMP = """\
class WriteBehindPipeline:
    def enqueue(self, batch):
        self.backend.put_many(batch)
    def enqueue_one(self, rec): pass
    def note_tick(self, tick): pass
    def barrier(self): pass
    def pump(self): pass
    def pending(self): pass
    def discard(self): pass
    def lag_ticks(self): pass
    def queue_depth(self): pass
    def degraded(self): pass
    def _flush_batch(self, batch):
        self.backend.put_many(batch)
"""

_WB_BAD_FSYNC = _WB_BAD_PUMP.replace(
    "    def note_tick(self, tick): pass",
    "    def note_tick(self, tick):\n        self.wal.sync()")


def test_pump_surface_rule_catches_store_on_pump(tmp_path):
    found = _snippet(_WB_BAD_PUMP, [PumpSurfaceRule], tmp_path,
                     rel="persist/writebehind.py")
    assert any("store/sleep" in f.message for f in found)


def test_pump_surface_rule_catches_vanished_class(tmp_path):
    found = _snippet("x = 1\n", [PumpSurfaceRule], tmp_path,
                     rel="persist/writebehind.py")
    assert any("vanished" in f.message for f in found)


def test_fsync_rule_catches_per_tick_sync(tmp_path):
    found = _snippet(_WB_BAD_FSYNC, [FsyncBarrierRule], tmp_path,
                     rel="persist/writebehind.py")
    assert any("fsync" in f.message for f in found)


def test_drill_rule_catches_clocked_schedule(tmp_path):
    found = _snippet("import time\nT = time.monotonic()\n",
                     [DrillClocklessRule], tmp_path,
                     rel="drill/schedule.py")
    assert found


def test_drill_rule_allows_runner_pacing(tmp_path):
    found = _snippet("import time\ntime.sleep(time.monotonic() % 1)\n",
                     [DrillClocklessRule], tmp_path,
                     rel="drill/runner.py")
    assert not found


def test_journal_tap_rule_catches_unguarded_write(tmp_path):
    src = (
        "class GameRole:\n"
        "    def _journal_tap(self):\n"
        "        def tap(conn_id, msg_id, payload):\n"
        "            self.journal.event(conn_id, msg_id, payload)\n"
        "        return tap\n"
    )
    found = _snippet(src, [JournalTapGuardRule], tmp_path,
                     rel="net/roles/game.py")
    assert any("TRACE_MSG_IDS" in f.message for f in found)


# --- CLI ------------------------------------------------------------------

def _cli(*args, module=False):
    cmd = ([sys.executable, "-m", "noahgameframe_tpu_torch.lint"] if module
           else [sys.executable, str(REPO / "scripts" / "torch_nf_lint.py")])
    return subprocess.run(cmd + list(args), capture_output=True, text=True,
                          cwd=REPO, timeout=300)


def test_cli_clean_package_exits_zero_with_json():
    res = _cli("--json", module=True)
    assert res.returncode == 0, res.stdout + res.stderr
    data = json.loads(res.stdout)
    assert data["counts"]["open"] == 0
    assert data["counts"]["baselined"] == 0
    assert data["root"].endswith("noahgameframe_tpu_torch")


def test_cli_violations_exit_nonzero():
    res = _cli("--root", str(FIX / "bad"), "--json")
    assert res.returncode == 1
    data = json.loads(res.stdout)
    assert data["counts"]["open"] > 0


def test_cli_rule_filter_and_unknown_rule():
    res = _cli("--root", str(FIX / "bad"), "--rule", "capture-safety",
               "--json")
    assert res.returncode == 1
    data = json.loads(res.stdout)
    assert data["rules"] == ["capture-safety"]
    assert {e["rule"] for e in data["findings"]} == {"capture-safety"}

    bad = _cli("--rule", "trace-safety")
    assert bad.returncode == 2


def test_cli_update_baseline_roundtrip(tmp_path):
    base = tmp_path / "base.json"
    res = _cli("--root", str(FIX / "bad"), "--baseline", str(base),
               "--update-baseline")
    assert res.returncode == 0, res.stdout + res.stderr
    assert base.exists()

    res = _cli("--root", str(FIX / "bad"), "--baseline", str(base),
               "--json")
    assert res.returncode == 0
    data = json.loads(res.stdout)
    assert data["counts"]["open"] == 0
    assert data["counts"]["baselined"] > 0


def test_cli_list_rules_matches_catalog():
    res = _cli("--list-rules")
    assert res.returncode == 0
    listed = [line.split()[0] for line in res.stdout.splitlines() if line]
    assert listed == RULE_NAMES
    assert set(listed) == set(RULES_BY_NAME)
