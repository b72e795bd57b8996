"""The port's tutorials (examples/torch_*.py) against the JAX package's.

Each port tutorial runs in-process through its ``main("cpu")``, and each
JAX tutorial at most once per session (``jax_stdout``).  Tutorials 1, 2,
3, 4, 6 and 7 print what the JAX tutorial prints, line for line (tutorial
4's result lines in a canonical order, as its two threads finish in
either order; guids from a pinned allocator in both packages).  Tutorial
5's ``alive`` / ``damaged`` line equals JAX's.  Tutorial 8 moves entities
by ``cos``/``sin``, which differ between XLA's and torch's CPU builds in
the last bit now and then, so it is held to its own population check and
to its own rerun.  The plugin template loads by manifest and drains MP
inside the port's tick.  Without ``--device cpu`` every tutorial that
builds device state asks for ``cuda``."""

from __future__ import annotations

import contextlib
import io
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_parity import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
GUID_BASE = 5_000_000


@contextlib.contextmanager
def pinned_guids():
    """Every guid allocator of both packages built in the block starts
    pinned at GUID_BASE (the tutorials print guids, which are wall-clock
    numbers otherwise)."""
    from noahgameframe_tpu.core import datatypes as jdt
    from noahgameframe_tpu_torch.core import datatypes as pdt

    saved = [(m, m.GuidAllocator.__init__) for m in (jdt, pdt)]

    def pinning(init):
        def __init__(self, *a, **kw):
            init(self, *a, **kw)
            self.pin(GUID_BASE)
        return __init__

    for m, init in saved:
        m.GuidAllocator.__init__ = pinning(init)
    try:
        yield
    finally:
        for m, init in saved:
            m.GuidAllocator.__init__ = init


def stdout_of(script: str, *args) -> list:
    """The lines ``main(*args)`` of ``examples/<script>.py`` prints."""
    ns = runpy.run_path(str(EXAMPLES / f"{script}.py"))
    buf = io.StringIO()
    with pinned_guids(), contextlib.redirect_stdout(buf):
        ns["main"](*args)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def jax_stdout():
    """The JAX tutorials' lines, each tutorial run once."""
    cache: dict = {}

    def get(name: str) -> list:
        if name not in cache:
            cache[name] = stdout_of(name)
        return cache[name]

    return get


def canonical(name: str, lines: list) -> list:
    if name == "tutorial4_actor":
        results = sorted(ln for ln in lines if ln.startswith("  result from actor"))
        rest = [ln for ln in lines if not ln.startswith("  result from actor")]
        return rest[:1] + results + rest[1:]
    return lines


def test_tutorial8_conserves_population_and_reruns_equal():
    """The tutorial asserts that every entity still exists once after 50
    ticks of migration; a second run of its first 10 ticks prints the
    same lines as far as it goes.  It runs first: after the JAX
    tutorials' compiles the process runs its many small ops slower."""
    first = stdout_of("torch_tutorial8_spatial", "cpu")
    assert first[-1] == "population conserved across all migrations - OK"
    assert len(first) == 7
    again = stdout_of("torch_tutorial8_spatial", "cpu", 1)
    assert again == first[:2] + first[-1:]


@pytest.mark.parametrize("name", [
    "tutorial1_lifecycle",
    "tutorial2_properties",
    "tutorial3_heartbeat_events",
    "tutorial4_actor",
    "tutorial6_cluster",
    "tutorial7_gameplay",
])
def test_tutorial_prints_what_jax_prints(name, jax_stdout):
    port = stdout_of(f"torch_{name}", "cpu")
    assert port[-1].endswith("done")
    assert canonical(name, port) == canonical(name, jax_stdout(name))


def test_tutorial5_alive_and_damaged_equal_jax(jax_stdout):
    port = stdout_of("torch_tutorial5_sharded_world", "cpu")
    assert port[-1] == "done"
    assert port[0] == "mesh: Mesh(virtual shard=4: ['cpu', 'cpu', 'cpu', 'cpu']) over 4 shards"
    assert port[1] == "i32 bank sharding: row blocks [256, 256, 256, 256] on " \
                      "['cpu', 'cpu', 'cpu', 'cpu']"
    (line,) = [ln for ln in port if ln.startswith("alive:")]
    assert line == [ln for ln in jax_stdout("tutorial5_sharded_world")
                    if ln.startswith("alive:")][0]


def test_plugin_template_loads_via_manifest_and_drains_mp_in_the_tick(tmp_path):
    """The template loads from a Plugin.xml manifest and its device phase
    drains MP inside the port's tick: live rows lose one a tick, floored
    at 0, and a dead row keeps its value."""
    from noahgameframe_tpu_torch.core.store import set_column, with_class
    from noahgameframe_tpu_torch.game import GameWorld, WorldConfig

    sys.path.insert(0, str(EXAMPLES))
    try:
        w = GameWorld(WorldConfig(combat=False, movement=False, regen=False,
                                  npc_capacity=16, player_capacity=4, middleware=False),
                      device="cpu")
        manifest = tmp_path / "Plugin.xml"
        manifest.write_text('<XML><Plugin Name="torch_plugin_template"/></XML>')
        assert w.pm.load_manifest(manifest) == 1
        w.start()
        w.scene.create_scene(1)
        k = w.kernel
        g = k.create_object("Player", {"MP": 10}, scene=1, group=0)
        low = k.create_object("Player", {"MP": 2}, scene=1, group=0)
        # a dead row holding MP: the phase must leave it alone
        cs = k.state.classes["Player"]
        dead = int((~cs.alive).nonzero()[0, 0])
        col = k.store.spec("Player").slot("MP").col
        i32 = set_column(cs.i32, col, torch.where(~cs.alive, 7, cs.i32[:, col]))
        k.state = with_class(k.state, "Player", cs.replace(i32=i32))
        w.run(4)
        assert int(k.get_property(g, "MP")) == 6  # 4 ticks drained
        assert int(k.get_property(low, "MP")) == 0  # floored at 0
        assert int(k.state.classes["Player"].i32[dead, col]) == 7
    finally:
        sys.path.remove(str(EXAMPLES))


@pytest.mark.parametrize("script", [
    "torch_tutorial2_properties",
    "torch_tutorial3_heartbeat_events",
    "torch_tutorial5_sharded_world",
    "torch_tutorial6_cluster",
    "torch_tutorial7_gameplay",
    "torch_tutorial8_spatial",
])
def test_tutorials_ask_for_cuda_unless_given_the_cpu(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ns = runpy.run_path(str(EXAMPLES / f"{script}.py"))
    with pytest.raises(RuntimeError, match="cuda|CUDA"), \
            contextlib.redirect_stdout(io.StringIO()):
        ns["main"]()


def test_tutorial_runs_as_a_script_with_device_cpu():
    r = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_tutorial2_properties.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[-1] == "tutorial2 done"
