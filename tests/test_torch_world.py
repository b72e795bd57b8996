"""The port's world tick (noahgameframe_tpu_torch) against the JAX package
on the CPU: the same seeded benchmark world, ticked in both, gives equal
per-tick state_digest streams and counter banks under every combat
engine, and equal banks at the end.  Plus the port's import hygiene and
its device default."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from noahgameframe_tpu.game.world import build_benchmark_world as jax_world
from noahgameframe_tpu_torch.core.store import state_to_numpy
from noahgameframe_tpu_torch.game.world import GameWorld
from noahgameframe_tpu_torch.game.world import build_benchmark_world as torch_world
from test_torch_parity import assert_tree_equal, jax_tree

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "noahgameframe_tpu_torch"


def _worlds(n, seed, engine):
    a = jax_world(n, seed=seed)
    b = torch_world(n, seed=seed, device="cpu")
    for w in (a, b):
        w.combat.use_pallas = engine
        w.kernel.enable_digest()
    return a, b


def _tick_both(a, b, ticks):
    """Tick both worlds, asserting equal counter banks (digest included)
    after every tick; returns the port's counter stream."""
    stream = []
    for t in range(ticks):
        a.tick()
        got = b.tick().counters
        assert got == a.kernel.last_counters, f"tick {t}"
        stream.append(got)
    return stream


def test_engine0_digest_stream_2000_npcs():
    """60 ticks at 2000 NPCs: movement, staggered AoE combat with the
    overflow auto-resize, regen and the stat recompute stay bit-exact."""
    a, b = _worlds(2000, seed=3, engine=0)
    stream = _tick_both(a, b, 60)
    assert sum(c["combat_hits"] for c in stream) > 0
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))


@pytest.mark.parametrize("engine", [1, 2])
def test_kernel_engines_digest_stream_200_npcs(engine):
    """Engines 1 and 2 (the JAX package runs its Pallas kernels in
    interpret mode; the port runs the kernels' plain versions on CPU)."""
    a, b = _worlds(200, seed=3, engine=engine)
    stream = _tick_both(a, b, 24)
    assert ("aoi_interest_pairs" in stream[-1]) == (engine == 2)
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))


def test_run_device_end_digest():
    """run_device(n) (no per-tick observation) lands on the same state
    as the JAX package's fused run loop."""
    a, b = _worlds(200, seed=5, engine=0)
    a.kernel.run_device(12)
    b.kernel.run_device(12)
    a.kernel.tick()
    got = b.kernel.tick().counters
    assert got["tick"] == 13
    assert got["state_digest"] == a.kernel.last_counters["state_digest"]


def test_arm_all_rearm_invalidates_like_jax(monkeypatch):
    """A re-arm that changes the attack duty (``arm_all(stagger=False)``
    after the staggered seeding) invalidates the kernel in both packages:
    the Verlet aux is dropped and rebuilt, so the counter banks (the
    grid rebuild/reuse counts and the cache age among them), the aux
    entries and the digests stay equal on every tick.  Tolerance 0."""
    monkeypatch.setenv("NF_VERLET_SKIN", "2.0")
    monkeypatch.setenv("NF_PALLAS", "0")
    a = jax_world(512, seed=4)
    b = torch_world(512, seed=4, device="cpu")
    for w in (a, b):
        w.kernel.enable_digest()
    _tick_both(a, b, 5)
    assert set(b.kernel.state.aux) == set(a.kernel.state.aux) == {"verlet/NPC"}
    gen = b.kernel.costbook.generation
    for w in (a, b):
        w.combat.arm_all(stagger=False)
    assert set(b.kernel.state.aux) == set(a.kernel.state.aux) == set()
    assert b.kernel.costbook.generation == gen + 1
    for t in range(5):
        a.tick()
        got = b.tick().counters
        assert got == a.kernel.last_counters, f"tick {t} after the re-arm"
        assert set(b.kernel.state.aux) == set(a.kernel.state.aux), t
    assert got["grid_cache_age"] == a.kernel.last_counters["grid_cache_age"]
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module (and chip_smoke.py, the port's scripts and its
    examples) imports in a fresh process without pulling jax, flax or
    noahgameframe_tpu into sys.modules, and no source names them in an
    import statement."""
    scripts = [REPO / "scripts" / f"{name}.py"
               for name in ("torch_gameday_smoke", "torch_reshard_smoke", "torch_codegen",
                            "torch_emit_client_vectors", "torch_run_role")]
    scripts += sorted((REPO / "examples").glob("torch_*.py"))
    assert len(scripts) == 14
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", *scripts]
    banned = ("jax", "flax", "noahgameframe_tpu")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, (f, mod)
    mods = ["chip_smoke"] + [
        ".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for f in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"for p in {[str(f) for f in scripts]!r}:\n"
        "    spec = importlib.util.spec_from_file_location(p, p)\n"
        "    sys.modules[p] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(sys.modules[p])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_default_device_is_cuda(monkeypatch):
    """device=None means "cuda": without a card the entry points raise
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_world(64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GameWorld()
    # the middleware stack's modules follow the world's device
    w = GameWorld(device="cpu").start()
    assert w.config.middleware and w.buffs._table.device.type == "cpu"
    assert all(c.device.type == "cpu" for c, _, _ in w.buffs._rec_cols.values())
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.game import GameRole
    from noahgameframe_tpu_torch.replay.replayer import make_offline_role

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GameRole(RoleConfig(6, 0, "G", "127.0.0.1", 0), backend="py")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_offline_role(backend="py")
    role = make_offline_role(backend="py", device="cpu")
    assert role.kernel.device.type == "cpu" and not role.kernel.graph_tick
    role.shut()
    # a given world's device is followed
    role = GameRole(RoleConfig(6, 0, "G", "127.0.0.1", 0), backend="py",
                    world=torch_world(64, device="cpu"))
    assert role.kernel.device.type == "cpu"
    role.shut()


def _assembly(w) -> dict:
    """A world's module list, plugin order and composed phases."""
    return {
        "modules": [m.name for m in w.all_modules],
        "plugins": [(name, [m.name for m in plugin.modules])
                    for name, plugin in w.pm.plugins.items()],
        "phases": [(p.name, p.order) for p in w.kernel._composed],
    }


def _digest_walk(w, ticks: int = 30):
    """Seed NPCs, two players with buffs (one expiring inside the walk),
    then ``ticks`` frames; the per-tick state digests."""
    k = w.kernel
    k.store.guids.pin(5000)
    if 1 not in w.scene.scenes:
        w.scene.create_scene(1)
    w.seed_npcs(30)
    w.buffs.define_buff("swift", 0.3, {"MOVE_SPEED": 50, "ATK_VALUE": 3})
    w.buffs.define_buff("stone", 100.0, {"DEF_VALUE": 9})
    for i in range(2):
        g = k.create_object("Player", {"Name": f"D{i}", "Account": f"d{i}"},
                            scene=1, group=0)
        w.buffs.apply_buff(g, "swift")
        w.buffs.apply_buff(g, "stone")
    k.enable_digest()
    out = []
    for _ in range(ticks):
        w.tick()
        out.append(k.last_counters["state_digest"])
    return out


@pytest.mark.parametrize("which", ["world", "role"])
def test_default_world_is_the_jax_middleware_stack(which):
    """``WorldConfig()`` and ``GameRole()``'s default world carry the
    middleware, as in the JAX package: the same module list, plugin
    order and phase orders (buffs at 55), and the same first 30 state
    digests over a seeded walk with buffs."""
    from noahgameframe_tpu.game.world import GameWorld as JWorld
    from noahgameframe_tpu.game.world import WorldConfig as JConfig
    from noahgameframe_tpu.net.roles.base import RoleConfig as JRoleConfig
    from noahgameframe_tpu.net.roles.game import GameRole as JRole
    from noahgameframe_tpu_torch.game.world import WorldConfig
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.game import GameRole

    assert WorldConfig().middleware is True
    roles = []
    if which == "world":
        a, b = JWorld(JConfig()).start(), GameWorld(WorldConfig(), device="cpu").start()
    else:
        roles = [JRole(JRoleConfig(6, 0, "G", "127.0.0.1", 0), backend="py"),
                 GameRole(RoleConfig(6, 0, "G", "127.0.0.1", 0), backend="py",
                          device="cpu")]
        a, b = (r.game_world for r in roles)
    assert _assembly(a) == _assembly(b)
    assert ("BuffModule.buffs", 55) in _assembly(b)["phases"]
    assert all(getattr(b, attr) is not None for attr in (
        "buffs", "team", "mail", "rank", "shop", "friends", "guilds", "gm", "pvp",
        "slg_building", "slg_shop", "pack", "items", "equip", "heroes", "tasks"))
    da, db = _digest_walk(a), _digest_walk(b)
    assert da == db and len(set(db)) > 1
    for r in roles:
        r.shut()


def test_store_key_and_verlet_cache_default_to_cuda(monkeypatch):
    """EntityStore(), prng_key(seed) and init_cache(n) without a device
    mean "cuda": without a card each raises, and each builds on the CPU
    only when asked for it by name."""
    from noahgameframe_tpu_torch.core.prng import prng_key
    from noahgameframe_tpu_torch.core.store import EntityStore
    from noahgameframe_tpu_torch.game.schema import standard_registry
    from noahgameframe_tpu_torch.ops.verlet import init_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = standard_registry()
    for make in (lambda **kw: EntityStore(reg, **kw), lambda **kw: prng_key(7, **kw),
                 lambda **kw: init_cache(16, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert EntityStore(reg, device="cpu").init_state().rng.device.type == "cpu"
    assert prng_key(7, device="cpu").device.type == "cpu"
    assert init_cache(16, device="cpu").order.device.type == "cpu"
