"""The port's defaults and import hygiene: no port file (the package,
chip_smoke.py, the port's scripts and examples) imports jax or the JAX
package; ``device=None`` means "cuda" and raises without a card; and the
default world and game role carry the JAX package's middleware stack,
with equal state digests over a seeded walk."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from noahgameframe_tpu_torch.game.world import GameWorld
from noahgameframe_tpu_torch.game.world import build_benchmark_world as torch_world
from test_torch_parity import one_intra_op_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "noahgameframe_tpu_torch"


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
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    scripts += sorted((REPO / "examples").glob("torch_*.py"))
    assert len(scripts) == 27
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
