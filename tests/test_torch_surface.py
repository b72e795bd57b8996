"""The port's package surface against the JAX package's.

For each of ``core``, ``net``, ``replay``, ``telemetry``, ``utils``,
``drill`` and ``tools``, ``from noahgameframe_tpu_torch.<pkg> import *``
gives the names that ``from noahgameframe_tpu.<pkg> import *`` gives
(its ``__all__``, or for a package without one its public non-module
names), every one of them importable, and every JAX submodule has a
port counterpart, less :data:`LEFT_OUT`.  The subpackages import in a
fresh interpreter with no import cycle, in the JAX package's order and
after ``game.world``."""

import importlib
import pkgutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
from test_torch_parity import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ("core", "net", "replay", "telemetry", "utils", "drill", "tools")

#: JAX names the port leaves out, each with the reason
LEFT_OUT = {
    "utils.platform.force_cpu": "forces jax onto its CPU backend (XLA flags, "
    "jax.config, clearing jax backends); the port picks a device per call "
    "with device=",
    "utils.platform.init_compile_cache": "turns on jax's persistent XLA "
    "compile cache (NF_COMPILE_CACHE); the port compiles no per-shape "
    "programs, and its CUDA kernels are built once per checkout",
}


def star_names(module) -> set:
    """The names ``from module import *`` binds: ``__all__``, or the
    public non-module attributes of a package without one."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {k for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_star_import_gives_jax_names(pkg):
    jax_pkg = importlib.import_module(f"noahgameframe_tpu.{pkg}")
    port = importlib.import_module(f"noahgameframe_tpu_torch.{pkg}")
    left_out = {k.rsplit(".", 1)[1] for k in LEFT_OUT if k.startswith(f"{pkg}.")
                and k.count(".") == 1}
    assert star_names(port) == star_names(jax_pkg) - left_out
    ns: dict = {}
    exec(f"from noahgameframe_tpu_torch.{pkg} import *", ns)
    assert star_names(port) <= set(ns)
    # every JAX submodule has its port, or its names are left out
    jax_mods = {m.name for m in pkgutil.iter_modules(jax_pkg.__path__)}
    port_mods = {m.name for m in pkgutil.iter_modules(port.__path__)}
    for mod in sorted(jax_mods - port_mods):
        jmod = importlib.import_module(f"noahgameframe_tpu.{pkg}.{mod}")
        public = {k for k, v in vars(jmod).items() if not k.startswith("_")
                  and getattr(v, "__module__", None) == jmod.__name__}
        assert public == {k.rsplit(".", 1)[1] for k in LEFT_OUT
                          if k.startswith(f"{pkg}.{mod}.")}, mod


def test_core_exports_the_store():
    from noahgameframe_tpu_torch.core import EntityStore, StoreConfig, WorldState, prop

    assert StoreConfig.__module__ == "noahgameframe_tpu_torch.core.store"
    assert EntityStore and WorldState and prop


@pytest.mark.parametrize("first", [(), ("game.world", "net.roles.game")],
                         ids=["jax-order", "after-game-world"])
def test_subpackages_import_fresh_without_a_cycle(first):
    order = [*first, *PACKAGES]
    code = "\n".join([
        "import importlib, sys",
        f"for name in {order!r}:",
        "    importlib.import_module('noahgameframe_tpu_torch.' + name)",
        f"for name in {list(PACKAGES)!r}:",
        "    exec('from noahgameframe_tpu_torch.' + name + ' import *', {})",
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'noahgameframe_tpu' or k.startswith('noahgameframe_tpu.'))",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
