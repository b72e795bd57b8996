"""The import guard compares whole top-level names."""

import subprocess
import sys

import pytest

from nfbench.guard import forbidden_modules


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("noahgameframe_tpu", True), ("noahgameframe_tpu.ops.stencil", True),
    ("noahgameframe_tpu_torch", False), ("noahgameframe_tpu_torch.kernel.kernel", False),
    ("jaxtyping", False), ("nfbench.run", False)])
def test_top_level_names_compared_whole(name, bad):
    assert (forbidden_modules([name]) == [name]) is bad


def test_the_harness_and_the_port_load_no_jax():
    code = ("import importlib, pkgutil, nfbench\n"
            "for m in pkgutil.walk_packages(nfbench.__path__, 'nfbench.'):\n"
            "    if '.tests' not in m.name and m.name != 'nfbench.__main__':\n"
            "        importlib.import_module(m.name)\n"
            "import noahgameframe_tpu_torch.game.world, noahgameframe_tpu_torch.parallel.rooms\n"
            "from nfbench.guard import forbidden_modules\n"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(__import__("nfbench").__path__[0] + "/.."))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import importlib, pkgutil, sys, nfbench.checks, nfbench.reference.tick\n"
            "import nfbench.reference.build\n"
            "for m in pkgutil.iter_modules(nfbench.checks.__path__, 'nfbench.checks.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'noahgameframe_tpu_torch', 'noahgameframe_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(__import__("nfbench").__path__[0] + "/.."))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
