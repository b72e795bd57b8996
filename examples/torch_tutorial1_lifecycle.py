"""Tutorial 1 — plugin & module lifecycle, on the PyTorch port.

The port's counterpart of examples/tutorial1_lifecycle.py (the reference's
Tutorial1, `Tutorial/Tutorial1/HelloWorld1.cpp`): a plugin registers one
module; the plugin manager drives the 9-phase lifecycle (awake → init →
after_init → check_config → ready_execute → execute… → before_shut →
shut) and the module logs each phase.  No world is built, so nothing is
placed on a device; ``--device`` is accepted as every port tutorial
accepts it.

Run:  python examples/torch_tutorial1_lifecycle.py
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.kernel import Module, Plugin, PluginManager  # noqa: E402


class HelloWorldModule(Module):
    name = "HelloWorldModule"

    def awake(self) -> None:
        print("HelloWorld awake")

    def init(self) -> None:
        print("HelloWorld init")

    def after_init(self) -> None:
        print("HelloWorld after_init")

    def ready_execute(self) -> None:
        print("HelloWorld ready_execute")

    def execute(self) -> None:
        print(f"HelloWorld execute (frame {self.pm.frame})")

    def before_shut(self) -> None:
        print("HelloWorld before_shut")

    def shut(self) -> None:
        print("HelloWorld shut")


def create_plugin(pm: PluginManager) -> Plugin:
    """The DllStartPlugin/CREATE_PLUGIN equivalent: a module exposing
    create_plugin() is loadable from a Plugin.xml manifest too."""
    m = HelloWorldModule()
    m.pm = pm
    return Plugin("HelloWorldPlugin", [m])


def main(device=None) -> None:
    pm = PluginManager(app_id=1, app_name="Tutorial1")
    pm.register_plugin(create_plugin(pm))
    pm.start()
    pm.run(3)
    pm.shutdown()
    print("tutorial1 done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
