"""Tutorial 2 — data-driven entities: properties, records, elements, on the
PyTorch port.

The port's counterpart of examples/tutorial2_properties.py (the
reference's Tutorial2): define a class schema, create an object, read and
write typed properties and table records, seed from element config.  The
schema compiles to SoA banks on the device (``cuda`` unless ``--device
cpu``), and the host API keeps the reference's shape
(`SetPropertyInt`/`GetPropertyInt` become `set_property`/`get_property`).

Run:  python examples/torch_tutorial2_properties.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.core.schema import ClassDef, ClassRegistry, prop, record  # noqa: E402
from noahgameframe_tpu_torch.core.store import StoreConfig  # noqa: E402
from noahgameframe_tpu_torch.kernel import Kernel, Plugin, PluginManager  # noqa: E402


def build_registry() -> ClassRegistry:
    reg = ClassRegistry()
    reg.define(ClassDef(
        name="IObject",
        properties=[
            prop("ID", "string", private=True),
            prop("SceneID", "int", private=True),
            prop("GroupID", "int", private=True),
        ],
    ))
    reg.define(ClassDef(
        name="Knight",
        parent="IObject",
        properties=[
            prop("Name", "string", public=True, save=True),
            prop("HP", "int", public=True, save=True),
            prop("Speed", "float", public=True),
            prop("Home", "vector3", private=True),
        ],
        records=[record("KillLog", 8, [("Victim", "string"), ("Count", "int")],
                        private=True)],
    ))
    return reg


def main(device=None) -> None:
    kernel = Kernel(build_registry(), StoreConfig(default_capacity=16), device=device)
    pm = PluginManager(app_name="Tutorial2")
    pm.register_plugin(Plugin("KernelPlugin", [kernel]))
    pm.start()

    g = kernel.create_object("Knight", {"Name": "Lancelot", "HP": 120,
                                        "Speed": 1.5, "Home": (1.0, 2.0, 0.0)})
    print("Name:", kernel.get_property(g, "Name"))
    print("HP:", kernel.get_property(g, "HP"))
    kernel.set_property(g, "HP", 95)
    print("HP after hit:", kernel.get_property(g, "HP"))
    print("Home:", kernel.get_property(g, "Home"))

    # records: AddRow / SetInt / FindRowsByTag parity
    store = kernel.store
    kernel.state, row = store.record_add_row(
        kernel.state, g, "KillLog", {"Victim": "goblin", "Count": 3})
    kernel.state = store.record_set(kernel.state, g, "KillLog", row, "Count", 4)
    print("KillLog[goblin] =", store.record_get(
        kernel.state, g, "KillLog", row, "Count"))
    print("rows for goblin:", store.record_find_rows(
        kernel.state, g, "KillLog", "Victim", "goblin"))

    # property-change subscription (per-write host callbacks)
    kernel.register_property_event(
        "Knight", "HP",
        lambda cname, pname, rows: print(f"HP changed on rows {rows}"))
    kernel.set_property(g, "HP", 90)
    pm.run(1)
    pm.shutdown()
    print("tutorial2 done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
