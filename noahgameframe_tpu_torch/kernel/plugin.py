"""Plugin manager: manifest loading, module registry, lifecycle pump.

Counterpart of ``noahgameframe_tpu/kernel/plugin.py`` (reference
NFCPluginManager: loads Plugin.xml, installs each plugin, drives the
lifecycle, lets modules find each other via FindModule<T>() and supports
hot reload, NFCPluginManager.cpp:60-327).  A plugin is a Python module
exposing ``create_plugin(pm)`` that returns a :class:`Plugin`; loading is
importlib, and a hot reload is importlib.reload plus a new phase chain.
:meth:`PluginManager.run_once` is the host side of the reference main
loop (NFPluginLoader.cpp:250-273): each module's host ``execute()``, then
one observed device tick, whose outputs it returns.
"""

from __future__ import annotations

import importlib
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Type, TypeVar

from .kernel import Kernel, TickOutputs
from .module import SHUTDOWN, Module

M = TypeVar("M", bound=Module)


class Plugin:
    """A named group of modules installed/uninstalled together."""

    def __init__(self, name: str, modules: Sequence[Module] = ()):
        self.name = name
        self.modules: List[Module] = list(modules)

    def add(self, module: Module) -> Module:
        self.modules.append(module)
        return module


class PluginManager:
    def __init__(self, app_id: int = 1, app_name: str = "app"):
        self.app_id = app_id
        self.app_name = app_name
        self.plugins: Dict[str, Plugin] = {}
        self._plugin_sources: Dict[str, str] = {}  # plugin name -> import path
        self.modules: Dict[str, Module] = {}
        self.kernel: Optional[Kernel] = None
        self._started = False
        self.frame = 0

    # -- registration -------------------------------------------------------

    def register_plugin(self, plugin: Plugin, source: str = "") -> Plugin:
        if plugin.name in self.plugins:
            raise ValueError(f"plugin {plugin.name!r} already registered")
        self.plugins[plugin.name] = plugin
        if source:
            self._plugin_sources[plugin.name] = source
        for m in plugin.modules:
            self._register_module(m)
        return plugin

    def _register_module(self, m: Module) -> None:
        if m.name in self.modules:
            raise ValueError(f"module {m.name!r} already registered")
        self.modules[m.name] = m
        if isinstance(m, Kernel):
            self.kernel = m
            for other in self.modules.values():
                other.kernel = m
        m.kernel = self.kernel

    def load_plugin_module(self, import_path: str) -> Plugin:
        """Import a Python module and install its plugin (the reference's
        dlopen + DllStartPlugin)."""
        mod = importlib.import_module(import_path)
        plugin = mod.create_plugin(self)
        return self.register_plugin(plugin, source=import_path)

    def load_manifest(self, path: Path) -> int:
        """Load a Plugin.xml-format manifest: ``<XML><Plugin Name="pkg.mod"/>
        ...`` (reference _Out/Debug/Plugin.xml)."""
        root = ET.parse(str(path)).getroot()
        n = 0
        for p in root.findall("Plugin"):
            self.load_plugin_module(p.get("Name", ""))
            n += 1
        return n

    def find_module(self, cls: Type[M]) -> M:
        """FindModule<T>: the registered instance of a module type."""
        for m in self.modules.values():
            if isinstance(m, cls):
                return m  # type: ignore[return-value]
        raise KeyError(f"no module of type {cls.__name__} registered")

    def find_module_by_name(self, name: str) -> Module:
        return self.modules[name]

    # -- lifecycle ----------------------------------------------------------

    def _each(self, phase: str) -> None:
        for m in self.modules.values():
            getattr(m, phase)()

    def start(self) -> None:
        """awake -> init -> (kernel.build) -> after_init -> check_config ->
        ready_execute -> (compile).  Modules declare schemas and timers in
        init; the world is built before after_init so that phase can
        create seed objects."""
        if self._started:
            return
        self._each("awake")
        self._each("init")
        if self.kernel is not None:
            self.kernel.build(list(self.modules.values()))
        self._each("after_init")
        self._each("check_config")
        self._each("ready_execute")
        if self.kernel is not None:
            self.kernel.compile()
        self._started = True

    def run_once(self) -> Optional[TickOutputs]:
        """One frame: host execute() on every module, then the device tick
        (returned, None without a kernel)."""
        for m in self.modules.values():
            if m is not self.kernel:
                m.execute()
        out = None
        if self.kernel is not None:
            self.kernel.execute()
            out = self.kernel.tick()
        self.frame += 1
        return out

    def run(self, frames: int) -> None:
        for _ in range(frames):
            self.run_once()

    def shutdown(self) -> None:
        for phase in SHUTDOWN:
            self._each(phase)
        self._started = False

    # -- hot reload ---------------------------------------------------------

    def reload_plugin(self, name: str) -> Plugin:
        """Live-patch one plugin (reference ReLoadPlugin): shut its modules,
        re-import the source, re-install, rebuild the phase chain (which
        drops the captured tick).  World state is preserved."""
        source = self._plugin_sources.get(name)
        if source is None:
            raise KeyError(f"plugin {name!r} was not loaded from an import path")
        old = self.plugins.pop(name)
        for m in old.modules:
            m.before_shut()
            m.shut()
            self.modules.pop(m.name, None)
        mod = importlib.reload(importlib.import_module(source))
        plugin = mod.create_plugin(self)
        self.register_plugin(plugin, source=source)
        for m in plugin.modules:
            m.awake()
            m.init()
            m.after_init()
            m.ready_execute()
        if self.kernel is not None:
            # every module contributes its own phases exactly once; the
            # unloaded plugin's phases are gone
            modules = list(self.modules.values())
            self.kernel.set_phases([p for m in modules for p in m.phases], modules)
            self.kernel.compile()
        return plugin
