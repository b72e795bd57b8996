"""Kernel layer: the world tick, modules, plugins, events, components and
actors; the JAX package's ``noahgameframe_tpu.kernel`` exports, under the
same names."""

from .actor import ActorComponent, ActorModule, AsyncSqlModule
from .component import Component as ObjectComponent
from .component import ComponentModule
from .events import DeviceEvent, EventModule
from .kernel import Kernel, ObjectEvent, TickCtx, TickOutputs
from .module import Module, Phase
from .plugin import Plugin, PluginManager
from .schedule import ScheduleModule

__all__ = [
    "ActorComponent",
    "ActorModule",
    "AsyncSqlModule",
    "ComponentModule",
    "DeviceEvent",
    "EventModule",
    "Kernel",
    "Module",
    "ObjectComponent",
    "ObjectEvent",
    "Phase",
    "Plugin",
    "PluginManager",
    "ScheduleModule",
    "TickCtx",
    "TickOutputs",
]
