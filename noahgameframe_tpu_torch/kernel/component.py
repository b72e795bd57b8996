"""Per-object component system (reference NFIComponent / NFCComponentManager).

Counterpart of ``noahgameframe_tpu/kernel/component.py``, whose text it
keeps.  The reference attaches named components to objects via the class XML
(`<Components><Component Name=... Enable=.../>`), clones a registered
prototype per instance (`CreateNewInstance`, NFIComponent.h:16-80), and
executes every object's enabled components from `NFCObject::Execute`
inside the kernel tick (NFCObject.cpp:42-47, NFCComponentManager.cpp).

Contract: components are the HOST path for divergent per-object
logic — the code that doesn't batch (scripted bosses, quest triggers,
per-object AI exceptions).  Anything batchable belongs in a Module device
phase instead; a component may itself register device phases through its
module at build time.  This is the "batchable module vs host module"
seam SURVEY §7 calls out.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type, Union

from ..core.datatypes import Guid
from .module import Module


class Component:
    """Base per-object component (NFIComponent).

    Subclass and override the lifecycle hooks; `self.kernel` and
    `self.guid` are bound before `init()`.  `new_instance` is the
    CreateNewInstance clone used when attaching to an object."""

    name: str = ""
    language: str = "python"

    def __init__(self) -> None:
        if not self.name:
            self.name = type(self).__name__
        self.enabled = True
        self.has_init = False
        self.kernel = None
        self.guid: Optional[Guid] = None

    # -- lifecycle (mirrors NFIComponent's Init/AfterInit/Execute/BeforeShut)
    def init(self) -> None: ...

    def after_init(self) -> None: ...

    def execute(self) -> None:
        """Per-frame host logic for this one object."""

    def before_shut(self) -> None: ...

    def new_instance(self) -> "Component":
        return type(self)()

    def set_enable(self, enable: bool) -> None:
        self.enabled = bool(enable)


ComponentFactory = Union[Type[Component], Callable[[], Component]]


class ComponentModule(Module):
    """Registry + per-object execution of components.

    Prototypes are registered by name; objects get instances attached
    automatically at CREATE_FINISH when their class schema lists a
    `<Component>` of that name (NFCClassModule.cpp:203-228), or manually
    via `attach`.  Instances are torn down at BEFORE_DESTROY."""

    name = "ComponentModule"

    def __init__(self) -> None:
        super().__init__()
        self._protos: Dict[str, ComponentFactory] = {}
        self._instances: Dict[Guid, List[Component]] = {}

    # -- registration --------------------------------------------------------

    def register(self, factory: ComponentFactory,
                 name: Optional[str] = None) -> None:
        """Register a component prototype under `name` (defaults to the
        class's `name`/__name__)."""
        if name is None:
            proto = factory() if not isinstance(factory, type) else None
            name = (proto.name if proto is not None
                    else (factory.name or factory.__name__))
        self._protos[name] = factory

    def _make(self, name: str) -> Optional[Component]:
        f = self._protos.get(name)
        if f is None:
            return None
        inst = f()
        if isinstance(inst, Component):
            return inst
        return None

    # -- kernel binding ------------------------------------------------------

    def after_init(self) -> None:
        from .kernel import ObjectEvent

        def on_event(guid: Guid, cname: str, ev) -> None:
            if ev == ObjectEvent.CREATE_FINISH:
                self._attach_schema_components(guid, cname)
            elif ev == ObjectEvent.BEFORE_DESTROY:
                self.detach_all(guid)

        self.kernel.register_class_event(on_event)

    def _attach_schema_components(self, guid: Guid, cname: str) -> None:
        spec = self.kernel.store.spec(cname)
        for cdef in spec.cls.components:
            inst = self._make(cdef.name)
            if inst is None:
                continue  # schema names a component no code registered
            inst.enabled = bool(getattr(cdef, "enable", True))
            self._bind(guid, inst)

    def _bind(self, guid: Guid, inst: Component) -> None:
        inst.kernel = self.kernel
        inst.guid = guid
        self._instances.setdefault(guid, []).append(inst)
        inst.init()
        inst.after_init()
        inst.has_init = True

    # -- public API (NFIKernelModule::AddComponent / FindComponent) ----------

    def attach(self, guid: Guid, component: Union[str, Component]) -> Optional[Component]:
        """Attach by registered name or from a prototype instance clone."""
        inst = (self._make(component) if isinstance(component, str)
                else component.new_instance())
        if inst is None:
            return None
        self._bind(guid, inst)
        return inst

    def find(self, guid: Guid, name: str) -> Optional[Component]:
        for c in self._instances.get(guid, ()):
            if c.name == name:
                return c
        return None

    def components_of(self, guid: Guid) -> List[Component]:
        return list(self._instances.get(guid, ()))

    def set_enable(self, guid: Guid, name: str, enable: bool) -> bool:
        c = self.find(guid, name)
        if c is None:
            return False
        c.set_enable(enable)
        return True

    def detach_all(self, guid: Guid) -> None:
        for c in self._instances.pop(guid, ()):
            try:
                c.before_shut()
            finally:
                c.kernel = None

    # -- per-frame host execution -------------------------------------------

    def execute(self) -> None:
        """The reference's per-object Execute loop, scoped to objects that
        actually carry components (everything batch lives in device
        phases, so this loop is small by construction)."""
        for comps in self._instances.values():
            for c in comps:
                if c.enabled:
                    c.execute()
