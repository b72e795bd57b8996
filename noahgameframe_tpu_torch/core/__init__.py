"""The entity core: datatypes, class schemas, the SoA entity store and the
string table.  Counterpart of ``noahgameframe_tpu/core`` with its exports."""

from .datatypes import Bank, DataType, Guid, GuidAllocator, NULL_GUID, NULL_OBJECT
from .element import Element, ElementStore, ElementTable
from .schema import (
    ClassDef,
    ClassRegistry,
    ClassSpec,
    ComponentDef,
    PropertyDef,
    RecordColDef,
    RecordDef,
    load_logic_class_xml,
    prop,
    record,
)
from .store import (
    ClassState,
    EntityStore,
    RecordState,
    StoreConfig,
    TimerState,
    WorldState,
    pack_handle,
    unpack_handle,
)
from .strings import StringTable

__all__ = [
    "Bank",
    "ClassDef",
    "ClassRegistry",
    "ClassSpec",
    "ClassState",
    "ComponentDef",
    "DataType",
    "Element",
    "ElementStore",
    "ElementTable",
    "EntityStore",
    "Guid",
    "GuidAllocator",
    "NULL_GUID",
    "NULL_OBJECT",
    "PropertyDef",
    "RecordColDef",
    "RecordDef",
    "RecordState",
    "StoreConfig",
    "StringTable",
    "TimerState",
    "WorldState",
    "load_logic_class_xml",
    "pack_handle",
    "prop",
    "record",
    "unpack_handle",
]
