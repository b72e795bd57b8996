"""Property-trail debug logging: follow every property change of chosen
objects.

Reference: NFCPropertyTrailModule
(NFServer/NFGameServerPlugin/NFCPropertyTrailModule.cpp) — StartTrail
dumps the object's data and hooks its property/record callbacks so each
subsequent change is logged; EndTrail unhooks.  The reference version is
mostly a stub (empty Execute/EndTrail, Trail* bodies log-only); here the
same surface is implemented completely on top of the kernel's
property-event spine.

Design note: property events in this framework arrive *batched per
(class, property)* with changed row indices (the device diff path), so
the trail keeps a per-class set of tracked rows and filters each batch —
one subscription per property regardless of how many objects are
trailed, and zero cost on the compiled tick (diff extraction is already
flag-driven).  A class-event hook drops dead rows from the tracked set
so a recycled row never trails the unrelated object that inherits it.

A copy of ``noahgameframe_tpu/game/trail.py``, which imports no jax: the
port keeps its own.  The port's ``force_diff_property`` invalidates the
captured tick once per new column, and those drops collapse into one
re-capture at the next dispatch, so a trail start costs one capture.
"""

from __future__ import annotations

from typing import Dict, Set

import numpy as np

from ..core.datatypes import Guid
from ..kernel.kernel import ObjectEvent
from ..kernel.module import Module


class PropertyTrailModule(Module):
    """StartTrail/EndTrail per-object property change logging."""

    name = "PropertyTrailModule"

    def __init__(self, logger=None):
        super().__init__()
        self._logger = logger  # LogModule-like (info/debug) or None -> print
        # class -> set of tracked rows; class -> whether subs installed
        self._rows: Dict[str, Set[int]] = {}
        self._hooked: Set[str] = set()
        # trail's own guid -> (class, row): rows are recycled on destroy
        # (store free-list) and DESTROY fires after the guid is unmapped,
        # so the store can't answer "which row was that" at cleanup time
        self._tracked: Dict[Guid, tuple] = {}

    def after_init(self) -> None:
        self.kernel.register_class_event(self._on_class_event)

    # -- public surface (reference StartTrail/EndTrail) ----------------------

    def start_trail(self, guid: Guid) -> None:
        """Log the object's current data, then follow every change."""
        class_name, row = self.kernel.store.row_of(guid)
        self._log_object_data(guid, class_name)
        self._rows.setdefault(class_name, set()).add(row)
        self._tracked[guid] = (class_name, row)
        if class_name not in self._hooked:
            self._hooked.add(class_name)
            spec = self.kernel.store.spec(class_name)
            for prop_name in spec.prop_order:
                # unflagged (non-public/upload) properties are normally
                # excluded from device diff extraction — a trail must see
                # ALL changes, so opt every column in (recompiles the
                # tick once per newly-trailed class)
                self.kernel.force_diff_property(class_name, prop_name)
                self.kernel.register_property_event(
                    class_name, prop_name, self._on_prop_batch
                )

    def end_trail(self, guid: Guid) -> None:
        """Idempotent; a destroyed guid is already un-trailed."""
        loc = self._tracked.pop(guid, None)
        if loc is not None:
            self._rows.get(loc[0], set()).discard(loc[1])

    def is_trailing(self, guid: Guid) -> bool:
        return guid in self._tracked

    # -- internals -----------------------------------------------------------

    def _on_class_event(self, guid: Guid, class_name: str, ev) -> None:
        if ev == ObjectEvent.DESTROY:
            self.end_trail(guid)

    def _log(self, msg: str) -> None:
        if self._logger is not None:
            self._logger.info(msg)
        else:  # pragma: no cover - fallback path
            print(msg)

    def _log_object_data(self, guid: Guid, class_name: str) -> None:
        """The LogObjectData dump: every property's current value."""
        spec = self.kernel.store.spec(class_name)
        for prop_name in spec.prop_order:
            val = self.kernel.get_property(guid, prop_name)
            self._log(f"[trail] {guid} {class_name}.{prop_name} = {val!r}")

    def _on_prop_batch(
        self, class_name: str, prop_name: str, rows: np.ndarray
    ) -> None:
        tracked = self._rows.get(class_name)
        if not tracked:
            return
        host = self.kernel.store._hosts[class_name]
        for row in np.asarray(rows).tolist():
            if row in tracked:
                guid = host.row_guid[row]
                if guid is None:  # row died between diff and delivery
                    continue
                val = self.kernel.get_property(guid, prop_name)
                self._log(
                    f"[trail] {guid} {class_name}.{prop_name} -> {val!r}"
                )
