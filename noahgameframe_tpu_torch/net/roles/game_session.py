"""The game role's session record and the helpers its mixins share."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from ...core.datatypes import Guid
from ..wire import Ident

_IdentKey = Tuple[int, int]

# row-identified wire targets (hero/equip record rows) ride Ident.index
# with THIS svrid tag — row 0 is valid, and protoc clients always send
# the required field (zeroed when untargeted), so a plain falsy test on
# the index cannot discriminate "no target" from "row 0"
ROW_TARGET_SVRID = 1


def guid_ident(g: Guid) -> Ident:
    """GUID ↔ wire Ident (`NFMsgBase.proto` Ident{svrid,index})."""
    return Ident(svrid=g.head, index=g.data)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class Session:
    ident: Ident
    conn_id: int  # proxy connection that owns this client
    account: str = ""
    guid: Optional[Guid] = None
