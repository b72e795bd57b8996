"""Python client SDK: ``GameClient`` and its world mirror ``MirrorObject``.

Counterpart of ``noahgameframe_tpu/client``."""

from .sdk import GameClient, MirrorObject  # noqa: F401
