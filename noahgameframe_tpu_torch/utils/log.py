"""Log module: role-aware structured game logging with rollover.

Reference: NFLogPlugin wraps easylogging++ — per-server conf files, a
level enum (`NLL_DEBUG_NORMAL…NLL_FATAL_NORMAL`), the game-specific API
surface `LogElement/LogProperty/LogRecord/LogObject/LogNormal`
(`NFCLogModule.h:34-49`) and a 200 MB rollout handler
(`NFCLogModule.cpp:33-50`).  Implemented over stdlib logging with size
rollover; the game-specific calls format GUID/property/record context
the same way so grep-driven ops workflows carry over.

A copy of ``noahgameframe_tpu/utils/log.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import logging
import logging.handlers
import sys
from pathlib import Path
from typing import Optional

from ..core.datatypes import Guid
from ..kernel.module import Module

ROLLOVER_BYTES = 200 * 1024 * 1024  # the reference's 200 MB rollout


class LogLevel(enum.IntEnum):
    """NF_LOG_LEVEL (NFILogModule.h)."""

    DEBUG = logging.DEBUG
    INFO = logging.INFO
    WARNING = logging.WARNING
    ERROR = logging.ERROR
    FATAL = logging.CRITICAL


class LogModule(Module):
    name = "LogModule"

    def __init__(
        self,
        app_name: str = "server",
        app_id: int = 0,
        log_dir: Optional[Path] = None,
        level: LogLevel = LogLevel.INFO,
        to_stderr: bool = False,
        rollover_bytes: int = ROLLOVER_BYTES,
        backups: int = 5,
    ) -> None:
        super().__init__()
        self.app_name = app_name
        self.app_id = app_id
        self._logger = logging.getLogger(f"nf.{app_name}.{app_id}")
        self._logger.setLevel(int(level))
        self._logger.propagate = False
        # getLogger returns a shared instance: drop handlers left by a
        # previous LogModule with the same identity (restart paths) so
        # lines aren't duplicated into leaked file handles
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)
        fmt = logging.Formatter(
            "%(asctime)s [%(levelname)s] " + f"{app_name}:{app_id} "
            + "%(message)s"
        )
        if log_dir is not None:
            log_dir = Path(log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            h = logging.handlers.RotatingFileHandler(
                log_dir / f"{app_name}_{app_id}.log",
                maxBytes=rollover_bytes,
                backupCount=backups,
            )
            h.setFormatter(fmt)
            self._logger.addHandler(h)
        if to_stderr or log_dir is None:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(fmt)
            self._logger.addHandler(h)

    # -- plain levels ----------------------------------------------------
    def log(self, level: int, msg: str, *args) -> None:
        # level is a LogLevel (IntEnum) — declared int: a host scalar,
        # never a traced value
        self._logger.log(int(level), msg, *args)

    def debug(self, msg: str, *args) -> None:
        self.log(LogLevel.DEBUG, msg, *args)

    def info(self, msg: str, *args) -> None:
        self.log(LogLevel.INFO, msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.log(LogLevel.WARNING, msg, *args)

    def error(self, msg: str, *args) -> None:
        self.log(LogLevel.ERROR, msg, *args)

    def fatal(self, msg: str, *args) -> None:
        self.log(LogLevel.FATAL, msg, *args)

    # -- game-shaped API (reference NFCLogModule.h:34-49) ----------------
    def log_normal(self, level: LogLevel, guid: Guid, msg: str,
                   detail: str = "") -> None:
        self.log(level, "[%s] %s %s", guid, msg, detail)

    def log_element(self, level: LogLevel, guid: Guid, element_id: str,
                    desc: str = "") -> None:
        self.log(level, "[%s] element=%s %s", guid, element_id, desc)

    def log_property(self, level: LogLevel, guid: Guid, prop_name: str,
                     desc: str = "") -> None:
        self.log(level, "[%s] property=%s %s", guid, prop_name, desc)

    def log_record(self, level: LogLevel, guid: Guid, record_name: str,
                   desc: str = "") -> None:
        self.log(level, "[%s] record=%s %s", guid, record_name, desc)

    def log_object(self, level: LogLevel, guid: Guid) -> None:
        """Dump one object's full state (reference LogObject / kernel
        LogSelfInfo, `NFCKernelModule.h:137-139`)."""
        k = self.kernel
        if k is None or guid not in k.store.guid_map:
            self.log(level, "[%s] <no such object>", guid)
            return
        cname, _ = k.store.row_of(guid)
        spec = k.store.spec(cname)
        parts = []
        for pname in spec.prop_order:
            try:
                parts.append(f"{pname}={k.get_property(guid, pname)!r}")
            except Exception:
                parts.append(f"{pname}=<err>")
        self.log(level, "[%s] class=%s %s", guid, cname, " ".join(parts))

    def shut(self) -> None:
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)
