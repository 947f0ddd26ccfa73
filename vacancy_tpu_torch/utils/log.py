"""Leveled logging (reference: include/vacancy/log.h:10-24, src/vacancy/log.cc).

Thin wrapper over Python logging with the reference's global-level API.
"""

from __future__ import annotations

import enum
import logging

_logger = logging.getLogger("vacancy_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


class LogLevel(enum.IntEnum):
    kVerbose = logging.DEBUG
    kDebug = logging.DEBUG
    kInfo = logging.INFO
    kWarning = logging.WARNING
    kError = logging.ERROR
    kNone = logging.CRITICAL + 1


def set_log_level(level: LogLevel) -> None:
    _logger.setLevel(int(level))


def get_log_level() -> int:
    return _logger.level


def LOGD(fmt: str, *args) -> None:
    _logger.debug(fmt, *args)


def LOGI(fmt: str, *args) -> None:
    _logger.info(fmt, *args)


def LOGW(fmt: str, *args) -> None:
    _logger.warning(fmt, *args)


def LOGE(fmt: str, *args) -> None:
    _logger.error(fmt, *args)
