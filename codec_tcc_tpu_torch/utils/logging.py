# Port of codec_tcc_tpu/utils/logging.py under its own logger name.
"""Structured logging for the framework.

The reference logs via bare bilingual ``print`` calls (e.g.
``src/codec.py:806,827,837``); this module replaces them with a
standard :mod:`logging` based logger plus a tiny helper for emitting structured
JSON run reports (replacing ``relatorio_mse.txt`` of ``src/mse.py:330-349``).
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Mapping

_LOGGER_NAME = "codec_tcc_tpu_torch"


def get_logger(name: str | None = None) -> logging.Logger:
    """Return the framework logger (child logger if ``name`` is given)."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    if name:
        return logger.getChild(name)
    return logger


def set_verbosity(level: int | str) -> None:
    get_logger().setLevel(level)


def write_json_report(path: str, report: Mapping[str, Any]) -> None:
    """Write a structured JSON run report (UTF-8, sorted keys, trailing \\n)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=_json_default)
        f.write("\n")


def _json_default(obj: Any) -> Any:
    # numpy scalars / arrays degrade gracefully in reports
    if hasattr(obj, "item") and callable(obj.item):
        try:
            return obj.item()
        except Exception:
            pass
    if hasattr(obj, "tolist") and callable(obj.tolist):
        return obj.tolist()
    return str(obj)
