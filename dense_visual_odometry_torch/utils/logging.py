"""Root-logger configuration.

Counterpart of ``dense_visual_odometry_tpu/utils/logging.py``: the root
logger with a fixed stdout format and a verbosity flag.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s: %(message)s"


def set_root_logger(verbose: bool = False) -> logging.Logger:
    """Configure the root logger (DEBUG if ``verbose`` else INFO) with the
    framework's stdout format; returns it."""
    root = logging.getLogger()
    root.setLevel(logging.DEBUG if verbose else logging.INFO)
    for handler in list(root.handlers):
        root.removeHandler(handler)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    return root
