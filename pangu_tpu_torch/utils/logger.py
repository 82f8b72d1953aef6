"""File+stream logging (role of reference era5_data/utils.py:18-38).

The port's own copy of ``pangu_tpu/utils/logger.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.
"""

from __future__ import annotations

import logging
import os
from typing import Optional


def get_logger(name: str, log_path: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d : %(message)s", datefmt="%y-%m-%d %H:%M:%S"
    )
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        fh = logging.FileHandler(log_path, mode="a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger
