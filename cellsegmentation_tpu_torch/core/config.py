"""Config handling: the reference's two-line ``config.ini`` with
``[data] data_path``, read by every CLI."""

from __future__ import annotations

import configparser
import os


def load_data_path(ini_path: str = "config.ini", default: str = "./data") -> str:
    """Read ``[data] data_path`` from an ini file; fall back to ``default``."""
    if os.path.exists(ini_path):
        parser = configparser.ConfigParser()
        parser.read(ini_path)
        if parser.has_option("data", "data_path"):
            return parser.get("data", "data_path")
    return default
