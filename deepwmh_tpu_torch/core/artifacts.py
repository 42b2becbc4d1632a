"""Artifact helpers: atomic JSON writes and the output-folder layout.

The port's own copy of the parts of ``deepwmh_tpu.core.artifacts`` that the
predict, serving and training paths use.
"""

from __future__ import annotations

import json
import os
import tempfile


def atomic_write_json(obj, path: str) -> None:
    """Write JSON atomically so a killed process never leaves a truncated
    file that would defeat the loadability probes."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def mkdir(path: str) -> str:
    """mkdir -p, returning the path."""
    os.makedirs(path, exist_ok=True)
    return path


def join_path(*parts) -> str:
    return os.path.join(*parts)
