"""Artifact helpers: marker-file checkpoints, atomic JSON writes and the
output-folder layout.

The port's own copy of the parts of ``deepwmh_tpu.core.artifacts`` that the
predict, serving and training paths use. ``Checkpoints`` keeps the same
marker names and layout (one empty file per finished phase), so a pipeline
folder one package marked is a folder the other resumes.
"""

from __future__ import annotations

import json
import os
import tempfile


class Checkpoints:
    """Marker-file resume system: ``<folder>/<name>`` exists once the phase
    ``name`` has finished."""

    def __init__(self, folder: str, enabled: bool = True):
        self.folder = folder
        self.enabled = enabled
        os.makedirs(folder, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.folder, name)

    def is_finished(self, name: str) -> bool:
        return self.enabled and os.path.exists(self._path(name))

    def set_finish(self, name: str) -> None:
        with open(self._path(name), "w"):
            pass

    def clear(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass


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


def try_load_json(path: str) -> bool:
    """True when ``path`` holds readable JSON."""
    try:
        load_json(path)
        return True
    except (OSError, ValueError):
        return False


def mkdir(path: str) -> str:
    """mkdir -p, returning the path."""
    os.makedirs(path, exist_ok=True)
    return path


def join_path(*parts) -> str:
    return os.path.join(*parts)
