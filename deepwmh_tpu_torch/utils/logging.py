"""Run logging, a wall-clock timer and stage timestamps (the port's copy
of ``deepwmh_tpu.utils.logging``)."""

from __future__ import annotations

import datetime
import os
import time


class SimpleTxtLog:
    """Timestamped append-only text log."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w"):
                pass

    def write(self, msg: str, timestamp: bool = True) -> None:
        stamp = ""
        if timestamp:
            stamp = datetime.datetime.now().strftime("[%Y-%m-%d %H:%M:%S] ")
        with open(self.path, "a") as f:
            f.write(stamp + msg + "\n")


class Timer:
    """Wall-clock timer."""

    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start

    def restart(self) -> float:
        e = self.elapsed()
        self.start = time.time()
        return e


class TimeStamps:
    """Named timestamps for stage bookkeeping."""

    def __init__(self):
        self._stamps = {}

    def record(self, name: str) -> None:
        self._stamps[name] = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")

    def get(self, name: str) -> str:
        return self._stamps.get(name, "<not recorded>")
