"""Small runtime helpers (the port's copy of ``deepwmh_tpu.utils.misc``)."""

from __future__ import annotations

import contextlib
import signal
from collections import OrderedDict


@contextlib.contextmanager
def ignore_sigint():
    """Defer Ctrl-C while writing artifacts that must not be left half
    written; a Ctrl-C received meanwhile is raised at the end. Outside the
    main thread (no signal handler can be set there) it does nothing."""
    received = []

    def handler(sig, frame):
        received.append((sig, frame))

    try:
        old = signal.signal(signal.SIGINT, handler)
    except ValueError:  # not the main thread
        yield
        return
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, old)
        if received:
            raise KeyboardInterrupt


def remove_duplicates(seq):
    """Order-preserving dedup."""
    return list(dict.fromkeys(seq))


def contain_duplicates(seq) -> bool:
    return len(set(seq)) != len(seq)


def minibar(progress: float, width: int = 30, msg: str = "") -> str:
    """Tiny text progress bar string."""
    progress = min(max(progress, 0.0), 1.0)
    filled = int(progress * width)
    return "[%s%s] %3d%% %s" % ("#" * filled, "-" * (width - filled),
                                int(progress * 100), msg)


class BoundedCache:
    """A tiny LRU mapping: past ``maxsize`` entries the least recently used
    one is dropped."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = int(maxsize)
        self._d = OrderedDict()

    def __contains__(self, key):
        return key in self._d

    def __len__(self):
        return len(self._d)

    def __getitem__(self, key):
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def keys(self):
        return list(self._d.keys())
