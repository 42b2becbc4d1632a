"""What every cell's driver shares. A driver is ``drivers/<name>.py`` with
a ``Driver`` class, named by its traffic file's ``driver`` key; the
harness calls ``plant`` (tests and readings only), ``setup``, ``run``,
``release``, ``check`` and, for a traced run, ``context``; the readings
tool also ``control`` and ``look``."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from wmhbench.harness import derive_seed


class Driver:
    FAULTS = ()  # the faults a test or a reading may plant in the timed path

    def __init__(self, cell, seed: int, device, workdir: str):
        self.cell = cell
        self.cfg = cell.config
        self.tr = cell.traffic
        self.plan = self.cfg["plan"]
        self.seed = derive_seed(seed, cell.driver)
        self.device = device
        self.workdir = workdir
        self.attempted = self.failed = 0
        self.fault = None
        self.done = []  # what each unit of the window left to check

    def plant(self, fault: str):
        if fault not in self.FAULTS:
            raise ValueError("%s cells have no fault %r (%s)"
                             % (self.cell.driver, fault, ", ".join(self.FAULTS)))
        self.fault = fault

    def closed_loop(self, win, unit):
        """One unit after another until the window closes; ``unit(i)``
        returns what the check needs of unit i."""
        win.begin()
        while True:
            self.attempted += 1
            self.done.append(unit(len(self.done)))
            if win.unit_done(synced=True):
                break
        win.end()

    def release(self):
        """Free the program's state before the check."""

    def sample(self) -> list:
        """``check_cases`` of the window's units, drawn from the seed."""
        rng = np.random.RandomState(derive_seed(self.seed, "check"))
        k = min(int(self.tr["check_cases"]), len(self.done))
        return [self.done[j] for j in sorted(rng.choice(len(self.done), k, replace=False))]

    @staticmethod
    def worst(rows: list) -> dict:
        return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}

    def context(self, win, **extra):
        """What a metric reader sees of a run: the whole window
        (``window_units``, ``window_s``, ``setup_s``) for the end-to-end
        metrics; the trace and the rate after it for the per-layer ones."""
        units, seconds = win.untraced_rate()
        return SimpleNamespace(cell=self.cell, plan=self.plan, trace=win.trace, units=units,
                               elapsed=seconds, traced_units=win.traced_units,
                               window_units=win.units, window_s=win.elapsed,
                               setup_s=win.setup_s,
                               volume_shape=self.cfg["volume_shape"],
                               spacing=self.cfg["spacing"], **extra)
