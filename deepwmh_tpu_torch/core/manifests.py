"""Dataset validation for the CLIs.

The port's own copy of ``deepwmh_tpu.core.manifests.check_dataset``: case
names use the charset A-Z a-z 0-9 _ -, never contain '_to_', are unique, and
every listed file exists.
"""

from __future__ import annotations

import os
import re

_CASE_NAME_RE = re.compile(r"^[A-Za-z0-9_\-]+$")


def check_dataset(dataset: dict, verbose: bool = True) -> bool:
    """Validate a dataset dict {column -> list}; returns False (after
    printing each problem) when any check fails."""
    ok = True
    cases = dataset.get("case", [])
    seen = set()
    for case in cases:
        if not _CASE_NAME_RE.match(case):
            ok = _fail(verbose, "invalid case name %r (allowed: A-Z a-z 0-9 _ -)" % case)
        if "_to_" in case:
            ok = _fail(verbose, "case name %r must not contain '_to_'" % case)
        if case in seen:
            ok = _fail(verbose, "duplicated case name %r" % case)
        seen.add(case)
    for key, values in dataset.items():
        if key in ("case", "desc"):
            continue
        for case, v in zip(cases, values):
            if isinstance(v, str) and v and not os.path.isfile(v):
                ok = _fail(verbose, "case %r: file not found: %s" % (case, v))
    return ok


def _fail(verbose: bool, msg: str) -> bool:
    if verbose:
        print("[dataset check] " + msg)
    return False
