"""Dataset manifests for the CLIs: the CSV contract and its validation.

The port's own copy of ``deepwmh_tpu.core.manifests``: ``load_csv_simple``
/ ``write_csv_simple`` read and write the reference CLIs' CSVs (a header row,
then one row per case); ``check_dataset`` checks that case names use the
charset A-Z a-z 0-9 _ -, never contain '_to_', are unique, and that every
listed file exists.
"""

from __future__ import annotations

import csv
import os
import re

_CASE_NAME_RE = re.compile(r"^[A-Za-z0-9_\-]+$")


def load_csv_simple(path: str, key_names: list) -> dict:
    """Load a CSV into {column -> list}; requires a header row containing
    each requested key."""
    table = {k: [] for k in key_names}
    with open(path, "r", newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError("empty CSV file: %s" % path)
        missing = [k for k in key_names if k not in reader.fieldnames]
        if missing:
            raise ValueError("CSV %s is missing column(s): %s" % (path, missing))
        for n, row in enumerate(reader, start=2):
            for k in key_names:
                v = row.get(k)
                if v is None:  # ragged row: DictReader fills missing cells
                    raise ValueError("CSV %s row %d is missing a value for column '%s'"
                                     % (path, n, k))
                table[k].append(v.strip())
    return table


def write_csv_simple(path: str, table: dict) -> None:
    keys = list(table.keys())
    n = len(table[keys[0]]) if keys else 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(keys)
        for i in range(n):
            writer.writerow([table[k][i] for k in keys])


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
