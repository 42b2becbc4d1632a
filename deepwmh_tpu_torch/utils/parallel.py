"""Host-side parallel fan-out for I/O-bound work (the port's copy of
``deepwmh_tpu.utils.parallel.run_parallel``).

A thread pool: the host work is gzip/NIfTI I/O, whose zlib calls release
the interpreter lock, while the compute runs on the card. The first worker
exception cancels the rest and is raised.
"""

from __future__ import annotations

from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait

from deepwmh_tpu_torch.utils.misc import minibar


def run_parallel(fn, tasks, num_workers: int = 8, desc: str = "", show_progress=True):
    """Apply fn to every task; fail fast on the first exception. Returns
    results in task order."""
    results = [None] * len(tasks)
    if not tasks:
        return results
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = {pool.submit(fn, t): i for i, t in enumerate(tasks)}
        pending = set(futures)
        done_count = 0
        while pending:
            done, pending = wait(pending, return_when=FIRST_EXCEPTION)
            for f in done:
                exc = f.exception()
                if exc is not None:
                    for p in pending:
                        p.cancel()
                    raise exc
                results[futures[f]] = f.result()
                done_count += 1
            if show_progress and desc:
                print("\r" + minibar(done_count / len(tasks), msg=desc),
                      end="", flush=True)
        if show_progress and desc:
            print()
    return results
