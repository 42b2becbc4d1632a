"""Spool-directory inference serving: load the model once, stream volumes
(the port of ``deepwmh_tpu.pipeline.serve``).

  spool/<case>.nii.gz          a request (any NIfTI; case = file stem)
  spool/.work/<server_id>/     claimed requests (atomic os.rename claim)
  spool/.done/<case>.json      receipt: timings + output paths + input sha256
  spool/.failed/<case>.nii.gz  the input that failed (+ <case>.err trace)
  spool/STOP                   sentinel: finish the current case and exit
  spool/.status/<server_id>.json   live counters, and the heartbeat

Outputs use the exact DeepWMH_predict layout under ``output_folder``.
Scale-out is N independent servers (one per card or host) pointed at one
spool on a shared filesystem: the rename claim is atomic on POSIX, so each
request runs exactly once. The claim, provenance, quarantine and recovery
logic is the JAX package's, line for line; the predictor is the port's
``SlidingWindowPredictor`` on ``device`` (CUDA unless the CPU is asked
for), or with ``mesh`` the ``ShardedSlidingWindowPredictor``: one server
spreads each volume's sweep over the mesh, and a burst runs one case a
shard.
"""

from __future__ import annotations

import json
import os
import time
import traceback

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import join_path, mkdir
from deepwmh_tpu_torch.pipeline.inference import (
    _case_paths,
    make_output_folders,
    predict_batch_cases,
    predict_one_case,
)
from deepwmh_tpu_torch.parallel.infer_sharded import ShardedSlidingWindowPredictor
from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
from deepwmh_tpu_torch.unet.release import load_released_model, resolve_model_dir

_NIFTI_EXTS = (".nii.gz", ".nii")


def case_name_of(filename: str):
    """Request file → case name (stem without the NIfTI extension), or
    None if the file is not a NIfTI request."""
    for ext in _NIFTI_EXTS:
        if filename.endswith(ext) and len(filename) > len(ext):
            return filename[: -len(ext)], ext
    return None


class SpoolServer:
    """Warm-model inference server over a spool directory."""

    def __init__(
        self,
        spool_dir,
        output_folder,
        model_dir,
        skip_bfc: bool = False,
        tta: bool = True,
        make_previews: bool = True,
        checkpoint_name: str = "model_best",
        poll_interval: float = 2.0,
        server_id: str | None = None,
        settle_seconds: float = 2.0,
        stale_after: float = 1800.0,
        task_name: str | None = None,
        batch_max: int | None = None,
        device=None,
        mesh=None,
    ):
        self.spool_dir = mkdir(spool_dir)
        self.folders = make_output_folders(output_folder)
        self.skip_bfc = skip_bfc
        self.make_previews = make_previews
        self.poll_interval = float(poll_interval)
        self.settle_seconds = float(settle_seconds)
        self.stale_after = float(stale_after)
        self.server_id = server_id or ("srv%d" % os.getpid())

        self.work_dir = mkdir(join_path(mkdir(join_path(self.spool_dir, ".work")),
                                        self.server_id))
        self.done_dir = mkdir(join_path(self.spool_dir, ".done"))
        self.failed_dir = mkdir(join_path(self.spool_dir, ".failed"))
        self.status_dir = mkdir(join_path(self.spool_dir, ".status"))

        # same -m semantics as DeepWMH_predict: a root holding one task
        # folder resolves to it; task_name picks one of several
        model_dir = resolve_model_dir(model_dir, task_name)
        if mesh is not None:
            model, plan = load_released_model(
                model_dir, checkpoint_name, device=mesh.devices[0] if device is None else device)
            self.predictor = ShardedSlidingWindowPredictor(model, plan, mesh, tta=tta,
                                                           device=device)
        else:
            model, plan = load_released_model(model_dir, checkpoint_name, device=device)
            self.predictor = SlidingWindowPredictor(model, plan, tta=tta, device=device)

        # burst batching: same-geometry requests that are claimable at the
        # same moment run as ONE batched sweep (bounded latency: only what
        # is already pending is batched — a lone request never waits). The
        # JAX package's measured policy: off (1) on one device unless
        # batch_max is set; with a mesh one case a shard, capped at the
        # mesh size (a lone request still takes the sharded sweep).
        if mesh is None:
            self.batch_max = 1 if batch_max is None else max(int(batch_max), 1)
        elif batch_max is None:
            self.batch_max = mesh.size
        else:
            self.batch_max = max(min(int(batch_max), mesh.size), 1)

        self._t0 = time.time()
        self.served = 0
        self.failed = 0
        self._stop = False

    # -- claim/process/ack ------------------------------------------------

    def claim_one(self):
        """Atomically claim the oldest pending request; returns
        (case, claimed_path) or None. os.rename is atomic within a
        filesystem, so concurrent servers never double-claim.

        A request is only claimable once its mtime is settle_seconds old:
        a client cp/scp-ing into the spool (a non-atomic write) keeps
        bumping mtime while it streams, so the guard skips half-written
        files instead of quarantining them mid-copy. Clients that write to
        a temp name and rename into the spool are claimable immediately."""
        # heartbeat BEFORE claiming: an idle-for-a-while server whose
        # heartbeat only landed after the rename would leave a window where
        # another server's recover_stale re-spools the just-claimed request
        # (double processing)
        self._heartbeat()
        pending = []
        now = time.time()
        for fn in os.listdir(self.spool_dir):
            parsed = case_name_of(fn)
            if parsed is None:
                continue
            path = join_path(self.spool_dir, fn)
            try:
                mt = os.path.getmtime(path)
            except OSError:
                continue  # raced: another server already claimed it
            if now - mt < self.settle_seconds:
                continue  # possibly still being written
            pending.append((mt, fn, parsed))
        pending.sort()
        for _mt, fn, (case, ext) in pending:
            src = join_path(self.spool_dir, fn)
            dst = join_path(self.work_dir, fn)
            if self._claimed_anywhere(fn):
                # SOME server holds an unfinished claim of the same case (a
                # client resubmission landed meanwhile): claiming it now
                # would either swap the in-flight run's input mid-pipeline
                # (same server) or race two servers' artifact writes for one
                # case (fleet). Leave it in the spool; it is claimed after
                # the in-flight one finishes (process() removes the claim).
                continue
            try:
                os.rename(src, dst)
            except OSError:
                continue  # lost the race for this one; try the next
            return case, dst
        return None

    def _claimed_anywhere(self, fn) -> bool:
        """True if ANY server's work dir holds an unfinished claim of this
        request filename."""
        root = join_path(self.spool_dir, ".work")
        try:
            sids = os.listdir(root)
        except OSError:
            return False
        for sid in sids:
            if os.path.exists(join_path(root, sid, fn)):
                return True
        return False

    def _respool(self, src_path):
        """Return a claimed request to the spool — UNLESS a newer
        submission of the same case is already there, in which case the
        old claim is superseded and dropped (renaming over the spool file
        would destroy the newer request's bytes)."""
        fn = os.path.basename(src_path)
        target = join_path(self.spool_dir, fn)
        if os.path.exists(target):
            try:
                os.remove(src_path)
            except FileNotFoundError:
                pass
            return False
        os.rename(src_path, target)
        return True

    def _heartbeat(self):
        """Freshen this server's status mtime — the liveness signal
        recover_stale uses to decide another id's claims are orphaned."""
        path = join_path(self.status_dir, "%s.json" % self.server_id)
        try:
            os.utime(path, None)
        except OSError:
            with open(path, "w") as f:
                json.dump({"server_id": self.server_id, "served": 0,
                           "failed": 0}, f)

    @staticmethod
    def _input_sha(path):
        import hashlib

        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def _case_artifacts(self, case):
        return [*_case_paths(self.folders, case),
                join_path(self.folders["previews"], "%s.gif" % case)]

    def _clear_case_artifacts(self, case):
        """Invalidate the receipt FIRST (a consumer must never hold a
        receipt whose artifacts are gone or about to change), then remove
        the artifacts so a CHANGED resubmission recomputes instead of
        serving the old input's results through resume probes. A removal
        failure of an EXISTING file raises: leaving one behind would let
        the resume probes silently serve stale data under a fresh
        receipt."""
        try:
            os.remove(join_path(self.done_dir, "%s.json" % case))
        except FileNotFoundError:
            pass
        for p in self._case_artifacts(case):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def _check_provenance(self, case, input_sha):
        """A resubmission under an existing case name with DIFFERENT bytes
        must recompute — without this, the artifact resume probes would
        acknowledge the new request with the OLD input's segmentation."""
        receipt_path = join_path(self.done_dir, "%s.json" % case)
        prev_sha = None
        if os.path.isfile(receipt_path):
            try:
                with open(receipt_path) as f:
                    prev_sha = json.load(f).get("input_sha256")
            except (OSError, ValueError):
                prev_sha = None
        if prev_sha != input_sha and (
            prev_sha is not None
            or any(os.path.exists(p) for p in self._case_artifacts(case))
        ):
            # covers BOTH a recorded different hash and an UNKNOWN
            # provenance (pre-upgrade receipt, or artifacts without a
            # receipt): stamping the new sha onto old artifacts would make
            # a stale result permanent and undetectable
            print(
                "case %s: input provenance %s — recomputing"
                % (case, "changed" if prev_sha else "unknown"), flush=True)
            self._clear_case_artifacts(case)
            # any preloaded volume stays valid: the prefetch decoded the
            # claimed file, which IS the new submission

    def _write_receipt(self, case, latency, seg_path, input_sha, burst=1):
        receipt = {
            "case": case,
            "server_id": self.server_id,
            "latency_s": round(latency, 3),
            "segmentation": seg_path,
            "input_sha256": input_sha,
            "finished_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        if burst > 1:
            receipt["burst_size"] = burst
        tmp = join_path(self.done_dir, ".%s.json.tmp" % case)
        with open(tmp, "w") as f:
            json.dump(receipt, f, indent=1)
        os.replace(tmp, join_path(self.done_dir, "%s.json" % case))

    def process(self, case, claimed_path, preloaded=None, input_sha=None):
        t0 = time.time()
        # the prefetch thread hashes while it decodes; fall back to a
        # synchronous read only when no prefetch ran
        if input_sha is None:
            input_sha = self._input_sha(claimed_path)
        self._check_provenance(case, input_sha)
        try:
            seg_path = predict_one_case(
                self.predictor, case, claimed_path, self.folders,
                skip_bfc=self.skip_bfc, make_previews=self.make_previews,
                preloaded=preloaded,
            )
        except Exception:
            self.failed += 1
            err_path = join_path(self.failed_dir, "%s.err" % case)
            with open(err_path, "w") as f:
                f.write(traceback.format_exc())
            try:
                os.rename(
                    claimed_path,
                    join_path(self.failed_dir, os.path.basename(claimed_path)),
                )
            except OSError:
                pass  # claim re-spooled by a stale-recoverer; nothing to move
            self._write_status(case, time.time() - t0, ok=False)
            return False
        latency = time.time() - t0
        self.served += 1
        self._write_receipt(case, latency, seg_path, input_sha)
        try:
            os.remove(claimed_path)
        except OSError:
            pass  # a stale-recoverer re-spooled it mid-run; the receipt
            # stands and the duplicate run will find complete artifacts
        self._write_status(case, latency, ok=True)
        return True

    def process_batch(self, items):
        """A burst of same-geometry requests through ONE batched sweep
        (pipeline/inference.predict_batch_cases). items:
        [(case, claimed_path, prefetch_box)], len >= 2, identical volume
        shape and spacing (drain groups them). Receipts, claim removal,
        provenance and status are per case, exactly like process(); any
        burst-level failure degrades to the per-case path so a single bad
        input quarantines alone."""
        t0 = time.time()
        preloads, shas = {}, {}
        for case, path, box in items:
            sha = box.get("sha") or self._input_sha(path)
            shas[case] = sha
            self._check_provenance(case, sha)
            if box.get("v") is not None:
                preloads[case] = box["v"]
        try:
            seg_paths = predict_batch_cases(
                self.predictor, [(c, p) for c, p, _ in items], self.folders,
                skip_bfc=self.skip_bfc, make_previews=self.make_previews,
                preloads=preloads,
            )
        except Exception:
            ok = True
            for case, path, box in items:
                ok = self.process(
                    case, path, preloaded=box.get("v"), input_sha=shas[case]
                ) and ok
            return ok
        latency = time.time() - t0
        for case, path, _box in items:
            self.served += 1
            self._write_receipt(case, latency, seg_paths[case], shas[case],
                                burst=len(items))
            try:
                os.remove(path)
            except OSError:
                pass  # stale-recoverer re-spooled it; receipt stands
            self._write_status(case, latency, ok=True)
        return True

    def _write_status(self, case, latency, ok):
        status = {
            "server_id": self.server_id,
            "served": self.served,
            "failed": self.failed,
            "last_case": case,
            "last_ok": ok,
            "last_latency_s": round(latency, 3),
            "uptime_s": round(time.time() - self._t0, 1),
        }
        tmp = join_path(self.status_dir, ".%s.tmp" % self.server_id)
        with open(tmp, "w") as f:
            json.dump(status, f, indent=1)
        os.replace(tmp, join_path(self.status_dir, "%s.json" % self.server_id))

    # -- loops -------------------------------------------------------------

    def recover_work(self):
        """Re-spool requests a previous server with this id claimed but
        never finished (crash recovery); returns how many."""
        n = 0
        for fn in os.listdir(self.work_dir):
            if case_name_of(fn) is not None:
                # _respool, never a bare rename: a newer resubmission of
                # the same case may be sitting in the spool and must win
                if self._respool(join_path(self.work_dir, fn)):
                    n += 1
        return n

    def recover_stale(self, stale_after: float = 1800.0):
        """Re-spool claims stranded by OTHER servers that look dead: their
        .work/<id> holds requests but their status heartbeat is missing or
        older than stale_after. Without this, a crashed server that
        restarts under a different id (the pid-based default) strands its
        in-flight requests forever. The heartbeat is touched at every
        claim, so stale_after only needs to exceed one case's wall time —
        a 30 min default clears even a slow first case. Returns
        how many requests were re-spooled."""
        root = join_path(self.spool_dir, ".work")
        now = time.time()
        total = 0
        for sid in os.listdir(root):
            if sid == self.server_id:
                continue
            wdir = join_path(root, sid)
            try:
                pending = [f for f in os.listdir(wdir) if case_name_of(f)]
            except OSError:
                continue  # stray non-directory entry under .work/
            if not pending:
                continue
            status = join_path(self.status_dir, "%s.json" % sid)
            try:
                if now - os.path.getmtime(status) < stale_after:
                    continue  # that server is alive (or was, recently)
            except OSError:
                pass  # no heartbeat at all: definitely recoverable
            n = 0
            for fn in pending:
                try:
                    if self._respool(join_path(wdir, fn)):
                        n += 1
                except OSError:
                    continue  # another recoverer beat us to it
            if n:
                print(
                    "recovered %d stale claim(s) from server '%s'" % (n, sid),
                    flush=True,
                )
            total += n
        return total

    def stop_requested(self):
        return self._stop or os.path.exists(join_path(self.spool_dir, "STOP"))

    def request_stop(self):
        self._stop = True

    def _start_load(self, claimed):
        """Begin loading a claimed request's volume in a daemon thread;
        returns (claimed, thread, box). A load error leaves the box empty —
        process() then loads (and fails) through the normal path so the
        quarantine traceback is the real one."""
        import threading

        box = {}

        def run():
            try:
                # hash here too: process() then needs no second full read
                # of the request on the latency path
                box["sha"] = self._input_sha(claimed[1])
                box["v"] = nifti.load_nifti(claimed[1])
            except Exception:
                pass

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return claimed, t, box

    def _unclaim(self, claimed):
        """Return a claimed-but-unprocessed request to the spool (STOP
        arrived between claim and process); a newer resubmission already
        in the spool wins over the unprocessed claim."""
        self._respool(claimed[1])

    def _claim_burst_loads(self):
        """Claim up to batch_max currently-pending requests and start their
        IO loads concurrently. Only what is already claimable is taken —
        a lone request is never delayed waiting for companions (the
        bounded-latency contract of burst batching)."""
        loads = []
        while len(loads) < self.batch_max and not self.stop_requested():
            claimed = self.claim_one()
            if claimed is None:
                break
            loads.append(self._start_load(claimed))
        return loads

    @staticmethod
    def _group_by_geometry(items):
        """Group [(case, path, box)] by (shape, spacing) of the prefetched
        volume; requests whose prefetch failed become singletons (their
        error surfaces through the per-case path)."""
        groups, order = {}, []
        for it in items:
            case, _path, box = it
            v = box.get("v")
            if v is None:
                key = ("solo", case)
            else:
                data, hdr = v
                key = (tuple(data.shape),
                       tuple(round(float(z), 4) for z in hdr.zooms[:3]))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(it)
        return [groups[k] for k in order]

    def drain(self):
        """Process everything currently claimable: claim a burst, group by
        volume geometry, run each same-geometry group >= 2 as ONE batched
        sweep (process_batch) and singletons through the one-case path,
        prefetching the NEXT burst's IO while the current one computes;
        returns (served, failed) deltas for this call."""
        s0, f0 = self.served, self.failed
        loads = self._claim_burst_loads()
        while loads:
            items = []
            for (case, path), thread, box in loads:
                thread.join()
                items.append((case, path, box))
            # claim + start loading the next burst BEFORE computing this one
            # (IO overlaps device compute)
            next_loads = [] if self.stop_requested() else self._claim_burst_loads()
            for group in self._group_by_geometry(items):
                if len(group) >= 2 and self.batch_max > 1:
                    print(">> burst of %d: %s"
                          % (len(group), [c for c, _, _ in group]), flush=True)
                    self.process_batch(group)
                else:
                    for case, path, box in group:
                        print(">> case %s" % case, flush=True)
                        self.process(case, path, preloaded=box.get("v"),
                                     input_sha=box.get("sha"))
            if self.stop_requested() and next_loads:
                for claimed, _t, _b in next_loads:
                    self._unclaim(claimed)
                next_loads = []
            loads = next_loads
        return self.served - s0, self.failed - f0

    def serve_forever(self):
        """Poll the spool until STOP (sentinel file or request_stop()).
        The current case always finishes before exit."""
        print(
            "serving: spool=%s id=%s (touch %s to stop)"
            % (self.spool_dir, self.server_id, join_path(self.spool_dir, "STOP")),
            flush=True,
        )
        self.recover_work()
        while not self.stop_requested():
            self.recover_stale(self.stale_after)
            served, failed = self.drain()
            if served == 0 and failed == 0 and not self.stop_requested():
                time.sleep(self.poll_interval)
        print(
            "serving stopped: %d served, %d failed, %.0fs uptime"
            % (self.served, self.failed, time.time() - self._t0),
            flush=True,
        )
