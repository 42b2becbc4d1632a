"""deepwmh_tpu_torch serving (pipeline/serve.py, cli/serve.py) on the CPU.

The contract of tests/test_serve.py, case for case where it does not need
a mesh, on the port's SpoolServer with tests/torch_port_fixture.py's
decisive tiny model: atomic claims, receipts with the input's sha256,
quarantine, STOP, crash and stale-claim recovery, provenance, the settle
guard, two servers on one spool, bursts and their fallback, and the --once
CLI. Then parity with the JAX package: both SpoolServers drain the same
requests (masks > 99.9% equal, the same receipt keys), and the burst path
against JAX's and against the port's own one-case path (masks > 99.9%
equal, fg within atol 5e-3: the bars of the whole predict path).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.pipeline.serve import SpoolServer, case_name_of

from torch_port_fixture import phantom, write_case

SHAPE = (24, 24, 20)
SPACING = (2.0, 2.0, 2.0)
MASKS = ("002_Segmentations/001_raw/%s.nii.gz", "002_Segmentations/002_postproc_3mm/%s.nii.gz",
         "002_Segmentations/003_postproc_fov/%s.nii.gz")
MASK_AGREEMENT = 0.999  # the predict path's bar
FG_ATOL = 5e-3


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_case(tmp_path_factory.mktemp("serve_model"))[1]


def spool_request(spool, case, seed=0, shape=SHAPE):
    hdr = nifti.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms(SPACING)
    nifti.save_nifti(phantom(shape, seed=seed), hdr, os.path.join(spool, case + ".nii.gz"))


def make_server(spool, out, model_dir, server_id, **kw):
    kw = {"skip_bfc": True, "tta": False, "make_previews": False, "settle_seconds": 0.0,
          "device": "cpu", **kw}
    return SpoolServer(spool, out, model_dir, server_id=server_id, **kw)


def fov(out, case):
    return nifti.load_nifti_simple(os.path.join(out, MASKS[2] % case))


def test_case_name_of():
    assert case_name_of("abc.nii.gz") == ("abc", ".nii.gz")
    assert case_name_of("a.b.nii") == ("a.b", ".nii")
    assert case_name_of("STOP") is None
    assert case_name_of(".nii.gz") is None
    assert case_name_of("notes.txt") is None


@pytest.fixture(scope="module")
def served(tmp_path_factory, model_dir):
    """One server draining two requests, shared by the tests below in
    order (as in tests/test_serve.py)."""
    tmp_path = tmp_path_factory.mktemp("serve")
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    spool_request(spool, "caseA", seed=0)
    spool_request(spool, "caseB", seed=1)
    srv = make_server(spool, str(tmp_path / "out"), model_dir, "t1")
    n_served, n_failed = srv.drain()
    return srv, spool, str(tmp_path / "out"), n_served, n_failed


def test_drain_serves_all(served):
    srv, spool, out, n_served, n_failed = served
    assert (n_served, n_failed) == (2, 0)
    for case in ("caseA", "caseB"):
        assert nifti.try_load_nifti(os.path.join(out, MASKS[2] % case))
        r = json.load(open(os.path.join(spool, ".done", case + ".json")))
        assert r["case"] == case and r["latency_s"] >= 0
        assert r["segmentation"].endswith(case + ".nii.gz")
        assert len(r["input_sha256"]) == 64
        assert fov(out, case).mean() > 0.01  # the decisive model finds its inner tissue
    assert [f for f in os.listdir(spool) if case_name_of(f)] == []
    assert os.listdir(os.path.join(spool, ".work", "t1")) == []


def test_status_file(served):
    srv, spool, out, *_ = served
    status = json.load(open(os.path.join(spool, ".status", "t1.json")))
    assert status["served"] == 2 and status["failed"] == 0
    assert status["last_ok"] is True


def test_failed_request_is_quarantined(served):
    srv, spool, out, *_ = served
    with open(os.path.join(spool, "broken.nii.gz"), "wb") as f:
        f.write(b"this is not a nifti file")
    assert srv.drain() == (0, 1)
    assert os.path.isfile(os.path.join(spool, ".failed", "broken.nii.gz"))
    assert "Traceback" in open(os.path.join(spool, ".failed", "broken.err")).read()
    # a failure must not poison subsequent requests
    spool_request(spool, "caseC", seed=2)
    assert srv.drain() == (1, 0)


def test_stop_sentinel(served):
    srv, spool, out, *_ = served
    spool_request(spool, "caseD", seed=3)
    stop = os.path.join(spool, "STOP")
    open(stop, "w").close()
    try:
        assert srv.stop_requested()
        assert srv.drain() == (0, 0)  # refuses new work
    finally:
        os.remove(stop)
    assert srv.drain() == (1, 0)  # resumes after STOP removed


def test_crash_recovery(served):
    srv, spool, out, *_ = served
    spool_request(spool, "caseE", seed=4)
    os.rename(os.path.join(spool, "caseE.nii.gz"),
              os.path.join(spool, ".work", "t1", "caseE.nii.gz"))
    assert srv.drain() == (0, 0)  # not claimable while stuck
    assert srv.recover_work() == 1
    assert srv.drain() == (1, 0)


def test_claim_is_exclusive(served):
    srv, spool, out, *_ = served
    spool_request(spool, "caseF", seed=5)
    first = srv.claim_one()
    assert first is not None and first[0] == "caseF"
    assert srv.claim_one() is None  # already claimed: no double claim
    os.rename(first[1], os.path.join(spool, "caseF.nii.gz"))
    assert srv.drain() == (1, 0)


def test_resubmission_while_in_flight_not_clobbered(served):
    srv, spool, out, *_ = served
    claimed = None
    try:
        spool_request(spool, "caseC", seed=2)
        claimed = srv.claim_one()
        assert claimed is not None and claimed[0] == "caseC"
        spool_request(spool, "caseC", seed=3)  # lands while caseC is in flight
        assert srv.claim_one() is None  # skipped, not clobbered
        assert os.path.isfile(os.path.join(spool, "caseC.nii.gz"))
        assert os.path.isfile(claimed[1])
    finally:
        if claimed:
            os.remove(claimed[1])
        os.remove(os.path.join(spool, "caseC.nii.gz"))


def test_changed_resubmission_recomputes(served):
    srv, spool, out, *_ = served
    receipt_path = os.path.join(spool, ".done", "caseA.json")
    sha0 = json.load(open(receipt_path))["input_sha256"]
    pre = os.path.join(out, "001_Preprocessed_Images", "caseA_0000.nii.gz")
    old_pre = nifti.load_nifti_simple(pre)
    spool_request(spool, "caseA", seed=0)  # identical bytes: no recompute
    srv.drain()
    assert json.load(open(receipt_path))["input_sha256"] == sha0
    spool_request(spool, "caseA", seed=7)  # changed bytes: recomputed
    srv.drain()
    assert json.load(open(receipt_path))["input_sha256"] != sha0
    new_pre = nifti.load_nifti_simple(pre)
    assert not np.allclose(old_pre, new_pre)
    np.testing.assert_allclose(new_pre, phantom(SHAPE, seed=7), atol=1e-4)  # skip_bfc


def test_respool_never_clobbers_newer_submission(served):
    srv, spool, out, *_ = served
    spool_request(spool, "caseD", seed=4)
    claimed = srv.claim_one()
    assert claimed[0] == "caseD"
    spool_request(spool, "caseD", seed=5)
    newer = open(os.path.join(spool, "caseD.nii.gz"), "rb").read()
    assert srv._respool(claimed[1]) is False  # superseded, dropped
    assert not os.path.exists(claimed[1])
    assert open(os.path.join(spool, "caseD.nii.gz"), "rb").read() == newer
    claimed2 = srv.claim_one() or (None, None)
    assert claimed2[0] == "caseD"
    assert srv._respool(claimed2[1]) is True
    os.remove(os.path.join(spool, "caseD.nii.gz"))


def test_inflight_guard_covers_other_servers(served):
    srv, spool, out, *_ = served
    other = os.path.join(spool, ".work", "other-srv")
    os.makedirs(other, exist_ok=True)
    try:
        spool_request(spool, "caseE", seed=6)
        open(os.path.join(other, "caseE.nii.gz"), "wb").write(b"x")
        assert srv.claim_one() is None
        os.remove(os.path.join(other, "caseE.nii.gz"))
        claimed = srv.claim_one()
        assert claimed[0] == "caseE"
        os.remove(claimed[1])
    finally:
        os.rmdir(other)
        p = os.path.join(spool, "caseE.nii.gz")
        if os.path.exists(p):
            os.remove(p)


def test_changed_resubmission_invalidates_receipt_first(served):
    """Unknown provenance (a receipt without sha) recomputes, and while it
    does no receipt exists."""
    srv, spool, out, *_ = served
    receipt = os.path.join(spool, ".done", "caseB.json")
    r = json.load(open(receipt))
    del r["input_sha256"]
    json.dump(r, open(receipt, "w"))
    seen = []
    orig = srv.predictor.predict_case_full

    def probe(*a, **kw):
        seen.append(os.path.exists(receipt))
        return orig(*a, **kw)

    srv.predictor.predict_case_full = probe
    try:
        spool_request(spool, "caseB", seed=1)
        srv.drain()
    finally:
        srv.predictor.predict_case_full = orig
    assert seen == [False]  # recomputed, with the receipt already gone
    assert "input_sha256" in json.load(open(receipt))


def test_stop_mid_drain_unclaims_prefetched(served):
    srv, spool, out, *_ = served
    srv.batch_max = 1
    spool_request(spool, "caseG", seed=6)
    spool_request(spool, "caseH", seed=7)
    stop = os.path.join(spool, "STOP")
    orig = srv.process

    def process_and_stop(case, path, **kw):
        open(stop, "w").close()
        return orig(case, path, **kw)

    srv.process = process_and_stop
    try:
        result = srv.drain()
    finally:
        srv.process = orig
        os.remove(stop)
    assert result == (1, 0)
    assert len([f for f in os.listdir(spool) if case_name_of(f)]) == 1
    assert srv.drain() == (1, 0)


def test_settle_guard_skips_fresh_files(served):
    srv, spool, out, *_ = served
    spool_request(spool, "caseI", seed=8)
    srv.settle_seconds = 3600.0
    try:
        assert srv.claim_one() is None
        os.utime(os.path.join(spool, "caseI.nii.gz"), (1, 1))  # long settled
        claimed = srv.claim_one()
        assert claimed is not None and claimed[0] == "caseI"
        os.rename(claimed[1], os.path.join(spool, "caseI.nii.gz"))
    finally:
        srv.settle_seconds = 0.0
    assert srv.drain() == (1, 0)


def test_stale_claim_recovery(served):
    srv, spool, out, *_ = served
    dead_work = os.path.join(spool, ".work", "deadsrv")
    os.makedirs(dead_work, exist_ok=True)
    spool_request(spool, "caseJ", seed=10)
    os.rename(os.path.join(spool, "caseJ.nii.gz"), os.path.join(dead_work, "caseJ.nii.gz"))
    status = os.path.join(spool, ".status", "deadsrv.json")
    open(status, "w").write("{}")
    assert srv.recover_stale(stale_after=3600.0) == 0  # a fresh heartbeat protects it
    assert os.path.isfile(os.path.join(dead_work, "caseJ.nii.gz"))
    os.utime(status, (1, 1))
    assert srv.recover_stale(stale_after=3600.0) == 1  # a stale one releases it
    assert srv.drain() == (1, 0)
    own = os.path.join(spool, ".status", srv.server_id + ".json")
    os.utime(own, (1, 1))
    spool_request(spool, "caseK", seed=11)
    claimed = srv.claim_one()
    assert claimed is not None
    assert time.time() - os.path.getmtime(own) < 60  # claiming freshens the heartbeat
    os.rename(claimed[1], os.path.join(spool, "caseK.nii.gz"))
    assert srv.drain() == (1, 0)


def test_serve_cli_once(tmp_path, model_dir):
    """The --once CLI on the CPU serves a request, and exits 1 with a
    corrupt one in the spool (quarantined with its traceback)."""
    from deepwmh_tpu_torch.cli.serve import main

    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    spool_request(spool, "cli_case", seed=7)
    argv = ["-m", model_dir, "-s", spool, "-o", str(tmp_path / "out"), "--once",
            "--skip-bfc", "--disable-tta", "--no-previews", "--server-id", "cli1",
            "--settle-seconds", "0", "--device", "cpu"]
    assert main(argv) == 0
    assert nifti.try_load_nifti(os.path.join(str(tmp_path / "out"), MASKS[2] % "cli_case"))
    assert os.path.isfile(os.path.join(spool, ".done", "cli_case.json"))
    with open(os.path.join(spool, "bad.nii.gz"), "wb") as f:
        f.write(b"corrupt")
    assert main(argv) == 1
    assert os.path.isfile(os.path.join(spool, ".failed", "bad.err"))


def test_serve_cli_device_rules(tmp_path, model_dir, monkeypatch):
    """-g with --device is a usage error; with no card and no --device cpu
    the server refuses to start rather than serve on the CPU."""
    from deepwmh_tpu_torch.cli.serve import main

    argv = ["-m", model_dir, "-s", str(tmp_path / "s"), "-o", str(tmp_path / "o"), "--once"]
    with pytest.raises(SystemExit) as e:
        main(argv + ["-g", "0", "--device", "cpu"])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_two_servers_share_one_spool(tmp_path, model_dir):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    for i in range(4):
        spool_request(spool, "case%d" % i, seed=20 + i)
    out = str(tmp_path / "out")
    a = make_server(spool, out, model_dir, "a")
    b = make_server(spool, out, model_dir, "b")
    total = 0
    while True:
        worked = False
        for srv in (a, b):
            claimed = srv.claim_one()
            if claimed:
                srv.process(*claimed)
                total += 1
                worked = True
        if not worked:
            break
    assert total == 4
    assert a.served + b.served == 4 and a.served >= 1 and b.served >= 1
    assert sorted(os.listdir(os.path.join(spool, ".done"))) == ["case%d.json" % i for i in range(4)]


def _agreement(a, b):
    return float((a == b).mean())


def test_burst_batching_contract(tmp_path, model_dir):
    """Same-geometry requests pending together run as one batched sweep
    (receipts carry burst_size); a request of another geometry runs on its
    own. A burst case agrees with its one-case run to the predict bars."""
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    for i in range(3):
        spool_request(spool, "same%d" % i, seed=i)
    spool_request(spool, "odd", seed=9, shape=(20, 24, 20))
    srv = make_server(spool, str(tmp_path / "out"), model_dir, "burst", batch_max=8, tta=True)
    assert srv.drain() == (4, 0)
    for i in range(3):
        r = json.load(open(os.path.join(spool, ".done", "same%d.json" % i)))
        assert r.get("burst_size") == 3, r
    assert "burst_size" not in json.load(open(os.path.join(spool, ".done", "odd.json")))

    single = make_server(spool, str(tmp_path / "out_single"), model_dir, "single", batch_max=1,
                         tta=True)
    spool_request(spool, "same0", seed=0)  # resubmit the identical bytes
    assert single.drain() == (1, 0)
    for rel in MASKS:
        a = nifti.load_nifti_simple(os.path.join(str(tmp_path / "out"), rel % "same0"))
        b = nifti.load_nifti_simple(os.path.join(str(tmp_path / "out_single"), rel % "same0"))
        assert _agreement(a, b) > MASK_AGREEMENT, rel


def test_burst_failure_degrades_to_per_case(tmp_path, model_dir):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    spool_request(spool, "x0", seed=0)
    spool_request(spool, "x1", seed=1)
    srv = make_server(spool, str(tmp_path / "out"), model_dir, "bf", batch_max=4)

    def boom(*a, **kw):
        raise RuntimeError("burst failed")

    solo = []
    orig = srv.predictor.predict_case_full
    srv.predictor.predict_case_full_batch = boom
    srv.predictor.predict_case_full = lambda *a, **kw: solo.append(1) or orig(*a, **kw)
    assert srv.drain() == (2, 0)
    assert len(solo) == 2  # each case through the one-case path
    for case in ("x0", "x1"):
        assert os.path.isfile(os.path.join(spool, ".done", "%s.json" % case))
        assert nifti.try_load_nifti(os.path.join(str(tmp_path / "out"), MASKS[2] % case))


def test_batch_max_default_policy(tmp_path, model_dir):
    """One device: per-case unless batch_max is set (the JAX package's
    single-chip policy)."""
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    assert make_server(spool, str(tmp_path / "o1"), model_dir, "p1").batch_max == 1
    assert make_server(spool, str(tmp_path / "o2"), model_dir, "p2", batch_max=4).batch_max == 4
    assert make_server(spool, str(tmp_path / "o3"), model_dir, "p3", batch_max=0).batch_max == 1


# ---------------------------------------------------------------- parity


def test_spool_servers_of_both_packages_agree(tmp_path, model_dir):
    """JAX's SpoolServer and the port's drain the same two requests (N4 and
    8-flip TTA on): the three masks > 99.9% equal, N4 within rtol 1e-3,
    receipts with the same keys."""
    from deepwmh_tpu.pipeline.serve import SpoolServer as JSpoolServer

    outs, receipts = {}, {}
    for name, cls, extra in (("jax", JSpoolServer, {}), ("port", SpoolServer, {"device": "cpu"})):
        spool = str(tmp_path / ("spool_" + name))
        os.makedirs(spool)
        spool_request(spool, "p0", seed=3)
        spool_request(spool, "p1", seed=4)
        outs[name] = str(tmp_path / ("out_" + name))
        srv = cls(spool, outs[name], model_dir, make_previews=False, server_id=name,
                  settle_seconds=0.0, **extra)
        assert srv.drain() == (2, 0)
        receipts[name] = {c: json.load(open(os.path.join(spool, ".done", c + ".json")))
                          for c in ("p0", "p1")}
    for case in ("p0", "p1"):
        assert set(receipts["jax"][case]) == set(receipts["port"][case])
        assert receipts["jax"][case]["input_sha256"] == receipts["port"][case]["input_sha256"]
        for rel in MASKS:
            a, b = (nifti.load_nifti_simple(os.path.join(outs[n], rel % case)) for n in outs)
            assert _agreement(a, b) > MASK_AGREEMENT, (case, rel)
        rel = "001_Preprocessed_Images/%s_0000.nii.gz" % case
        a, b = (nifti.load_nifti_simple(os.path.join(outs[n], rel)) for n in outs)
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3 * float(np.abs(a).max()))
        assert fov(outs["port"], case).mean() > 0.01


@pytest.fixture(scope="module")
def burst_inputs():
    return np.stack([phantom(SHAPE, seed=s) for s in (5, 6)])


def test_predict_case_full_batch_matches_jax_and_one_case(model_dir, burst_inputs):
    """The burst of two (N4 on, 8 flips): the port's batch against JAX's
    vmapped program and against the port's one-case runs."""
    import jax.numpy as jnp

    from deepwmh_tpu.unet.infer import SlidingWindowPredictor as JPredictor
    from deepwmh_tpu.unet.release import load_released_model as jload
    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.release import load_released_model

    jmodel, jparams, jplan = jload(model_dir)
    want = [np.asarray(o) for o in JPredictor(jmodel, jparams, jplan).predict_case_full_batch(
        jnp.asarray(burst_inputs), SPACING, apply_n4=True)]
    model, plan = load_released_model(model_dir, device="cpu")
    pred = SlidingWindowPredictor(model, plan, device="cpu")
    got = [o.numpy() for o in pred.predict_case_full_batch(burst_inputs, SPACING, apply_n4=True)]
    solo = [[o.numpy() for o in pred.predict_case_full(v, SPACING, apply_n4=True)]
            for v in burst_inputs]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [np.float32, np.uint8, np.float32, np.float32, np.float32]
    for i in range(len(burst_inputs)):
        for ref in (want, [s for s in zip(*solo)]):
            ref_i = [np.asarray(r[i]) for r in ref]
            np.testing.assert_allclose(got[0][i], ref_i[0], rtol=1e-3,
                                       atol=1e-3 * float(np.abs(ref_i[0]).max()))
            for k in (1, 2, 3):
                assert _agreement(got[k][i], ref_i[k]) > MASK_AGREEMENT, (i, k)
            assert np.abs(got[4][i] - ref_i[4]).max() < FG_ATOL
        assert got[3][i].mean() > 0.01


def test_predict_batch_cases_matches_one_case_path(tmp_path, model_dir, burst_inputs):
    """predict_batch_cases writes the artifacts of the one-case path: a
    burst of two fresh cases, and a resumed case in the same call that
    takes the staged path on its own."""
    from deepwmh_tpu.pipeline.inference import make_output_folders as jfolders
    from deepwmh_tpu.pipeline.inference import predict_batch_cases as jbatch
    from deepwmh_tpu.unet.infer import SlidingWindowPredictor as JPredictor
    from deepwmh_tpu.unet.release import load_released_model as jload
    from deepwmh_tpu_torch.pipeline.inference import (
        make_output_folders,
        predict_batch_cases,
        predict_one_case,
    )
    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.release import load_released_model

    hdr = nifti.NiftiHeader()
    hdr.set_shape(SHAPE)
    hdr.set_zooms(SPACING)
    cases = []
    for i, vol in enumerate(list(burst_inputs) + [phantom(SHAPE, seed=7)]):
        path = str(tmp_path / ("b%d.nii.gz" % i))
        nifti.save_nifti(vol, hdr, path)
        cases.append(("b%d" % i, path))
    model, plan = load_released_model(model_dir, device="cpu")
    pred = SlidingWindowPredictor(model, plan, tta=False, device="cpu")
    jmodel, jparams, jplan = jload(model_dir)
    jpred = JPredictor(jmodel, jparams, jplan, tta=False)
    roots = {k: str(tmp_path / k) for k in ("burst", "solo", "jax")}
    folders = {k: (jfolders if k == "jax" else make_output_folders)(v) for k, v in roots.items()}
    # b2 is resumed: its pre artifact exists already in every tree
    for k in roots:
        nifti.save_nifti(phantom(SHAPE, seed=7), hdr,
                         os.path.join(folders[k]["images"], "b2_0000.nii.gz"))
    seen = []
    orig = pred.predict_case_full_batch
    pred.predict_case_full_batch = lambda d, *a, **kw: seen.append(len(d)) or orig(d, *a, **kw)
    got = predict_batch_cases(pred, cases, folders["burst"], skip_bfc=True, make_previews=False)
    assert seen == [2] and sorted(got) == ["b0", "b1", "b2"]
    for case, path in cases:
        predict_one_case(pred, case, path, folders["solo"], skip_bfc=True, make_previews=False)
    jbatch(jpred, cases, folders["jax"], skip_bfc=True, make_previews=False)
    for case, _ in cases:
        for rel in MASKS:
            a = nifti.load_nifti_simple(os.path.join(roots["burst"], rel % case))
            for other in ("solo", "jax"):
                b = nifti.load_nifti_simple(os.path.join(roots[other], rel % case))
                assert _agreement(a, b) > MASK_AGREEMENT, (case, rel, other)
    with pytest.raises(ValueError, match="share geometry"):
        odd = str(tmp_path / "odd.nii.gz")
        h2 = nifti.NiftiHeader()
        h2.set_shape((20, 24, 20))
        h2.set_zooms(SPACING)
        nifti.save_nifti(phantom((20, 24, 20), seed=1), h2, odd)
        predict_batch_cases(pred, [("o0", cases[0][1]), ("o1", odd)],
                            make_output_folders(str(tmp_path / "geo")), skip_bfc=True,
                            make_previews=False)
