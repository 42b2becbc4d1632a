"""deepwmh_tpu_torch's device mesh on the CPU: parallel/mesh.py, the
flip- and patch-sharded inference of parallel/infer_sharded.py, the predict
and serve paths over a mesh, stage-1 over a mesh, the --mesh CLIs, the
dryrun and torch.distributed's two-process start.

The port runs on ``Mesh([cpu] * n)``; the JAX package on the first n of
the 8 virtual devices of tests/conftest.py (``make_mesh(n)``), with the
weights of tests/torch_port_fixture.py's decisive tiny model. Tolerances:
f32 sweeps within the repo's f32 bar (atol 2e-4, rtol 1e-3) of JAX's; the
port's flip-sharded sweep bit-equal to its unsharded sweep at n = 1 and at
n = 8 (one flip a shard: the psum adds in the unsharded order), within
1e-6 otherwise, and the patch-sharded sweep within 1e-6 (the shards'
accumulators add up in another order); the whole predict path masks >
99.9% equal and fg within 5e-3; stage-1 artifacts over a mesh equal to the
one-by-one run's and within the slice test's bars of JAX's mesh run.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepwmh_tpu.parallel.infer_sharded import (
    ShardedSlidingWindowPredictor as JShardedPredictor,
)
from deepwmh_tpu.parallel.mesh import device_info as jdevice_info
from deepwmh_tpu.parallel.mesh import make_mesh as jmake_mesh
from deepwmh_tpu.unet import infer as jinfer
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu.unet.preprocess import preprocess_case as jpreprocess
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.parallel import mesh as pmesh
from deepwmh_tpu_torch.parallel.infer_sharded import ShardedSlidingWindowPredictor
from deepwmh_tpu_torch.unet import infer
from deepwmh_tpu_torch.unet.release import load_released_model

import chip_smoke
from torch_port_fixture import SPACING, phantom, write_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL, F32_RTOL = 2e-4, 1e-3
MASK_AGREEMENT = 0.999
FG_ATOL = 5e-3
SWEEP_SHAPE = (24, 24, 20)
CASE_SHAPE = (24, 24, 20)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    image, pkg, params, jplan = write_case(tmp_path_factory.mktemp("mesh"))
    return image, pkg, params, jplan


def cpu_mesh(n):
    return pmesh.Mesh([CPU] * n)


def jax_mesh(n):
    if jax.device_count() < n:
        pytest.skip("needs %d virtual JAX devices" % n)
    return jmake_mesh(n)


# ---------------------------------------------------------------- the mesh


def test_mesh_api_and_device_info():
    m = pmesh.Mesh(["cpu"] * 3, ("sp",))
    assert m.size == 3 and m.shape == {"sp": 3} and m.axis_names == ("sp",)
    assert m.devices == (CPU,) * 3
    with pytest.raises(ValueError):
        pmesh.Mesh([])
    with pytest.raises(ValueError):
        pmesh.Mesh(["cpu"], ("a", "b"))
    info = pmesh.device_info()
    assert set(info) == set(jdevice_info())
    assert info["process_count"] == 1 and info["device_count"] >= 1


def test_mesh_needs_a_card(monkeypatch):
    """No CPU fallback: make_mesh raises without a card, and so does
    select_device; a CPU mesh is built explicitly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Mesh"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="Mesh"):
        pmesh.make_mesh(local=True)
    with pytest.raises(ValueError, match="out of range"):
        pmesh.select_device(0)


def test_collectives():
    m = cpu_mesh(4)
    parts = [torch.tensor([float(d + 1)]) for d in range(4)]
    assert pmesh.psum(m, parts).item() == 10.0
    assert pmesh.all_gather(m, parts).flatten().tolist() == [1, 2, 3, 4]
    assert [t.item() for t in pmesh.ppermute(m, parts, [(0, 1), (1, 2), (2, 3)])] == [0, 1, 2, 3]
    assert [t.item() for t in pmesh.broadcast(m, torch.tensor(7.0))] == [7.0] * 4
    # psum adds in shard order, ((a + b) + c) + d: in f32 1e8 + 1 is 1e8
    # (another order, (a + c) + b + d, would give 2)
    vals = [torch.tensor([v], dtype=torch.float32) for v in (1e8, 1.0, -1e8, 1.0)]
    assert pmesh.psum(m, vals).item() == 1.0
    with pytest.raises(ValueError):
        pmesh.psum(m, parts[:3])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_patch_positions_bucket_like_jax(n):
    for size, patch in [((64, 64, 64), (16, 16, 16)), ((40, 97, 33), (32, 48, 16)),
                        ((10, 10, 10), (16, 16, 16))]:
        pos, w = infer.patch_positions(size, patch, bucket_multiple=n)
        jpos, jw = jinfer.patch_positions(size, patch, bucket_multiple=n)
        np.testing.assert_array_equal(pos, np.asarray(jpos))
        np.testing.assert_array_equal(w, np.asarray(jw))
        assert len(pos) % (infer.POS_BUCKET * n) == 0


# ---------------------------------------------------------------- sharded sweeps


def _f32_pair(case, n, mode, tta=True):
    _, pkg, params, jplan = case
    model, plan = load_released_model(pkg, device="cpu", dtype=torch.float32)
    jpred = JShardedPredictor(JUNet3D(plan=jplan, dtype=jnp.float32), params, jplan,
                              jax_mesh(n), tta=tta, mode=mode)
    port = ShardedSlidingWindowPredictor(model, plan, cpu_mesh(n), tta=tta, mode=mode)
    single = infer.SlidingWindowPredictor(model, plan, tta=tta, mode=mode, device="cpu")
    return jpred, port, single, jplan


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_flip_sharded_sweep(case, n):
    """Whole-volume TTA with the 8 flips dealt over n shards."""
    jpred, port, single, jplan = _f32_pair(case, n, "fullvol")
    vol = np.asarray(jpreprocess(jnp.asarray(phantom(SWEEP_SHAPE, seed=1)), SPACING, jplan))
    got = port.predict_volume(vol)
    want = np.asarray(jpred.predict_volume(vol))
    assert got.shape == want.shape == SWEEP_SHAPE + (2,)
    print("flip-sharded n=%d: gap to JAX %.2e" % (n, np.abs(got.numpy() - want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=F32_RTOL)
    ref = single.predict_volume(vol)
    if n in (1, 8):
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_flip_sharded_sweep_without_tta_skips_padding_slots(case):
    _, port, single, _ = _f32_pair(case, 4, "fullvol", tta=False)
    vol = phantom(SWEEP_SHAPE, seed=2) / 300.0
    assert torch.equal(port.predict_volume(vol), single.predict_volume(vol))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_patch_sharded_sweep(case, n):
    """The bucketed position list cut into n blocks (27 positions padded to
    32 or 64), accumulators psum-merged."""
    jpred, port, single, jplan = _f32_pair(case, n, "patch")
    vol = np.asarray(jpreprocess(jnp.asarray(phantom((20, 24, 18), seed=3)), SPACING, jplan))
    got = port.predict_volume(vol)
    want = np.asarray(jpred.predict_volume(vol))
    print("patch-sharded n=%d: gap to JAX %.2e" % (n, np.abs(got.numpy() - want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=F32_RTOL)
    torch.testing.assert_close(got, single.predict_volume(vol), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- the case program


def _bf16_pair(case, n):
    _, pkg, params, jplan = case
    model, plan = load_released_model(pkg, device="cpu")
    jpred = JShardedPredictor(JUNet3D(plan=jplan), params, jplan, jax_mesh(n), tta=True)
    return jpred, ShardedSlidingWindowPredictor(model, plan, cpu_mesh(n), tta=True)


def _check_case(got, want):
    """(seg, ..., fg) pairs of the predict path: masks > 99.9%, fg 5e-3."""
    for g, w in zip(got[:-1], want[:-1]):
        assert g.shape == w.shape
        assert (g == w).mean() > MASK_AGREEMENT
    assert np.abs(got[-1] - want[-1]).max() <= FG_ATOL


@pytest.mark.parametrize("method,n", [("predict_case", 2), ("predict_case_full", 4),
                                      ("predict_case_full_batch", 2),
                                      ("predict_case_full_batch", 4)])
def test_case_program_on_mesh_matches_jax(case, method, n):
    """The case program around the sharded sweep (bf16, decisive model, N4
    on) on the inputs where the unsharded port is held to JAX at the
    predict path's bars: the slice test's phantom (tests/test_torch_port_
    slice.py says why the bf16 fg bar needs N4) and the serve test's burst
    of two, which runs one case a shard (JAX pads it to the mesh)."""
    jpred, port = _bf16_pair(case, n)
    if method == "predict_case_full_batch":
        data = np.stack([phantom(CASE_SHAPE, seed=s) for s in (5, 6)])
    else:
        data = phantom(seed=3)
    got = [o.numpy() for o in getattr(port, method)(data, SPACING, apply_n4=True)]
    want = [np.asarray(o) for o in getattr(jpred, method)(data, SPACING, apply_n4=True)]
    if method != "predict_case":
        head = data > 0
        assert got[0].shape == want[0].shape == data.shape
        np.testing.assert_allclose(got[0][head], want[0][head], rtol=1e-3, atol=0)  # N4
        got, want = got[1:], want[1:]
    assert 0.01 < (want[0] > 0).mean() < 0.9
    _check_case(got, want)


def test_case_program_on_mesh_is_the_unsharded_one(case):
    """On a resampled geometry the mesh's case program gives the unsharded
    port's masks, and its fg within 1e-6 (the sweeps add in another
    order)."""
    _, pkg, _, _ = case
    model, plan = load_released_model(pkg, device="cpu")
    data = phantom(CASE_SHAPE, seed=4)
    spacing = (2.6, 1.8, 2.2)
    got = ShardedSlidingWindowPredictor(model, plan, cpu_mesh(2), tta=True).predict_case_full(
        data, spacing, apply_n4=True)
    want = infer.SlidingWindowPredictor(model, plan, device="cpu").predict_case_full(
        data, spacing, apply_n4=True)
    for g, w in zip(got[:-1], want[:-1]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[-1], want[-1], atol=1e-6, rtol=0)


def test_burst_is_each_case_alone(case):
    """predict_case_full_batch on a mesh gives each case's own
    predict_case_full (the same sweep, one case a shard)."""
    _, pkg, _, _ = case
    model, plan = load_released_model(pkg, device="cpu", dtype=torch.float32)
    port = ShardedSlidingWindowPredictor(model, plan, cpu_mesh(2), tta=False)
    data = np.stack([phantom(CASE_SHAPE, seed=s) for s in (7, 8, 9)])
    burst = port.predict_case_full_batch(data, SPACING, apply_n4=True)
    for b in range(3):
        alone = port.predict_case_full(data[b], SPACING, apply_n4=True)
        for o_burst, o_alone in zip(burst, alone):
            torch.testing.assert_close(o_burst[b], o_alone, atol=1e-6, rtol=0)


# ---------------------------------------------------------------- serve and predict


def _spool_request(spool, name, seed, shape=CASE_SHAPE):
    hdr = nifti.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms(SPACING)
    nifti.save_nifti(phantom(shape, seed=seed), hdr, os.path.join(spool, name + ".nii.gz"))


@pytest.mark.parametrize("batch_max", [None, 1, 2, 5, 16])
def test_spool_server_batch_max_cap_matches_jax(case, tmp_path, batch_max):
    from deepwmh_tpu.pipeline.serve import SpoolServer as JSpoolServer
    from deepwmh_tpu_torch.pipeline.serve import SpoolServer

    _, pkg, _, _ = case
    kw = dict(skip_bfc=True, make_previews=False, batch_max=batch_max)
    port = SpoolServer(str(tmp_path / "sp"), str(tmp_path / "op"), pkg, mesh=cpu_mesh(4), **kw)
    jserver = JSpoolServer(str(tmp_path / "sj"), str(tmp_path / "oj"), pkg, mesh=jax_mesh(4),
                           **kw)
    assert port.batch_max == jserver.batch_max
    assert isinstance(port.predictor, ShardedSlidingWindowPredictor)
    single = SpoolServer(str(tmp_path / "s1"), str(tmp_path / "o1"), pkg, device="cpu", **kw)
    assert single.batch_max == (1 if batch_max is None else batch_max)


def test_spool_server_on_mesh_matches_jax(case, tmp_path):
    """Both servers drain the same two requests over a 2-shard mesh (a
    burst of two: one case a shard)."""
    from deepwmh_tpu.pipeline.serve import SpoolServer as JSpoolServer
    from deepwmh_tpu_torch.pipeline.serve import SpoolServer

    _, pkg, _, _ = case
    outs = {}
    for name in ("port", "jax"):
        spool, out = str(tmp_path / ("spool_" + name)), str(tmp_path / ("out_" + name))
        os.makedirs(spool)
        for i in range(2):
            _spool_request(spool, "r%d" % i, seed=10 + i)
        kw = dict(skip_bfc=True, tta=False, make_previews=False, settle_seconds=0.0)
        if name == "port":
            server = SpoolServer(spool, out, pkg, mesh=cpu_mesh(2), **kw)
        else:
            server = JSpoolServer(spool, out, pkg, mesh=jax_mesh(2), **kw)
        assert server.batch_max == 2
        assert server.drain() == (2, 0)
        outs[name] = out
        for i in range(2):
            with open(os.path.join(spool, ".done", "r%d.json" % i)) as f:
                assert json.load(f)["case"] == "r%d" % i
    for i in range(2):
        for rel in chip_smoke.SERVE_ARTIFACTS[1:]:
            g, w = (nifti.load_nifti_simple(os.path.join(outs[k], rel % ("r%d" % i)))
                    for k in ("port", "jax"))
            assert g.shape == w.shape and (g == w).mean() > MASK_AGREEMENT, rel


def test_predict_one_case_takes_the_sharded_n4_when_it_would_shard(case, tmp_path,
                                                                   monkeypatch):
    """A volume n4_would_shard picks runs the staged path with the sharded
    N4 first (the JAX package's _can_fuse gate); a pinned run fuses."""
    from deepwmh_tpu_torch.ops import n4
    from deepwmh_tpu_torch.parallel.spatial import HaloShardedOps
    from deepwmh_tpu_torch.pipeline import inference

    image, pkg, _, _ = case
    model, plan = load_released_model(pkg, device="cpu")
    mesh = cpu_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(n4, "N4_SHARD_MIN_VOXELS", 1000)
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **k: mesh)
    pred = ShardedSlidingWindowPredictor(model, plan, mesh, tta=False)
    assert not inference._can_fuse(pred, (48, 48, 40), skip_bfc=False)
    assert inference._can_fuse(pred, (48, 48, 40), skip_bfc=True)
    pinned = infer.SlidingWindowPredictor(model, plan, tta=False, device="cpu")
    assert inference._can_fuse(pinned, (48, 48, 40), skip_bfc=False)
    calls = []
    full = pred.predict_case_full
    monkeypatch.setattr(pred, "predict_case_full", lambda *a, **k: calls.append(1) or full(*a, **k))
    folders = inference.make_output_folders(str(tmp_path / "out"))
    inference.predict_one_case(pred, "subj01", image, folders, make_previews=False)
    assert calls == []
    pre = nifti.load_nifti_simple(str(tmp_path / "out" / "001_Preprocessed_Images" /
                                      "subj01_0000.nii.gz"))
    want = HaloShardedOps(mesh).n4_bias_correction(
        torch.from_numpy(np.array(nifti.load_nifti_simple(image))))
    np.testing.assert_array_equal(pre, want.numpy())


def test_predict_cli_mesh(case, tmp_path, monkeypatch, capsys):
    """--mesh is exclusive with -g and --device, needs a card (no CPU
    fallback), and on a CPU mesh (make_mesh stood in) gives the masks of
    the --device cpu run."""
    from deepwmh_tpu_torch.cli import predict as cli

    image, pkg, _, _ = case
    base = ["-i", image, "-n", "subj01", "-m", pkg, "--no-previews", "--skip-integrity-check",
            "--skip-bfc"]
    for extra in (["-g", "0"], ["--device", "cpu"]):
        with pytest.raises(SystemExit):
            cli.main(base + ["-o", str(tmp_path / "x"), "--mesh"] + extra)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Mesh"):
        cli.main(base + ["-o", str(tmp_path / "x"), "--mesh"])
    monkeypatch.setattr(cli, "make_mesh", lambda local: cpu_mesh(4))
    cli.main(base + ["-o", str(tmp_path / "mesh"), "--mesh"])
    assert "mesh: sharding each sweep over 4 device(s)" in capsys.readouterr().out
    cli.main(base + ["-o", str(tmp_path / "cpu"), "--device", "cpu"])
    for rel in chip_smoke.SERVE_ARTIFACTS[1:]:
        g = nifti.load_nifti_simple(str(tmp_path / "mesh" / (rel % "subj01")))
        w = nifti.load_nifti_simple(str(tmp_path / "cpu" / (rel % "subj01")))
        assert (g == w).mean() > MASK_AGREEMENT, rel


def test_serve_cli_mesh(case, tmp_path, monkeypatch, capsys):
    from deepwmh_tpu_torch.cli import serve as cli

    _, pkg, _, _ = case
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    _spool_request(spool, "s0", seed=20)
    base = ["-m", pkg, "-s", spool, "-o", str(tmp_path / "out"), "--once", "--settle-seconds",
            "0", "--skip-bfc", "--disable-tta", "--no-previews"]
    for extra in (["-g", "0"], ["--device", "cpu"]):
        with pytest.raises(SystemExit):
            cli.main(base + ["--mesh"] + extra)
    monkeypatch.setattr(pmesh, "make_mesh", lambda local: cpu_mesh(2))
    assert cli.main(base + ["--mesh"]) == 0
    assert "mesh: sharding each sweep over 2 device(s)" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(spool, ".done", "s0.json"))


# ---------------------------------------------------------------- stage-1


def test_stage1_on_mesh_matches_one_by_one_and_jax(tmp_path):
    """Three same-geometry cases over a 2-shard mesh: the artifacts of the
    one-by-one run exactly, and JAX's mesh run (one vmapped program over
    its mesh) within the stage-1 slice test's bars."""
    from deepwmh_tpu.pipeline.analysis import LesionAnalyzer as JLesionAnalyzer
    from deepwmh_tpu_torch.pipeline.analysis import LesionAnalyzer

    shape, spacing, K = (24, 28, 20), (2.0, 2.0, 2.0), 3
    cases = [("case%d" % i,) + tuple(chip_smoke.write_cohort(
        str(tmp_path / ("c%d" % i)), shape, spacing, K, 30 + i, suffix=".nii.gz")[:4])
        for i in range(3)]
    runs = {}
    for name, mesh in (("mesh", cpu_mesh(2)), ("solo", None), ("jax", jax_mesh(2))):
        out = str(tmp_path / name)
        an = (JLesionAnalyzer(out) if name == "jax" else LesionAnalyzer(out, device="cpu"))
        for c in cases:
            an.add_case(*c)
        an.analyze_and_do_segmentation(intensity_prior="+", mesh=mesh)
        runs[name] = out
    names = ("anomaly_score", "valid_mask", "normalized_input", "averaged_label",
             "segmentation", "segmentation_pp")
    for c in cases:
        case_dirs = {k: os.path.join(v, c[0]) for k, v in runs.items()}
        for art in names:
            g, s, w = (nifti.load_nifti_simple(os.path.join(case_dirs[k], art + ".nii.gz"))
                       for k in ("mesh", "solo", "jax"))
            np.testing.assert_array_equal(g, s, err_msg=art)
            if art == "anomaly_score":
                assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
            elif art == "averaged_label":
                np.testing.assert_array_equal(g, w)
            elif art == "normalized_input":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            else:
                assert (g == w).mean() > MASK_AGREEMENT, art
        summaries = {}
        for k, d in case_dirs.items():
            with open(os.path.join(d, "summary.json")) as f:
                summaries[k] = json.load(f)
        assert summaries["mesh"] == summaries["solo"]
        xs = summaries["jax"]["histogram_curves"]["x"]
        assert abs(summaries["mesh"]["autoseg_threshold"]
                   - summaries["jax"]["autoseg_threshold"]) <= (xs[1] - xs[0]) * 1.0001


def test_stage1_chunks_deal_cases_over_the_shards(tmp_path, monkeypatch):
    """JAX's chunk sizing; ``map_blocks`` deals a padded batch over the
    shards a block each, on the shard's device, gathered in shard order;
    the analyzer sends a chunk's batch through ``nll_analysis_batch`` with
    its mesh and a group of one through ``analyze_case``."""
    from deepwmh_tpu_torch.pipeline import analysis
    from deepwmh_tpu_torch.pipeline.analysis import LesionAnalyzer

    from deepwmh_tpu.pipeline.analysis import LesionAnalyzer as JLesionAnalyzer

    an = LesionAnalyzer(str(tmp_path / "port"), device="cpu")
    jan = JLesionAnalyzer(str(tmp_path / "jax"))
    for shape, K, n in [((192, 224, 192), 10, 8), ((64, 80, 64), 10, 2),
                        ((192, 224, 192), 10, 1), ((400, 400, 400), 30, 4)]:
        assert an._auto_batch_cases(shape, K, n) == jan._auto_batch_cases(shape, K, n)
    mesh = pmesh.Mesh([CPU, torch.device("cpu", 0)])
    seen = []
    out = pmesh.map_blocks(mesh, [torch.arange(5.0)],
                           lambda dev, b: seen.append((str(dev), b.tolist())) or (b * 2, None))
    assert sorted(seen) == [("cpu", [0.0, 1.0, 2.0]), ("cpu:0", [3.0, 4.0, 4.0])]
    assert out[0].tolist() == [0.0, 2.0, 4.0, 6.0, 8.0] and out[1] is None
    calls, solo = [], []
    monkeypatch.setattr(analysis, "nll_analysis_batch", lambda xs, *a, mesh=None, **kw: (
        calls.append((xs.shape[0], mesh)) or [torch.ones(xs.shape)] * 8
        + [torch.arange(float(xs.shape[0]))]))
    an.analyze_case = lambda case, **kw: solo.append(case) or ("result " + case, "hdr", None)
    vol = np.zeros((4, 4, 4), np.float32)
    loaded = [(vol, "h%d" % i, (1.0, 1.0, 1.0), np.zeros((2, 4, 4, 4)), np.zeros((2, 4, 4, 4)),
               np.full((2, 4, 4, 4), c, np.float32)) for i, c in enumerate((1, 1, 2))]
    res = an._analyze_chunk_batched(["a", "b", "c"], loaded, "+", False, mesh)
    assert calls == [(2, mesh)] and solo == ["c"]
    assert [r[1] for r in res] == ["h0", "h1", "hdr"] and res[2][0] == "result c"
    assert [r[0].threshold for r in res[:2]] == [0.0, 1.0]
    with pytest.raises(TypeError, match="Mesh"):
        an.analyze_and_do_segmentation(mesh=object())


# ---------------------------------------------------------------- dryrun and processes


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip(n, capsys):
    from deepwmh_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(n)
    out = capsys.readouterr().out
    assert "dryrun_multichip(%d): sharded inference ok" % n in out
    assert "halo-sharded ops ok, median (%d, 10, 12)" % (4 * n) in out
    assert "sharded mean_std_grid (%d, 10, 12) + N4 (%d, 10, 12) ok" % (4 * n, 4 * n) in out


WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %(repo)r)
    os.environ["DEEPWMH_COORDINATOR"] = %(coord)r
    os.environ["DEEPWMH_NUM_PROCESSES"] = "2"
    os.environ["DEEPWMH_PROCESS_ID"] = sys.argv[1]
    import torch
    import torch.distributed as dist
    from deepwmh_tpu_torch.parallel.mesh import device_info, init_distributed_from_env

    assert init_distributed_from_env()
    info = device_info()
    assert info["process_count"] == 2, info
    rank = int(sys.argv[1])
    t = torch.tensor([float(2 * rank), float(2 * rank + 1)]).sum().reshape(1)
    dist.all_reduce(t)
    assert t.item() == 6.0, t
    dist.destroy_process_group()
    print("proc %%d ok" %% rank, flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_from_env_two_gloo_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"repo": REPO, "coord": "127.0.0.1:%d" % _free_port()})
    env = {k: v for k, v in os.environ.items() if not k.startswith("DEEPWMH_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d:\n%s" % (rank, out)
        assert "proc %d ok" % rank in out


def test_init_distributed_from_env_fails_fast(monkeypatch):
    monkeypatch.delenv("DEEPWMH_PROCESS_ID", raising=False)
    monkeypatch.delenv("DEEPWMH_NUM_PROCESSES", raising=False)
    assert pmesh.init_distributed_from_env() is False
    monkeypatch.setenv("DEEPWMH_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="DEEPWMH_PROCESS_ID"):
        pmesh.init_distributed_from_env()
    monkeypatch.setenv("DEEPWMH_NUM_PROCESSES", "1")
    assert pmesh.init_distributed(num_processes=1) is False
