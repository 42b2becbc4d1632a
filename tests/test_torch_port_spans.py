"""The port's spans (``utils/profiling.span``) under a CPU ``torch.profiler``.

Each pipeline that a benchmark cell drives runs once on tiny inputs inside
``profiling.trace`` (every thread recorded): ``predict_one_case`` on its
fused path, ``analyze_and_do_segmentation(batch_cases=1)`` and two steps of
``Trainer.fit``. Each run emits every span name documented for it and no
other; within a thread no span encloses another span of its pipeline's
stage list, except the labelling and the NIfTI I/O that stages call. With
no profiler a span opens no profiler event, and the outputs are the same
bits as under a profiler. A span is a host event of the operators' kind,
never a user annotation, which kineto would mirror onto the device's
timeline.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.pipeline import analysis
from deepwmh_tpu_torch.pipeline.inference import make_output_folders, predict_one_case
from deepwmh_tpu_torch.unet.data import SegDataset
from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer
from deepwmh_tpu_torch.utils import profiling
from torch_port_fixture import phantom, tiny_plan

# spans that a stage calls, and so may lie inside another stage's span
SHARED = {"components.label", "nifti.read", "nifti.write"}
BUILDS = {"kernels.build", "native.build"}  # whichever run builds first
STAGE1_CORE = {"stage1." + s for s in ("mask_zscore_otsu", "local_mean_alignment", "nll",
                                        "component_filtering", "histogram_threshold",
                                        "tissue_vote", "median_3mm")}
PIPELINES = {
    "predict": {"predict.n4", "predict.preprocess", "predict.sweep", "predict.resample_back",
                "predict.sparks", "predict.brain_mask", "predict.to_host", "predict.preview"}
    | SHARED,
    "stage1": STAGE1_CORE | {"stage1.read", "stage1.read_wait", "stage1.label_count",
                             "stage1.to_device", "stage1.to_host", "stage1.plot",
                             "stage1.sparks"} | SHARED,
    "train": {"train.sample", "train.data_wait", "train.augment", "train.forward_backward",
              "train.update", "train.validate", "train.checkpoint"},
}
SPACING = (2.0, 2.0, 2.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _spans(prof) -> list:
    """[(name without the prefix, thread, start_ns, end_ns)] of the port's
    spans in a finished profile."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(profiling.PREFIX):
            start = ev.start_ns()
            out.append((ev.name()[len(profiling.PREFIX):], ev.start_thread_id(), start,
                        start + ev.duration_ns()))
    return out


def _traced(tmp_path, fn):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        out = fn()
    return out, _spans(prof)


def _check_names(spans, pipeline):
    names = {s[0] for s in spans}
    assert names - BUILDS == PIPELINES[pipeline], (
        "missing %s, not documented %s" % (sorted(PIPELINES[pipeline] - names),
                                           sorted(names - BUILDS - PIPELINES[pipeline])))


def _check_nesting(spans):
    """Within a thread only the shared spans and the builds lie inside
    another span."""
    for name, thread, start, end in spans:
        for inner, t2, s2, e2 in spans:
            if t2 == thread and (s2, e2) != (start, end) and start <= s2 and e2 <= end:
                assert inner in SHARED | BUILDS, "%s encloses %s" % (name, inner)


def _predictor(plan):
    model = init_weights(UNet3D(plan, dtype=torch.float32), torch.Generator().manual_seed(3))
    return SlidingWindowPredictor(model, plan, tta=False, device="cpu")


def _predict_run(tmp_path, tag):
    hdr = nifti.NiftiHeader()
    hdr.set_shape((48, 48, 40))
    hdr.set_zooms(SPACING)
    path = str(tmp_path / "flair.nii.gz")
    nifti.save_nifti(phantom(), hdr, path)
    folders = make_output_folders(str(tmp_path / tag))
    return lambda: predict_one_case(_predictor(tiny_plan(Plan)), "case", path, folders)


def test_predict_one_case_spans(tmp_path):
    seg_fov, spans = _traced(tmp_path, _predict_run(tmp_path, "out"))
    _check_names(spans, "predict")
    _check_nesting(spans)
    # the fused path: each stage once; the four artifacts written, the input read
    count = {n: sum(1 for s in spans if s[0] == n) for n in PIPELINES["predict"]}
    for name in ("predict.n4", "predict.preprocess", "predict.sweep", "predict.resample_back",
                 "predict.sparks", "predict.brain_mask", "predict.preview"):
        assert count[name] == 1, name
    assert count["nifti.write"] == 4 and count["nifti.read"] == 1
    assert nifti.try_load_nifti(seg_fov)


def test_stage1_spans(tmp_path):
    *inputs, _ = chip_smoke.write_cohort(str(tmp_path / "data"), (24, 28, 20), SPACING, 3,
                                         seed=2, suffix=".nii.gz")

    def run():
        an = analysis.LesionAnalyzer(str(tmp_path / "out"), device="cpu")
        an.add_case("case", *inputs)
        an.analyze_and_do_segmentation("+", batch_cases=1)

    _, spans = _traced(tmp_path, run)
    _check_names(spans, "stage1")
    _check_nesting(spans)
    for name in STAGE1_CORE | {"stage1.read", "stage1.read_wait", "stage1.sparks"}:
        assert sum(1 for s in spans if s[0] == name) == 1, name
    # the read runs on the reader thread, the wait on the caller's
    (read,) = [s for s in spans if s[0] == "stage1.read"]
    (wait,) = [s for s in spans if s[0] == "stage1.read_wait"]
    assert read[1] != wait[1]


def test_train_fit_spans(tmp_path):
    plan = tiny_plan(Plan)
    rng = np.random.RandomState(4)
    datasets = [SegDataset(plan.patch_size) for _ in range(2)]
    for ds in datasets:
        for i in range(2):
            ds.add_case("c%d" % i, rng.randn(20, 18, 16).astype(np.float32),
                        (rng.rand(20, 18, 16) > 0.9).astype(np.uint8))
    cfg = TrainConfig(epochs=1, batches_per_epoch=2, val_batches=1, seed=5)
    trainer = Trainer(plan, cfg, str(tmp_path / "train"), device="cpu")

    _, spans = _traced(tmp_path, lambda: trainer.fit(*datasets, resume=False))
    _check_names(spans, "train")
    _check_nesting(spans)
    count = {n: sum(1 for s in spans if s[0] == n) for n in PIPELINES["train"]}
    for name in ("train.sample", "train.data_wait", "train.augment",
                 "train.forward_backward", "train.update"):
        assert count[name] == 2, name
    # validation finds a best model, so no checkpoint is written after the loop
    assert count["train.validate"] == 1 and count["train.checkpoint"] == 1


def test_span_without_a_profiler_never_records(monkeypatch):
    def refuse(name):
        raise AssertionError("a profiler event %r with no profiler" % name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not profiling.recording()

    @profiling.span("test.decorated")
    def double(x):
        return 2 * x

    with profiling.span("test.block") as s:
        assert double(3) == 6
    assert s.name == "test.block"
    timer = profiling.StageTimer()
    with timer.stage("test.stage"):
        pass
    assert set(timer.durations) == {"test.stage"} and timer.durations["test.stage"] >= 0


def test_span_is_an_operator_event_not_a_user_annotation():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.block"):
            torch.ones(4).sum()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == profiling.PREFIX + "test.block"]
    assert not ev.is_user_annotation() and ev.device_type() == torch.autograd.DeviceType.CPU


def test_outputs_equal_under_a_profiler(tmp_path):
    plan = tiny_plan(Plan)
    predictor = _predictor(plan)
    vol = phantom()

    def run():
        return predictor.predict_case_full(vol, SPACING, apply_n4=True)

    plain = run()
    traced, spans = _traced(tmp_path, run)
    assert {s[0] for s in spans} >= {"predict.n4", "predict.sweep", "components.label"}
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    assert os.listdir(tmp_path / "trace")
