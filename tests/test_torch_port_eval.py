"""deepwmh_tpu_torch's evaluation against deepwmh_tpu's on the CPU: the
metrics (components labelled by the port's ``label_components``) and their
harnesses, both evaluate CLIs, the statistics, the xlsx workbooks, the PDF
canvas and cards, colormaps, previews and plots. Metrics, p-values and
regressions are exact; workbooks are compared by parsed content, PDFs and
colormaps by bytes. Inputs come from numpy seeds."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from deepwmh_tpu.cli import evaluate as jcli
from deepwmh_tpu.core import xlsx as jxlsx
from deepwmh_tpu.eval import colormaps as jcm
from deepwmh_tpu.eval import metrics as jm
from deepwmh_tpu.eval import pdfcanvas as jpdf
from deepwmh_tpu.eval import preview as jpreview
from deepwmh_tpu.eval import stats as jstats
from deepwmh_tpu_torch.cli import evaluate as cli
from deepwmh_tpu_torch.core import nifti, xlsx
from deepwmh_tpu_torch.eval import colormaps as cm
from deepwmh_tpu_torch.eval import metrics as m
from deepwmh_tpu_torch.eval import pdfcanvas as pdf
from deepwmh_tpu_torch.eval import plots, preview, stats
from deepwmh_tpu_torch.ops.components import label_components

SHAPE = (20, 24, 18)


@pytest.fixture(autouse=True)
def one_thread():
    """Labelling runs many rounds of small scatters; with the test workers
    sharing the cores, torch's thread pool turns each into milliseconds."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def lesion_masks(seed, shape=SHAPE):
    """(pred, truth) f32 with many components: truth is random blobs plus
    two planted 2x2x2 cubes (a size tie) and single voxels; pred a shifted
    copy with voxels dropped and spurious specks."""
    rng = np.random.RandomState(seed)
    truth = np.zeros(shape, bool)
    for _ in range(40):
        c = [rng.randint(1, s - 4) for s in shape]
        e = rng.randint(1, 4, 3)
        truth[c[0]:c[0] + e[0], c[1]:c[1] + e[1], c[2]:c[2] + e[2]] = True
    truth[1:3, 1:3, 1:3] = truth[-3:-1, -3:-1, -3:-1] = True
    truth |= rng.rand(*shape) < 0.01
    pred = np.roll(truth, 1, axis=seed % 3) & (rng.rand(*shape) < 0.9)
    pred |= rng.rand(*shape) < 0.02
    return pred.astype(np.float32), truth.astype(np.float32)


def _save(arr, path):
    hdr = nifti.NiftiHeader()
    hdr.set_shape(arr.shape)
    hdr.set_zooms((1.0, 1.0, 1.0))
    nifti.save_nifti(arr, hdr, path)
    return path


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_metrics_equal_jax(seed):
    pred, truth = lesion_masks(seed)
    sizes = [s for s, _ in jm.binary_component_dice(pred, truth)]
    assert len(sizes) > 50 and len(sizes) > len(set(sizes))  # many components, size ties
    assert m.hard_dice_binary(pred, truth) == jm.hard_dice_binary(pred, truth)
    assert m.voxel_precision_recall(pred, truth) == jm.voxel_precision_recall(pred, truth)
    for a, b in ((pred, truth), (truth, pred), (pred, pred), (pred, np.zeros_like(pred)),
                 (np.zeros_like(pred), truth)):
        assert m.instance_confusion(a, b, device="cpu") == jm.instance_confusion(a, b)
        assert m.instance_f1(a, b, device="cpu") == jm.instance_f1(a, b)
        assert m.binary_component_dice(a, b, device="cpu") == jm.binary_component_dice(a, b)
    # a tensor runs on its own device, whatever ``device`` says
    assert m.instance_confusion(torch.from_numpy(pred), torch.from_numpy(truth)) == \
        jm.instance_confusion(pred, truth)
    tp, fp, fn = jm.instance_confusion(pred, truth)
    precision, recall = jm.voxel_precision_recall(pred, truth)
    assert m.evaluate_masks(pred, truth, m.METRICS, device="cpu") == {
        "dice": jm.hard_dice_binary(pred, truth), "precision": precision, "recall": recall,
        "instance_f1": jm.instance_f1(pred, truth), "tp": tp, "fp": fp, "fn": fn,
        "component_dice": jm.binary_component_dice(pred, truth)}
    labels, rounds = label_components(torch.from_numpy(truth), return_rounds=True)
    assert rounds >= 2 and torch.equal(labels, label_components(torch.from_numpy(truth)))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Three cases of predictions and truths, .nii.gz and .nii mixed, one
    prediction without a truth."""
    root = tmp_path_factory.mktemp("ev")
    for d in ("pred", "truth"):
        os.makedirs(root / d)
    for i in range(3):
        pred, truth = lesion_masks(10 + i)
        ext = ".nii.gz" if i != 1 else ".nii"
        _save(pred, str(root / "pred" / ("case%d.nii.gz" % i)))
        _save(truth, str(root / "truth" / ("case%d%s" % (i, ext))))
    _save(pred, str(root / "pred" / "orphan.nii.gz"))
    return root


def test_harnesses_equal_jax(folders):
    cases = ["case0", "case1", "case2"]
    pairs = [(c, str(folders / "pred" / (c + ".nii.gz")),
              str(folders / "truth" / (c + (".nii" if c == "case1" else ".nii.gz")))) for c in cases]
    for workers in (1, 3):
        port, jax_ev = m.PairedEvaluation(device="cpu"), jm.PairedEvaluation()
        for ev in (port, jax_ev):
            for p in pairs:
                ev.add_pair(*p)
        got = port.run(metrics=m.METRICS, num_workers=workers)
        want = jax_ev.run(metrics=m.METRICS, num_workers=workers)
        assert got == want and m.summarize(got) == jm.summarize(want)
    truth_of = {c: t for c, _p, t in pairs}
    pred_of = {c: p for c, p, _t in pairs}
    for name in ("BinaryDiceEvaluation", "VoxelPrecisionRecallEvaluation",
                 "InstancePrecisionRecallEvaluation", "InstanceF1Evaluation",
                 "BinaryComponentDiceEvaluation"):
        evs = [getattr(m, name)(cases, device="cpu"), getattr(jm, name)(cases)]
        for ev in evs:
            ev.add_method("truth", truth_of.get)
            ev.add_method("pred", pred_of.get)
            ev.add_method("none", lambda c: None)
            assert ev.get_subject_list() == cases
        for workers in (1, 3):
            assert evs[0].run_eval("truth", "pred", num_workers=workers) == \
                evs[1].run_eval_parallel("truth", "pred", num_workers=workers)
            assert evs[0].run_eval("truth", "none", workers, allow_null=True) == \
                evs[1].run_eval("truth", "none", workers, allow_null=True)
        for ev in evs:
            with pytest.raises(RuntimeError, match="NULL"):
                ev.run_eval("truth", "none", num_workers=1)
            with pytest.raises(RuntimeError, match="no valid file"):
                ev.run_eval("none", "none", num_workers=1, allow_null=True)
    for ev in (m.PairedEvaluation(device="cpu"), jm.PairedEvaluation()):
        ev.add_pair("x", *pairs[0][1:])
        with pytest.raises(ValueError, match="unknown metric"):
            ev.run(metrics=("hausdorff",))
    assert m.summarize({"a": {"component_dice": []}}) == jm.summarize({"a": {"component_dice": []}})


@pytest.mark.parametrize("metrics", [None, list(m.METRICS)])
def test_evaluate_clis_write_equal_reports(folders, tmp_path, metrics, capsys):
    extra = [] if metrics is None else ["--metrics"] + metrics
    args = ["-p", str(folders / "pred"), "-g", str(folders / "truth")] + extra
    report = cli.main(args + ["-o", str(tmp_path / "port.json"), "--device", "cpu"])
    jcli.main(args + ["-o", str(tmp_path / "jax.json")])
    with open(tmp_path / "port.json") as f:
        port = json.load(f)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert port == want == json.loads(json.dumps(report))
    assert sorted(port["cases"]) == ["case0", "case1", "case2"]
    assert "[skip] no ground truth for orphan.nii.gz" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(args + ["-o", str(tmp_path / "x.json"), "--metrics", "hausdorff"])


def test_stats_equal_jax(tmp_path):
    rng = np.random.RandomState(7)
    a = rng.rand(25)
    for b in (a + 0.3 * rng.rand(25), a + rng.randn(25) * 0.1, a.copy()):
        for method in ("wilcoxon", "ttest"):
            if method == "ttest" and np.array_equal(a, b):
                continue
            p = stats.paired_test(a, b, method)
            assert p == jstats.paired_test(a, b, method)
            assert stats.significance_stars(p) == jstats.significance_stars(p)
    for p in (0.0005, 0.005, 0.04, 0.5):
        assert stats.significance_stars(p) == jstats.significance_stars(p)
    with pytest.raises(ValueError):
        stats.paired_test(a, a, "anova")
    y, X = rng.rand(30), rng.rand(30, 3)
    for cov in (X, X[:, 0]):
        r1, b1 = stats.nuisance_regression(y, cov)
        r2, b2 = jstats.nuisance_regression(y, cov)
        assert np.array_equal(r1, r2) and np.array_equal(b1, b2)
    groups = [rng.rand(15), rng.rand(15) + 0.3]
    stats.boxplot_compare(groups, ["a", "b"], str(tmp_path / "box.png"), paired_pairs=[(0, 1)])
    size_dice = [(int(v), float(d)) for v, d in zip(rng.randint(1, 1000, 40), rng.rand(40))]
    stats.component_dice_scatter(size_dice, str(tmp_path / "sc.png"), n_boot=10)
    with pytest.raises(ValueError):
        stats.component_dice_scatter([], str(tmp_path / "none.png"))
    plots.curve_plot([[0, 1, 2]] * 2, [[1, 2, 3], [3, 2, 1]], ["a", "b"], str(tmp_path / "c.png"))
    plots.training_curve_plot([1, 2, 3], [0.9, 0.5, 0.4], [0.1, 0.5, 0.6], str(tmp_path / "t.png"))
    plots.training_curve_plot([1, 2], [0.9, 0.5], None, str(tmp_path / "t2.png"))
    for f in ("box.png", "sc.png", "c.png", "t.png", "t2.png"):
        assert os.path.getsize(tmp_path / f) > 1000


def _read_both(path):
    a, b = xlsx.read_xlsx(path), jxlsx.read_xlsx(path)
    assert a == b
    return a


def test_workbooks_read_the_same_in_both(tmp_path):
    sheets = {"S & 1": [["h", "n", None, "<x>"], [1, 2.5, "", "a\"b"], [], ["z", -3, 1e-9]],
              "two": [["only"]]}
    for writer, name in ((xlsx.write_xlsx, "port.xlsx"), (jxlsx.write_xlsx, "jax.xlsx")):
        writer(str(tmp_path / name), sheets)
    assert _read_both(str(tmp_path / "port.xlsx")) == _read_both(str(tmp_path / "jax.xlsx"))
    # the matrix rating workbook: the same shuffles, the same parse
    cases, methods = ["c1", "c2", "c3", "c4"], ["ours", "base", "third"]
    for mod, name in ((stats, "p.xlsx"), (jstats, "j.xlsx")):
        mod.VisualScoreEvaluation.make_matrix_workbook(cases, methods, str(tmp_path / name), seed=3)
    book = _read_both(str(tmp_path / "p.xlsx"))
    assert book == _read_both(str(tmp_path / "j.xlsx"))
    score = [["case", "seg_1", "seg_2", "seg_3"], ["c1", 2, 1, 0], ["c2", "x", 2, 1],
             ["c3", 1.0, 1.5, 2], ["c4", 0, 1]]
    xlsx.write_xlsx(str(tmp_path / "scored.xlsx"), {"Score": score, "Mapping": book["Mapping"]})
    for kw in ({}, {"return_methods_and_subjects": True}):
        got = stats.VisualScoreEvaluation.parse_matrix_sheet(str(tmp_path / "scored.xlsx"), **kw)
        assert got == jstats.VisualScoreEvaluation.parse_matrix_sheet(
            str(tmp_path / "scored.xlsx"), **kw)
    assert got[1] == cases
    # TianTan: three regions, n/a voiding
    header = ["case", "seg_1"]
    xlsx.write_xlsx(str(tmp_path / "tian.xlsx"), {
        "Mapping": [header, ["c1", "ours"], ["c2", "ours"], ["c3", "ours"]],
        "Cerebral_small": [header, ["c1", "2"], ["c2", "n/a"], ["c3", 1]],
        "Cerebral_large": [header, ["c1", "1"], ["c2", "n/a"], ["c3", "n/a"]],
        "Cerebellum_and_brainstem": [header, ["c1", "2"], ["c2", "n/a"], ["c3", 0]]})
    assert stats.VisualScoreEvaluation.parse_tiantan_scores(str(tmp_path / "tian.xlsx")) == \
        jstats.VisualScoreEvaluation.parse_tiantan_scores(str(tmp_path / "tian.xlsx"))


@pytest.mark.parametrize("fmt", ["xlsx", "csv"])
def test_blinded_sheets_and_unblind_equal_jax(tmp_path, fmt):
    evs = [stats.VisualScoreEvaluation(str(tmp_path / "p"), seed=5, fmt=fmt),
           jstats.VisualScoreEvaluation(str(tmp_path / "j"), seed=5, fmt=fmt)]
    paths = []
    for ev in evs:
        for i in range(7):
            ev.add_entry("c%d" % (i // 2), ("ours", "base")[i % 2], "p%d.gif" % i)
        paths.append(ev.make_blinded_sheet())
    if fmt == "xlsx":
        for port_path, jax_path in zip(*paths):
            assert _read_both(port_path) == _read_both(jax_path)
        rows = xlsx.read_xlsx(paths[0][0])["rating"]
        for i, r in enumerate(rows[1:]):
            r += [""] * (3 - len(r))
            r[2] = float(i % 3) if i != 2 else ""
        xlsx.write_xlsx(paths[0][0], {"rating": rows})
    else:
        for a, b in zip(*paths):
            assert open(a).read() == open(b).read()
        rows = list(csv.reader(open(paths[0][0])))
        for i, r in enumerate(rows[1:]):
            r[2] = str(i % 3) if i != 2 else ""
        with open(paths[0][0], "w", newline="") as f:
            csv.writer(f).writerows(rows)
    got = stats.VisualScoreEvaluation.unblind(*paths[0])
    assert got == jstats.VisualScoreEvaluation.unblind(*paths[0])
    assert sum(len(v) for v in got.values()) == 6


def test_pdf_bytes_equal_jax(tmp_path):
    def draw(mod, path):
        cv = mod.PdfCanvas(path, "10cm*8cm")
        cv.register_font("x.ttf", "myfont")
        cv.text("a (b) \\ c", "1cm, 2cm", "myfont", 11, (0.2, 0.3, 0.4), alpha=0.5)
        cv.text("t", (1, 1), "Times-Bold", 9)
        cv.line("1mm, 1mm", "2in, 1in", 1.5, dashed=True)
        cv.rect((0.5, 0.5), (3, 2), 0.5, (1, 0, 0), (0, 1, 0), line_alpha=0.3, fill_alpha=0.7)
        cv.rect((1, 1), (2, 2), 1, None, (0, 0, 1))
        cv.rect((1, 1), (2, 2), 1, (0, 0, 0), None)
        cv.image_array((4, 4), (6, 6), np.arange(48, dtype=np.uint8).reshape(4, 4, 3))
        cv.save()
        return open(path, "rb").read()

    assert draw(pdf, str(tmp_path / "p.pdf")) == draw(jpdf, str(tmp_path / "j.pdf"))
    for s in ("5mm", "2cm", "1in", "1inch", 3, 2.5, " 4 "):
        assert pdf.parse_unit(s) == jpdf.parse_unit(s)
    for s in ("5cm, 3.4cm", (1, 2), [0.5, 1]):
        assert pdf.parse_position(s) == jpdf.parse_position(s)
    mat = np.random.RandomState(0).rand(6, 9)
    for kw in ({}, {"cmap": "vik", "normalize_data": False}):
        a = pdf.plot_mat(mat, str(tmp_path / "pm.pdf"), **kw)
        b = jpdf.plot_mat(mat, str(tmp_path / "jm.pdf"), **kw)
        assert open(a, "rb").read() == open(b, "rb").read()
    scores = np.random.RandomState(1).rand(30)
    for kw in ({}, {"color_palette": "blue"}, {"null_plot": True}):
        pdf_a = stats.VisualScoreEvaluation.score_histogram(scores, 12, str(tmp_path / "h.pdf"), **kw)
        pdf_b = jstats.VisualScoreEvaluation.score_histogram(scores, 12, str(tmp_path / "jh.pdf"),
                                                             **kw)
        assert open(pdf_a, "rb").read() == open(pdf_b, "rb").read()
    png = str(tmp_path / "img.png")
    preview.draw_colorbar(png, "plasma", size=(20, 6))
    for mod, name in ((pdf, "pi.pdf"), (jpdf, "ji.pdf")):
        cv = mod.PdfCanvas(str(tmp_path / name))
        cv.image("1cm, 1cm", None, png)
        cv.save()
    assert open(tmp_path / "pi.pdf", "rb").read() == open(tmp_path / "ji.pdf", "rb").read()


def test_colormaps_and_previews_equal_jax(tmp_path):
    from PIL import Image

    assert cm.list_colormaps() == jcm.list_colormaps() and cm.REFERENCE_MAPS == jcm.REFERENCE_MAPS
    v = np.random.RandomState(0).rand(13, 17) * 1.4 - 0.2
    for name in cm.list_colormaps():
        got = cm.apply_colormap(v, name)
        assert got.dtype == np.uint8 and np.array_equal(got, jcm.apply_colormap(v, name))
    with pytest.raises(ValueError):
        cm.apply_colormap(v, "nope")
    img = (np.random.RandomState(1).rand(10, 12, 8) * 300).astype(np.float32)
    mask = (img > 250).astype(np.float32)
    for number, zoom in ((0, 1), (1234567890, 2), (42, 3)):
        rgb = np.full((12, 40, 3), 200, np.uint8)
        assert np.array_equal(preview._stamp_number(rgb.copy(), number, zoom),
                              jpreview._stamp_number(rgb.copy(), number, zoom))

    def same_png(name, fn):
        fn(preview, str(tmp_path / ("p_" + name)))
        fn(jpreview, str(tmp_path / ("j_" + name)))
        a = np.asarray(Image.open(tmp_path / ("p_" + name)))
        assert np.array_equal(a, np.asarray(Image.open(tmp_path / ("j_" + name))))

    same_png("slice.png", lambda mod, p: mod.save_slice_png(img[:, :, 3], p, "metalheat",
                                                            slice_number=17, font_zoom=2))
    same_png("view.png", lambda mod, p: mod.view_slice(
        img, p, axis="coronal", slice_num=4, reverse_slice_order=True, show_slice_number=True,
        hflip=True, crop=[1, 1, 9, 7], spacing=(1.0, 2.0, 1.0), global_zoom=2,
        intensity_range=[None, 200], colormap="vik"))
    same_png("bar.png", lambda mod, p: mod.draw_colorbar(p, "rainbow", size=(32, 5)))
    same_png("box.png", lambda mod, p: mod.lightbox(img, p, ncols=3, lesion_mask=mask,
                                                    slice_step=2))
    path = _save(img, str(tmp_path / "v.nii.gz"))
    same_png("nii.png", lambda mod, p: mod.SimpleNiftiPreview(10, "auto", "green").plot(
        path, "sagittal", 5, p, output_colormap=p + ".bar.png", vflip=True))
    for bad in ({"colormap": "nope"}, {"min_intensity": "low"}):
        with pytest.raises(ValueError):
            preview.SimpleNiftiPreview(**bad)
    with pytest.raises(ValueError):
        preview.view_slice(img, str(tmp_path / "x.png"))
