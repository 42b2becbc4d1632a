"""Statistical analysis and report plots of an evaluation (the port's copy
of ``deepwmh_tpu.eval.stats``; the same p-values, regressions, shuffles and
files):

- paired significance tests and boxplots with significance stars;
- lesion-size against per-lesion Dice scatter with a bootstrap trend band;
- nuisance-variable linear regression;
- a blinded visual-scoring harness: blinded rating sheets, the matrix
  rating workbook, its parse, the TianTan three-region format, the score
  histogram PDF card and the unblinding.

Host numpy throughout; scipy and matplotlib are imported at the call, so a
host without matplotlib still writes workbooks and PDF cards.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from deepwmh_tpu_torch.core.xlsx import read_xlsx, write_xlsx
from deepwmh_tpu_torch.eval.pdfcanvas import PdfCanvas


def _plt():
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    return plt


def significance_stars(p: float) -> str:
    if p < 0.001:
        return "***"
    if p < 0.01:
        return "**"
    if p < 0.05:
        return "*"
    return "n.s."


def paired_test(a, b, method: str = "wilcoxon") -> float:
    """p-value of a paired two-sided test between matched samples."""
    from scipy import stats

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    if method == "wilcoxon":
        if np.allclose(a, b):
            return 1.0
        return float(stats.wilcoxon(a, b).pvalue)
    if method == "ttest":
        return float(stats.ttest_rel(a, b).pvalue)
    raise ValueError(method)


def boxplot_compare(groups, labels, save_file, paired_pairs=None, method="wilcoxon",
                    title="", ylabel=""):
    """Boxplots of metric distributions with significance stars between the
    requested pairs of group indices (reference boxplot_2x)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(1.6 * len(groups) + 2, 5), dpi=120)
    ax.boxplot(groups, showfliers=True)
    ax.set_xticks(range(1, len(labels) + 1), labels)
    top = max(float(np.max(g)) for g in groups if len(g))
    step = 0.08 * max(top, 1e-6)
    y = top + step
    for (i, j) in paired_pairs or []:
        p = paired_test(groups[i], groups[j], method=method)
        ax.plot([i + 1, i + 1, j + 1, j + 1], [y, y + step / 3, y + step / 3, y],
                lw=1, color="k")
        ax.text((i + j) / 2 + 1, y + step / 2, significance_stars(p),
                ha="center", fontsize=10)
        y += step
    ax.set_title(title)
    ax.set_ylabel(ylabel)
    os.makedirs(os.path.dirname(os.path.abspath(save_file)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_file)
    plt.close(fig)


def component_dice_scatter(size_dice_pairs, save_file, n_boot: int = 200,
                           seed: int = 0, title="per-lesion Dice vs size"):
    """Scatter of per-lesion (volume, Dice) with a bootstrap moving-average
    trend band (the reference's LOWESS-bootstrap figure, metrics.py:304-536)."""
    plt = _plt()
    pairs = np.asarray(size_dice_pairs, np.float64)
    if len(pairs) == 0:
        raise ValueError("no components to plot")
    x = np.log10(np.maximum(pairs[:, 0], 1))
    y = pairs[:, 1]
    order = np.argsort(x)
    x, y = x[order], y[order]

    def moving_avg(xs, ys, grid, width):
        out = np.empty_like(grid)
        for k, g in enumerate(grid):
            w = np.exp(-0.5 * ((xs - g) / width) ** 2)
            out[k] = np.sum(w * ys) / max(np.sum(w), 1e-9)
        return out

    grid = np.linspace(x.min(), x.max(), 50)
    width = max((x.max() - x.min()) / 8, 1e-3)
    rng = np.random.RandomState(seed)
    boots = []
    for _ in range(n_boot):
        idx = rng.randint(0, len(x), len(x))
        boots.append(moving_avg(x[idx], y[idx], grid, width))
    boots = np.stack(boots)
    lo, mid, hi = (np.percentile(boots, q, axis=0) for q in (2.5, 50, 97.5))

    fig, ax = plt.subplots(figsize=(7, 5), dpi=120)
    ax.scatter(x, y, s=12, alpha=0.5, color="tab:blue")
    ax.plot(grid, mid, color="tab:red", lw=1.5)
    ax.fill_between(grid, lo, hi, color="tab:red", alpha=0.2)
    ax.set_xlabel("log10 lesion volume (voxels)")
    ax.set_ylabel("per-lesion Dice")
    ax.set_title(title)
    os.makedirs(os.path.dirname(os.path.abspath(save_file)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_file)
    plt.close(fig)


def nuisance_regression(y, covariates):
    """Residualize `y` [N] against nuisance covariates [N, P] with an
    intercept (reference linreg, metrics.py:896-994). Returns (residuals,
    coefficients)."""
    y = np.asarray(y, np.float64)
    X = np.asarray(covariates, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    X1 = np.concatenate([np.ones((len(y), 1)), X], axis=1)
    beta, *_ = np.linalg.lstsq(X1, y, rcond=None)
    resid = y - X1 @ beta
    return resid, beta


class VisualScoreEvaluation:
    """Blinded visual rating harness (reference metrics.py:538-893).

    Build: shuffle (case, method) preview entries with a hidden key, emit a
    rating sheet the rater fills in; Unblind: join scores back to methods.
    Sheets are .xlsx via the in-house core.xlsx codec — matching the
    reference's xlsx rating workflow (metrics.py:584-647) — with CSV as a
    fallback format (fmt="csv").
    """

    def __init__(self, output_folder: str, seed: int = 0, fmt: str = "xlsx"):
        assert fmt in ("xlsx", "csv")
        self.folder = output_folder
        os.makedirs(output_folder, exist_ok=True)
        self.seed = seed
        self.fmt = fmt
        self.entries = []  # (case, method, preview_path)

    def add_entry(self, case: str, method: str, preview_path: str):
        self.entries.append((case, method, preview_path))

    def make_blinded_sheet(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.entries))
        key_rows = [["blind_id", "case", "method"]]
        sheet_rows = [["blind_id", "preview", "score"]]
        for blind_id, idx in enumerate(order):
            case, method, preview = self.entries[idx]
            key_rows.append([blind_id, case, method])
            sheet_rows.append([blind_id, preview, ""])

        if self.fmt == "xlsx":
            key_path = os.path.join(self.folder, "unblind_key.xlsx")
            sheet_path = os.path.join(self.folder, "rating_sheet.xlsx")
            write_xlsx(key_path, {"key": key_rows})
            write_xlsx(sheet_path, {"rating": sheet_rows})
        else:
            key_path = os.path.join(self.folder, "unblind_key.csv")
            sheet_path = os.path.join(self.folder, "rating_sheet.csv")
            with open(key_path, "w", newline="") as kf:
                csv.writer(kf).writerows(key_rows)
            with open(sheet_path, "w", newline="") as sf:
                csv.writer(sf).writerows(sheet_rows)
        return sheet_path, key_path

    @staticmethod
    def _read_rows(path):
        if path.endswith(".xlsx"):
            sheets = read_xlsx(path)
            rows = next(iter(sheets.values()))
        else:
            with open(path) as f:
                rows = list(csv.reader(f))
        header = [str(h) for h in rows[0]]
        # pad short rows: an empty trailing cell (unrated score) may be
        # absent from the stored sheet row entirely
        padded = [list(r) + [""] * (len(header) - len(r)) for r in rows[1:]]
        return [dict(zip(header, r)) for r in padded]

    @staticmethod
    def make_matrix_workbook(cases, methods, out_xlsx, seed: int = 0):
        """Emit the reference's rating-workbook layout (metrics.py:584-614):
        one 'Score' worksheet the rater fills in and one hidden 'Mapping'
        worksheet. Columns are anonymous names seg_1..seg_N; every case row
        gets an INDEPENDENT shuffled method->anonymous assignment so raters
        cannot learn a column identity across cases. The reference shuffles
        with the unseeded global RNG; here the shuffle is seeded for
        reproducibility."""
        methods = list(methods)
        anon = ["seg_%d" % (i + 1) for i in range(len(methods))]
        rng = np.random.RandomState(seed)
        score_rows = [["case"] + anon]
        map_rows = [["case"] + anon]
        for case in cases:
            perm = rng.permutation(len(methods))
            # anon[j] shows methods[perm[j]] for this case
            score_rows.append([case] + [""] * len(methods))
            map_rows.append([case] + [methods[perm[j]] for j in range(len(methods))])
        write_xlsx(out_xlsx, {"Score": score_rows, "Mapping": map_rows})
        return out_xlsx

    @staticmethod
    def parse_matrix_sheet(xlsx_file, worksheet_name="Score",
                           return_methods_and_subjects=False):
        """Parse a scored workbook in the reference's matrix layout
        (metrics.py:664-726 parse_sheet): method identities come from the
        'Mapping' worksheet row by row; a cell that does not parse as an
        integer is 'n/a', and any n/a in a case row voids the whole row
        (all methods get 'n/a' for that case). Returns
        {method: {case: score_str}} or, with return_methods_and_subjects,
        (methods, cases) from the Mapping sheet."""
        sheets = read_xlsx(xlsx_file)
        if "Mapping" not in sheets:
            raise ValueError('no "Mapping" worksheet in %s' % xlsx_file)
        if worksheet_name not in sheets:
            raise ValueError('no "%s" worksheet in %s' % (worksheet_name, xlsx_file))
        mapping = sheets["Mapping"]
        # keyed by case name, not row position: a stray blank-cased row in
        # the Mapping sheet must not shift every later lookup onto the
        # wrong permutation
        map_rows = {}
        for r in mapping[1:]:
            if r and str(r[0]):
                map_rows[str(r[0])] = r
        cases = list(map_rows)
        if not cases:
            raise ValueError(
                'the "Mapping" worksheet of %s has no case rows' % xlsx_file)
        # the method set is the first data row's assignment (every row holds
        # the same methods, differently permuted — reference metrics.py:679-683)
        methods = [str(c) for c in map_rows[cases[0]][1:] if str(c)]
        if return_methods_and_subjects:
            return methods, cases
        score_sheet = sheets[worksheet_name]
        out = {m: {} for m in methods}
        for row in score_sheet[1:]:
            if not row or not str(row[0]):
                continue
            case = str(row[0])
            if case not in map_rows:
                raise ValueError('case "%s" is not in the Mapping sheet' % case)
            map_row = map_rows[case]
            cells = list(row[1:]) + [""] * (len(methods) - len(row) + 1)
            row_scores, has_na = {}, False
            for j, method in enumerate(str(c) for c in map_row[1:]):
                if method not in out:
                    continue
                try:
                    # the reference accepts only whole-number scores
                    # (int(str(cell)) at metrics.py:699-704); xlsx numeric
                    # cells arrive as floats, so 2.0 is "2" but 1.5 is n/a
                    f = float(cells[j])
                    if not f.is_integer():
                        raise ValueError(cells[j])
                    score = str(int(f))
                except (TypeError, ValueError, IndexError):
                    score, has_na = "n/a", True
                row_scores[method] = score
            if has_na:  # one n/a voids the case for every method
                row_scores = {m: "n/a" for m in row_scores}
            for m, s in row_scores.items():
                out[m][case] = s
        return out

    @staticmethod
    def parse_tiantan_scores(xlsx_file):
        """Combine the three anatomical-region rating sheets of the
        reference's TianTan workbook format (metrics.py:833-893
        parse_xlsx_TianTan_format): worksheets 'Cerebral_small',
        'Cerebral_large', 'Cerebellum_and_brainstem', each scored 0-2.
        Per (method, subject): an n/a region contributes 0 and removes 2
        from the attainable maximum; subjects with no valid region at all
        are dropped. Returns (methods, valid_subjects,
        {method: {subject: normalized score in [0,1]}})."""
        parse = VisualScoreEvaluation.parse_matrix_sheet
        regions = [parse(xlsx_file, w) for w in
                   ("Cerebral_small", "Cerebral_large", "Cerebellum_and_brainstem")]
        methods, subjects = parse(xlsx_file, "Mapping",
                                  return_methods_and_subjects=True)
        final, valid = {}, []
        for method in methods:
            final[method] = {}
            for subj in subjects:
                total, attainable = 0.0, 0
                for reg in regions:
                    s = reg[method].get(subj, "n/a")
                    if s != "n/a":
                        total += float(s)
                        attainable += 2
                if attainable == 0:
                    continue
                final[method][subj] = total / attainable
                if subj not in valid:
                    valid.append(subj)
        return methods, valid, final

    @staticmethod
    def score_histogram(normalized_scores, n_max, save_file,
                        color_palette="red", null_plot=False):
        """Vertical visual-score distribution card as a vector PDF
        (reference plot_hist, metrics.py:729-831): the reference's exact
        bin edges [0,.1,.2,.3,.4,.6,.7,.8,.9,1] (a double-width middle bin),
        bars drawn top-down with width proportional to count (normalized by
        `n_max` and the narrowest bin), banded background, per-bar counts,
        and a dashed mean-score marker line."""
        v = np.asarray(normalized_scores, np.float64)
        if not null_plot and (v.size == 0 or v.min() < -0.001 or v.max() > 1.001):
            raise ValueError("scores must be normalized to [0,1]")
        if n_max <= 0:
            raise ValueError("n_max must be positive, got %r" % (n_max,))
        palettes = {
            "red": ((228 / 255, 140 / 255, 141 / 255),
                    (217 / 255, 68 / 255, 69 / 255)),
            "blue": ((136 / 255, 180 / 255, 213 / 255),
                     (57 / 255, 128 / 255, 171 / 255)),
        }
        bar_color, line_color = palettes.get(color_palette, palettes["red"])
        bins = [0.0, 0.1, 0.2, 0.3, 0.4, 0.6, 0.7, 0.8, 0.9, 1.0]
        hist, _ = np.histogram(v, bins=bins) if v.size else (np.zeros(9, int), None)
        rbins = bins[::-1]
        hist = hist[::-1]

        w_cm, h_cm = 2.8, 4.0
        cv = PdfCanvas(save_file, "%fcm*%fcm" % (w_cm, h_cm))
        y_lo, y_hi = h_cm * 0.02, h_cm * 0.98
        x_lo, x_hi = 0.0, w_cm
        cx = (x_lo + x_hi) / 2.0
        n_bars = len(rbins) - 1
        span = rbins[0] - rbins[-1]
        heights = [(y_hi - y_lo) * (rbins[i] - rbins[i + 1]) / span
                   for i in range(n_bars)]
        if int(np.max(hist)) > n_max:
            import warnings

            warnings.warn(
                "maximum bar height (%d) > n_max (%d); bars are clamped to "
                "the page width" % (int(np.max(hist)), n_max))
        widths = [min((hist[i] / n_max) * (min(heights) / heights[i]), 1.0)
                  * (x_hi - x_lo) for i in range(n_bars)]
        for w in (0.0, 0.4, 0.8):  # banded background
            wy = y_lo + (y_hi - y_lo) * w
            cv.rect((x_lo, wy), (x_hi, wy + (y_hi - y_lo) * 0.2), 0,
                    None, (0.95, 0.95, 0.95))
        gray = (0.8, 0.8, 0.8)
        cv.line((x_lo, y_lo), (x_hi, y_lo), 1.2, gray)
        cv.line((x_lo, y_hi), (x_hi, y_hi), 1.2, gray)
        cv.line((cx, y_hi), (cx, y_lo), 1.2, gray, alpha=0.6)
        if not null_plot:
            y = y_hi
            for i in range(n_bars):
                bw, bh = widths[i], heights[i]
                x0, y0 = cx - bw / 2, y - bh
                if hist[i] > 0:
                    cv.rect((x0, y0), (x0 + bw, y0 + bh), 0,
                            line_color=None, fill_color=bar_color)
                    cv.line((x0, y0), (x0, y0 + bh), 1, line_color=line_color)
                    cv.line((x0 + bw, y0 + bh), (x0 + bw, y0), 1,
                            line_color=line_color)
                    cv.text("%d" % hist[i], (x0 + bw + 0.04, y0 + bh / 2 - 0.115),
                            "font", 9, font_color=(0, 0, 0))
                y -= bh
            mean = float(np.mean(v))
            my = y_lo + (y_hi - y_lo) * mean
            cv.line((x_lo, my), (x_hi, my), 2, line_color=(0, 0, 0),
                    alpha=0.6, dashed=True, dash_pattern=(5, 4))
            ty = my + 0.06 if mean < 0.5 else my - 0.32
            cv.text("%.2f" % mean, (x_lo + 0.04, ty), "font", 10,
                    font_color=(0, 0, 0))
        cv.save()
        return save_file

    @staticmethod
    def unblind(sheet_path: str, key_path: str) -> dict:
        """Returns {method: [scores]} after the rater filled the sheet."""

        def _id(v):
            return str(int(float(v))) if v not in ("", None) else ""

        key = {
            _id(row["blind_id"]): (row["case"], row["method"])
            for row in VisualScoreEvaluation._read_rows(key_path)
        }
        out = {}
        for row in VisualScoreEvaluation._read_rows(sheet_path):
            score = row.get("score", "")
            if score in ("", None):
                continue
            _case, method = key[_id(row["blind_id"])]
            out.setdefault(method, []).append(float(score))
        return out
