"""Driver of the stage-1 cells: the port's ``LesionAnalyzer`` on one
registered case at a time (closed loop), as ``DeepWMH_train`` stage I runs
it: ``analyze_and_do_segmentation`` with ``batch_cases`` 1, so the
analysis (``nll_analysis_core``, K2 among its stages), the artifact
writes, the threshold segmentation and the 3 mm spark removal.

Set-up writes one seeded cohort (a target with planted lesions and K
registered references with their label1 / label2 maps, the maps as uint8)
as ``.nii`` files, waits until they are on disk, and runs one warm-up case. One unit is one case under an output folder of
its own (the analyzer skips a case whose summary exists); every unit reads
the same cohort: the port keeps nothing between analyzers.

The check: the plain reference (``reference/stage1.py``) analyses the
cohort once; a sample of the window's cases, drawn from the seed, is
compared with it: the anomaly map, the threshold, and the segmentation and
the post-processed segmentation (as one number, the larger mismatch).
"""

from __future__ import annotations

import json
import os
import numpy as np
import torch

from wmhbench import compare
from wmhbench.drivers import base
from wmhbench.harness import derive_seed
from wmhbench.niftiio import read_nifti, write_nifti
from wmhbench.traffic.synthetic import synthetic_cohort


class Driver(base.Driver):
    FAULTS = ("answer_altered",)

    def __init__(self, cell, seed: int, device, workdir: str):
        super().__init__(cell, seed, device, workdir)
        self._restore = None

    def setup(self):
        from deepwmh_tpu_torch.pipeline import analysis

        self.analysis = analysis
        shape, K = self.cfg["volume_shape"], int(self.tr["K"])
        target, refs, l1, l2, _lesions = synthetic_cohort(shape, K, derive_seed(self.seed,
                                                                                "cohort"))
        self.cohort = (target, refs, l1, l2)
        folder = os.path.join(self.workdir, "cohort")
        os.makedirs(folder)
        self.paths = {"x": os.path.join(folder, "target.nii")}
        # the cohort is on disk before the window opens, so that its
        # write-back never runs in the window; the label maps (0 to 3) as
        # uint8, a quarter of the bytes, read back as the same float32
        write_nifti(self.paths["x"], target, self.cfg["spacing"], sync=True)
        for key, stack, dtype in (("r", refs, np.float32), ("m", l1, np.uint8),
                                  ("y", l2, np.uint8)):
            self.paths[key] = []
            for k in range(K):
                path = os.path.join(folder, "%s%02d.nii" % (key, k))
                write_nifti(path, stack[k], self.cfg["spacing"], dtype=dtype, sync=True)
                self.paths[key].append(path)
        if self.fault == "answer_altered":
            self._alter_answers()
        self._unit(os.path.join(self.workdir, "warmup"))

    def _alter_answers(self):
        """The fault: the anomaly map doubled in the central slab where the
        analysis produces it."""
        core = self.analysis.nll_analysis_core

        def altered(*args, **kwargs):
            out = core(*args, **kwargs)
            anomaly = out[0].clone()
            D = anomaly.shape[0]
            anomaly[D // 2 - max(D // 32, 1): D // 2 + max(D // 32, 1)] *= 2.0
            return (anomaly,) + tuple(out[1:])

        self.analysis.nll_analysis_core = altered
        self._restore = core

    def _unit(self, out: str):
        analyzer = self.analysis.LesionAnalyzer(out, device=self.device)
        analyzer.add_case("case", self.paths["x"], self.paths["r"], self.paths["m"],
                          self.paths["y"])
        analyzer.analyze_and_do_segmentation("+", do_postprocessing=True, batch_cases=1)

    def run(self, win):
        def unit(i):
            out = os.path.join(self.workdir, "unit%04d" % i)
            self._unit(out)
            return out

        self.closed_loop(win, unit)

    def release(self):
        if self._restore is not None:
            self.analysis.nll_analysis_core = self._restore
            self._restore = None

    def reference(self, precision: str) -> dict:
        from wmhbench.reference.stage1 import analyze

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

        out = analyze(*(dev(a) for a in self.cohort),
                      tuple(round(float(v), 4) for v in self.cfg["spacing"]), precision)
        return {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in out.items()}

    @staticmethod
    def artifacts(out: str) -> dict:
        case = os.path.join(out, "case")
        with open(os.path.join(case, "summary.json")) as f:
            thr = json.load(f)["autoseg_threshold"]
        got = {k: torch.from_numpy(read_nifti(os.path.join(case, name + ".nii.gz")))
               for k, name in (("anomaly", "anomaly_score"), ("segmentation", "segmentation"),
                               ("segmentation_pp", "segmentation_pp"))}
        got["threshold"] = np.float32(thr)
        return got

    @staticmethod
    def numbers(got: dict, want: dict) -> dict:
        return {
            "anomaly_rel_max": compare.rel_max(got["anomaly"], want["anomaly"]),
            "threshold_rel": abs(float(got["threshold"]) - float(want["threshold"]))
            / max(abs(float(want["threshold"])), 1e-30),
            # one number for both masks: the control's flips are single voxels
            # near the threshold, which the spark removal deletes, so the
            # post-processed mask alone does not tell the control apart
            "masks_mismatch": max(compare.mismatch(got["segmentation"], want["segmentation"]),
                                  compare.mismatch(got["segmentation_pp"],
                                                   want["segmentation_pp"])),
        }

    def check(self) -> dict:
        self.judged = []
        for out in self.sample():
            try:
                self.judged.append(self.artifacts(out))
            except (OSError, ValueError, KeyError):
                self.failed += 1
                return {}
        self.ref = self.reference("f32")
        return self.worst([self.numbers(got, self.ref) for got in self.judged])

    def control(self) -> dict:
        """The control put in the program's place, judged as it is."""
        self.ctl = self.reference("control")
        return self.numbers(self.ctl, self.ref)

    def look(self, control: bool = False) -> list:
        rows = [self.ctl] if control else self.judged
        return [{"threshold": float(r["threshold"]), "ref_threshold": float(self.ref["threshold"]),
                 "seg_voxels": int((r["segmentation"] > 0.5).sum()),
                 "ref_seg_voxels": int((self.ref["segmentation"] > 0.5).sum())} for r in rows]
