"""Driver of the predict cells: the port's ``predict_one_case``, one volume
after another, as ``run_predict`` drives it (closed loop).

Set-up makes the network's weights on the device from the seed, builds one
``SlidingWindowPredictor`` (whole-volume 8-flip TTA), writes a pool of
seeded FLAIRs as ``.nii.gz`` and runs one warm-up case. One unit is one
volume: read, N4, preprocessing, the sweep, resampling, spark removal, the
brain mask, four gzip writes and the preview, under a case name of its own
(the port skips a case whose artifacts exist). The pool's volumes repeat
across units: nothing in the port keeps state between cases but the
model, the kernels' geometry and N4's projection matrix, which depend on
shapes only.

The check: a sample of the window's volumes, drawn from the seed, each
run again by the plain reference (``reference/predict.py``) from the same
input. Compared: the N4 output, and the raw, 3 mm and FOV masks.
"""

from __future__ import annotations

import math
import os
import torch

from wmhbench import compare
from wmhbench.drivers import base
from wmhbench.harness import derive_seed
from wmhbench.niftiio import read_nifti, write_nifti
from wmhbench.traffic.synthetic import synthetic_flair

ARTIFACTS = {"pre": ("001_Preprocessed_Images", "%s_0000.nii.gz"),
             "raw": ("002_Segmentations/001_raw", "%s.nii.gz"),
             "post_3mm": ("002_Segmentations/002_postproc_3mm", "%s.nii.gz"),
             "post_fov": ("002_Segmentations/003_postproc_fov", "%s.nii.gz")}


def make_weights(shapes: dict, seed: int, device) -> dict:
    """LeCun-normal kernels (std sqrt(1 / fan_in); the heads' centred over
    their input channels), zero biases, unit norm scales, from one normal
    draw on ``device``; float32, the type the port
    keeps its parameters in. ``shapes``: {name: shape} of the state dict."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kernels = [n for n, s in shapes.items() if len(s) > 1]
    total = sum(math.prod(shapes[n]) for n in kernels)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) > 1:
            n = math.prod(shape)
            cin = shape[0] if name.startswith("ups.") else shape[1]
            fan_in = int(cin) * math.prod(shape[2:])
            w = (flat[at:at + n] * math.sqrt(1.0 / fan_in)).view(shape)
            if name.startswith("heads."):
                # a head's kernel centred over its input channels: the
                # activations after norm and leaky ReLU have about the same
                # mean in every channel, so an uncentred kernel would add a
                # seed-dependent offset that makes nearly every voxel one class
                w = w - w.mean(dim=1, keepdim=True)
            out[name] = w
            at += n
        elif name.endswith("norm_weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


class Driver(base.Driver):
    FAULTS = ("answer_altered",)

    def setup(self):
        from deepwmh_tpu_torch.pipeline.inference import make_output_folders, predict_one_case
        from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
        from deepwmh_tpu_torch.unet.model import UNet3D
        from deepwmh_tpu_torch.unet.plan import Plan

        self.predict_one_case = predict_one_case
        plan = Plan(**self.plan)
        model = UNet3D(plan, dtype=getattr(torch, self.cfg["compute_dtype"]))
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        weights = make_weights(shapes, derive_seed(self.seed, "weights"), self.device)
        model.load_state_dict(weights)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        self.predictor = SlidingWindowPredictor(model, plan, tta=True, device=self.device)
        if self.fault == "answer_altered":
            self._alter_answers()
        self.out = os.path.join(self.workdir, "out")
        self.folders = make_output_folders(self.out)
        shape, self.spacing = self.cfg["volume_shape"], self.cfg["spacing"]
        self.inputs, self.paths = [], []
        os.makedirs(os.path.join(self.workdir, "in"), exist_ok=True)
        for i in range(int(self.tr["pool"])):
            vol = synthetic_flair(shape, derive_seed(self.seed, "flair", i))
            path = os.path.join(self.workdir, "in", "flair%d.nii.gz" % i)
            write_nifti(path, vol, self.spacing)
            self.inputs.append(vol)
            self.paths.append(path)
        self._unit("warmup", 0)

    def _alter_answers(self):
        """The fault: one slab of every raw mask inverted where the sweep's
        threshold produces it."""
        cases = self.predictor._cases

        def altered(vols, spacing):
            out = cases(vols, spacing)
            for seg, _fg in out:
                seg[: max(seg.shape[0] // 16, 1)] ^= 1
            return out

        self.predictor._cases = altered

    def _unit(self, case: str, index: int):
        self.predict_one_case(self.predictor, case, self.paths[index], self.folders,
                              skip_bfc=not self.tr["n4"], make_previews=self.tr["previews"])

    def run(self, win):
        def unit(i):
            case, index = "case%04d" % i, i % len(self.paths)
            self._unit(case, index)
            return case, index

        self.closed_loop(win, unit)

    def release(self):
        del self.predictor
        self.predictor = None

    def reference(self, precision: str, index: int) -> dict:
        from wmhbench.reference.predict import make_model, predict_case
        from wmhbench.reference.unet import no_tf32

        no_tf32()
        model = make_model(self.plan, self.weights, self.device, precision)
        raw = torch.from_numpy(self.inputs[index]).to(self.device)
        return {k: v.cpu() for k, v in predict_case(model, self.plan, raw, self.spacing,
                                                    precision).items()}

    def artifacts(self, case: str) -> dict:
        return {k: torch.from_numpy(read_nifti(os.path.join(self.out, sub, fmt % case)))
                for k, (sub, fmt) in ARTIFACTS.items()}

    @staticmethod
    def numbers(got: dict, want: dict) -> dict:
        fg = want["fg"]
        out = {"n4_rel_max": compare.rel_max(got["pre"], want["pre"])}
        for what in ("raw", "post_3mm", "post_fov"):
            out[what + "_decisive_per_near"] = compare.decisive_per_near(got[what], want[what], fg)
        return out

    @staticmethod
    def diagnose(got: dict, want: dict) -> dict:
        """Where the raw masks differ, by the reference's margin from the
        threshold: the share of voxels within each margin, and the flips
        among them and beyond them."""
        margin = (want["fg"] - 0.5).abs()
        out = {"fg_share": float((want["raw"] > 0.5).double().mean())}
        for what in ("raw", "post_3mm", "post_fov"):
            flip = (got[what] > 0.5) != (want[what] > 0.5)
            out[what] = {"flips": int(flip.sum())}
            for d in (0.001, 0.003, 0.01, 0.03, 0.1):
                near = margin < d
                out[what]["flips_near_%g" % d] = int((flip & near).sum())
                if what == "raw":
                    out["near_%g" % d] = int(near.sum())
        return out

    def check(self) -> dict:
        self.refs, self.judged = {}, []
        for case, index in self.sample():
            try:
                got = self.artifacts(case)
            except (OSError, ValueError):
                self.failed += 1
                return {}
            if index not in self.refs:
                self.refs[index] = self.reference("f32", index)
            self.judged.append((got, index))
        return self.worst([self.numbers(got, self.refs[i]) for got, i in self.judged])

    def control(self) -> dict:
        """The control put in the program's place, judged as it is."""
        self.controls = [(self.reference("control", i), i) for i in sorted(self.refs)]
        return self.worst([self.numbers(got, self.refs[i]) for got, i in self.controls])

    def look(self, control: bool = False) -> list:
        return [self.diagnose(got, self.refs[i])
                for got, i in (self.controls if control else self.judged)]
