"""The 3-stage annotation-free self-training pipeline (the port of
``deepwmh_tpu.pipeline.multistage``):

  Stage I   NLL anomaly scoring + auto-thresholding -> noisy pseudo-labels
            (``pipeline/analysis.py``, K2 on the card)
  Stage II  label denoising: a short U-Net training (no validation split,
            a checkpoint every epoch), then the background softmax of every
            epoch of the last 10% with TTA off, inverted-background masking
            y = 1 - (m * (1 - x)), the mean over those epochs, lesion =
            field < 0.5, 3 mm spark removal
  Stage III the final model: a Dice-ranked 5% validation split (interleaved
            pick, at least one case), the final training, and the
            training-set fit with TTA, spark removal and GIF previews

Every phase is gated by the JAX package's marker checkpoints and every
artifact is loadability-probed, so the pipeline resumes at any point, also
from a folder the JAX package wrote (and the other way round).

Training runs on K1, forward and backward (``unet/train.Trainer``). The
sweeps of stages 2-4 and 3-5 run one inference model on K1
under ``torch.inference_mode``; stage 2-4 loads each ensemble epoch's
weights into it in place. Every phase that runs records its seconds (and
its peak device memory on a card) in ``stage_stats``. With ``mesh`` (a
``parallel.mesh.Mesh``) stage I runs its cases a block a shard and every
Trainer takes data-parallel steps over it; the sweeps of stages 2-4 and
3-5 stay on one device, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import (
    Checkpoints,
    atomic_write_json,
    join_path,
    load_json,
    mkdir,
)
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.eval.metrics import hard_dice_binary
from deepwmh_tpu_torch.ops.components import remove_3mm_sparks
from deepwmh_tpu_torch.pipeline.analysis import LesionAnalyzer
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet.data import SegDataset
from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
from deepwmh_tpu_torch.unet.model import UNet3D
from deepwmh_tpu_torch.unet.plan import Plan, plan_experiment
from deepwmh_tpu_torch.unet.preprocess import normalize_zscore, resample_volume
from deepwmh_tpu_torch.unet.release import release_model
from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer
from deepwmh_tpu_torch.utils.logging import SimpleTxtLog
from deepwmh_tpu_torch.utils.profiling import span

@contextlib.contextmanager
def timed_stage(stats: dict, name: str, device, log=print):
    """Record in ``stats[name]`` the seconds (and, on a card, the peak
    device memory) of a phase that runs, the device synchronised on both
    sides; the phase is also the span ``run_train.<name>``."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with span("run_train." + name):
        yield
    if cuda:
        torch.cuda.synchronize(device)
    rec = {"s": time.perf_counter() - t0}
    if cuda:
        rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    stats[name] = rec
    log("%s: %.2f s" % (name, rec["s"]))


@dataclass
class StageBudget:
    """The reference's budgets, overridable for tests and small runs."""

    stage2_epochs: int = 50
    stage3_epochs: int = 100
    batches_per_epoch: int = 150
    batch_size: int = 2
    val_fraction: float = 0.05
    voxel_budget: int = 128 * 128 * 128
    # network width overrides (None: the plan's 32 -> 320); a released
    # model records its width in plan.json
    base_features: int = None
    max_features: int = None

    @property
    def ensemble_epochs(self) -> int:
        return max(int(0.1 * self.stage2_epochs), 1)


class PipelineMultistage:
    STAGE2_TASK = "Task001_LabelDenoising"
    STAGE3_TASK = "Task002_FinalModel"

    def __init__(self, output_folder: str, intensity_prior: str = "+",
                 budget: StageBudget = None, mesh=None, device=None):
        """``device``: CUDA unless the CPU is asked for (with ``mesh``, the
        mesh's home shard's by default). ``mesh``: stage I and the
        training steps over its shards."""
        if intensity_prior not in ("+", "-", None):
            raise ValueError("intensity_prior must be '+', '-' or None")
        self.mesh = mesh
        self.device = resolve_device(mesh.home if device is None and mesh is not None else device)
        self.folder = mkdir(os.path.abspath(output_folder))
        self.intensity_prior = intensity_prior
        self.budget = budget or StageBudget()

        self.logger = SimpleTxtLog(join_path(
            self.folder, datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S") + ".txt"))
        self.stage1_folder = mkdir(join_path(self.folder, "Stage_1_initial_segmentation"))
        self.stage2_folder = mkdir(join_path(self.folder, "Stage_2_label_denoising"))
        self.stage3_folder = mkdir(join_path(self.folder, "Stage_3_DCNN_training"))
        self.dcnn_folder = mkdir(join_path(self.folder, "DCNN_Outputs"))
        self.checkpoints = Checkpoints(join_path(self.folder, "Checkpoints"))
        self.analyzer = LesionAnalyzer(self.stage1_folder, logger=self.logger,
                                       device=self.device)
        self.train_dict = {}
        self.stage_stats = {}

    def log(self, msg):
        self.logger.write(msg)
        print(msg, flush=True)

    def add_training_case(self, name, x_train, x_refs, label1, label2, description=None):
        self.train_dict[name] = {"description": description}
        self.analyzer.add_case(name, x_train, x_refs, label1, label2)

    def _stage(self, name: str):
        return timed_stage(self.stage_stats, name, self.device, self.log)

    def _release_device_memory(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    # shared helpers
    # ------------------------------------------------------------------ #

    def _task_dir(self, task: str) -> str:
        return mkdir(join_path(self.dcnn_folder, task))

    def _train_dir(self, task: str) -> str:
        return mkdir(join_path(self._task_dir(task), "training"))

    def _case_paths(self, case: str) -> dict:
        d = join_path(self.stage1_folder, case)
        return {
            "image": join_path(d, "preprocessed_image.nii.gz"),
            "seg": join_path(d, "segmentation.nii.gz"),
            "seg_pp": join_path(d, "segmentation_pp.nii.gz"),
            "valid_mask": join_path(d, "valid_mask.nii.gz"),
            "normalized": join_path(d, "normalized_input.nii.gz"),
        }

    def _plan_from(self, task: str, images) -> Plan:
        """The task's plan.json, planned from ``images``' geometry on first
        use."""
        plan_path = join_path(self._task_dir(task), "plan.json")
        if os.path.isfile(plan_path):
            return Plan.load(plan_path)
        shapes = [list(nifti.get_nifti_header(p).shape) for p in images]
        spacings = [nifti.get_nifti_pixdim(p) for p in images]
        plan = plan_experiment(shapes, spacings, voxel_budget=self.budget.voxel_budget,
                               batch_size=self.budget.batch_size)
        if self.budget.base_features is not None:
            plan.base_features = int(self.budget.base_features)
        if self.budget.max_features is not None:
            plan.max_features = int(self.budget.max_features)
        plan.save(plan_path)
        return plan

    def _make_plan(self, task: str, cases) -> Plan:
        return self._plan_from(task, [self._case_paths(c)["image"] for c in cases])

    def _preprocessed(self, img, lbl, spacing, plan: Plan):
        """(image resampled linearly and z-scored, label resampled nearest)
        at the plan's spacing, as numpy."""
        dev = self.device
        img_r = resample_volume(torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev),
                                spacing, plan.target_spacing, 1)
        lbl_r = resample_volume(torch.from_numpy(np.ascontiguousarray(lbl, np.float32)).to(dev),
                                spacing, plan.target_spacing, 0)
        return normalize_zscore(img_r).cpu().numpy(), lbl_r.cpu().numpy()

    def _build_dataset(self, case_labels: dict, plan: Plan) -> SegDataset:
        """case_labels: {case: (label_path, mask_path or None)}."""
        ds = SegDataset(plan.patch_size)
        for case, (label_path, mask_path) in case_labels.items():
            img_path = self._case_paths(case)["image"]
            img = nifti.load_nifti_simple(img_path)
            spacing = nifti.get_nifti_pixdim(img_path)
            lbl = (nifti.load_nifti_simple(label_path) > 0.5).astype(np.float32)
            if mask_path is not None:
                lbl = lbl * (nifti.load_nifti_simple(mask_path) > 0.5)
            ds.add_case(case, *self._preprocessed(img, lbl, spacing, plan))
        return ds

    def _trainer(self, task: str, epochs: int, noval: bool, save_every_epoch: bool,
                 plan: Plan) -> Trainer:
        cfg = TrainConfig(
            epochs=epochs,
            batches_per_epoch=self.budget.batches_per_epoch,
            batch_size=self.budget.batch_size,
            noval=noval,
            save_every_epoch=save_every_epoch,
        )
        return Trainer(plan, cfg, self._train_dir(task), device=self.device, logger=self.logger,
                       mesh=self.mesh)

    def _load_state(self, task: str, checkpoint_name: str) -> dict:
        """A checkpoint of the task's training folder (either package's) as
        a UNet3D state_dict."""
        return ckpt.params_from_flax(ckpt.load_flax_params(self._train_dir(task),
                                                           checkpoint_name))

    def _predictor_for(self, task: str, plan: Plan, checkpoint_name: str, tta: bool):
        """An inference predictor (K1 on every block) holding ``checkpoint_name``."""
        model = UNet3D(plan)
        model.load_state_dict(self._load_state(task, checkpoint_name), strict=True)
        return SlidingWindowPredictor(model, plan, tta=tta, device=self.device)

    def _remove_sparks(self, mask, spacing) -> np.ndarray:
        m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(self.device)
        return remove_3mm_sparks(m, spacing).cpu().numpy()

    # ------------------------------------------------------------------ #
    # stages
    # ------------------------------------------------------------------ #

    def _do_initial_segmentation(self):
        self.log("== Stage I: initial segmentation ==")
        if not self.checkpoints.is_finished("STAGE_1_INITIAL_SEGMENTATION"):
            with self._stage("stage1"):
                self.analyzer.analyze_and_do_segmentation(
                    intensity_prior=self.intensity_prior, do_postprocessing=True,
                    mesh=None if self.mesh is None else self.mesh.local())
            self.checkpoints.set_finish("STAGE_1_INITIAL_SEGMENTATION")
        self.log("stage 1 complete.")

    def _ensemble_epochs(self):
        B = self.budget
        return range(B.stage2_epochs - B.ensemble_epochs + 1, B.stage2_epochs + 1)

    def _raw_softmax(self, cases, plan: Plan, raw_softmax: str):
        """2-4: the background softmax of every ensemble epoch's checkpoint,
        TTA off. One inference model; each epoch's weights are loaded into
        it in place."""
        predictor = None
        for epoch in self._ensemble_epochs():
            epoch_dir = mkdir(join_path(raw_softmax, "epoch_%04d" % epoch))
            todo = [c for c in cases
                    if not nifti.try_load_nifti(join_path(epoch_dir, "%s_0.nii.gz" % c))]
            if not todo:
                continue
            self.log("softmax for epoch %d (%d case(s))" % (epoch, len(todo)))
            name = ckpt.MODEL_EPOCH_FMT % epoch
            if predictor is None:
                predictor = self._predictor_for(self.STAGE2_TASK, plan, name, tta=False)
            else:
                predictor.model.load_state_dict(self._load_state(self.STAGE2_TASK, name),
                                                strict=True)
            for c in todo:
                img_path = self._case_paths(c)["image"]
                img, hdr = nifti.load_nifti(img_path)
                _, fg = predictor.predict_case(img, nifti.get_nifti_pixdim(img_path))
                bg = 1.0 - fg.cpu().numpy()  # only the background is stored
                nifti.save_nifti(bg, hdr, join_path(epoch_dir, "%s_0.nii.gz" % c))

    def _do_label_denoising(self):
        self.log("== Stage II: label denoising ==")
        B = self.budget
        cases = list(self.train_dict.keys())
        plan = self._make_plan(self.STAGE2_TASK, cases)

        # 2-1/2-2: training data from the stage-1 pseudo-labels (masked)
        if not self.checkpoints.is_finished("STAGE_2-3_TRAINING_DENOISER"):
            labels = {c: (self._case_paths(c)["seg_pp"], self._case_paths(c)["valid_mask"])
                      for c in cases}
            with self._stage("2-2_dataset"):
                ds = self._build_dataset(labels, plan)
            trainer = self._trainer(self.STAGE2_TASK, B.stage2_epochs, noval=True,
                                    save_every_epoch=True, plan=plan)
            with self._stage("2-3_training"):
                trainer.fit(ds, resume=True)
            # the trainer's weights, momentum and cached blocks go before the sweep
            del trainer, ds
            self._release_device_memory()
            self.checkpoints.set_finish("STAGE_2-3_TRAINING_DENOISER")

        # 2-4: per-epoch background softmax over the ensemble window
        raw_softmax = mkdir(join_path(self.stage2_folder, "003_raw_softmax"))
        if not self.checkpoints.is_finished("STAGE_2-4_RAW_SOFTMAX"):
            with self._stage("2-4_raw_softmax"):
                self._raw_softmax(cases, plan, raw_softmax)
            self._release_device_memory()
            self.checkpoints.set_finish("STAGE_2-4_RAW_SOFTMAX")

        # 2-5: inverted-background masking y = 1 - (m * (1 - x))
        masked_softmax = mkdir(join_path(self.stage2_folder, "004_masked_softmax"))
        if not self.checkpoints.is_finished("STAGE_2-5_MASKED_SOFTMAX"):
            with self._stage("2-5_masked_softmax"):
                for epoch in self._ensemble_epochs():
                    in_dir = join_path(raw_softmax, "epoch_%04d" % epoch)
                    out_dir = mkdir(join_path(masked_softmax, "epoch_%04d" % epoch))
                    for c in cases:
                        out_path = join_path(out_dir, "%s_0.nii.gz" % c)
                        if nifti.try_load_nifti(out_path):
                            continue
                        x, hdr = nifti.load_nifti(join_path(in_dir, "%s_0.nii.gz" % c))
                        m = nifti.load_nifti_simple(self._case_paths(c)["valid_mask"])
                        nifti.save_nifti(1 - (m * (1 - x)), hdr, out_path)
            self.checkpoints.set_finish("STAGE_2-5_MASKED_SOFTMAX")

        # 2-6: the mean over the ensemble epochs -> refined labels
        refined = mkdir(join_path(self.stage2_folder, "005_refined_label"))
        if not self.checkpoints.is_finished("STAGE_2-6_ENSEMBLING"):
            with self._stage("2-6_ensembling"):
                for c in cases:
                    case_dir = mkdir(join_path(refined, c))
                    out_field = join_path(case_dir, "softmax_ensembled.nii.gz")
                    out_seg = join_path(case_dir, "label_ensembled.nii.gz")
                    if nifti.try_load_nifti(out_field) and nifti.try_load_nifti(out_seg):
                        continue
                    fields = [nifti.load_nifti_simple(join_path(
                        masked_softmax, "epoch_%04d" % epoch, "%s_0.nii.gz" % c))
                        for epoch in self._ensemble_epochs()]
                    field = np.mean(np.stack(fields), axis=0)
                    img_path = self._case_paths(c)["image"]
                    phys = nifti.get_nifti_pixdim(img_path)
                    lesion = self._remove_sparks((field < 0.5).astype(np.float32), phys)
                    hdr = nifti.get_nifti_header(img_path)
                    nifti.save_nifti(field, hdr, out_field)
                    nifti.save_nifti(lesion, hdr, out_seg)
            self.checkpoints.set_finish("STAGE_2-6_ENSEMBLING")
        self.log("stage 2 complete.")

    def _refined_label_path(self, case: str) -> str:
        return join_path(self.stage2_folder, "005_refined_label", case, "label_ensembled.nii.gz")

    def _split(self, cases):
        """3-1: rank the cases by the Dice of their stage-1 and refined
        labels (a stable descending sort) and pick every other case of the
        top of the ranking for validation until max(int(n * val_fraction),
        1) are taken."""
        pairs = []
        for c in cases:
            d = hard_dice_binary(nifti.load_nifti_simple(self._case_paths(c)["seg_pp"]),
                                 nifti.load_nifti_simple(self._refined_label_path(c)))
            pairs.append((c, float(d)))
        pairs.sort(key=lambda x: x[1], reverse=True)
        val_target = max(int(len(cases) * self.budget.val_fraction), 1)
        train_cases, val_cases = [], []
        for i, (c, _) in enumerate(pairs):
            if len(val_cases) < val_target:
                (train_cases if i % 2 == 0 else val_cases).append(c)
            else:
                train_cases.append(c)
        return train_cases, val_cases

    def _preview(self, case: str, seg_path: str, gif_path: str):
        """Best-effort GIF preview: a rendering error (or a host without
        PIL) never fails the stage."""
        from deepwmh_tpu_torch.eval.preview import nii_as_gif, nii_slice_range, try_load_gif

        try:
            if not try_load_gif(gif_path):
                img = nifti.load_nifti_simple(self._case_paths(case)["normalized"])
                seg = nifti.load_nifti_simple(seg_path)
                s0, s1 = nii_slice_range(img, axis="axial")
                nii_as_gif(img, gif_path, axis="axial", lesion_mask=seg, side_by_side=True,
                           slice_range=(s0, s1))
        except Exception as e:
            self.log("warning: preview rendering failed for %s: %r" % (case, e))

    def _do_DCNN_training(self):
        self.log("== Stage III: final model training ==")
        B = self.budget
        cases = list(self.train_dict.keys())
        partition_folder = mkdir(join_path(self.stage3_folder, "001_data_partitions"))
        train_fit_folder = mkdir(join_path(self.stage3_folder, "002_training_fit"))
        preview_folder = mkdir(join_path(self.stage3_folder, "003_final_preview"))

        # 3-1: the Dice-ranked split
        split_path = join_path(partition_folder, "split.json")
        if not self.checkpoints.is_finished("STAGE_3-1_DATA_SPLIT"):
            train_cases, val_cases = self._split(cases)
            atomic_write_json({"train": train_cases, "val": val_cases}, split_path)
            self.log("train=%d val=%d (%s)" % (len(train_cases), len(val_cases), val_cases))
            self.checkpoints.set_finish("STAGE_3-1_DATA_SPLIT")
        split = load_json(split_path)
        train_cases, val_cases = split["train"], split["val"]

        # 3-2/3-3: data preparation and the plan
        plan = self._make_plan(self.STAGE3_TASK, cases)

        # 3-4: the final training with the chosen validation cases
        if not self.checkpoints.is_finished("STAGE_3-4_TRAINING"):
            labels = {c: (self._refined_label_path(c), self._case_paths(c)["valid_mask"])
                      for c in cases}
            with self._stage("3-3_dataset"):
                train_ds = self._build_dataset({c: labels[c] for c in train_cases}, plan)
                val_ds = self._build_dataset({c: labels[c] for c in val_cases}, plan)
            trainer = self._trainer(self.STAGE3_TASK, B.stage3_epochs, noval=False,
                                    save_every_epoch=False, plan=plan)
            with self._stage("3-4_training"):
                trainer.fit(train_ds, val_ds, resume=True)
            del trainer, train_ds, val_ds
            self._release_device_memory()
            self.checkpoints.set_finish("STAGE_3-4_TRAINING")

        # 3-5: the training-set fit, spark removal and previews
        if not self.checkpoints.is_finished("STAGE_3-5_FINAL_FIT"):
            with self._stage("3-5_final_fit"):
                predictor = self._predictor_for(self.STAGE3_TASK, plan, ckpt.MODEL_BEST,
                                                tta=True)
                post_dir = mkdir(join_path(train_fit_folder, "3mm_postproc"))
                for c in cases:
                    raw_path = join_path(train_fit_folder, "%s.nii.gz" % c)
                    if not nifti.try_load_nifti(raw_path):
                        img_path = self._case_paths(c)["image"]
                        img, hdr = nifti.load_nifti(img_path)
                        seg, _ = predictor.predict_case(img, nifti.get_nifti_pixdim(img_path))
                        nifti.save_nifti(seg.cpu().numpy(), hdr, raw_path)
                    out_path = join_path(post_dir, "%s.nii.gz" % c)
                    if not nifti.try_load_nifti(out_path):
                        seg, hdr = nifti.load_nifti(raw_path)
                        m = nifti.load_nifti_simple(self._case_paths(c)["valid_mask"])
                        phys = nifti.get_nifti_pixdim(self._case_paths(c)["image"])
                        nifti.save_nifti(self._remove_sparks(seg * m, phys), hdr, out_path)
                    self._preview(c, out_path,
                                  join_path(preview_folder, "%s_image+seg.gif" % c))
                del predictor
            self._release_device_memory()
            self.checkpoints.set_finish("STAGE_3-5_FINAL_FIT")

        self.checkpoints.set_finish("PIPELINE_TRAINING_COMPLETE")
        self.log("stage 3 complete.")

    # ------------------------------------------------------------------ #

    def run_training(self, run_stages: str = "full"):
        if run_stages not in ("initseg", "denoise", "full"):
            raise ValueError("run_stages must be initseg, denoise or full")
        self._do_initial_segmentation()
        if run_stages in ("denoise", "full"):
            self._do_label_denoising()
        if run_stages == "full":
            self._do_DCNN_training()
            self.log("training complete.")

    def release_model(self, output_folder: str):
        """Package the stage-3 model into ``output_folder``; returns the
        tarball (None when the pipeline is not fully trained)."""
        if not (self.checkpoints.is_finished("PIPELINE_TRAINING_COMPLETE")
                or self.checkpoints.is_finished("MIXED_COHORT_3_MODEL_TRAINING")):
            self.log("Pipeline is not fully trained; cannot release.")
            return None
        plan = Plan.load(join_path(self._task_dir(self.STAGE3_TASK), "plan.json"))
        with self._stage("release"):
            tarball = release_model(self._train_dir(self.STAGE3_TASK), plan, output_folder)
        self.log("released model: %s" % tarball)
        return tarball

    def mixed_cohort_training(self, data_dict, val_cases, add_noise=True,
                              model_release_folder=None):
        """Train the final model directly on multi-cohort (image, label)
        pairs: data_dict {case: (image path, label path)}."""
        for v in val_cases:
            if v not in data_dict:
                raise ValueError("val case %r not in data_dict" % v)
        cases = list(data_dict.keys())
        plan = self._plan_from(self.STAGE3_TASK, [data_dict[c][0] for c in cases])

        if not self.checkpoints.is_finished("MIXED_COHORT_3_MODEL_TRAINING"):
            train_ds = SegDataset(plan.patch_size)
            val_ds = SegDataset(plan.patch_size)
            rng = np.random.RandomState(0)
            for c in cases:
                img_path, lbl_path = data_dict[c][0], data_dict[c][1]
                img = nifti.load_nifti_simple(img_path)
                spacing = nifti.get_nifti_pixdim(img_path)
                lbl = (nifti.load_nifti_simple(lbl_path) > 0.5).astype(np.float32)
                if add_noise:  # the reference's noise=0.1 augmentation, host RNG
                    q5, q95 = np.percentile(img, 5), np.percentile(img, 95)
                    img = img + rng.normal(scale=0.1 * (q95 - q5), size=img.shape)
                (val_ds if c in val_cases else train_ds).add_case(
                    c, *self._preprocessed(img, lbl, spacing, plan))
            trainer = self._trainer(self.STAGE3_TASK, self.budget.stage3_epochs, noval=False,
                                    save_every_epoch=False, plan=plan)
            trainer.fit(train_ds, val_ds, resume=True)
            self.checkpoints.set_finish("MIXED_COHORT_3_MODEL_TRAINING")

        if model_release_folder is not None:
            self.release_model(model_release_folder)
