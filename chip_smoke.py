"""Smoke run of the PyTorch/CUDA port (deepwmh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines to stdout:

1. device: the card's name and power limit (``nvidia-smi``), and the build
   of every CUDA kernel of the port from ``deepwmh_tpu_torch/csrc``, with
   registers and spills;
2. k1: K1's two kernels at every [N, M, C] the flagship forward gives them:
   the statistics kernel against its plain PyTorch version (and the same
   bits on a second call) with its back-to-back, device-only (profiler) and
   host-per-call times beside ``torch.var_mean``'s (the two measured in
   turns, medians of five) and the memory bound;
   the apply kernel (normalize + affine + leaky ReLU) bit for bit against
   the plain chain, with both times and its memory bound; then both kernels
   at one narrow width per dtype (fault B0: [1, M, 4] bf16, [1, M, 2] f32
   at the flagship M) checked the same way and timed beside the wide width
   of the same M, K1's backward at every [2, M, C] of the flagship train
   step (its two kernels against their plain versions, the same bits twice;
   back-to-back and device ms beside the 6-byte bound, the design's 10
   bytes and the plain chain's autograd backward), and the 8-flip
   flagship sweep with K1 on against the
   plain norm chain (``experiments/studies/fused_stats_study.measure``);
3. main_path: ``DeepWMH_predict`` through ``run_predict`` at the flagship plan
   (192x224x192 1 mm FLAIR, 8-flip whole-volume TTA, random weights from a
   seed) on two cases, with the kernels' launch counts from that run (and
   the NIfTI gzip through the native zlib, none in Python), then a
   per-stage timing of the same pipeline, a profile of one TTA sweep and a
   volume's gzip read and writes, native against Python's gzip (the same
   bytes);
4. card_vs_cpu: the card (kernel path, f32, no TF32) against the CPU (plain
   path) on a small plan, whole-volume and patch sweeps;
5. k2: the 3x3x3 median kernel against its plain version (value equality)
   at the flagship stage-1 call, an odd shape and 1x1x1, with the kernel's,
   the plain version's and an unfold + torch.median route's times beside
   its bound and its min/max per output (counted and from the SASS);
6. stage1: stage-1 NLL lesion analysis through ``LesionAnalyzer`` at
   192x224x192 1 mm with K = 10 synthetic registered references (one
   case), K2's launches from that run, the artifacts checked against the
   planted lesions, then the host I/O and analysis of one case;
7. postproc_exact: spark removal and the brain mask on the card equal to the
   CPU's at 192x224x192;
8. stage1_card_vs_cpu: the stage-1 core on the card against the CPU at
   96x112x96, 2 mm, K = 4;
9. serve: ``python -m deepwmh_tpu_torch.cli.serve --once`` in a subprocess
   over a spool of two flagship FLAIRs and a corrupt request (exit 1, the
   receipts, the quarantine, the artifacts), then in-process a burst of two
   (``SpoolServer(batch_max=2)``) against the same two served one by one:
   receipts, mask agreement, walls, K1 launches per volume, peak memory;
10. train: ``Trainer.fit`` at the flagship plan (patch 128x160x128, batch 2,
   augmentation on) on three synthetic preprocessed cases with planted
   lesions, two epochs of six steps with a one-case validation set: finite
   losses, the four checkpoints read back, a second fit that resumes at the
   end, ``release_model`` served by the port's predictor on the card, K1's
   launches (forward and backward a block a step, remat's recompute, the
   validation forwards); then seconds per step, peak memory with and
   without remat and one step's device time by section and kernel group;
11. train_card_vs_cpu: one Trainer step from the same weights and batch on
   the card (K1 forward and backward) and on the CPU (their plain
   versions; small plan, f32, no TF32, no augmentation);
12. k1_learned (run right after k1): K1's two kernels at every [1, M, C]
   of the learned registration network on the 2 mm template grid of the
   flagship cohort (96x112x96; C = 8, 16, 32, 32), checked as in k1;
13. group_register: ``python -m deepwmh_tpu_torch.cli.group_register`` with
   the training-prep preset in a subprocess on a 2x1 cohort at
   192x224x192 (two synthetic atlases; one target, the first atlas warped
   by a seeded diffeomorphism and a small affine, labels alike): the
   artifacts and affine.json read back, LNCC up, propagated brain Dice
   above the floor and above the unregistered one, a re-run skipping both
   pairs;
   then one pair stage by stage (affine, SVF, final resample, writes, peak
   memory), launches, device time and busy share per Adam step at every
   pyramid level, and the plain-torch hot loops' times;
14. warm: ``--svf-warm-start`` on a copy of that output without the second
   source's pair (the auxiliary pair and one warm pair), the same checks;
15. learned: ``LearnedGroupRegistration`` at full width on the same cohort,
   training cut to 30 of 300 steps: K1's launches from its forward passes
   (this run only), the same checks, seconds per template volume, per step
   and per pair;
16. priors: the priors CLI (its synthetic atlas, --quick) on one subject;
17. reg_card_vs_cpu: one pair at 48x56x48, short schedule, on the card (no
   TF32) against the CPU within the one-pair bars, and the field gather;
   then fault C6: the pair uploaded in C, Fortran and C order again on the
   card, the same bits every time;
18. train_e2e: ``DeepWMH_train`` through ``run_train`` on a phantom cohort
   (``eval/phantom.write_cohort``) at 64x80x64 2 mm, 3 references x 2
   patients (6 svf pairs, auto asserted to resolve to svf), the production
   plan (patch 64x80x64, batch 2, widths 32 -> 320) cut to 4 / 6 epochs of
   10 steps: K1's and K2's launches from that run, the nine markers, the
   registration artifacts and run_registration.sh, stage-1 recall and Dice
   against the planted lesions, the release installed and a held-out
   patient predicted through the two CLIs, a second run through the train
   CLI (a subprocess) that trains nothing within 60 s; the installed
   release in this process gives the CLI's held-out masks, a foreground
   probability that is not constant, and stage 3-5's training fit;
   seconds per stage (run_train's ``stage_stats``), peak memory, the
   held-out Dice; then N4's repeatability (fault C3): the differing bits
   of two N4 runs on a cohort FLAIR and of a rerun on the flagship FLAIR,
   and the differing voxels of the stage-1 and predict masks they give,
   beside the same readings with N4's histogram summed in f32 (the
   control);
19. convert_evaluate: a user moving from the reference. A Generic_UNet
   replica at the flagship plan's widths (``tests/torch_port_nnunet.py``,
   seeded weights) saved in the reference's install layout and converted
   by ``python -m deepwmh_tpu_torch.cli.convert_torch`` (discovery
   included); the converted model on the card against the replica on one
   128x160x128 patch (f32 logits within atol 2e-4 / rtol 1e-3 with TF32
   off, bf16 argmax agreement > 0.98, K1's launches counted by the wrappers
   and seen by the profiler); the predict CLI on one flagship FLAIR with
   TTA (seconds, K1's launches); the evaluate CLI over that mask and two
   synthetic pairs of >= 200 lesions at 192x224x192 with all five metrics,
   on the card and with ``--device cpu``: equal reports, equal to a scipy
   reference (``scipy.ndimage.label``, 6-connectivity), seconds a case and
   ``label_components`` rounds a mask; a rating workbook written and read
   back, the score histogram PDF, and the boxplot and lightbox where
   matplotlib / PIL are installed (a line says which were drawn);
20. dicom_predict: a scanner export through the port alone. The flagship
   FLAIR quantized to uint16, written as a uint16 NIfTI and as a 192-slice
   JPEG Lossless SV1 series (``tests/torch_port_dicom.py``'s writer, in a
   pool of processes while the predict CLI runs on the NIfTI); the
   dcm2niix CLI gives the source integers exactly and the sform within
   1e-5 mm, with one native Huffman pass a slice and none in Python; the
   predict CLI on the converted NIfTI (seconds, K1's launches) gives the
   NIfTI input's N4 output, masks and foreground probability bit for bit;
   then a 16-slice 224x192 series in each other syntax (explicit / implicit
   VR LE, explicit BE, Deflated, RLE, JPEG Baseline 8-bit and Extended
   12-bit, Lossless P14 predictor 7, JPEG-LS lossless and near 2, an
   enhanced multi-frame JPEG Lossless file) through the CLI, checked
   against its source (or, for DCT, the decode of its own streams), with
   seconds a series and a slice, and each native route (Huffman pass,
   predictor-7 reconstruction, JPEG-LS scan) against its Python version on
   four slices with both times;
21. oasis3_prep: the OASIS-3 recipe's ``prepare_reference_case`` for one
   reference subject at 192x224x192 (that FLAIR, a T1w contrast remap of it
   under a small known affine, the first atlas of ``registration_cohort``):
   label1's brain Dice above the floor, label2 holding classes 1-3; then
   ``evaluate_training_fit`` on three flagship cases (the dicom_predict
   mask and two synthetic predictions, two synthetic raters each) on the
   card and on the CPU: the same CSV;
22. k1_train: K1's two kernels at every [1, M, C] of the train path's
   sweeps (the stage-2 plan at 64x80x64), checked and timed as in k1;
23. kernels: one line listing each kernel with its launches on its path
   (K1's statistics and apply kernels on the predict path and, as
   ``learned_launches`` / ``train_launches`` / ``convert_launches`` /
   ``dicom_launches`` / ``mesh_launches`` / ``mesh_train_launches``, on the
   learned registration, on the train path, on the converted model's
   predict CLI run, on the predict CLI run on the converted DICOM series,
   on the 8-shard mesh's predict_case_full and on run_train over the
   2-shard mesh; K1's backward over phase train's six steps and on the
   train path; K2 on the stage-1 path, the train path, the halo-sharded
   median and run_train over the mesh), after a line of the policy's
   readings at the flagship shape;
24. mesh (run right after serve): the device mesh's inference side on an
   8-shard mesh whose shards all name this card (every exchange through
   the mesh's collectives): ``predict_case_full`` on the main path's FLAIR
   with the 8 flips one a shard against the unsharded predictor (masks and
   N4 output equal, fg within 1e-6, K1 176 / 176, seconds, peak memory);
   the patch mode's sharded sweep against the unsharded one (fg within
   1e-5, masks > 99.9%); ``HaloShardedOps``' median (K2 once a slab, 0
   differing voxels against K2 on the whole volume), z-score, and N4 (rel
   < 1e-3 in the brain against unsharded N4, the same bits twice); the
   predict CLI with ``--mesh`` against ``-g 0`` (four artifacts equal);
   ``cli.serve --mesh --once`` on two requests; stage-1 over the mesh (two
   cases) equal to the one-by-one run;
25. mesh_train (run after reg_card_vs_cpu): the device mesh's training side
   on a 2-shard mesh whose shards both name this card. The flagship
   ``Trainer`` (patch 128x160x128, batch 2, one sample a shard, bf16) for
   three steps in turns with an unsharded one from the same weights,
   batches and seeds: the augmented batches equal, the replicas the same
   bits after every step, the losses, the first step's gradient cosine and
   norm ratio, seconds a step, peak memory; then one f32 step (no TF32):
   loss rtol 1e-5, gradient cosine > 0.9999. ``LearnedRegistration.train``
   over the mesh at the flagship template grid (96x112x96, batch_pairs 1 ->
   2, 10 steps) beside unsharded batch 2, its first step's loss and
   gradient against the unsharded one at JAX's bars. ``register_pairs_mesh``
   on group_register's two flagship pairs (iterations cut) bit-equal to
   ``_pair_core`` one by one. ``run_train`` over the mesh on a 2 x 2
   phantom cohort at 64x80x64 (quick registration, 1 / 1 epoch x 2 steps):
   K1's and K2's launches, the nine markers, the release installed; then a
   resume through the train CLI with ``--mesh`` that trains nothing;
26. surface (run right after convert_evaluate): the last of the JAX
   package's public surface. The main path's FLAIR saved in LPS and read
   with ``load_nifti(force_RAS=True)`` equal to the RAS array;
   ``resample_nifti`` to 1.5 mm and back (seconds, shapes, sform scales,
   the head's Dice and mean); ``native.label_components_host`` against the
   card's ``label_components`` on convert_evaluate's three truth masks
   (the same ids; host ms against card ms, the card's rounds).

``python3 chip_smoke.py --e2e-dice`` builds the kernels and then, instead
of the phases, runs ``eval/e2e.run_e2e_accuracy`` at the e2e accuracy
configuration (64x80x64 2 mm, 5 references, 3 patients, 2 held-out
patients, ``default_e2e_budget()``) for seeds 0, 1 and 2, each with the
svf and with the learned registration forced, ``--repeats`` (1) times:
one line per run (held-out and stage-1 Dice, wall, seconds per
registration pair), then the means, the run-to-run ranges, the svf -
learned gap a seed and the policy readings at that shape.
``python3 chip_smoke.py --crossover svf|learned`` builds the kernels and
then, instead of the phases, runs the crossover study
(``experiments/studies/crossover_e2e_study.py``: 12 references x 14
patients, 168 pairs, that mode forced, seed 0) and prints its held-out
Dice (fault C1's rule: svf at or above learned at 168 pairs).
``python3 chip_smoke.py --convert-evaluate`` builds the kernels and runs
only the convert_evaluate and surface phases; ``python3 chip_smoke.py --dicom`` builds
them and runs only dicom_predict and oasis3_prep; ``python3 chip_smoke.py
--mesh`` builds them and runs only mesh and mesh_train; ``python3
chip_smoke.py --k1`` builds them and runs only k1 and train.

The last line of stdout is ``{"ok": true, "device": {...}}``. A failed phase
raises, and the script exits non-zero before printing it; so it does with no
CUDA device, or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM, NVIDIA's data sheet: HBM rate and the f32 rate outside the
# tensor cores (FMA-counted; the statistics kernel does f32 adds and FMAs,
# the median's min/max run at half of it)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores

FLAGSHIP_SHAPE = (192, 224, 192)
FLAGSHIP_SPACING = (1.0, 1.0, 1.0)
TIMED_ITERS = 20
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def synthetic_flair(shape, seed):
    """A head-shaped FLAIR-like volume: textured ellipsoid on a dim
    background (the style of bench.py's synthetic input)."""
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    r = np.sqrt(sum(a**2 for a in g))
    head = (r < 0.85).astype(np.float32)
    tex = rng.rand(*shape).astype(np.float32)
    return head * (400 + 150 * tex) + 30 * rng.rand(*shape).astype(np.float32)


LESION_CENTERS = ((0.3, 0.2, 0.3), (-0.35, -0.1, 0.2), (0.0, 0.4, -0.1),
                  (0.15, -0.2, -0.6))  # the last lies in the class-2 region
LESION_RADIUS = 0.1


def synthetic_cohort(shape, K, seed):
    """A registered stage-1 cohort from a numpy seed, in normalised [-1, 1]
    coordinates per axis (axis 2 runs inferior to superior):

    - an ellipsoidal brain with a smooth intensity gradient and dark central
      ventricles; references are the brain plus Gaussian noise;
    - label1 brain masks whose radius differs a little per reference, so the
      majority vote is not trivial;
    - label2 tissue maps: 0 outside, 1 cerebrum, 2 an inferior
      cerebellum/brainstem region, 3 the ventricles, each boundary moved a
      little per reference;
    - a target with four bright spherical lesions, one inside class 2.

    Returns (target [D,H,W], refs, label1s, label2s [K,D,H,W], lesions), f32.
    """
    rng = np.random.default_rng(seed)
    a, b, c = (np.linspace(-1, 1, s, dtype=np.float32).reshape(
        [-1 if i == ax else 1 for i in range(3)]) for ax, s in enumerate(shape))
    r = np.sqrt((a / 0.8) ** 2 + (b / 0.85) ** 2 + (c / 0.8) ** 2)
    vent = (a / 0.25) ** 2 + (b / 0.35) ** 2 + ((c - 0.1) / 0.25) ** 2
    brain = r < 1.0
    base = np.where(vent < 1.0, 90.0, 200.0 + 40.0 * np.cos(3.0 * c) + 20.0 * a)
    base = (base * brain).astype(np.float32)

    def noisy():
        return base + 8.0 * rng.standard_normal(shape, dtype=np.float32) * brain

    refs = np.empty((K,) + tuple(shape), np.float32)
    l1 = np.empty_like(refs)
    l2 = np.empty_like(refs)
    for k in range(K):
        refs[k] = noisy()
        brain_k = r < 1.0 + 0.02 * rng.standard_normal()
        l1[k] = brain_k
        cb_k = brain_k & (c < -0.45 + 0.03 * rng.standard_normal()) & (np.abs(a) < 0.6)
        l2[k] = np.where(brain_k & (vent < 1.0 + 0.05 * rng.standard_normal()), 3.0,
                         np.where(cb_k, 2.0, brain_k.astype(np.float32)))
    lesions = np.zeros(shape, bool)
    for ca, cb, cc in LESION_CENTERS:
        lesions |= (a - ca) ** 2 + (b - cb) ** 2 + (c - cc) ** 2 < LESION_RADIUS ** 2
    lesions = (lesions & brain).astype(np.float32)
    return noisy() + 150.0 * lesions, refs, l1, l2, lesions


def write_cohort(folder, shape, spacing, K, seed, suffix=".nii"):
    """``synthetic_cohort`` written as NIfTI files (uncompressed unless
    ``suffix`` is ".nii.gz"). Returns (target path, ref paths, label1
    paths, label2 paths, lesions)."""
    from deepwmh_tpu_torch.core import nifti

    target, refs, l1, l2, lesions = synthetic_cohort(shape, K, seed)
    hdr = nifti.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms(spacing)
    os.makedirs(folder, exist_ok=True)
    tpath = os.path.join(folder, "target" + suffix)
    nifti.save_nifti(target, hdr, tpath)
    paths = {}
    for name, stack in (("ref", refs), ("label1", l1), ("label2", l2)):
        paths[name] = []
        for k in range(K):
            paths[name].append(os.path.join(folder, "%s%02d%s" % (name, k, suffix)))
            nifti.save_nifti(stack[k], hdr, paths[name][-1])
    return tpath, paths["ref"], paths["label1"], paths["label2"], lesions


def cuda_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean device time of fn() in ms over ``iters`` back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stats_shapes(plan, vol_shape):
    """Every (spatial shape, C, calls per forward) the U-Net hands K1 on a
    whole-volume forward of ``vol_shape``: two blocks per encoder stage, two
    more per decoder stage."""
    from deepwmh_tpu_torch.unet.infer import fullvol_shape
    from deepwmh_tpu_torch.unet.plan import features_per_stage

    feats = features_per_stage(plan)
    shape = list(fullvol_shape(vol_shape, plan))
    out = []
    for i in range(plan.num_pools + 1):
        if i:
            shape = [s // int(k) for s, k in zip(shape, plan.pool_kernels[i - 1])]
        out.append((tuple(shape), feats[i], 2 if i == plan.num_pools else 4))
    return out


def phase_device(kernels):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # every kernel of the port
    sources = sorted({k.source for k in kernels.KERNELS.values()})
    t0 = time.perf_counter()
    libs = kernels.build(sources)
    build_s = time.perf_counter() - t0
    for k in kernels.KERNELS.values():
        k.lib()
    # registers and spills per kernel, from the -Xptxas -v log of the build
    ptxas = {}
    for src, lib in libs.items():
        log = ""
        log_path = os.path.splitext(lib)[0] + ".log"
        if os.path.isfile(log_path):  # absent when the library was built earlier
            with open(log_path) as f:
                log = f.read()
        ptxas[src] = {"registers": [int(n) for n in re.findall(r"Used (\d+) registers", log)],
                      "spill_store_bytes": [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]}
    emit({"phase": "device", "nvidia_smi": smi, "sources": sources,
          "libraries": [os.path.relpath(p, HERE) for p in libs.values()],
          "build_s": build_s, "ptxas": ptxas})
    return smi


def sass_count(library: str, opcode: str):
    """How many ``opcode`` instructions the built library's SASS holds
    (``cuobjdump -sass``); None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return len(re.findall(r"\b%s\b" % opcode, sass))


def device_ms(fn, iters: int = TIMED_ITERS):
    """Device time of fn() in ms per call: the summed duration of the CUDA
    kernels torch.profiler records over ``iters`` calls (no host gaps). The
    profiler on the card's machine now and then delivers fewer kernel
    records than were launched, so three windows are profiled and only
    those with the most records (at least one per call) count; their
    median is returned, None (not measured) if none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append((len(spans), sum(spans) / 1e3 / iters))
    most = max(n for n, _ in seen)
    if most < iters:
        return None
    return float(np.median([ms for n, ms in seen if n == most]))


def host_us(fn, iters: int = TIMED_ITERS) -> float:
    """Host time of fn() in microseconds per call: the enqueue, with the
    card's queue drained before and after (not inside) the timed calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def in_turns(measure, fns: dict) -> dict:
    """``measure(fn)`` of each of ``fns`` in turns, five times; the median
    per name. Host-bound times drift with the host's load, so two
    versions are compared only measured in turns."""
    seen = {name: [] for name in fns}
    for _ in range(5):
        for name, fn in fns.items():
            seen[name].append(measure(fn))
    return {name: float(np.median(v)) for name, v in seen.items()}


def phase_k1(kernels, plan, vol_shape=FLAGSHIP_SHAPE, phase="k1", what="flagship"):
    """K1's statistics kernel against its plain version and torch.var_mean,
    and K1's apply kernel against the plain chain it replaces, at every
    [N, M, C] of ``plan``'s whole-volume forward of ``vol_shape`` (the
    flagship's by default). Returns the kernels-line entries of both: times
    summed over the calls of one forward."""
    import torch

    stats, act = kernels.instance_norm_stats, kernels.instance_norm_act
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    keys = ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bytes_ms", "ops_ms", "act_ms", "act_plain_ms", "act_bytes_ms")
    total = {k: 0.0 for k in keys}
    max_err = act_err = 0.0
    calls_per_forward = 0
    slope = float(torch.tensor(0.01, dtype=torch.bfloat16))  # the bf16 model's slope
    for spatial, c, calls in stats_shapes(plan, vol_shape):
        x = (torch.randn((1,) + spatial + (c,), generator=gen, device=DEVICE) * 2
             + 0.5).to(torch.bfloat16)
        n, m = 1, int(np.prod(spatial))
        mean, var = stats(x)
        again = stats(x)
        ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
        torch.cuda.synchronize()
        # f32 sums in another order than torch's reduction: both are within
        # a few ulps of the exact moments (var ~ 4 here); the kernel's own
        # order is fixed, so a second call gives the same bits
        torch.testing.assert_close(mean, ref_mean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(var, ref_var, atol=1e-4, rtol=1e-4)
        check(torch.equal(mean, again[0]) and torch.equal(var, again[1]),
              "K1 gave other bits on a second call at %s" % ([n, m, c],))
        err = max(float((mean - ref_mean).abs().max()), float((var - ref_var).abs().max()))
        # the apply pass on the statistics as ConvNormAct forms them (unit
        # scale, a bias), bit for bit against the plain chain
        mul = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
        bias = torch.linspace(-0.5, 0.5, c, device=DEVICE)
        out = act(x, mean, mul, bias, slope)
        want = kernels.instance_norm_act_reference(x, mean, mul, bias, slope)
        torch.cuda.synchronize()
        check(torch.equal(out, want), "K1's apply pass differs from the plain chain at %s"
              % ([n, m, c],))
        row_act_err = float((out.float() - want.float()).abs().max())
        # the burst's shape: two samples of other moments in one [2, M, C]
        # launch, each sample's statistics and output against the plain version
        x2 = torch.cat([x, (torch.randn(x.shape, generator=gen, device=DEVICE) * 1.5
                            - 1.0).to(torch.bfloat16)])
        mean2, var2 = stats(x2)
        ref_mean2, ref_var2 = kernels.instance_norm_stats_reference(x2)
        torch.cuda.synchronize()
        torch.testing.assert_close(mean2, ref_mean2, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(var2, ref_var2, atol=1e-4, rtol=1e-4)
        err2 = max(float((mean2 - ref_mean2).abs().max()), float((var2 - ref_var2).abs().max()))
        mul2 = torch.rsqrt(var2.clamp_min(0.0) + 1e-5)
        out2 = act(x2, mean2, mul2, bias, slope)
        want2 = kernels.instance_norm_act_reference(x2, mean2, mul2, bias, slope)
        torch.cuda.synchronize()
        check(torch.equal(out2, want2), "K1's apply pass differs from the plain chain at %s"
              % ([2, m, c],))
        err = max(err, err2)
        del x2, mean2, var2, ref_mean2, ref_var2, mul2, out2, want2
        x3 = x.view(n, m, c)
        pair = {"kernel": lambda: stats(x),
                "library": lambda: torch.var_mean(x3, dim=1, correction=0)}
        b2b, host = in_turns(cuda_ms, pair), in_turns(host_us, pair)
        row = {
            "kernel_ms": b2b["kernel"],
            "kernel_device_ms": device_ms(pair["kernel"]),
            "kernel_host_us": host["kernel"],
            "plain_ms": cuda_ms(lambda: kernels.instance_norm_stats_reference(x)),
            "library_ms": b2b["library"],
            "library_device_ms": device_ms(pair["library"]),
            "library_host_us": host["library"],
            # each input element read once, mean and var written once
            "bytes_ms": (x.numel() * x.element_size() + 2 * n * c * 4) / HBM_BYTES_PER_S * 1e3,
            # per element: an add for the sum, an FMA (2) for the squares
            "ops_ms": 3 * x.numel() / F32_FLOP_PER_S * 1e3,
            "act_ms": cuda_ms(lambda: act(x, mean, mul, bias, slope)),
            "act_plain_ms": cuda_ms(
                lambda: kernels.instance_norm_act_reference(x, mean, mul, bias, slope)),
            # the activation read once and written once, the [N, C] inputs read
            "act_bytes_ms": (2 * x.numel() * x.element_size() + 3 * n * c * 4)
            / HBM_BYTES_PER_S * 1e3,
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        emit({"phase": phase, "shape_nmc": [n, m, c], "calls_per_forward": calls,
              "max_abs_err": err, "act_max_abs_err": row_act_err, **row})
        for key in total:
            total[key] = None if total[key] is None or row[key] is None else (
                total[key] + calls * row[key])
        max_err = max(max_err, err)
        act_err = max(act_err, row_act_err)
        calls_per_forward += calls
        del x, x3, mean, var, ref_mean, ref_var, out, want
    check(calls_per_forward == 4 * plan.num_pools + 2, "K1 shape table is off")
    narrow = backward = None
    if phase == "k1":
        narrow = k1_narrow(kernels, int(np.prod(vol_shape)), phase)
        backward = k1_backward(kernels, plan)
        k1_sweep(plan, vol_shape)
    per = "one %s forward (%d calls)" % (what, calls_per_forward)
    stats_entry = {
        "name": "instance_norm_stats", "route": "cuda",
        "source": "deepwmh_tpu_torch/csrc/instance_norm_stats.cu",
        "replaces": "deepwmh_tpu/ops/pallas_kernels.py:127",
        "max_abs_err": max_err,
        "ms": total["kernel_ms"], "device_ms": total["kernel_device_ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": max(total["bytes_ms"], total["ops_ms"]),
        "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
        "library_ms": total["library_ms"], "library_device_ms": total["library_device_ms"],
        "per": per,
    }
    if narrow is not None:
        stats_entry["narrow"] = [{k: r[k] for k in ("shape_nmc", "dtype", "max_abs_err", "ms",
                                                    "plain_ms", "library_ms", "bound_ms",
                                                    "wide_shape_nmc", "wide_ms")} for r in narrow]
    act_entry = {
        "name": "instance_norm_act", "route": "cuda",
        "source": "deepwmh_tpu_torch/csrc/instance_norm_act.cu",
        # the pass that consumes K1's statistics (the JAX package leaves it
        # to XLA beside the Pallas call)
        "replaces": "deepwmh_tpu/ops/pallas_kernels.py:127",
        "max_abs_err": act_err,
        "ms": total["act_ms"], "plain_ms": total["act_plain_ms"],
        "bound_ms": total["act_bytes_ms"], "bound_by": "bytes",
        # no one PyTorch call normalizes with given statistics and applies
        # the leaky ReLU
        "library_ms": None,
        "per": per,
    }
    if narrow is not None:
        act_entry["narrow"] = [{"shape_nmc": r["shape_nmc"], "dtype": r["dtype"],
                                "ms": r["act_ms"], "plain_ms": r["act_plain_ms"],
                                "bound_ms": r["act_bound_ms"], "wide_ms": r["wide_act_ms"]}
                               for r in narrow]
    return stats_entry, act_entry, backward


def k1_backward(kernels, plan):
    """K1's backward (``kernels.instance_norm_act_backward``: the sums
    kernel with the [N, C] terms, the dx kernel) at every [2, M, C] of
    ``plan``'s train step (its patch, batch 2, bf16): the terms the same
    bits twice and within 1e-5 of the plain version's, relative to the same
    terms over |g| and |g * (x - mean)|, dx from the kernel's terms bit for
    bit the plain dx pass; then its back-to-back and
    device ms, each kernel's back-to-back ms, the plain chain's autograd
    backward (``ConvNormAct._plain``) and the bounds: 6 bytes an element
    (dy and x read, dx written: any backward) and the design's 10. Returns
    the kernels-line entry: times summed over the step's blocks."""
    import torch

    from deepwmh_tpu_torch.unet.model import NORM_EPS, ConvNormAct

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    slope = float(torch.tensor(0.01, dtype=torch.bfloat16))
    keys = ("ms", "device_ms", "stats_ms", "dx_ms", "plain_ms", "bound_ms", "design_bytes_ms")
    total = {k: 0.0 for k in keys}
    blocks = 0
    for spatial, c, calls in stats_shapes(plan, tuple(plan.patch_size)):
        shape = (2,) + spatial + (c,)
        x = (torch.randn(shape, generator=gen, device=DEVICE) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
        weight = torch.rand(c, generator=gen, device=DEVICE) + 0.5
        bias = torch.randn(c, generator=gen, device=DEVICE) - 0.3
        mean, var = kernels.instance_norm_stats(x)
        mul = torch.rsqrt(var.clamp_min(0.0) + NORM_EPS) * weight
        terms = kernels.instance_norm_act_bwd_stats(x, dy, mean, mul, bias, var, slope,
                                                    NORM_EPS)
        again = kernels.instance_norm_act_bwd_stats(x, dy, mean, mul, bias, var, slope,
                                                    NORM_EPS)
        ref = kernels.instance_norm_act_bwd_stats_reference(x, dy, mean, mul, bias, var, slope,
                                                            NORM_EPS)
        g, xc = kernels._backward_g(x, dy, mean, mul, bias, slope)
        m = int(np.prod(spatial))
        rstd = torch.rsqrt(var.clamp_min(0.0) + NORM_EPS)
        # each term over |g| and |g * (x - mean)|: the size of its sum
        abs_g, abs_gx = g.abs().sum((1, 2, 3)), (g * xc).abs().sum((1, 2, 3)) * rstd
        sizes = (abs_g / m, abs_gx * rstd / m, abs_gx.sum(0), abs_g.sum(0))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(terms, again)),
              "K1's backward terms gave other bits on a second call at %s" % (shape,))
        terms_err = max(float(((a - b).abs() / sz).max()) for a, b, sz in zip(terms, ref, sizes))
        check(terms_err <= 1e-5, "K1's backward terms at %s: %r" % (shape, terms_err))
        del g, xc, ref, again
        k1, k2 = terms[0], terms[1]
        dx = kernels.instance_norm_act_bwd_dx(x, dy, mean, mul, bias, k1, k2, slope)
        want = kernels.instance_norm_act_bwd_dx_reference(x, dy, mean, mul, bias, k1, k2, slope)
        torch.cuda.synchronize()
        check(torch.equal(dx, want), "K1's backward dx differs from its plain version at %s"
              % (shape,))
        del dx, want

        def fused():
            return kernels.instance_norm_act_backward(x, dy, mean, var, mul, bias, slope,
                                                      NORM_EPS)

        blk = ConvNormAct(c, c, (3, 3, 3)).to(DEVICE)
        with torch.no_grad():
            blk.norm_weight.copy_(weight)
            blk.norm_bias.copy_(bias)
        y = x.permute(0, 4, 1, 2, 3).detach().requires_grad_(True)  # channels-last NCDHW
        out = blk._plain(y)
        dout = dy.permute(0, 4, 1, 2, 3)
        params = [y, blk.norm_weight, blk.norm_bias]
        row = {
            "ms": cuda_ms(fused), "device_ms": device_ms(fused),
            "stats_ms": cuda_ms(lambda: kernels.instance_norm_act_bwd_stats(
                x, dy, mean, mul, bias, var, slope, NORM_EPS)),
            "dx_ms": cuda_ms(lambda: kernels.instance_norm_act_bwd_dx(
                x, dy, mean, mul, bias, k1, k2, slope)),
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(out, params, dout,
                                                            retain_graph=True)),
            "bound_ms": 6 * x.numel() / HBM_BYTES_PER_S * 1e3,
            "design_bytes_ms": 10 * x.numel() / HBM_BYTES_PER_S * 1e3,
        }
        emit({"phase": "k1_backward", "shape_nmc": [2, m, c], "calls_per_step": calls,
              "terms_max_rel_err": terms_err, **row})
        for key in total:
            total[key] = None if total[key] is None or row[key] is None else (
                total[key] + calls * row[key])
        blocks += calls
        del x, dy, out, y, dout, params, blk, terms, k1, k2
    check(blocks == 4 * plan.num_pools + 2, "K1 backward shape table is off")
    return {"name": "instance_norm_act_backward", "route": "cuda",
            "source": "deepwmh_tpu_torch/csrc/instance_norm_act_backward.cu",
            "replaces": None,  # no TPU counterpart: the JAX trainer differentiates flax
            **total, "bound_by": "bytes",
            "per": "one train step's %d blocks at patch %s, batch 2" % (
                blocks, "x".join(map(str, plan.patch_size)))}


def k1_sweep(plan, vol_shape):
    """The 8-flip whole-volume sweep with K1 on against the plain norm chain
    (the same weights): ``fused_stats_study.measure``, the port of the JAX
    package's fused_stats_study, whose script prints this reading alone."""
    from deepwmh_tpu_torch.experiments.studies import fused_stats_study

    row = fused_stats_study.measure(plan, vol_shape, DEVICE, repeats=3)
    # random weights: the two paths round the norm at other places, so this
    # is a sanity bound, not a parity bar (the per-kernel checks above are)
    check(np.isfinite(row["max_abs_prob_diff"]) and row["argmax_agreement"] > 0.95,
          "K1 on / off sweeps disagree: %r" % {k: row[k] for k in ("max_abs_prob_diff",
                                                                   "argmax_agreement")})
    emit({"phase": "k1_sweep", **row})
    return row


# K1's narrow widths (fault B0): a base-4 model's first width on a flagship
# volume in bf16, and half of it in f32, each beside the wide width of the
# same bytes a row (C = 8 bf16, C = 4 f32) at the same M
K1_NARROW = (("bfloat16", 4, 8), ("float32", 2, 4))


def k1_narrow(kernels, m, phase="k1"):
    """K1's two kernels at one narrow width per dtype, [1, m, C]: the
    statistics within 1e-4 of the plain version and the same bits twice,
    the apply pass bit for bit; times beside the plain version's, the
    library's, the bound and the wide width's at the same m."""
    import torch

    stats, act = kernels.instance_norm_stats, kernels.instance_norm_act
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows = []
    for dtype_name, c, wide_c in K1_NARROW:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn((1, m, c), generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
        wide = (torch.randn((1, m, wide_c), generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
        mean, var = stats(x)
        again = stats(x)
        ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(mean, ref_mean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(var, ref_var, atol=1e-4, rtol=1e-4)
        check(torch.equal(mean, again[0]) and torch.equal(var, again[1]),
              "narrow K1 gave other bits on a second call at %s" % ([1, m, c],))
        mul = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
        bias = torch.linspace(-0.5, 0.5, c, device=DEVICE)
        slope = float(torch.tensor(0.01, dtype=dtype))
        out = act(x, mean, mul, bias, slope)
        want = kernels.instance_norm_act_reference(x, mean, mul, bias, slope)
        torch.cuda.synchronize()
        check(torch.equal(out, want), "narrow K1 apply differs from the plain chain at %s"
              % ([1, m, c],))
        wmean, wvar = stats(wide)
        wmul = torch.rsqrt(wvar.clamp_min(0.0) + 1e-5)
        wbias = torch.linspace(-0.5, 0.5, wide_c, device=DEVICE)
        b2b = in_turns(cuda_ms, {"kernel": lambda: stats(x), "wide": lambda: stats(wide),
                                 "library": lambda: torch.var_mean(x, dim=1, correction=0)})
        act_b2b = in_turns(cuda_ms, {"kernel": lambda: act(x, mean, mul, bias, slope),
                                     "wide": lambda: act(wide, wmean, wmul, wbias, slope)})
        nbytes = x.numel() * x.element_size()
        row = {"phase": phase + "_narrow", "shape_nmc": [1, m, c], "dtype": dtype_name,
               "wide_shape_nmc": [1, m, wide_c],
               "max_abs_err": max(float((mean - ref_mean).abs().max()),
                                  float((var - ref_var).abs().max())),
               "ms": b2b["kernel"], "wide_ms": b2b["wide"], "library_ms": b2b["library"],
               "plain_ms": cuda_ms(lambda: kernels.instance_norm_stats_reference(x)),
               "bound_ms": max((nbytes + 2 * c * 4) / HBM_BYTES_PER_S,
                               3 * x.numel() / F32_FLOP_PER_S) * 1e3,
               "act_ms": act_b2b["kernel"], "wide_act_ms": act_b2b["wide"],
               "act_plain_ms": cuda_ms(
                   lambda: kernels.instance_norm_act_reference(x, mean, mul, bias, slope)),
               "act_bound_ms": (2 * nbytes + 3 * c * 4) / HBM_BYTES_PER_S * 1e3}
        emit(row)
        rows.append(row)
        del x, wide, mean, var, again, ref_mean, ref_var, out, want, wmean, wvar
    return rows


def _timed(name, fn, times):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
    return out


def gzip_volume_io(work, flair_path, artifacts, hdr):
    """A predict volume's gzip work on the host, native zlib against the
    plain path (Python's gzip, ``native.python_path()``) in turns (native,
    then plain: one turn each, to keep the script within its time): the
    input read and the four artifact writes (the N4 output and three masks,
    level 4 as the pipeline writes them), seconds of each step and their
    sum; the two paths' files byte for byte equal."""
    from deepwmh_tpu_torch import native
    from deepwmh_tpu_torch.core import nifti

    seen = {}
    for route in ("native", "plain"):
        ctx = native.python_path() if route == "plain" else contextlib.nullcontext()
        folder = os.path.join(work, "gzip_" + route)
        os.makedirs(folder, exist_ok=True)
        steps = {}
        with ctx:
            t0 = time.perf_counter()
            nifti.load_nifti(flair_path)
            steps["read_input"] = time.perf_counter() - t0
            for key in ("pre", "raw", "3mm", "fov"):
                t0 = time.perf_counter()
                nifti.save_nifti(artifacts[key], hdr, os.path.join(folder, key + ".nii.gz"))
                steps["write_" + key] = time.perf_counter() - t0
        seen[route] = steps
    for key in ("pre", "raw", "3mm", "fov"):
        blobs = [open(os.path.join(work, "gzip_" + r, key + ".nii.gz"), "rb").read()
                 for r in ("native", "plain")]
        check(blobs[0] == blobs[1], "native and plain gzip wrote other bytes for %s" % key)
    return {route: {"steps_s": steps, "one_write_s": steps["write_pre"],
                    "volume_total_s": sum(steps.values())}
            for route, steps in seen.items()}


def phase_main_path(kernels, work, smi):
    """The flagship DeepWMH_predict through run_predict on two cases; the
    kernels' launch counts are those of this run only."""
    import torch

    from deepwmh_tpu_torch import native
    from deepwmh_tpu_torch.cli.predict import run_predict
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.ops.brain import brain_extract
    from deepwmh_tpu_torch.ops.components import remove_3mm_sparks
    from deepwmh_tpu_torch.ops.n4 import n4_bias_correction
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.preprocess import preprocess_case, resample_to_shape
    from deepwmh_tpu_torch.unet.release import load_released_model

    plan = default_plan_1mm_iso()
    pkg = flagship_package(work)
    cases, images, vols = ["case0", "case1"], [], []
    hdr = nifti.NiftiHeader()
    hdr.set_shape(FLAGSHIP_SHAPE)
    hdr.set_zooms(FLAGSHIP_SPACING)
    for i, case in enumerate(cases):
        vols.append(synthetic_flair(FLAGSHIP_SHAPE, seed=i))
        images.append(os.path.join(work, "%s.nii.gz" % case))
        nifti.save_nifti(vols[-1], hdr, images[-1])
    out = os.path.join(work, "predict")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS.values():
        k.launches = 0
    native.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_predict(images, cases, pkg, out, make_previews=False, device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    gzip_calls = {k: native.CALLS[k] for k in ("gzip_inflate", "gzip_deflate")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the NIfTI codec went through zlib in the native library (PARITY C14):
    # each case's input read, its four artifacts written, none in Python
    check(gzip_calls["gzip_inflate"] >= len(cases) and gzip_calls["gzip_deflate"] >= 4 * len(cases)
          and native.PYTHON_CALLS["gzip_inflate"] == native.PYTHON_CALLS["gzip_deflate"] == 0,
          "predict's gzip did not go through the native library: %r / %r"
          % (gzip_calls, native.PYTHON_CALLS))

    blocks = 4 * plan.num_pools + 2
    expect = len(cases) * len(ALL_FLIPS) * blocks
    for name in ("instance_norm_stats", "instance_norm_act"):
        check(launches[name] == expect,
              "%s launched %d times on the main path, expected %d (2 cases x 8 flips x %d "
              "blocks)" % (name, launches[name], expect, blocks))

    fracs = {}
    for case in cases:
        arts = {}
        for key, rel in (("pre", "001_Preprocessed_Images/%s_0000.nii.gz"),
                         ("raw", "002_Segmentations/001_raw/%s.nii.gz"),
                         ("3mm", "002_Segmentations/002_postproc_3mm/%s.nii.gz"),
                         ("fov", "002_Segmentations/003_postproc_fov/%s.nii.gz")):
            data, h = nifti.load_nifti(os.path.join(out, rel % case))
            check(data.shape == FLAGSHIP_SHAPE and data.dtype == np.float32,
                  "%s %s: shape %s dtype %s" % (case, key, data.shape, data.dtype))
            check(tuple(h.zooms[:3]) == FLAGSHIP_SPACING, "%s %s: zooms %s" % (case, key, h.zooms))
            check(np.isfinite(data).all(), "%s %s has non-finite values" % (case, key))
            arts[key] = data
        for key in ("raw", "3mm", "fov"):
            check(set(np.unique(arts[key]).tolist()) <= {0.0, 1.0}, "%s %s not binary" % (case, key))
        check(((arts["3mm"] <= arts["raw"]) & (arts["fov"] <= arts["3mm"])).all(),
              "%s: post-processing added voxels" % case)
        check(arts["pre"].max() > 0, "%s: empty N4 output" % case)
        fracs[case] = {k: float(arts[k].mean()) for k in ("raw", "3mm", "fov")}
        if case == cases[0]:
            first = arts

    # the same pipeline stage by stage, warm, for where the time goes
    dev = torch.device(DEVICE)
    model, plan2 = load_released_model(pkg, device=dev)
    predictor = SlidingWindowPredictor(model, plan2, device=dev)
    times = {}
    with torch.inference_mode():
        raw = torch.from_numpy(vols[0]).to(dev)
        pre = _timed("n4", lambda: n4_bias_correction(raw), times)
        vol = _timed("preprocess", lambda: preprocess_case(pre, FLAGSHIP_SPACING, plan2), times)
        probs = _timed("tta_sweep", lambda: predictor.predict_volume(vol), times)
        seg = _timed("resample_threshold", lambda: (
            resample_to_shape(probs[..., 1], FLAGSHIP_SHAPE, order=1) > 0.5).to(torch.uint8), times)
        s3 = _timed("spark_removal", lambda: remove_3mm_sparks(seg, FLAGSHIP_SPACING), times)
        fov = _timed("brain_mask", lambda: (
            (s3 * brain_extract(pre, FLAGSHIP_SPACING)) > 0.5).float(), times)
        profile = profile_sweep(predictor, vol)
    # the host side of one case: the input read and one of the four
    # artifact writes (gzip level 4, as the pipeline writes them)
    io = {}
    _timed("read_input", lambda: nifti.load_nifti(images[0]), io)
    pre_np = _timed("to_host", lambda: pre.cpu().numpy(), io)
    _timed("write_one_artifact", lambda: nifti.save_nifti(
        pre_np, hdr, os.path.join(work, "io_probe.nii.gz")), io)
    io["gzip"] = gzip_volume_io(work, images[0], first, hdr)
    agree = float((fov.cpu().numpy() == first["fov"]).mean())
    # a rerun of the whole case (phase train_e2e holds N4 and the masks to
    # the same bits)
    check(agree > 0.999, "staged rerun agrees with the main path on only %.5f" % agree)
    emit({"phase": "main_path", "nvidia_smi": smi, "plan": "default_plan_1mm_iso",
          "shape": list(FLAGSHIP_SHAPE), "cases": len(cases), "tta_flips": len(ALL_FLIPS),
          "wall_s": wall_s, "s_per_volume": wall_s / len(cases),
          "peak_device_gb": peak_gb, "launches": launches, "fg_fraction": fracs,
          "stage_s": times, "stage_sum_s": sum(times.values()), "host_io_s": io,
          "tta_sweep_profile": profile, "staged_vs_main_fov_agreement": agree,
          **sweep_rate(plan2, profile, times["tta_sweep"])})
    return launches, vols[0], pkg


def sweep_rate(plan, profile, sweep_s):
    """Conv FLOP rate of the 8-flip sweep, over its wall time and over the
    time the profiler saw in convolution kernels."""
    from deepwmh_tpu_torch.unet.flops import forward_flops
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, fullvol_shape

    flop = len(ALL_FLIPS) * forward_flops(plan, fullvol_shape(FLAGSHIP_SHAPE, plan))
    out = {"tta_sweep_tflop": flop / 1e12,
           "tta_sweep_tflop_per_s": flop / sweep_s / 1e12,
           "tta_sweep_bf16_peak_share": flop / sweep_s / BF16_FLOP_PER_S}
    conv_ms = profile["group_ms"]["conv"]
    if conv_ms > 0:
        out["conv_kernels_tflop_per_s"] = flop / (conv_ms / 1e3) / 1e12
    return out


_KERNEL_GROUPS = (
    ("k1_apply", ("inorm_act",)),  # ahead of k1, whose key it contains
    ("k1", ("inorm_",)),
    ("conv", ("conv", "xmma", "cudnn", "implicit", "gemm", "fprop", "dgrad", "wgrad", "sm90")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce", "cat", "copy")),
)


def profile_sweep(predictor, vol):
    """One 8-flip whole-volume sweep under torch.profiler: the device's busy
    time by kernel group and the busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_volume(vol)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    groups = {g: 0.0 for g, _ in _KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, us in by_name.items():
        low = name.lower()
        group = next((g for g, keys in _KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[group] += us / 1e3
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_ms,
            "busy_share": busy_ms * 1e3 / wall_us, "group_ms": groups,
            "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


def _small_plan():
    from deepwmh_tpu_torch.unet.plan import Plan

    return Plan(target_spacing=[2.0, 2.0, 2.0], patch_size=[32, 32, 32], batch_size=2,
                pool_kernels=[[2, 2, 2], [2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 4,
                base_features=8, max_features=32)


def phase_card_vs_cpu(kernels, work):
    """Kernel path on the card against the plain path on the CPU, in f32
    with TF32 off, on a small plan: whole-volume and patch sweeps."""
    import torch

    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor, fullvol_shape
    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.preprocess import pad_to, preprocess_case
    from deepwmh_tpu_torch.unet.release import load_released_model, write_model_package

    plan = _small_plan()
    vol = synthetic_flair((64, 72, 56), seed=5)
    spacing = (2.0, 2.0, 2.0)
    model = init_weights(UNet3D(plan, dtype=torch.float32), torch.Generator().manual_seed(1))
    with torch.no_grad():
        # centre the head's class-1 bias on this volume, so that about half
        # of it is foreground and the masks compared are not trivial
        x = preprocess_case(torch.from_numpy(vol), spacing, plan)
        logits = model(pad_to(x, fullvol_shape(x.shape, plan))[None, None])[0]
        model.heads[0].bias[1] -= (logits[1] - logits[0]).median()
    pkg = write_model_package(os.path.join(work, "small_model"), model, plan)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        result = {}
        for mode in ("fullvol", "patch"):
            outs = {}
            for dev in (DEVICE, "cpu"):
                model, p = load_released_model(pkg, device=dev, dtype=torch.float32)
                pred = SlidingWindowPredictor(model, p, mode=mode, device=dev)
                before = (kernels.instance_norm_stats.launches, kernels.instance_norm_act.launches)
                outs[dev] = [o.cpu().numpy() for o in pred.predict_case_full(vol, spacing, apply_n4=True)]
                if dev == DEVICE:
                    check(kernels.instance_norm_stats.launches > before[0]
                          and kernels.instance_norm_act.launches > before[1],
                          "card run of mode %s launched no K1" % mode)
            (pre_g, seg_g, s3_g, fov_g, fg_g), (pre_c, seg_c, s3_c, fov_c, fg_c) = outs[DEVICE], outs["cpu"]
            row = {
                "n4_max_rel": float((np.abs(pre_g - pre_c) / np.maximum(np.abs(pre_c), 1e-3)).max()),
                "fg_max_abs": float(np.abs(fg_g - fg_c).max()),
                "seg_agreement": float((seg_g == seg_c).mean()),
                "seg_3mm_agreement": float((s3_g == s3_c).mean()),
                "seg_fov_agreement": float((fov_g == fov_c).mean()),
                "fg_fraction": float(seg_c.mean()),
            }
            check(row["n4_max_rel"] < 1e-3, "N4 card vs CPU: %r" % row)
            check(row["fg_max_abs"] < 5e-3, "fg probability card vs CPU: %r" % row)
            for key in ("seg_agreement", "seg_3mm_agreement", "seg_fov_agreement"):
                check(row[key] > 0.999, "%s card vs CPU (%s): %r" % (key, mode, row))
            result[mode] = row
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    emit({"phase": "card_vs_cpu", "plan": "small f32, no TF32", "shape": list(vol.shape),
          **result})


def phase_postproc_exact(flair):
    """Spark removal on a random-blob mask and the brain mask of a flagship
    FLAIR: the card's output equals the CPU's voxel for voxel."""
    import torch
    import torch.nn.functional as F

    from deepwmh_tpu_torch.ops.brain import brain_extract
    from deepwmh_tpu_torch.ops.components import remove_3mm_sparks

    noise = torch.rand(FLAGSHIP_SHAPE, generator=torch.Generator().manual_seed(3))
    smooth = F.avg_pool3d(noise[None, None], 5, stride=1, padding=2)[0, 0]
    blobs = (smooth > 0.56).float()
    flair_t = torch.from_numpy(flair)
    row = {"blob_fraction": float(blobs.mean())}
    for name, fn, arg in (("remove_3mm_sparks", lambda v: remove_3mm_sparks(v, FLAGSHIP_SPACING), blobs),
                          ("brain_extract", lambda v: brain_extract(v, FLAGSHIP_SPACING), flair_t)):
        t0 = time.perf_counter()
        want = fn(arg)
        cpu_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(arg.to(DEVICE))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        check(torch.equal(got.cpu(), want), "%s differs between card and CPU" % name)
        row[name] = {"cpu_s": cpu_s, "card_s": card_s, "fraction": float(want.mean())}
    check(0 < row["remove_3mm_sparks"]["fraction"] < row["blob_fraction"],
          "spark removal removed nothing or everything: %r" % row)
    emit({"phase": "postproc_exact", "shape": list(FLAGSHIP_SHAPE), **row})


# ---------------------------------------------------------------------- #
# stage-1 NLL lesion analysis and K2
# ---------------------------------------------------------------------- #

STAGE1_K = 10  # the reference cohort of the reference's OASIS-3 experiment
K2_SHAPES = (FLAGSHIP_SHAPE, (61, 67, 53), (1, 1, 1))
STAGE1_ARTIFACTS = ("anomaly_score", "valid_mask", "normalized_input", "averaged_label",
                    "preprocessed_image", "segmentation", "segmentation_pp")


def signed_volume(shape, seed):
    """An f32 volume on the card with negative values, +0.0 and -0.0, as
    stage-1's masked anomaly has."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    v = torch.randn(shape, generator=gen, device=DEVICE) * 3
    v[torch.rand(shape, generator=gen, device=DEVICE) < 0.3] = 0.0
    v[torch.rand(shape, generator=gen, device=DEVICE) < 0.15] = -0.0
    return v


def median3_library(vol):
    """The closest library route to a 3-D median (no single PyTorch call
    computes one): F.pad + three unfolds + torch.median(dim=-1)."""
    import torch.nn.functional as F

    lead = vol.dim() - 3  # a batch [B, D, H, W] volume by volume
    win = F.pad(vol, (1, 1, 1, 1, 1, 1))
    for ax in range(lead, lead + 3):
        win = win.unfold(ax, 3, 1)
    return win.reshape(tuple(vol.shape) + (27,)).median(-1).values


def _cu_constant(source: str, name: str) -> int:
    """An integer ``constexpr`` of a kernel source, as built."""
    from deepwmh_tpu_torch.ops.kernels import CSRC_DIR

    with open(os.path.join(CSRC_DIR, source)) as f:
        return int(re.search(r"constexpr int %s = (\d+);" % name, f.read()).group(1))


def median3_minmax_executed(kernels, shape) -> int:
    """min/max instructions K2 executes on ``shape``: per thread (a lane of
    a 32-wide warp on an existing row y) two slabs ahead of its walk along
    z, then per step of two outputs two slabs, a pair and two selects."""
    ops = kernels.median27_shared_ops()
    chunk = _cu_constant("median3.cu", "kChunk")
    D, H, W = shape
    per_column = 0
    for z0 in range(0, D, chunk):
        steps = -(-min(chunk, D - z0) // 2)
        per_column += (2 + 2 * steps) * ops["plane"] + steps * (ops["pair"] + 2 * ops["select"])
    return per_column * H * 32 * (-(-W // 32))


def phase_k2(kernels):
    """K2 against its plain version (value equality) and the unfold+median
    library route at the flagship stage-1 call, an odd shape and 1x1x1,
    beside its bound. Returns the kernels-line entry, timed at the flagship
    shape (one call per stage-1 case)."""
    import torch

    k2 = kernels.median3
    shared = kernels.median27_shared_ops()
    # the SASS holds the walk's two leading slabs once and, in its loop,
    # two slabs, a pair and two selects for two outputs
    fmnmx = sass_count(kernels.library_path(k2.source), "FMNMX")
    sass_per_output = None if fmnmx is None else (fmnmx - 2 * shared["plane"]) / 2
    entry = None
    for i, shape in enumerate(K2_SHAPES):
        vol = signed_volume(shape, seed=10 + i)
        got = k2(vol)
        want = kernels.median3_reference(vol)
        lib = median3_library(vol)
        torch.cuda.synchronize()
        # a median is a selection: the same value, -0.0 == +0.0
        check(torch.equal(got, want), "K2 differs from its plain version at %s" % (shape,))
        check(torch.equal(lib, want), "the library route differs at %s" % (shape,))
        n = vol.numel()
        executed = median3_minmax_executed(kernels, shape)
        row = {
            "kernel_ms": cuda_ms(lambda: k2(vol)),
            "plain_ms": cuda_ms(lambda: kernels.median3_reference(vol)),
            "library_ms": cuda_ms(lambda: median3_library(vol)),
            # each voxel read once and written once
            "bytes_ms": 8 * n / HBM_BYTES_PER_S * 1e3,
            # the min/max this kernel executes on this shape, at the f32
            # non-FMA rate (half the FMA-counted peak, the yardstick of the first
            # K2 design's bound)
            "ops_ms": executed / (F32_FLOP_PER_S / 2) * 1e3,
            # the first K2 design's count: 520 min/max per voxel at the same rate
            "ops_ms_520": kernels.median27_minmax_ops() * n / (F32_FLOP_PER_S / 2) * 1e3,
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        err = float((got - want).abs().max())
        emit({"phase": "k2", "shape": list(shape),
              "minmax_per_voxel_pr2": kernels.median27_minmax_ops(),
              "minmax_per_output": shared["per_output"],
              "minmax_executed_per_output": executed / n,
              "outputs_per_thread": _cu_constant("median3.cu", "kChunk"),
              "sass_fmnmx": fmnmx, "sass_minmax_per_output": sass_per_output,
              "max_abs_err": err,
              "library_route": "F.pad + 3x unfold + torch.median(dim=-1)", **row})
        if shape == FLAGSHIP_SHAPE:
            entry = {
                "name": "median3", "route": "cuda",
                "source": "deepwmh_tpu_torch/csrc/median3.cu",
                "replaces": "deepwmh_tpu/ops/pallas_kernels.py:59",
                "max_abs_err": err, "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations",
                "bound_ms_520": max(row["bytes_ms"], row["ops_ms_520"]),
                "library_ms": row["library_ms"],
                "per": "one flagship stage-1 call, %dx%dx%d" % shape,
            }
        del vol, got, want, lib
    entry.update(k2_batch(kernels, entry["bound_ms"]))
    return entry


K2_BATCH = 2  # flagship volumes in one batched call (stage-1 over a case batch)


def k2_batch(kernels, single_bound_ms) -> dict:
    """K2 over [K2_BATCH, 192, 224, 192] in one launch against the single
    calls on each volume (bit-equal) and the plain version: its time, its
    bound (K2_BATCH times the one-volume bound: the same work a volume)
    and its launches."""
    import torch

    k2 = kernels.median3
    vols = torch.stack([signed_volume(FLAGSHIP_SHAPE, seed=20 + b) for b in range(K2_BATCH)])
    before = k2.launches
    got = k2(vols)
    torch.cuda.synchronize()
    launches = k2.launches - before
    singles = torch.stack([k2(v) for v in vols])
    want = kernels.median3_reference(vols)
    check(launches == 1, "the batched K2 call launched %d times" % launches)
    check(torch.equal(got, singles), "the batched K2 differs from single calls")
    check(torch.equal(got, want), "the batched K2 differs from its plain version")
    row = {"batch_shape": list(vols.shape), "batch_launches": launches,
           "batch_max_abs_err": float((got - want).abs().max()),
           "batch_ms": cuda_ms(lambda: k2(vols)),
           "batch_singles_ms": cuda_ms(lambda: [k2(v) for v in vols]),
           "batch_plain_ms": cuda_ms(lambda: kernels.median3_reference(vols), iters=5),
           "batch_library_ms": cuda_ms(lambda: median3_library(vols), iters=5),
           "batch_bound_ms": K2_BATCH * single_bound_ms}
    emit({"phase": "k2_batch", **row})
    return row


def _dice(a, b):
    return 2.0 * float((a & b).sum()) / max(float(a.sum() + b.sum()), 1.0)


def phase_stage1(kernels, work, smi):
    """Stage-1 NLL lesion analysis through LesionAnalyzer at the flagship
    geometry with K = 10 references, one case (two until the serving and
    training phases joined the script's time); K2's launch count is that of
    this run only. Then the same case step by step (reads, analysis, writes,
    segmentation) for where the time goes, which must give the same anomaly
    and threshold."""
    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.pipeline.analysis import LesionAnalyzer

    t0 = time.perf_counter()
    *inputs, lesions = write_cohort(os.path.join(work, "cohort"), FLAGSHIP_SHAPE,
                                    FLAGSHIP_SPACING, STAGE1_K, seed=0)
    setup_s = time.perf_counter() - t0
    cases = ["case0"]
    out = os.path.join(work, "stage1")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    an = LesionAnalyzer(out, device=DEVICE)
    for case in cases:
        an.add_case(case, *inputs)
    an.analyze_and_do_segmentation(intensity_prior="+")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["median3"] == len(cases),
          "K2 launched %d times on the stage-1 path, expected once per case (%d)"
          % (launches["median3"], len(cases)))

    arts = {}
    for case in cases:
        case_dir = os.path.join(out, case)
        for f in ("summary.json", "segmentation.txt"):
            check(os.path.isfile(os.path.join(case_dir, f)), "%s: no %s" % (case, f))
        with open(os.path.join(case_dir, "summary.json")) as f:
            summary = json.load(f)
        thr = summary["autoseg_threshold"]
        check(math.isfinite(thr), "%s: threshold %r" % (case, thr))
        a = {"threshold": thr}
        for key in STAGE1_ARTIFACTS:
            data, h = nifti.load_nifti(os.path.join(case_dir, key + ".nii.gz"))
            check(data.shape == FLAGSHIP_SHAPE and np.isfinite(data).all(),
                  "%s %s: shape %s or non-finite values" % (case, key, data.shape))
            check(tuple(h.zooms[:3]) == FLAGSHIP_SPACING, "%s %s: zooms %s" % (case, key, h.zooms))
            a[key] = data
        seg, pp = a["segmentation"] > 0.5, a["segmentation_pp"] > 0.5
        check(not (pp & ~seg).any(), "%s: segmentation_pp is not inside segmentation" % case)
        a["dice_pp"] = _dice(pp, lesions > 0.5)
        check(a["dice_pp"] > 0.5, "%s: Dice %.3f against the planted lesions" % (case, a["dice_pp"]))
        arts[case] = a
    first = arts[cases[0]]
    avg = first["averaged_label"]
    in_cb = float((lesions * (avg == 2)).sum())
    check(in_cb > 0, "no planted lesion lies in the class-2 (median) region")

    # the same case step by step: host reads, the analysis, artifact writes,
    # segmentation
    an2 = LesionAnalyzer(os.path.join(work, "stage1_staged"), device=DEVICE)
    an2.add_case(cases[0], *inputs)
    io = {}
    loaded = _timed("read_inputs", lambda: an2._load_case(cases[0]), io)
    result, hdr, _ = _timed("analyze_case", lambda: an2.analyze_case(
        cases[0], loaded=loaded), io)
    _timed("write_artifacts", lambda: an2._save_case_artifacts(cases[0], result, hdr, "+"), io)
    _timed("segmentation_and_pp", lambda: an2.analyze_and_do_segmentation("+"), io)
    check(result.threshold == first["threshold"] and np.array_equal(result.anomaly,
                                                                   first["anomaly_score"]),
          "the staged rerun differs from the main run")
    batch, batch_launches = stage1_batch(kernels)
    emit({"phase": "stage1", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "spacing": list(FLAGSHIP_SPACING), "K": STAGE1_K, "cases": len(cases),
          "setup_s": setup_s, "wall_s": wall_s, "s_per_case": wall_s / len(cases),
          "peak_device_gb": peak_gb, "launches": launches, "threshold": first["threshold"],
          "dice_pp": first["dice_pp"], "lesion_voxels": float(lesions.sum()),
          "lesion_voxels_in_class2": in_cb,
          "seg_fraction": float(first["segmentation"].mean()),
          "seg_pp_fraction": float(first["segmentation_pp"].mean()),
          "host_s": io,
          "batch": batch})
    return launches, (inputs, out), batch_launches


def stage1_batch(kernels):
    """Stage-1 over a case batch: the phase's case (seed 0) and a second
    seeded one through one nll_analysis_batch (B = 2), each row against
    nll_analysis_core on that case at the stage-1 bars (anomaly within 1e-4
    of its max, threshold equal or one bin apart, averaged label equal);
    device seconds of the batch and of the cases one by one, peak memory
    and the batch's launches (counts reset just before it)."""
    import torch

    from deepwmh_tpu_torch.pipeline.analysis import (
        nll_analysis_batch,
        nll_analysis_core,
        patch_size_from_voxel,
    )

    cohorts = [synthetic_cohort(FLAGSHIP_SHAPE, STAGE1_K, seed)[:4] for seed in (0, 1)]
    kw = dict(patch_size=patch_size_from_voxel(FLAGSHIP_SPACING), voxel_size=FLAGSHIP_SPACING,
              num_label_classes=max(int(c[3].max()) for c in cohorts) + 1)
    dev = torch.device(DEVICE)
    up = [[torch.from_numpy(a).to(dev) for a in c] for c in cohorts]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    singles, single_s = [], []
    for c in up:
        out, sec = timed(lambda: nll_analysis_core(*c, **kw))
        singles.append([o.cpu().numpy() for o in out])
        single_s.append(sec)
    stacks = [torch.stack([c[i] for c in up]) for i in range(4)]
    del up
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS.values():
        k.launches = 0
    out, batch_s = timed(lambda: nll_analysis_batch(*stacks, **kw))
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = [o.cpu().numpy() for o in out]
    del stacks, out
    check(launches["median3"] == 1, "the batched stage-1 launched K2 %d times, expected once"
          % launches["median3"])
    rows = []
    for b, one in enumerate(singles):
        bin_w = float(one[4][1] - one[4][0])
        row = {"anomaly_max_rel": float(np.abs(got[0][b] - one[0]).max() / np.abs(one[0]).max()),
               "threshold": float(got[8][b]), "threshold_one": float(one[8]),
               "bin_width": bin_w,
               "averaged_label_equal": bool(np.array_equal(got[3][b], one[3])),
               "valid_agreement": float((got[1][b] == one[1]).mean())}
        check(row["anomaly_max_rel"] <= 1e-4 and abs(row["threshold"] - row["threshold_one"])
              <= bin_w * 1.0001 and row["averaged_label_equal"],
              "stage-1 batch row %d against its case: %r" % (b, row))
        rows.append(row)
    return {"cases": len(cohorts), "batch_s": batch_s, "one_by_one_s": single_s,
            "batch_over_one_by_one": batch_s / sum(single_s), "peak_device_gb": peak_gb,
            "launches": launches, "rows": rows}, launches


def phase_stage1_card_vs_cpu(kernels):
    """The stage-1 core on the card (K2 path) against the CPU (plain path)
    at 96x112x96, 2 mm, K = 4, where the median is still 3x3x3."""
    import torch

    from deepwmh_tpu_torch.ops.components import remove_3mm_sparks
    from deepwmh_tpu_torch.pipeline.analysis import nll_analysis_core, patch_size_from_voxel

    shape, spacing = (96, 112, 96), (2.0, 2.0, 2.0)
    x, refs, l1, l2, _ = synthetic_cohort(shape, 4, seed=1)
    outs = {}
    for dev in (DEVICE, "cpu"):
        before = kernels.median3.launches
        t0 = time.perf_counter()
        res = nll_analysis_core(*(torch.from_numpy(a).to(dev) for a in (x, refs, l1, l2)),
                                patch_size=patch_size_from_voxel(spacing), voxel_size=spacing,
                                num_label_classes=int(l2.max()) + 1)
        anomaly, thr = res[0], res[8]
        seg = (anomaly > thr).float()
        pp = remove_3mm_sparks(seg, spacing)
        outs[dev] = {"anomaly": anomaly, "valid": res[1], "avg": res[3], "x": res[4],
                     "thr": float(thr), "seg": seg, "pp": pp}
        outs[dev] = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                     for k, v in outs[dev].items()}
        outs[dev]["s"] = time.perf_counter() - t0
        if dev == DEVICE:
            check(kernels.median3.launches == before + 1, "the card's stage-1 core launched no K2")
    card, cpu = outs[DEVICE], outs["cpu"]
    bin_w = float(cpu["x"][1] - cpu["x"][0])
    row = {
        "anomaly_max_rel": float(np.abs(card["anomaly"] - cpu["anomaly"]).max()
                                 / np.abs(cpu["anomaly"]).max()),
        "threshold_card": card["thr"], "threshold_cpu": cpu["thr"], "bin_width": bin_w,
        "valid_agreement": float((card["valid"] == cpu["valid"]).mean()),
        "seg_agreement": float((card["seg"] == cpu["seg"]).mean()),
        "seg_pp_agreement": float((card["pp"] == cpu["pp"]).mean()),
        "averaged_label_equal": bool(np.array_equal(card["avg"], cpu["avg"])),
        "seg_fraction": float(cpu["seg"].mean()), "card_s": card["s"], "cpu_s": cpu["s"],
    }
    check(row["anomaly_max_rel"] < 1e-4, "stage-1 anomaly card vs CPU: %r" % row)
    check(abs(card["thr"] - cpu["thr"]) <= bin_w * 1.0001, "stage-1 threshold card vs CPU: %r" % row)
    for key in ("valid_agreement", "seg_agreement", "seg_pp_agreement"):
        check(row[key] >= 0.999, "stage-1 %s card vs CPU: %r" % (key, row))
    check(row["averaged_label_equal"], "stage-1 averaged label card vs CPU: %r" % row)
    check(row["seg_fraction"] > 0, "stage-1 card vs CPU compared empty segmentations")
    emit({"phase": "stage1_card_vs_cpu", "shape": list(shape), "spacing": list(spacing), "K": 4,
          **row})


# ---------------------------------------------------------------------- #
# serving and training (no kernel of their own: serving runs K1's two
# kernels through the predictor, training runs none)
# ---------------------------------------------------------------------- #

SERVE_ARTIFACTS = ("001_Preprocessed_Images/%s_0000.nii.gz", "002_Segmentations/001_raw/%s.nii.gz",
                   "002_Segmentations/002_postproc_3mm/%s.nii.gz",
                   "002_Segmentations/003_postproc_fov/%s.nii.gz")


def _write_flair(path, seed):
    from deepwmh_tpu_torch.core import nifti

    hdr = nifti.NiftiHeader()
    hdr.set_shape(FLAGSHIP_SHAPE)
    hdr.set_zooms(FLAGSHIP_SPACING)
    nifti.save_nifti(synthetic_flair(FLAGSHIP_SHAPE, seed=seed), hdr, path)


def _served_pass(kernels, pkg, spool_files, out, batch_max, server_id):
    """Copy ``spool_files`` into a fresh spool and drain it in this process
    with SpoolServer(batch_max) on the model package ``pkg``; returns wall,
    K1 launches, peak memory and the receipts."""
    import torch

    from deepwmh_tpu_torch.pipeline.serve import SpoolServer

    spool = out + "_spool"
    os.makedirs(spool)
    for f in spool_files:
        shutil.copyfile(f, os.path.join(spool, os.path.basename(f)))
    srv = SpoolServer(spool, out, pkg, make_previews=False, server_id=server_id,
                      settle_seconds=0.0, batch_max=batch_max, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    check(result == (len(spool_files), 0), "%s drained %r" % (server_id, result))
    receipts = {}
    for f in spool_files:
        case = os.path.basename(f)[: -len(".nii.gz")]
        with open(os.path.join(spool, ".done", case + ".json")) as fh:
            receipts[case] = json.load(fh)
    return {"wall_s": wall, "launches": launches,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}, receipts


def phase_serve(kernels, work, pkg, smi):
    """The port's serve CLI on a spool of two flagship FLAIRs and a corrupt
    request (``--once`` must exit 1), then a burst of two in this process
    against the same two requests served one by one."""
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso

    root = os.path.join(work, "serve")
    spool, out = os.path.join(root, "spool"), os.path.join(root, "out")
    os.makedirs(spool)
    cases = ["req0", "req1"]
    for i, case in enumerate(cases):
        _write_flair(os.path.join(spool, case + ".nii.gz"), seed=10 + i)
    with open(os.path.join(spool, "corrupt.nii.gz"), "wb") as f:
        f.write(b"\x1f\x8b this is not a NIfTI volume")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "deepwmh_tpu_torch.cli.serve", "-m", pkg, "-s", spool,
           "-o", out, "--once", "--settle-seconds", "0", "--no-previews",
           "--server-id", "smoke", "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    cli_wall = time.perf_counter() - t0
    check(proc.returncode == 1, "serve --once exited %d, expected 1 (the corrupt request):\n%s"
          % (proc.returncode, (proc.stdout + proc.stderr)[-3000:]))
    latencies = {}
    for case in cases:
        with open(os.path.join(spool, ".done", case + ".json")) as f:
            r = json.load(f)
        check(len(r.get("input_sha256", "")) == 64, "%s: receipt without input_sha256" % case)
        latencies[case] = r["latency_s"]
        for rel in SERVE_ARTIFACTS:
            data = nifti.load_nifti_simple(os.path.join(out, rel % case))
            check(data.shape == FLAGSHIP_SHAPE and np.isfinite(data).all(),
                  "%s: %s shape %s or non-finite" % (case, rel, data.shape))
    check(os.path.isfile(os.path.join(spool, ".failed", "corrupt.nii.gz"))
          and os.path.isfile(os.path.join(spool, ".failed", "corrupt.err")),
          "the corrupt request was not quarantined with its .err")
    left = [f for f in os.listdir(spool) if f.endswith(".nii.gz")]
    check(left == [], "requests left in the spool: %s" % left)
    check(os.listdir(os.path.join(spool, ".work", "smoke")) == [], "claims left in .work")
    served_s = sum(latencies.values())

    # a burst of two against the same two one by one, in this process
    pair = []
    for i in range(2):
        pair.append(os.path.join(root, "pair%d.nii.gz" % i))
        _write_flair(pair[-1], seed=20 + i)
    passes, receipts = {}, {}
    for name, batch_max in (("burst", 2), ("solo", 1)):
        passes[name], receipts[name] = _served_pass(
            kernels, pkg, pair, os.path.join(root, name), batch_max, name)
    per_volume = len(ALL_FLIPS) * (4 * default_plan_1mm_iso().num_pools + 2)
    for name in passes:
        bursts = {r.get("burst_size") for r in receipts[name].values()}
        check(bursts == ({2} if name == "burst" else {None}),
              "%s: receipts' burst_size %s" % (name, bursts))
        # one by one, each volume takes its own launches; a burst's forward
        # reads both volumes ([2, *spatial, C]) in one launch a block
        want = per_volume * (1 if name == "burst" else 2)
        for k in ("instance_norm_stats", "instance_norm_act"):
            check(passes[name]["launches"][k] == want,
                  "%s: %s launched %d times for two volumes, expected %d"
                  % (name, k, passes[name]["launches"][k], want))
    agreement = {}
    for i in range(2):
        for rel in SERVE_ARTIFACTS[1:]:
            a, b = (nifti.load_nifti_simple(os.path.join(root, n, rel % ("pair%d" % i)))
                    for n in ("burst", "solo"))
            agreement["pair%d:%s" % (i, rel.split("/")[1])] = float((a == b).mean())
    check(min(agreement.values()) > 0.999, "burst against one-case masks: %r" % agreement)
    emit({"phase": "serve", "nvidia_smi": smi, "plan": "default_plan_1mm_iso",
          "shape": list(FLAGSHIP_SHAPE), "tta_flips": len(ALL_FLIPS),
          "cli_requests": len(cases) + 1, "cli_exit_code": proc.returncode,
          "cli_wall_s": cli_wall, "latency_s": latencies,
          "volumes_per_min_served": 60.0 * len(cases) / served_s,
          "volumes_per_min_cli_wall": 60.0 * len(cases) / cli_wall,
          "k1_launches_per_volume": {k: passes["solo"]["launches"][k] // 2
                                     for k in ("instance_norm_stats", "instance_norm_act")},
          "passes": passes, "burst_vs_solo_wall": passes["burst"]["wall_s"] / passes["solo"]["wall_s"],
          "burst_vs_solo_mask_agreement": agreement})


MESH_SHARDS = 8  # the 8-way mesh on one card (the JAX tests' 8 virtual devices)
MESH_N4_REL = 1e-3  # tests/test_spatial_sharding.py's bar, in the brain
MESH_PATCH_FG_ATOL = 1e-5  # the patch shards' accumulators add up in another order


def _counted(kernels, fn):
    """fn() with every kernel's count set to 0 just before and read just
    after, between two synchronisations: (result, launches, seconds)."""
    import torch

    for k in kernels.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.KERNELS.items()}, time.perf_counter() - t0


def phase_mesh(kernels, work, smi, pkg, flair, stage1=None):
    """The inference side of the device mesh on an 8-shard mesh whose
    shards all name this card (``Mesh([cuda:0] * 8)``): every exchange
    goes through the mesh's collectives as on a node of eight cards.

    - predict_case_full, flips dealt one a shard, against the unsharded
      predictor (masks equal; fg within 1e-6, expected the same bits);
    - the patch mode's sharded sweep against the unsharded one;
    - HaloShardedOps' median (K2 once a slab) against K2 on the whole
      volume, its z-score against ops.stats', N4 sharded against N4 (rel
      in the brain; twice for the same bits);
    - the predict CLI with --mesh against -g 0 (a one-card mesh: the same
      bits), serve --mesh --once on two requests;
    - stage-1 over the mesh (two cases padded to a block of one a shard)
      against the one-by-one run
      (``stage1``: (inputs, output folder) of phase stage1's case0; run
      here when absent)."""
    import io

    import torch

    from deepwmh_tpu_torch.cli import predict as predict_cli
    from deepwmh_tpu_torch.cli import serve as serve_cli
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.device import resolve_device
    from deepwmh_tpu_torch.ops import stats
    from deepwmh_tpu_torch.ops.n4 import n4_bias_correction
    from deepwmh_tpu_torch.parallel.infer_sharded import ShardedSlidingWindowPredictor
    from deepwmh_tpu_torch.parallel.mesh import Mesh
    from deepwmh_tpu_torch.parallel.spatial import HaloShardedOps
    from deepwmh_tpu_torch.pipeline.analysis import LesionAnalyzer
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, SlidingWindowPredictor, patch_positions
    from deepwmh_tpu_torch.unet.preprocess import padded_shape
    from deepwmh_tpu_torch.unet.release import load_released_model

    dev = resolve_device(DEVICE)
    mesh = Mesh([dev] * MESH_SHARDS)
    model, plan = load_released_model(pkg, device=dev)
    blocks = 4 * plan.num_pools + 2
    out = {"phase": "mesh", "nvidia_smi": smi, "shards": MESH_SHARDS, "mesh_devices":
           sorted({str(d) for d in mesh.devices}), "shape": list(FLAGSHIP_SHAPE)}

    # 1. the whole predict case, flips dealt over the mesh (the main path),
    # in turns with the unsharded predictor: unsharded, mesh, mesh, unsharded
    single = SlidingWindowPredictor(model, plan, device=dev)
    sharded = ShardedSlidingWindowPredictor(model, plan, mesh, tta=True, device=dev)
    runs = {"unsharded": [], "mesh": []}
    for name in ("unsharded", "mesh", "mesh", "unsharded"):
        pred = sharded if name == "mesh" else single
        if name == "mesh" and not runs["mesh"]:
            torch.cuda.reset_peak_memory_stats()
        runs[name].append(_counted(kernels, lambda: pred.predict_case_full(
            flair, FLAGSHIP_SPACING, apply_n4=True)))
        if name == "mesh" and len(runs["mesh"]) == 1:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = runs["unsharded"][0][0]
    expect = len(ALL_FLIPS) * blocks
    fg_diff = 0.0
    for got, launches, _ in runs["mesh"] + runs["unsharded"][1:]:
        fg_diff = max(fg_diff, float((got[4] - want[4]).abs().max()))
        for k, name in ((0, "N4 output"), (1, "seg_raw"), (2, "seg_3mm"), (3, "seg_fov")):
            check(torch.equal(got[k], want[k]), "mesh predict_case_full: %s differs" % name)
        for name in ("instance_norm_stats", "instance_norm_act"):
            check(launches[name] == expect, "mesh predict: %s launched %d times, expected %d"
                  % (name, launches[name], expect))
    check(fg_diff <= 1e-6, "mesh predict_case_full: fg max abs diff %g" % fg_diff)
    got, launches, _ = runs["mesh"][0]
    out.update(predict_case_full={
        "s": [r[2] for r in runs["mesh"]], "unsharded_s": [r[2] for r in runs["unsharded"]],
        "fg_max_abs_diff": fg_diff, "fg_bit_equal": bool(torch.equal(got[4], want[4])),
        "peak_device_gb": peak_gb, "launches": launches,
        "fg_fraction": float(got[1].float().mean())})
    mesh_launches = dict(launches)
    del runs, got, want

    # 2. the patch mode: positions in 8 blocks, accumulators psum'd
    vol = torch.from_numpy(flair).to(dev)
    p_single = SlidingWindowPredictor(model, plan, mode="patch", device=dev)
    p_sharded = ShardedSlidingWindowPredictor(model, plan, mesh, tta=True, mode="patch", device=dev)
    want_p, _, p_single_s = _counted(kernels, lambda: p_single.predict_case(vol, FLAGSHIP_SPACING))
    got_p, p_launches, p_mesh_s = _counted(kernels, lambda: p_sharded.predict_case(
        vol, FLAGSHIP_SPACING))
    positions = int(patch_positions(padded_shape(FLAGSHIP_SHAPE, plan.patch_size),
                                    plan.patch_size)[1].sum())
    p_diff = float((got_p[1] - want_p[1]).abs().max())
    p_agree = float((got_p[0] == want_p[0]).float().mean())
    check(p_diff <= MESH_PATCH_FG_ATOL, "mesh patch sweep: fg max abs diff %g" % p_diff)
    check(p_agree > 0.999, "mesh patch sweep: mask agreement %.6f" % p_agree)
    check(p_launches["instance_norm_stats"] == positions * blocks,
          "mesh patch sweep: K1 launched %d times, expected %d positions x %d blocks"
          % (p_launches["instance_norm_stats"], positions, blocks))
    out.update(patch={"s": p_mesh_s, "unsharded_s": p_single_s, "fg_max_abs_diff": p_diff,
                      "mask_agreement": p_agree, "positions": positions, "launches": p_launches})

    # 3. halo-sharded median and z-score, sharded N4
    ops = HaloShardedOps(mesh)
    sv = signed_volume(FLAGSHIP_SHAPE, seed=3)
    whole = kernels.median3(sv)
    med, med_launches, med_s = _counted(kernels, lambda: ops.median_filter(sv, 3))
    med_ms = {"sharded": cuda_ms(lambda: ops.median_filter(sv, 3)),
              "unsharded": cuda_ms(lambda: kernels.median3(sv))}
    med_diff = int((med != whole).sum())
    check(med_diff == 0, "halo-sharded median: %d voxels differ from K2 unsharded" % med_diff)
    check(med_launches["median3"] == MESH_SHARDS,
          "halo-sharded median: K2 launched %d times, expected one a slab (%d)"
          % (med_launches["median3"], MESH_SHARDS))
    head = vol > 100.0
    z_diff = float((ops.z_score(vol, head) - stats.z_score(vol, head)).abs().max())
    check(z_diff <= 1e-5, "halo-sharded z-score: max abs diff %g" % z_diff)
    n4_want, _, n4_single_s = _counted(kernels, lambda: n4_bias_correction(vol))
    n4_runs = [_counted(kernels, lambda: ops.n4_bias_correction(vol)) for _ in range(2)]
    n4_got = n4_runs[0][0]
    n4_rel = float(((n4_got - n4_want).abs() / n4_want.abs().clamp(min=1.0))[head].max())
    n4_bits = bit_diff(n4_runs[0][0].cpu().numpy(), n4_runs[1][0].cpu().numpy())
    check(n4_rel < MESH_N4_REL, "sharded N4: rel %.3g in the brain" % n4_rel)
    check(n4_bits["words"] == 0, "sharded N4 differs run to run: %r" % n4_bits)
    out.update(halo={"median_s": med_s, "median_ms": med_ms, "median_differing_voxels": med_diff,
                     "median_launches": med_launches, "zscore_max_abs_diff": z_diff,
                     "n4_s": [r[2] for r in n4_runs], "n4_unsharded_s": n4_single_s,
                     "n4_rel_in_brain": n4_rel, "n4_run_to_run": n4_bits})
    mesh_launches["median3"] = med_launches["median3"]

    # 4. the predict CLI: --mesh (this process's cards) against -g 0
    image = os.path.join(work, "mesh_case.nii.gz")
    _write_flair(image, seed=0)
    cli_s, cli_launches = {}, {}
    pin = ["-g", str(dev.index)] if dev.type == "cuda" else ["--device", "cpu"]
    for name, extra in (("mesh", ["--mesh"]), ("g0", pin)):
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            _, cli_launches[name], cli_s[name] = _counted(kernels, lambda: predict_cli.main([
                "-i", image, "-n", "m0", "-m", pkg, "-o", os.path.join(work, "mesh_cli_" + name),
                "--no-previews", "--skip-integrity-check"] + extra))
        if name == "mesh":
            line = "mesh: sharding each sweep over %d device(s)" % torch.cuda.device_count()
            check(line in said.getvalue(), "predict --mesh did not say %r" % line)
    arts = {n: _predict_artifacts(os.path.join(work, "mesh_cli_" + n), "m0") for n in cli_s}
    for key in arts["g0"]:
        check(np.array_equal(arts["mesh"][key], arts["g0"][key]),
              "predict --mesh: %s differs from -g 0's" % key)
    check(cli_launches["mesh"]["instance_norm_stats"] == expect,
          "predict --mesh: K1 launched %d times" % cli_launches["mesh"]["instance_norm_stats"])
    out.update(predict_cli={"s": cli_s, "launches": cli_launches, "artifacts_equal": True})

    # 5. serve --mesh --once on two requests
    spool, served = os.path.join(work, "mesh_spool"), os.path.join(work, "mesh_served")
    os.makedirs(spool)
    for i in range(2):
        _write_flair(os.path.join(spool, "q%d.nii.gz" % i), seed=30 + i)
    with contextlib.redirect_stdout(io.StringIO()):
        rc, serve_launches, serve_s = _counted(kernels, lambda: serve_cli.main([
            "-m", pkg, "-s", spool, "-o", served, "--once", "--settle-seconds", "0",
            "--no-previews", "--server-id", "mesh", "--mesh"]))
    check(rc == 0, "serve --mesh --once exited %r" % rc)
    for i in range(2):
        check(os.path.isfile(os.path.join(spool, ".done", "q%d.json" % i)), "q%d: no receipt" % i)
        fov = nifti.load_nifti_simple(os.path.join(served, SERVE_ARTIFACTS[3] % ("q%d" % i)))
        check(fov.shape == FLAGSHIP_SHAPE and np.isfinite(fov).all(), "q%d: bad FOV mask" % i)
    check(serve_launches["instance_norm_stats"] == 2 * expect,
          "serve --mesh: K1 launched %d times" % serve_launches["instance_norm_stats"])
    out.update(serve_cli={"s": serve_s, "requests": 2, "launches": serve_launches})

    # 6. stage-1 over the mesh: two cases, a block a shard
    if stage1 is None:
        inputs = write_cohort(os.path.join(work, "cohort"), FLAGSHIP_SHAPE, FLAGSHIP_SPACING,
                              STAGE1_K, seed=0)[:4]
        solo = os.path.join(work, "stage1")
        an = LesionAnalyzer(solo, device=dev)
        an.add_case("case0", *inputs)
        an.analyze_and_do_segmentation(intensity_prior="+")
    else:
        inputs, solo = stage1
    an = LesionAnalyzer(os.path.join(work, "mesh_stage1"), device=dev)
    for case in ("m0", "m1"):
        an.add_case(case, *inputs)
    _, s1_launches, s1_s = _counted(kernels, lambda: an.analyze_and_do_segmentation(
        intensity_prior="+", mesh=mesh))
    # nll_analysis_batch(mesh=) pads the two cases to a block of one a shard
    # (the last case repeated, as JAX's does) and runs each as the one-case core
    check(s1_launches["median3"] == mesh.size,
          "stage-1 over the mesh: K2 launched %d times, expected %d (one a shard)"
          % (s1_launches["median3"], mesh.size))
    for case in ("m0", "m1"):
        for key in STAGE1_ARTIFACTS:
            a = nifti.load_nifti_simple(os.path.join(work, "mesh_stage1", case, key + ".nii.gz"))
            b = nifti.load_nifti_simple(os.path.join(solo, "case0", key + ".nii.gz"))
            check(np.array_equal(a, b), "stage-1 over the mesh: %s %s differs from one by one"
                  % (case, key))
    out.update(stage1={"s": s1_s, "cases": 2, "launches": s1_launches, "equal_to_one_by_one": True})
    check(set(launches) == set(med_launches) == set(s1_launches)
          == set(kernels.KERNELS),
          "unlisted kernels on the mesh paths: %s" % sorted(launches))
    emit(out)
    return mesh_launches


def remat_flops(plan, shape) -> int:
    """Conv MACs x 2 of one batch-1 forward that remat computes again in the
    backward pass: every ConvNormAct block of stages 0 and 1."""
    from deepwmh_tpu_torch.unet.plan import features_per_stage

    feats = features_per_stage(plan)
    spatial = [tuple(shape)]
    for k in plan.pool_kernels:
        spatial.append(tuple(-(-a // int(s)) for a, s in zip(spatial[-1], k)))
    macs = 0
    cin = plan.in_channels
    for i in range(plan.num_pools + 1):
        vox, kv = math.prod(spatial[i]), math.prod(plan.conv_kernels[i])
        if i <= 1:
            macs += vox * kv * (cin + feats[i]) * feats[i]  # encoder pair
            if i < plan.num_pools:
                macs += vox * kv * 3 * feats[i] * feats[i]  # decoder pair (2C -> C, C -> C)
        cin = feats[i]
    return 2 * macs


_TRAIN_GROUPS = (
    ("conv_dgrad", ("dgrad",)),
    ("conv_wgrad", ("wgrad",)),
    ("conv_fwd", ("conv", "xmma", "cudnn", "implicit", "gemm", "fprop", "sm90")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce", "cat", "copy", "index",
                     "softmax", "where")),
)


def _profiled(fn, by_name=None):
    """fn() under torch.profiler: (result, {group: device ms}, wall ms);
    each kernel's device ms is added to ``by_name`` when given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = {g: 0.0 for g, _ in _TRAIN_GROUPS}
    groups["other"] = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            low = e.name.lower()
            g = next((g for g, keys in _TRAIN_GROUPS if any(k in low for k in keys)), "other")
            groups[g] += e.time_range.elapsed_us() / 1e3
            if by_name is not None:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out, groups, wall


def trainer_launches(plan, steps, val_batches=0) -> dict:
    """Each kernel's launches over ``steps`` Trainer steps (remat on stages
    0-1) and ``val_batches`` validation forwards at ``plan``: K1's two
    forward kernels once a block a forward and again for each block remat
    recomputes, K1's two backward kernels once a block a step, no K2."""
    blocks = 4 * plan.num_pools + 2
    remat = sum(2 if i == plan.num_pools else 4 for i in range(min(1, plan.num_pools) + 1))
    forwards = steps * (blocks + remat) + val_batches * blocks
    return {"instance_norm_stats": forwards, "instance_norm_act": forwards,
            "instance_norm_act_bwd_stats": steps * blocks,
            "instance_norm_act_bwd_dx": steps * blocks, "median3": 0}


def _train_cohort(shape, seed):
    """A preprocessed training case: synthetic_cohort's target (planted
    lesions) z-scored over the volume, and its lesion mask as the label."""
    target, _refs, _l1, _l2, lesions = synthetic_cohort(shape, 1, seed)
    image = (target - target.mean()) / max(float(target.std()), 1e-8)
    return image.astype(np.float32), lesions.astype(np.uint8)


def phase_train(kernels, work, smi):
    """Trainer.fit at the flagship plan, then the step taken apart."""
    import torch

    from deepwmh_tpu_torch.unet import checkpoint as ckpt
    from deepwmh_tpu_torch.unet.data import SegDataset
    from deepwmh_tpu_torch.unet.flops import forward_flops
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.model import UNet3D
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.release import load_released_model, release_model
    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

    plan = default_plan_1mm_iso()
    t0 = time.perf_counter()
    train_ds, val_ds = SegDataset(plan.patch_size), SegDataset(plan.patch_size)
    for i in range(3):
        train_ds.add_case("train%d" % i, *_train_cohort(FLAGSHIP_SHAPE, seed=30 + i))
    val_ds.add_case("val0", *_train_cohort(FLAGSHIP_SHAPE, seed=40))
    setup_s = time.perf_counter() - t0
    cfg = TrainConfig(epochs=2, batches_per_epoch=6, batch_size=2, augment=True,
                      save_every_epoch=True)
    out = os.path.join(work, "train")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = Trainer(plan, cfg, out, device=DEVICE)
    _, best = trainer.fit(train_ds, val_ds)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    fit_peak = torch.cuda.max_memory_allocated() / 1e9
    # K1 forward and backward a block a step, remat's recompute, and K1
    # forward a block on each validation batch
    steps = cfg.epochs * cfg.batches_per_epoch
    check(fit_launches == trainer_launches(plan, steps, cfg.epochs * cfg.val_batches),
          "the training path's launches: %r" % fit_launches)
    losses = [v for h in trainer.history for v in h["losses"]]
    check(len(losses) == 12 and all(math.isfinite(v) for v in losses),
          "train losses: %r" % losses)
    reference = UNet3D(plan)
    for name in (ckpt.MODEL_LATEST, ckpt.MODEL_BEST, "model_ep_0001", "model_ep_0002"):
        params, opt_state, meta = ckpt.load_checkpoint(out, name)
        reference.load_state_dict(ckpt.params_from_flax(params), strict=True)
        check(all(torch.isfinite(p).all() for p in reference.parameters()),
              "%s has non-finite weights" % name)
        check((opt_state is not None) == (name == ckpt.MODEL_LATEST),
              "%s: optimizer state %s" % (name, "missing" if opt_state is None else "present"))
    again = Trainer(plan, cfg, out, device=DEVICE)
    again.fit(train_ds, val_ds)
    check(again.history == [], "a second fit trained again: %r" % again.history)

    # the trained model handed to serving
    pkg = release_model(out, plan, os.path.join(work, "train_release"), make_tarball=True)
    model, plan2 = load_released_model(os.path.dirname(pkg), device=DEVICE)
    predictor = SlidingWindowPredictor(model, plan2, device=DEVICE)
    for k in kernels.KERNELS.values():
        k.launches = 0
    pred = predictor.predict_case_full(synthetic_flair(FLAGSHIP_SHAPE, seed=50),
                                       FLAGSHIP_SPACING, apply_n4=True)
    torch.cuda.synchronize()
    check(all(tuple(o.shape) == FLAGSHIP_SHAPE and torch.isfinite(o.float()).all() for o in pred),
          "the released model's prediction is malformed")
    per_volume = len(ALL_FLIPS) * (4 * plan.num_pools + 2)
    check(kernels.instance_norm_stats.launches == per_volume
          and kernels.instance_norm_act.launches == per_volume,
          "the released model made %d/%d K1 launches, expected %d each"
          % (kernels.instance_norm_stats.launches, kernels.instance_norm_act.launches,
             per_volume))
    del model, predictor, pred, again

    # the step taken apart, on one batch
    np_rng = np.random.RandomState(0)
    images, labels = trainer._to_device(*train_ds.sample_batch(np_rng, cfg.batch_size,
                                                               cfg.oversample_fg))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for k in kernels.KERNELS.values():
        k.launches = 0
    step_s = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(images, labels, 1e-4, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        check(math.isfinite(float(loss)), "a timed step's loss is %r" % float(loss))
    step_launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    check(step_launches == trainer_launches(plan, len(step_s)),
          "the timed train steps' launches: %r" % step_launches)
    peak = {}
    for remat in (True, False):
        trainer.model.remat = remat
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        noaug = trainer.loss(images, labels)
        grads = torch.autograd.grad(noaug, trainer.params, allow_unused=True)
        torch.cuda.synchronize()
        peak["remat_on" if remat else "remat_off"] = torch.cuda.max_memory_allocated() / 1e9
        del noaug, grads
    trainer.model.remat = True

    sections, by_name = {}, {}
    _, sections["augment"], _ = _profiled(lambda: trainer.augment(images, labels, gen), by_name)
    loss, sections["forward"], _ = _profiled(lambda: trainer.loss(images, labels), by_name)
    grads, sections["backward"], _ = _profiled(
        lambda: torch.autograd.grad(loss, trainer.params, allow_unused=True), by_name)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainer.params, grads)]
    _, sections["optimizer"], _ = _profiled(lambda: trainer.update(grads, 1e-4), by_name)
    section_ms = {k: sum(v.values()) for k, v in sections.items()}
    step_dev_ms = sum(section_ms.values())
    groups = {g: sum(sections[s][g] for s in sections) for g in sections["forward"]}

    # the warp alone (order 1 on the image, order 0 on the label) on one patch
    from deepwmh_tpu_torch.ops.warp import affine_warp, rotation_matrix

    mat = torch.cat([rotation_matrix([0.3, -0.2, 0.1]).T / 1.1, torch.zeros(3, 1)], dim=1)
    center = [(s - 1) / 2.0 for s in plan.patch_size]
    warp_ms = cuda_ms(lambda: (affine_warp(images[0], mat, order=1, center=center),
                               affine_warp(labels[0].float(), mat, order=0, center=center)),
                      iters=5)
    fwd = forward_flops(plan, tuple(plan.patch_size), cfg.batch_size)
    recompute = cfg.batch_size * remat_flops(plan, tuple(plan.patch_size))
    med = float(np.median(step_s[1:]))
    emit({"phase": "train", "nvidia_smi": smi, "plan": "default_plan_1mm_iso",
          "step_launches": step_launches,
          "patch": list(plan.patch_size), "batch": cfg.batch_size, "cases": len(train_ds),
          "epochs": cfg.epochs, "batches_per_epoch": cfg.batches_per_epoch,
          "setup_s": setup_s, "fit_s": fit_s, "fit_peak_device_gb": fit_peak,
          "fit_launches": fit_launches, "losses": losses, "best_metric": best,
          "val_metrics": [h["metric"] for h in trainer.history],
          "s_per_step_median": med, "s_per_step": step_s, "peak_device_gb": peak,
          "step_forward_tflop": fwd / 1e12,
          "step_tflop_with_backward_and_remat": (3 * fwd + recompute) / 1e12,
          "step_tflop_per_s": (3 * fwd + recompute) / med / 1e12,
          "step_bf16_peak_share": (3 * fwd + recompute) / med / BF16_FLOP_PER_S,
          "step_device_ms_by_section": section_ms, "step_device_ms": step_dev_ms,
          "step_device_ms_by_group": groups, "step_device_ms_by_section_and_group": sections,
          "step_top_kernels_ms": [[n[:90], ms] for n, ms in
                                  sorted(by_name.items(), key=lambda kv: -kv[1])[:12]],
          "warp_pair_ms": warp_ms})
    return step_launches


def phase_train_card_vs_cpu(kernels, work):
    """One Trainer step from the same weights and batch on the card and on
    the CPU: a small plan in f32 with TF32 off, augmentation off."""
    import torch

    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

    plan = _small_plan()
    cfg = TrainConfig(epochs=1, batches_per_epoch=1, augment=False)
    rng = np.random.RandomState(3)
    images = rng.randn(2, *plan.patch_size).astype(np.float32)
    labels = (images + 0.5 * rng.randn(*images.shape) > 1.2).astype(np.int32)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        trainers, result = {}, {}
        for dev in ("cpu", DEVICE):
            tr = Trainer(plan, cfg, os.path.join(work, "tcc_" + dev), device=dev,
                         dtype=torch.float32)
            if dev == "cpu":
                tr.init_state(0)
                start = tr.state_trees()
            else:
                tr.load_state_trees(*start)
            before = {name: k.launches for name, k in kernels.KERNELS.items()}
            loss = tr.train_step(*tr._to_device(images, labels), tr.lr_at(0))
            result[dev] = float(loss)
            if dev == DEVICE:
                torch.cuda.synchronize()
                launched = {name: k.launches - before[name]
                            for name, k in kernels.KERNELS.items()}
                check(launched == trainer_launches(plan, 1),
                      "the card's train step launched %r" % launched)
            trainers[dev] = tr
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    # the same card step under torch's own TF32 settings: what TF32 alone
    # moves (recorded, not checked)
    tr = Trainer(plan, cfg, os.path.join(work, "tcc_tf32"), device=DEVICE, dtype=torch.float32)
    tr.load_state_trees(*start)
    loss_tf32 = float(tr.train_step(*tr._to_device(images, labels), tr.lr_at(0)))
    row = {"loss_card": result[DEVICE], "loss_cpu": result["cpu"],
           "loss_rel": abs(result[DEVICE] - result["cpu"]) / abs(result["cpu"]),
           "torch_tf32_defaults": {"cudnn": saved[0], "matmul": saved[1]},
           "loss_rel_torch_tf32_defaults": abs(loss_tf32 - result["cpu"]) / abs(result["cpu"])}
    for what in ("params", "trace"):
        cpu = [t.detach() for t in getattr(trainers["cpu"], what)]
        card = [t.detach().cpu() for t in getattr(trainers[DEVICE], what)]
        scale = max(float(t.abs().max()) for t in cpu)
        row[what + "_max_abs"] = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
        row[what + "_scale"] = scale
        check(row[what + "_max_abs"] <= 1e-5 * scale, "%s card vs CPU: %r" % (what, row))
    check(row["loss_rel"] <= 1e-5, "train loss card vs CPU: %r" % row)
    emit({"phase": "train_card_vs_cpu", "plan": "small f32, no TF32", "patch": plan.patch_size,
          **row})


# ---------------------------------------------------------------------- #
# group registration (no kernel of its own; the learned mode runs K1's two
# kernels in its network's forward passes)
# ---------------------------------------------------------------------- #


def smooth_velocity(shape, amp, seed):
    """A smooth [3, *shape] velocity (voxels) from a numpy seed: per
    component a product of one-period sinusoids with random phases."""
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(0, 2 * np.pi, s, dtype=np.float32) for s in shape],
                    indexing="ij")
    out = []
    for _ in range(3):
        ph = rng.uniform(0, 2 * np.pi, 3)
        out.append(amp * np.sin(g[0] + ph[0]) * np.sin(g[1] + ph[1]) * np.cos(g[2] + ph[2]))
    return np.stack(out).astype(np.float32)


def small_affine(shape, spacing, seed):
    """A physical 3x4 affine near identity about the volume's centre: a few
    degrees of rotation, a few percent of scale, a few mm of shift."""
    from deepwmh_tpu_torch.ops.warp import rotation_matrix

    rng = np.random.RandomState(seed)
    R = rotation_matrix(rng.uniform(-0.05, 0.05, 3).astype(np.float32)).numpy()
    A = R * (1.0 + rng.uniform(-0.03, 0.03, 3)).astype(np.float32)
    c = (np.asarray(shape, np.float32) - 1) / 2 * np.asarray(spacing, np.float32)
    t = rng.uniform(-2.0, 2.0, 3).astype(np.float32)
    return np.concatenate([A, (c - A @ c + t)[:, None]], axis=1).astype(np.float32)


def registration_cohort(folder, shape, spacing, n_targets=2, seed=0, device="cpu",
                        amp=None):
    """The group-registration inputs: two sources, ``synthetic_atlas`` from
    seeds ``seed`` and ``seed + 1``; ``n_targets`` targets, the first atlas
    warped by a seeded diffeomorphism (exp of a smooth velocity of about
    ``amp`` voxels, shape/40 by default) then a small affine, each label
    warped the same way with order 0. Writes .nii.gz images and labels and
    src.csv / tgt.csv (case, data); returns (src_csv, tgt_csv, {case:
    (image path, label path)})."""
    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.core.manifests import write_csv_simple
    from deepwmh_tpu_torch.registration.priors import synthetic_atlas
    from deepwmh_tpu_torch.registration.svf import apply_affine_svf, scaling_and_squaring

    os.makedirs(folder, exist_ok=True)
    hdr = nifti.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms(spacing)
    cases = {}

    def write(case, image, label):
        paths = tuple(os.path.join(folder, "%s_%s.nii.gz" % (case, k)) for k in ("img", "lbl"))
        nifti.save_nifti(image, hdr, paths[0])
        nifti.save_nifti(label, hdr, paths[1])
        cases[case] = paths

    atlas = [synthetic_atlas(shape, spacing, seed=seed + i) for i in range(2)]
    for i, (image, label) in enumerate(atlas):
        write("src%d" % i, image, label)
    amp = max(shape) / 40.0 if amp is None else amp
    img = torch.from_numpy(atlas[0][0]).to(device)
    lbl = torch.from_numpy(atlas[0][1]).to(device)
    for t in range(n_targets):
        v = torch.from_numpy(smooth_velocity(shape, amp, seed=100 + t)).to(device)
        disp = scaling_and_squaring(v, 6)
        mat = small_affine(shape, spacing, seed=200 + t)
        image = apply_affine_svf(img, mat, disp, shape, spacing, spacing, order=1)
        label = apply_affine_svf(lbl, mat, disp, shape, spacing, spacing, order=0)
        write("tgt%d" % t, image.cpu().numpy(), label.cpu().numpy())
    csvs = []
    for kind in ("src", "tgt"):
        names = sorted(c for c in cases if c.startswith(kind))
        csvs.append(os.path.join(folder, kind + ".csv"))
        write_csv_simple(csvs[-1], {"case": names, "data": [cases[c][0] for c in names]})
    return csvs[0], csvs[1], cases


REG_PRESET = ["--keep-deformation", "--allow-quick-registration", "--allow-large-deformations"]
REG_BRAIN_DICE_FLOOR = 0.85  # propagated brain mask against the target's own
LEARNED_STEPS = 30  # of LearnedRegConfig's 300


def learned_stats_shapes(grid_shape):
    """Every (spatial shape, C, calls per forward) the learned registration
    network hands K1 on a template grid of ``grid_shape``."""
    from deepwmh_tpu_torch.registration.learned import LearnedRegConfig, _reg_plan
    from deepwmh_tpu_torch.unet.plan import features_per_stage

    cfg = LearnedRegConfig()
    stride = 2 ** cfg.num_pools
    shape = [-(-s // stride) * stride for s in grid_shape]
    plan = _reg_plan(shape, cfg)
    feats = features_per_stage(plan)
    out = []
    for i in range(plan.num_pools + 1):
        if i:
            shape = [s // 2 for s in shape]
        out.append((tuple(shape), feats[i], 2 if i == plan.num_pools else 4))
    return out


def template_grid(shape, spacing, out_spacing=(2.0, 2.0, 2.0)):
    return tuple(int(s * sp / o) for s, sp, o in zip(shape, spacing, out_spacing))


def phase_k1_learned(kernels):
    """K1's two kernels at every [1, M, C] of the learned registration
    network on the flagship cohort's 2 mm template grid (C = 8, 16, 32 and
    the bottleneck), bf16: statistics within 1e-4 of the plain version and
    the same bits on a second call, the apply pass bit for bit against the
    plain chain, with the kernels', the plain versions' and torch.var_mean's
    times and the memory bound. Returns per-forward totals."""
    import torch

    stats, act = kernels.instance_norm_stats, kernels.instance_norm_act
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    slope = float(torch.tensor(0.01, dtype=torch.bfloat16))
    grid = template_grid(FLAGSHIP_SHAPE, FLAGSHIP_SPACING)
    total = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "act_ms",
                              "act_plain_ms", "act_bound_ms")}
    max_err = 0.0
    calls_per_forward = 0
    for spatial, c, calls in learned_stats_shapes(grid):
        x = (torch.randn((1,) + spatial + (c,), generator=gen, device=DEVICE) * 2
             + 0.5).to(torch.bfloat16)
        mean, var = stats(x)
        again = stats(x)
        ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(mean, ref_mean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(var, ref_var, atol=1e-4, rtol=1e-4)
        check(torch.equal(mean, again[0]) and torch.equal(var, again[1]),
              "K1 gave other bits on a second call at %s" % ([1, spatial, c],))
        err = max(float((mean - ref_mean).abs().max()), float((var - ref_var).abs().max()))
        mul = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
        bias = torch.linspace(-0.5, 0.5, c, device=DEVICE)
        out = act(x, mean, mul, bias, slope)
        want = kernels.instance_norm_act_reference(x, mean, mul, bias, slope)
        torch.cuda.synchronize()
        check(torch.equal(out, want), "K1's apply pass differs from the plain chain at %s"
              % ([1, spatial, c],))
        m = x.numel() // c
        x3 = x.view(1, m, c)
        row = {
            "ms": cuda_ms(lambda: stats(x)),
            "plain_ms": cuda_ms(lambda: kernels.instance_norm_stats_reference(x)),
            "library_ms": cuda_ms(lambda: torch.var_mean(x3, dim=1, correction=0)),
            "bound_ms": max((x.numel() * 2 + 2 * c * 4) / HBM_BYTES_PER_S,
                            3 * x.numel() / F32_FLOP_PER_S) * 1e3,
            "act_ms": cuda_ms(lambda: act(x, mean, mul, bias, slope)),
            "act_plain_ms": cuda_ms(
                lambda: kernels.instance_norm_act_reference(x, mean, mul, bias, slope)),
            "act_bound_ms": (2 * x.numel() * 2 + 3 * c * 4) / HBM_BYTES_PER_S * 1e3,
        }
        emit({"phase": "k1_learned", "shape_nmc": [1, m, c], "calls_per_forward": calls,
              "max_abs_err": err, **row})
        for k in total:
            total[k] += calls * row[k]
        max_err = max(max_err, err)
        calls_per_forward += calls
        del x, x3, mean, var, out, want
    return {"learned_forward_calls": calls_per_forward, "learned_max_abs_err": max_err,
            **{"learned_forward_" + k: v for k, v in total.items()}}


def _lncc_full(a, b):
    from deepwmh_tpu_torch.registration.similarity import lncc, winsorize_rescale

    return float(lncc(winsorize_rescale(a), winsorize_rescale(b), radius=2))


def _pair_checks(out, cases, pairs, dev, gain=True):
    """Per pair: the artifacts read back (matrix, image, warp), LNCC with
    the target before and after, and the source label carried over by
    apply_pair_transforms against the target's own, beside the unregistered
    overlap. Raises below the floor and, with ``gain``, unless LNCC and the
    overlap rose."""
    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.registration.group import apply_pair_transforms

    rows = {}
    for pair in pairs:
        s, t = pair.split("_to_")
        with open(os.path.join(out, pair, "affine.json")) as f:
            meta = json.load(f)
        mat = np.asarray(meta["matrix"], np.float32)
        check(mat.shape == (3, 4) and np.isfinite(mat).all() and meta["deformable"]
              and meta["warp_kept"], "%s: affine.json %r" % (pair, meta))
        warped = nifti.load_nifti_simple(os.path.join(out, pair + ".nii.gz"))
        warp = nifti.load_nifti_simple(os.path.join(out, pair, "warp.nii.gz"))
        check(warped.shape == tuple(meta["fixed_shape"]) and np.isfinite(warped).all(),
              "%s: warped image %s" % (pair, warped.shape))
        check(warp.shape == tuple(meta["fixed_shape"]) + (3,) and np.isfinite(warp).all(),
              "%s: warp %s" % (pair, warp.shape))
        target = torch.from_numpy(nifti.load_nifti_simple(cases[t][0])).to(dev)
        source = torch.from_numpy(nifti.load_nifti_simple(cases[s][0])).to(dev)
        before = _lncc_full(target, source)
        after = _lncc_full(target, torch.from_numpy(warped).to(dev))
        prop = os.path.join(out, "prop_%s.nii" % pair)
        apply_pair_transforms(os.path.join(out, pair), [cases[s][1]], [prop], device=dev)
        lab, want = nifti.load_nifti_simple(prop), nifti.load_nifti_simple(cases[t][1])
        src_lab = nifti.load_nifti_simple(cases[s][1])
        row = {"lncc_before": before, "lncc_after": after,
               "brain_dice": _dice(lab > 0.5, want > 0.5),
               "brain_dice_unregistered": _dice(src_lab > 0.5, want > 0.5),
               "class_agreement": float((lab == want).mean()),
               "class_agreement_unregistered": float((src_lab == want).mean()),
               "warp_max_vox": float(np.abs(warp).max())}
        check(row["brain_dice"] >= REG_BRAIN_DICE_FLOOR, "%s: propagated brain Dice %r"
              % (pair, row))
        check(not gain or (after > before
                           and row["brain_dice"] > row["brain_dice_unregistered"]),
              "%s: registration gained nothing: %r" % (pair, row))
        rows[pair] = row
    return rows


def _run_cli(module, args, timeout=900):
    """``python -m module args --device DEVICE`` from the checkout; returns
    (stdout, wall seconds), raising unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module] + args + ["--device", DEVICE],
                          cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, "%s exited %d:\n%s" % (module, proc.returncode,
                                                       (proc.stdout + proc.stderr)[-3000:]))
    return proc.stdout, wall


def _rerun_registers_nothing(src_csv, tgt_csv, out, warm_start):
    """The same registration again in this process (the training-prep
    preset): every pair's probes pass and no file of ``out`` changes.
    Returns its wall seconds."""
    from deepwmh_tpu_torch.core.manifests import load_csv_simple
    from deepwmh_tpu_torch.registration.group import GroupRegistration

    src, tgt = (load_csv_simple(p, ["case", "data"]) for p in (src_csv, tgt_csv))
    stamps = {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
              for d, _, fs in os.walk(out) for f in fs}
    t0 = time.perf_counter()
    GroupRegistration(list(zip(src["case"], src["data"])), list(zip(tgt["case"], tgt["data"])),
                      out, keep_deformation=True, quick=True, large_deformation=True,
                      warm_start=warm_start, device=DEVICE).launch(verbose=False)
    wall = time.perf_counter() - t0
    now = {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
           for d, _, fs in os.walk(out) for f in fs}
    check(now == stamps, "the re-run changed %s" % sorted(set(now.items()) ^ set(stamps.items()))[:4])
    return wall


def _profile_steps(fn, steps):
    """fn() (``steps`` optimiser steps) twice: its wall per step without the
    profiler, then under it the CUDA kernels launched and their summed time
    per step, and the device's busy share of the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device activity only: the host-side op records of thousands of
    # launches a step would cost more than the steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(spans, "the profiler saw no device activity")
    dev_ms = sum(spans) / 1e3 / steps
    return {"wall_ms_per_step": wall_ms, "launches_per_step": len(spans) / steps,
            "device_ms_per_step": dev_ms, "busy_share": dev_ms / wall_ms}


def reg_step_readings(fixed, moving, acfg, scfg, dev, steps=5, batch=1):
    """Launches per Adam step, device and wall ms per step (and wall per
    pair) and the busy share at every pyramid level of the preset, affine
    (rigid, strided MI where the level has the samples) and SVF
    (first-order and exact), with the pair stacked ``batch`` times as one
    batch (timing needs no distinct pairs); and the peak memory."""
    import torch

    from deepwmh_tpu_torch.registration.affine import _center_of_mass, _optimize_level
    from deepwmh_tpu_torch.registration.affine import spacing_tensor
    from deepwmh_tpu_torch.registration.similarity import downsample_mean, winsorize_rescale
    from deepwmh_tpu_torch.registration.svf import _optimize_svf_level

    torch.cuda.reset_peak_memory_stats()
    f, m = winsorize_rescale(fixed.float()), winsorize_rescale(moving.float())
    lead = ()
    if batch > 1:
        lead = (batch,)
        f, m = (t.expand(lead + tuple(t.shape)).contiguous() for t in (f, m))
    sp = spacing_tensor(FLAGSHIP_SPACING, dev)
    center = _center_of_mass(f, sp)
    out = {}

    def reading(shape, fn, **extra):
        row = _profile_steps(fn, steps)
        return dict(shape=list(shape[-3:]), **extra, **row,
                    wall_ms_per_step_per_pair=row["wall_ms_per_step"] / batch)

    for shrink in acfg.shrinks:
        fs, ms = downsample_mean(f, shrink), downsample_mean(m, shrink)
        stride = acfg.sample_stride if math.prod(fs.shape[-3:]) // acfg.sample_stride >= 4096 \
            else 1
        for mode, n in (("rigid", 6), ("affine", 12)):
            p0 = torch.zeros(lead + (n,), device=dev)
            out["affine_%s_shrink%d" % (mode, shrink)] = reading(
                fs.shape, lambda: _optimize_level(fs, ms, sp * shrink, sp * shrink, p0, center,
                                                  mode=mode, iters=steps, lr=0.05, metric="mi",
                                                  mi_bins=acfg.mi_bins, lncc_radius=4,
                                                  sample_stride=stride), sample_stride=stride)
    for shrink in scfg.shrinks:
        fs, ms = downsample_mean(f, shrink), downsample_mean(m, shrink)
        v0 = torch.zeros(lead + (3,) + tuple(fs.shape[-3:]), device=dev)
        for exact in (False, True):
            out["svf_%s_shrink%d" % ("exact" if exact else "first_order", shrink)] = reading(
                fs.shape, lambda: _optimize_svf_level(fs, ms, v0, iters=steps, lr=scfg.lr,
                                                      n_squaring=scfg.n_squaring,
                                                      lncc_radius=scfg.lncc_radius,
                                                      bending=scfg.bending_weight,
                                                      sigma=scfg.smooth_sigma_vox,
                                                      exact_exp_grad=exact))
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def reg_hot_loops(fixed, moving, scfg, acfg, dev):
    """Device ms of the registration's plain-torch hot loops at the
    preset's finest level, forward and backward: the 3-channel field gather
    of a squaring, the image gather of the warp, the LNCC box sums and the
    MI histogram (the evidence for a later kernel)."""
    import torch

    from deepwmh_tpu_torch.ops.warp import identity_grid, sample_channels, sample_volume
    from deepwmh_tpu_torch.registration.similarity import (
        downsample_mean,
        lncc,
        mutual_information,
    )

    shrink = scfg.shrinks[-1]
    f = downsample_mean(fixed.float(), shrink)
    m = downsample_mean(moving.float(), shrink)
    shape = tuple(f.shape)
    d = torch.from_numpy(smooth_velocity(shape, 2.0, 5)).to(dev).requires_grad_(True)
    grid = identity_grid(shape, dev)
    fm = f / f.max()
    mm = (m / m.max()).requires_grad_(True)
    n_mi = f.numel() // (acfg.sample_stride if f.numel() // acfg.sample_stride >= 4096 else 1)

    def back(fn):
        def run():
            out = fn()
            torch.autograd.grad(out.sum() if out.dim() else out, [t for t in (d, mm)
                                                                   if t.requires_grad],
                                allow_unused=True)
        return run

    with torch.no_grad():
        fwd = {
            "sample_channels_fwd": cuda_ms(lambda: sample_channels(d, grid + d)),
            "sample_volume_fwd": cuda_ms(lambda: sample_volume(m, grid + d)),
            "lncc_fwd": cuda_ms(lambda: lncc(fm, mm, radius=scfg.lncc_radius)),
            "mi_fwd": cuda_ms(lambda: mutual_information(fm.reshape(-1)[:n_mi],
                                                         mm.reshape(-1)[:n_mi])),
        }
    both = {
        "sample_channels_fwd_bwd": cuda_ms(back(lambda: sample_channels(d, grid + d)), iters=5),
        "lncc_fwd_bwd": cuda_ms(back(lambda: lncc(fm, mm, radius=scfg.lncc_radius)), iters=5),
        "mi_fwd_bwd": cuda_ms(back(lambda: mutual_information(fm.reshape(-1)[:n_mi],
                                                              mm.reshape(-1)[:n_mi])), iters=5),
    }
    return {"level_shape": list(shape), "mi_samples": n_mi, **fwd, **both}


REG_BATCH_PAIRS = 2  # the CLI's --batch-pairs: the 2 x 1 cohort's pairs as one batch
REG_STEP_BATCHES = (1, 2, 4)


def phase_group_register(kernels, work, smi):
    """The group CLI with the training-prep preset on a 2x1 flagship cohort
    in a subprocess, at the default --batch-pairs 1 (one pair at a time)
    and at --batch-pairs 2 (both pairs one batch), the artifacts of both
    checked, a re-run that skips both pairs; then one pair in
    this process stage by stage, the same pair as row 1 of a batch of two
    against it, the optimisers' launches per step and busy share with the
    pair stacked 1, 2 and 4 times, and the hot loops' times."""
    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.registration.affine import (
        _affine_core,
        resample_moving,
        spacing_tensor,
    )
    from deepwmh_tpu_torch.registration.group import (
        GroupRegistration,
        _pair_core_batch,
        _to_host,
    )
    from deepwmh_tpu_torch.registration.svf import _svf_core, apply_affine_svf

    root = os.path.join(work, "reg")
    t0 = time.perf_counter()
    src_csv, tgt_csv, cases = registration_cohort(os.path.join(root, "cohort"), FLAGSHIP_SHAPE,
                                                  FLAGSHIP_SPACING, n_targets=1, seed=0,
                                                  device=DEVICE)
    setup_s = time.perf_counter() - t0
    out_b1, out = os.path.join(root, "out_b1"), os.path.join(root, "out")
    for k in kernels.KERNELS.values():
        k.launches = 0
    pairs = ["src0_to_tgt0", "src1_to_tgt0"]
    stdout_b1, cli_s = _run_cli("deepwmh_tpu_torch.cli.group_register",
                                ["-s", src_csv, "-t", tgt_csv, "-o", out_b1] + REG_PRESET)
    check("%d registration pair(s)" % len(pairs) in stdout_b1,
          "group CLI output:\n%s" % stdout_b1[-2000:])
    checks_b1 = _pair_checks(out_b1, cases, pairs, DEVICE)
    stdout, cli_b2_s = _run_cli("deepwmh_tpu_torch.cli.group_register",
                                ["-s", src_csv, "-t", tgt_csv, "-o", out, "--batch-pairs",
                                 str(REG_BATCH_PAIRS)] + REG_PRESET)
    # one batch: one "[2/2] registering [...]" line naming both pairs
    chunk_lines = [line for line in stdout.splitlines() if "registering" in line]
    check("%d registration pair(s)" % len(pairs) in stdout and len(chunk_lines) == 1
          and all(p in chunk_lines[0] for p in pairs),
          "group CLI output:\n%s" % stdout[-2000:])
    checks = _pair_checks(out, cases, pairs, DEVICE)
    rerun_s = _rerun_registers_nothing(src_csv, tgt_csv, out, warm_start=False)

    # one pair in this process, stage by stage
    dev = torch.device(DEVICE)
    reg = GroupRegistration([], [], os.path.join(root, "staged"), quick=True,
                            large_deformation=True, device=dev)
    acfg, scfg = reg._pair_cfgs(FLAGSHIP_SHAPE)
    fixed = torch.from_numpy(nifti.load_nifti_simple(cases["tgt0"][0]).astype(np.float16)).to(dev)
    moving = torch.from_numpy(nifti.load_nifti_simple(cases["src1"][0]).astype(np.float16)).to(dev)
    sp = spacing_tensor(FLAGSHIP_SPACING, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stage = {}
    f, m = fixed.float(), moving.float()
    mat, aff_loss = _timed("affine", lambda: _affine_core(f, m, sp, sp, acfg), stage)
    disp, svf_loss = _timed("svf", lambda: _svf_core(
        f, resample_moving(m, mat, f.shape, sp, sp), scfg), stage)
    warped = _timed("final_resample", lambda: apply_affine_svf(
        m, mat, disp, f.shape, sp, sp).half(), stage)
    host = _timed("to_host", lambda: _to_host((mat, aff_loss, disp.half(), svf_loss, warped)),
                  stage)
    paths = reg._pair_paths("src1", "tgt0")
    _timed("write_artifacts", lambda: reg._write_pair(
        paths, nifti.get_nifti_header(cases["tgt0"][0]), FLAGSHIP_SPACING, FLAGSHIP_SPACING,
        FLAGSHIP_SHAPE, *host), stage)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the staged pair as row 1 of a batch of two (src0_to_tgt0 as row 0)
    # against the staged one-pair run
    moving0 = torch.from_numpy(nifti.load_nifti_simple(cases["src0"][0]).astype(np.float16)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    batch_stage = {}
    bouts = _timed("pair_core_batch", lambda: _to_host(_pair_core_batch(
        torch.stack([fixed, fixed]), torch.stack([moving0, moving]), sp, sp, acfg, scfg, True)),
        batch_stage)
    batch_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    label = torch.from_numpy(nifti.load_nifti_simple(cases["src1"][1])).to(dev)

    def warped_brain(mat_, disp16_):
        return apply_affine_svf(label, mat_, torch.from_numpy(disp16_).to(dev), FLAGSHIP_SHAPE,
                                sp, sp, order=0).cpu().numpy() > 0.5

    batched = {"pairs": ["src0_to_tgt0", "src1_to_tgt0"], "s": batch_stage["pair_core_batch"],
               "peak_device_gb": batch_peak_gb,
               "matrix_max_diff": float(np.abs(bouts[0][1] - host[0]).max()),
               "disp_max_diff_vox": float(np.abs(bouts[2][1].astype(np.float32)
                                                 - host[2].astype(np.float32)).max()),
               "warped_brain_dice": _dice(warped_brain(bouts[0][1], bouts[2][1]),
                                          warped_brain(host[0], host[2])),
               "affine_loss": [float(bouts[1][1]), host[1]],
               "svf_loss": [float(bouts[3][1]), host[3]]}
    check(batched["warped_brain_dice"] >= REG_BRAIN_DICE_FLOOR
          and np.isfinite(bouts[0]).all() and np.isfinite(bouts[4].astype(np.float32)).all(),
          "the staged pair as a batch row: %r" % batched)
    del bouts
    steps = {"B%d" % b: reg_step_readings(fixed, moving, acfg, scfg, dev, batch=b)
             for b in REG_STEP_BATCHES}
    hot = reg_hot_loops(fixed, moving, scfg, acfg, dev)
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    check(all(v == 0 for v in launches.values()), "the SVF path launched a kernel: %r" % launches)
    emit({"phase": "group_register", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "preset": REG_PRESET, "affine_cfg": [list(acfg.shrinks), list(acfg.iters)],
          "svf_cfg": [list(scfg.shrinks), list(scfg.iters), scfg.n_squaring,
                      scfg.exact_polish_iters],
          "pairs": len(pairs), "batch_pairs": REG_BATCH_PAIRS, "setup_s": setup_s,
          "cli_wall_s": cli_s, "s_per_pair_cli": cli_s / len(pairs),
          "cli_wall_s_b2": cli_b2_s, "s_per_pair_cli_b2": cli_b2_s / len(pairs),
          "rerun_s": rerun_s, "staged_pair_s": stage, "staged_pair_sum_s": sum(stage.values()),
          "staged_peak_device_gb": peak_gb, "pairs_checked_b1": checks_b1,
          "pairs_checked": checks,
          "batched_pair": batched, "steps": steps, "hot_loops_ms": hot})
    return src_csv, tgt_csv, cases, out, {"s_per_pair": cli_s / len(pairs), "stage": stage}


def phase_warm(work, smi, src_csv, tgt_csv, cases, out):
    """--svf-warm-start on a copy of the group output without the second
    source's pair: the auxiliary pair and one warm pair registered, the
    same checks on the warm pair, and a re-run that registers nothing."""
    warm_out = os.path.join(work, "reg", "out_warm")
    shutil.copytree(out, warm_out)
    for name in os.listdir(warm_out):
        if name.startswith("src1_to_"):
            path = os.path.join(warm_out, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    stdout, wall = _run_cli("deepwmh_tpu_torch.cli.group_register",
                            ["-s", src_csv, "-t", tgt_csv, "-o", warm_out, "--svf-warm-start"]
                            + REG_PRESET)
    check(stdout.count("[warm ") == 1 and stdout.count("registering") == 2,
          "warm CLI output:\n%s" % stdout[-2000:])
    check(os.path.isfile(os.path.join(warm_out, "_warm_aux", "src1_to_src0", "affine.json")),
          "no auxiliary pair under _warm_aux")
    # the first source's pairs are group_register's, copied: check the warm ones
    checks = _pair_checks(warm_out, cases, ["src1_to_tgt0"], DEVICE)
    rerun_s = _rerun_registers_nothing(src_csv, tgt_csv, warm_out, warm_start=True)
    emit({"phase": "warm", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "cli_wall_s": wall, "pairs_registered": 2, "rerun_s": rerun_s,
          "pairs_checked": checks})


@contextlib.contextmanager
def learned_timing():
    """Times the learned registration's parts while it runs: the affine
    template, the network's training, each pair's forward (``register``)
    and the first training step, each between two synchronisations.
    Yields the dict they are summed into."""
    import torch

    from deepwmh_tpu_torch.registration import learned, learned_group

    timing = {"template_s": 0.0, "train_s": 0.0, "register_s": [], "first_step_s": None}
    build, train, register = (learned_group.build_affine_template,
                              learned.LearnedRegistration.train,
                              learned.LearnedRegistration.register)
    step = learned.LearnedRegistration.train_step

    def synced(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if isinstance(timing[key], list):
                timing[key].append(dt)
            else:
                timing[key] = (timing[key] or 0.0) + dt
            return res
        return run

    def first_step(self, *a, **kw):
        if timing["first_step_s"] is not None:
            return step(self, *a, **kw)
        return synced("first_step_s", step)(self, *a, **kw)

    learned_group.build_affine_template = synced("template_s", build)
    learned.LearnedRegistration.train = synced("train_s", train)
    learned.LearnedRegistration.register = synced("register_s", register)
    learned.LearnedRegistration.train_step = first_step
    try:
        yield timing
    finally:
        learned_group.build_affine_template = build
        learned.LearnedRegistration.train = train
        learned.LearnedRegistration.register = register
        learned.LearnedRegistration.train_step = step


def phase_learned(kernels, work, smi, cases):
    """LearnedGroupRegistration at full width on the 2x1 cohort with the
    training cut to LEARNED_STEPS steps: K1's launches from its forward
    passes (this run only), the artifacts checked, seconds per template
    volume, per training step and per pair."""
    import torch

    from deepwmh_tpu_torch.registration import learned, learned_group

    sources = [(c, cases[c][0]) for c in ("src0", "src1")]
    targets = [(c, cases[c][0]) for c in ("tgt0",)]
    out = os.path.join(work, "reg", "out_learned")
    with learned_timing() as timing:
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = learned_group.LearnedGroupRegistration(
            sources, targets, out, reg_cfg=learned.LearnedRegConfig(steps=LEARNED_STEPS),
            device=DEVICE)
        lg.launch(verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pairs = ["src0_to_tgt0", "src1_to_tgt0"]
    blocks = 4 * lg.reg.plan.num_pools + 2
    for name in ("instance_norm_stats", "instance_norm_act"):
        check(launches[name] == len(pairs) * blocks,
              "%s launched %d times on the learned path, expected %d (%d pairs x %d blocks)"
              % (name, launches[name], len(pairs) * blocks, len(pairs), blocks))
    for pair in pairs:
        check(lg.pair_complete(*pair.split("_to_")), "%s incomplete" % pair)
        with open(os.path.join(out, pair, "affine.json")) as f:
            check(json.load(f)["method"] == "learned", "%s: not a learned pair" % pair)
    # 30 of 300 training steps: the floor, not a gain over the unregistered
    checks = _pair_checks(out, cases, pairs, DEVICE, gain=False)
    n_vols = len(sources) + len(targets)
    s_per_step = timing["train_s"] / LEARNED_STEPS
    reg_s = timing["register_s"]
    per_pair = (wall - timing["template_s"] - timing["train_s"]) / len(pairs)
    row = {"phase": "learned", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
           "template_grid": list(lg.reg.grid_shape), "steps": LEARNED_STEPS,
           "steps_of": learned.LearnedRegConfig().steps, "wall_s": wall,
           "launches": launches, "peak_device_gb": peak_gb,
           "template_s": timing["template_s"], "s_per_template_volume": timing["template_s"] / n_vols,
           "train_s": timing["train_s"], "s_per_step": s_per_step,
           "first_step_s": timing["first_step_s"],
           "register_s": reg_s, "s_per_pair": per_pair,
           "pairs_checked": checks}
    emit(row)
    return launches, row


def phase_priors(work, smi, cases):
    """The priors CLI (the synthetic 2 mm atlas it writes, --quick) on one
    flagship subject: label1/label2 read back, brain Dice against the
    subject's own label above the floor."""
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.core.manifests import write_csv_simple

    root = os.path.join(work, "priors")
    os.makedirs(root)
    csv = os.path.join(root, "in.csv")
    write_csv_simple(csv, {"case": ["tgt0"], "flair": [cases["tgt0"][0]]})
    stdout, wall = _run_cli("deepwmh_tpu_torch.cli.priors",
                            ["--make-atlas", os.path.join(root, "atlas"), "-i", csv, "-o",
                             os.path.join(root, "out"), "--quick"])
    l1 = nifti.load_nifti_simple(os.path.join(root, "out", "tgt0_label1.nii.gz"))
    l2 = nifti.load_nifti_simple(os.path.join(root, "out", "tgt0_label2.nii.gz"))
    want = nifti.load_nifti_simple(cases["tgt0"][1])
    check(l1.shape == l2.shape == FLAGSHIP_SHAPE and set(np.unique(l2)) <= {0.0, 1.0, 2.0, 3.0},
          "priors: labels %s %s" % (l1.shape, np.unique(l2)))
    dice = _dice(l1 > 0.5, want > 0.5)
    check(dice >= REG_BRAIN_DICE_FLOOR, "priors: brain Dice %.4f" % dice)
    emit({"phase": "priors", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE), "cli_wall_s": wall,
          "brain_dice": dice, "class_agreement": float((l2 == want).mean())})


def phase_reg_card_vs_cpu(work):
    """One pair at 48x56x48 with a short schedule through _pair_core on the
    card (TF32 off) and on the CPU: the one-pair bars (the exact-gradient
    polish scatters with float atomics, so this is a tolerance), and the
    field gather of a squaring on the card against the CPU."""
    import torch

    from deepwmh_tpu_torch.ops.warp import identity_grid, sample_channels
    from deepwmh_tpu_torch.registration.affine import AffineConfig, spacing_tensor
    from deepwmh_tpu_torch.registration.group import _pair_core, _to_host
    from deepwmh_tpu_torch.registration.svf import SVFConfig

    shape = (48, 56, 48)
    _, _, cases = registration_cohort(os.path.join(work, "reg_small"), shape, (1.0, 1.0, 1.0),
                                      n_targets=1, seed=3, amp=1.5)
    from deepwmh_tpu_torch.core import nifti

    fixed = nifti.load_nifti_simple(cases["tgt0"][0]).astype(np.float16)
    moving = nifti.load_nifti_simple(cases["src1"][0]).astype(np.float16)
    acfg = AffineConfig(shrinks=(4,), iters=(2,))
    scfg = SVFConfig(shrinks=(4,), iters=(4,), n_squaring=4, exact_polish_iters=2)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        for dev in (DEVICE, "cpu"):
            sp = spacing_tensor((1.0, 1.0, 1.0), dev)
            outs[dev] = _to_host(_pair_core(torch.from_numpy(fixed).to(dev),
                                            torch.from_numpy(moving).to(dev), sp, sp, acfg, scfg,
                                            True))
        d = torch.from_numpy(smooth_velocity(shape, 3.0, 9))
        grid = identity_grid(shape)
        want = sample_channels(d, grid + d)
        got = sample_channels(d.to(DEVICE), (grid + d).to(DEVICE)).cpu()
        # fault C6: a Fortran-ordered upload gives the C-ordered upload's
        # bits on the card (C, F, then C again: the first-order SVF only, as
        # the exact polish scatters with float atomics)
        sp = spacing_tensor((1.0, 1.0, 1.0), DEVICE)
        lcfg = SVFConfig(shrinks=(4,), iters=(4,), n_squaring=4)
        layouts = [(order, _to_host(_pair_core(
            torch.from_numpy(np.asarray(fixed, order=order)).to(DEVICE),
            torch.from_numpy(np.asarray(moving, order=order)).to(DEVICE), sp, sp, acfg, lcfg,
            True))) for order in ("C", "F", "C")]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    card, cpu = outs[DEVICE], outs["cpu"]
    span = float(fixed.astype(np.float32).max() - fixed.astype(np.float32).min())
    row = {"matrix_max_abs": float(np.abs(card[0] - cpu[0]).max()),
           "affine_loss_card": card[1], "affine_loss_cpu": cpu[1],
           "disp_max_abs_vox": float(np.abs(card[2].astype(np.float32)
                                            - cpu[2].astype(np.float32)).max()),
           "warped_max_abs_of_range": float(np.abs(card[4].astype(np.float32)
                                                   - cpu[4].astype(np.float32)).max()) / span,
           "svf_loss_card": card[3], "svf_loss_cpu": cpu[3],
           "sample_channels_max_abs": float((got - want).abs().max())}
    # Adam's first steps are g / (|g| + eps): where g is near 0 (the
    # background) the card's summation order (the polish's float-atomic
    # scatters, the reductions) and the CPU's flip them, so the field is held
    # within 0.05 voxel on 99% of the voxels and 0.5 everywhere (on an H100:
    # 99.77% within 0.05, 0.160 at most; the warped image within 0.6% of the
    # range)
    gap = np.abs(card[2].astype(np.float32) - cpu[2].astype(np.float32))
    row["disp_share_within_0.05"] = float((gap <= 0.05).mean())
    check(row["matrix_max_abs"] <= 2e-3 and row["disp_share_within_0.05"] >= 0.99
          and row["disp_max_abs_vox"] <= 0.5 and row["warped_max_abs_of_range"] <= 1e-2,
          "registration card vs CPU: %r" % row)
    check(row["sample_channels_max_abs"] <= 1e-5, "sample_channels card vs CPU: %r" % row)

    def same(a, b):
        return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))

    row["c6_c_order_repeats"] = same(layouts[0][1], layouts[2][1])
    row["c6_fortran_equals_c"] = same(layouts[0][1], layouts[1][1])
    check(row["c6_c_order_repeats"] and row["c6_fortran_equals_c"],
          "a pair's bits depend on its upload's layout on the card: %r" % row)
    emit({"phase": "reg_card_vs_cpu", "shape": list(shape), "tf32": False, **row})


E2E_SHAPE = (64, 80, 64)  # the phantom cohorts' shape, 2 mm
E2E_SPACING = (2.0, 2.0, 2.0)
# train_e2e's cut: the production plan at E2E_SHAPE, 4 / 6 epochs of 10 steps
E2E_BUDGET = dict(stage2_epochs=4, stage3_epochs=6, batches_per_epoch=10)
E2E_REFS, E2E_PATIENTS = 3, 2  # 6 svf pairs: auto resolves to svf; stage-1 keeps K = 3
E2E_BATCH_PAIRS = E2E_REFS * E2E_PATIENTS  # the cohort's pairs registered as one batch
STAGE1_RECALL_FLOOR = 0.9  # tests/test_train_pipeline_e2e.py's floors
STAGE1_DICE_FLOOR = 0.15


def bit_diff(a, b) -> dict:
    """Differing f32 words and differing bits between two arrays."""
    x = (np.ascontiguousarray(a, np.float32).view(np.uint32)
         ^ np.ascontiguousarray(b, np.float32).view(np.uint32))
    return {"words": int((x != 0).sum()), "bits": int(np.unpackbits(x.view(np.uint8)).sum()),
            "of": int(x.size)}


def float_triangular_histogram(lo, w_lo, w_hi, nbins: int):
    """C3's control: N4's histogram summed as it was before it took fixed
    point, two f32 ``index_add_`` calls (float atomics on the card)."""
    import torch

    hist = torch.zeros(nbins + 1, dtype=torch.float32, device=lo.device)
    hist.index_add_(0, lo, w_lo).index_add_(0, lo + 1, w_hi)
    return hist[:nbins]


@contextlib.contextmanager
def float_n4_histogram():
    """N4 with ``float_triangular_histogram`` in place of its fixed-point
    sum while the block runs; yields the dict counting its calls."""
    from deepwmh_tpu_torch.ops import n4

    check(callable(getattr(n4, "_triangular_histogram", None)),
          "ops/n4.py has no _triangular_histogram to stand the control in for")
    saved, calls = n4._triangular_histogram, {"n": 0}

    def counted(*a):
        calls["n"] += 1
        return float_triangular_histogram(*a)

    n4._triangular_histogram = counted
    try:
        yield calls
    finally:
        n4._triangular_histogram = saved


def _stage1_scores(core, gt_paths) -> dict:
    """Stage-1 recall and Dice of each case against its lesion GT."""
    from deepwmh_tpu_torch.core import nifti

    out = {}
    for case, gp in gt_paths.items():
        seg = nifti.load_nifti_simple(os.path.join(
            core, "Stage_1_initial_segmentation", case, "segmentation_pp.nii.gz")) > 0.5
        gt = nifti.load_nifti_simple(gp) > 0.5
        out[case] = {"recall": float((seg & gt).sum()) / max(float(gt.sum()), 1.0),
                     "dice": _dice(seg, gt)}
    return out


def _checkpoint_stamps(folder) -> dict:
    return {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
            for d, _, fs in os.walk(folder) for f in fs if f.endswith(".msgpack")}


def n4_repeatability(work, out, core, cohort_flair, flair, pkg, pred):
    """Fault C3: N4 twice on a cohort FLAIR (against each other and against
    run_train's output) and once more on the flagship FLAIR (against the
    main path's output): the corrected images' differing bits, and the
    differing voxels of the stage-1 mask (stage-1 rerun on the second N4
    image with run_train's registered references) and of the three predict
    masks (the predict pipeline rerun with N4; ``pred`` is the main path's
    output folder, ``flair`` its first case). The control: the same
    readings with N4's histogram summed in f32 (``float_n4_histogram``),
    two runs against each other."""
    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.ops.n4 import n4_bias_correction
    from deepwmh_tpu_torch.pipeline.analysis import LesionAnalyzer
    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.release import load_released_model

    row = {}
    raw, hdr = nifti.load_nifti(cohort_flair)
    with torch.inference_mode():
        a, b = (n4_bias_correction(torch.from_numpy(raw).to(DEVICE)).cpu().numpy()
                for _ in range(2))
    saved = nifti.load_nifti_simple(os.path.join(out, "001_Preprocessed", "SUB00.nii.gz"))
    row["cohort_n4_twice"] = bit_diff(a, b)
    row["cohort_n4_vs_run_train"] = bit_diff(b, saved)
    second = os.path.join(work, "c3_SUB00_n4.nii.gz")
    nifti.save_nifti(b, hdr, second)
    refs = sorted(f[:-len("_to_SUB00.nii.gz")] for f in os.listdir(
        os.path.join(out, "002_Registration")) if f.endswith("_to_SUB00.nii.gz"))
    analyzer = LesionAnalyzer(os.path.join(work, "c3_stage1"), device=DEVICE)
    analyzer.add_case(
        "SUB00", second,
        [os.path.join(out, "002_Registration", "%s_to_SUB00.nii.gz" % r) for r in refs],
        [os.path.join(out, "003_Transformed", "%s_to_SUB00" % r, "label1.nii.gz") for r in refs],
        [os.path.join(out, "003_Transformed", "%s_to_SUB00" % r, "label2.nii.gz") for r in refs])
    analyzer.analyze_and_do_segmentation("+")
    seg2 = nifti.load_nifti_simple(os.path.join(work, "c3_stage1", "SUB00",
                                                "segmentation_pp.nii.gz"))
    seg1 = nifti.load_nifti_simple(os.path.join(core, "Stage_1_initial_segmentation", "SUB00",
                                                "segmentation_pp.nii.gz"))
    row["stage1_mask_voxels_differing"] = int((seg1 != seg2).sum())

    model, plan = load_released_model(pkg, device=DEVICE)
    predictor = SlidingWindowPredictor(model, plan, device=DEVICE)
    pre, seg_raw, seg_3mm, seg_fov, _ = predictor.predict_case_full(flair, FLAGSHIP_SPACING,
                                                                    apply_n4=True)
    row["flagship_n4_vs_main_path"] = bit_diff(pre.cpu().numpy(), nifti.load_nifti_simple(
        os.path.join(pred, "001_Preprocessed_Images", "case0_0000.nii.gz")))
    row["predict_mask_voxels_differing"] = {
        key: int((mask.cpu().numpy().astype(np.float32) != nifti.load_nifti_simple(
            os.path.join(pred, "002_Segmentations", folder, "case0.nii.gz"))).sum())
        for key, mask, folder in (("raw", seg_raw, "001_raw"), ("3mm", seg_3mm, "002_postproc_3mm"),
                                  ("fov", seg_fov, "003_postproc_fov"))}

    # the control: N4's f32 histogram, two runs against each other
    with float_n4_histogram() as calls, torch.inference_mode():
        a, b = (n4_bias_correction(torch.from_numpy(raw).to(DEVICE)).cpu().numpy()
                for _ in range(2))
        (pre_a, *masks_a), (pre_b, *masks_b) = (
            predictor.predict_case_full(flair, FLAGSHIP_SPACING, apply_n4=True)[:4]
            for _ in range(2))
    check(calls["n"] > 0, "the control never summed N4's histogram in f32")
    row["float_histogram_control"] = {
        "cohort_n4_twice": bit_diff(a, b),
        "flagship_n4_twice": bit_diff(pre_a.cpu().numpy(), pre_b.cpu().numpy()),
        "predict_mask_voxels_differing": {
            key: int((ma != mb).sum().item())
            for key, ma, mb in zip(("raw", "3mm", "fov"), masks_a, masks_b)},
        "histogram_calls": calls["n"]}
    # N4's histogram sums in fixed point: every rerun gives the same bits
    check(row["cohort_n4_twice"]["words"] == row["cohort_n4_vs_run_train"]["words"]
          == row["flagship_n4_vs_main_path"]["words"] == row["stage1_mask_voxels_differing"]
          == 0 and not any(row["predict_mask_voxels_differing"].values()),
          "N4 does not repeat bit for bit: %r" % row)
    return row


def released_model_checks(core, model_dir, pred_dir, test_case, test_flair) -> dict:
    """What train_e2e's short training does produce, held where it is
    exact: the installed release's held-out masks in this process equal
    the predict CLI's, its foreground probability is finite and not
    constant, and on each training case (TTA on) it gives stage 3-5's
    training-fit mask. Returns the held-out foreground range and the
    training-fit masks' voxels."""
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.release import load_released_model

    model, plan = load_released_model(model_dir, device=DEVICE)
    predictor = SlidingWindowPredictor(model, plan, device=DEVICE)
    _, seg_raw, seg_3mm, seg_fov, fg = predictor.predict_case_full(
        nifti.load_nifti_simple(test_flair), nifti.get_nifti_pixdim(test_flair), apply_n4=True)
    for mask, folder in ((seg_raw, "001_raw"), (seg_3mm, "002_postproc_3mm"),
                         (seg_fov, "003_postproc_fov")):
        cli = nifti.load_nifti_simple(os.path.join(pred_dir, "002_Segmentations", folder,
                                                   "%s.nii.gz" % test_case))
        check(np.array_equal(mask.cpu().numpy().astype(np.float32), cli),
              "the predict CLI's %s mask is not the released model's" % folder)
    fg = fg.cpu().numpy()
    check(np.isfinite(fg).all() and fg.min() >= 0.0 and fg.max() <= 1.0 and fg.max() > fg.min(),
          "held-out foreground probability out of [0, 1] or constant")
    fit_dir = os.path.join(core, "Stage_3_DCNN_training", "002_training_fit")
    trainfit = {}
    for f in sorted(os.listdir(fit_dir)):
        if not f.endswith(".nii.gz"):
            continue
        image = os.path.join(core, "Stage_1_initial_segmentation", f[:-len(".nii.gz")],
                             "preprocessed_image.nii.gz")
        seg, _ = predictor.predict_case(nifti.load_nifti_simple(image),
                                        nifti.get_nifti_pixdim(image))
        fit = nifti.load_nifti_simple(os.path.join(fit_dir, f))
        agree = float((seg.cpu().numpy().astype(np.float32) == fit).mean())
        check(agree > 0.999, "the release's fit of %s agrees with stage 3-5's on %.5f" % (f, agree))
        trainfit[f[:-len(".nii.gz")]] = {"voxels": int(fit.sum()), "agreement": agree}
    check(trainfit, "no stage 3-5 training fit found")
    return {"fg_min": float(fg.min()), "fg_max": float(fg.max()), "trainfit": trainfit}


def phase_train_e2e(kernels, work, smi, flair, pkg):
    """DeepWMH_train end to end through run_train on a phantom cohort at
    64x80x64 2 mm (3 references x 2 patients, 6 svf pairs, the production
    plan, 4 / 6 epochs of 10 steps), K1's and K2's launches from that run;
    the markers, registration artifacts, run_registration.sh, stage-1
    against the phantom's lesions, the release installed and predicted on a
    held-out patient through the CLIs in this process, a second run
    through the train CLI in a subprocess that trains nothing; seconds per
    stage and peak memory; then fault C3 (``n4_repeatability``). Returns
    (launches, the stage-2 plan)."""
    import torch

    from deepwmh_tpu_torch.cli import install_model as install_cli
    from deepwmh_tpu_torch.cli import predict as predict_cli
    from deepwmh_tpu_torch.cli.train import run_train
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.eval.e2e import write_test_cases
    from deepwmh_tpu_torch.eval.metrics import hard_dice_binary, voxel_precision_recall
    from deepwmh_tpu_torch.eval.phantom import write_cohort
    from deepwmh_tpu_torch.pipeline.multistage import PipelineMultistage, StageBudget
    from deepwmh_tpu_torch.registration.policy import select_registration_mode
    from deepwmh_tpu_torch.unet.plan import Plan, features_per_stage

    root = os.path.join(work, "train_e2e")
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    ref_csv, train_csv, gt_paths = write_cohort(data, shape=E2E_SHAPE, spacing=E2E_SPACING,
                                                n_ref=E2E_REFS, n_train=E2E_PATIENTS, seed=0,
                                                device=DEVICE)
    test_cases, test_gt = write_test_cases(data, E2E_SHAPE, E2E_SPACING, E2E_REFS, E2E_PATIENTS,
                                           1, 0, device=DEVICE)
    (test_case, test_flair), = test_cases
    setup_s = time.perf_counter() - t0
    mode = select_registration_mode(E2E_REFS, E2E_PATIENTS, volume_voxels=math.prod(E2E_SHAPE))
    check(mode == "svf", "auto resolved to %s at %d x %d pairs of %s"
          % (mode, E2E_REFS, E2E_PATIENTS, E2E_SHAPE))

    out = os.path.join(root, "out")
    budget = StageBudget(**E2E_BUDGET)
    stats = {}
    for k in kernels.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core = run_train(ref_csv, train_csv, out, budget=budget, device=DEVICE, stage_stats=stats,
                     batch_pairs=E2E_BATCH_PAIRS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    # each step and stage resets the card's peak counter when it starts
    peak_gb = max(st.get("peak_gb", 0.0) for st in stats.values())
    for name in ("instance_norm_stats", "instance_norm_act", "median3"):
        check(launches[name] > 0, "%s was not launched on the train path" % name)
    check(launches["median3"] == E2E_PATIENTS, "K2 launched %d times, one per case expected"
          % launches["median3"])

    for m in ("STAGE_1_INITIAL_SEGMENTATION", "STAGE_2-3_TRAINING_DENOISER",
              "STAGE_2-4_RAW_SOFTMAX", "STAGE_2-5_MASKED_SOFTMAX", "STAGE_2-6_ENSEMBLING",
              "STAGE_3-1_DATA_SPLIT", "STAGE_3-4_TRAINING", "STAGE_3-5_FINAL_FIT",
              "PIPELINE_TRAINING_COMPLETE"):
        check(os.path.isfile(os.path.join(core, "Checkpoints", m)), "marker %s missing" % m)
    refs = ["REF%02d" % i for i in range(E2E_REFS)]
    subs = ["SUB%02d" % i for i in range(E2E_PATIENTS)]
    for r in refs:
        for t in subs:
            pair = os.path.join(out, "002_Registration", "%s_to_%s" % (r, t))
            check(nifti.try_load_nifti(pair + ".nii.gz")
                  and os.path.isfile(os.path.join(pair, "affine.json"))
                  and nifti.try_load_nifti(os.path.join(pair, "warp.nii.gz")),
                  "registration artifacts of %s incomplete" % pair)
            for lab in ("label1", "label2"):
                check(nifti.try_load_nifti(os.path.join(
                    out, "003_Transformed", "%s_to_%s" % (r, t), lab + ".nii.gz")),
                    "%s of %s_to_%s not propagated" % (lab, r, t))
    with open(os.path.join(out, "run_registration.sh")) as f:
        check("python -m deepwmh_tpu_torch.cli.group_register" in f.read(),
              "run_registration.sh does not name the port's registration CLI")
    stage1 = _stage1_scores(core, gt_paths)
    for case, sc in stage1.items():
        check(sc["recall"] > STAGE1_RECALL_FLOOR and sc["dice"] > STAGE1_DICE_FLOOR,
              "stage-1 of %s: %r" % (case, sc))

    # the release installed and predicted on the held-out patient
    model_dir = os.path.join(root, "model")
    pred_dir = os.path.join(root, "predict")
    t0 = time.perf_counter()
    install_cli.main(["-m", os.path.join(core, "Model_release", "model_release.tar.gz"),
                      "-o", model_dir])
    predict_cli.main(["-i", test_flair, "-n", test_case, "-m", model_dir, "-o", pred_dir,
                      "--no-previews", "--device", DEVICE])
    predict_s = time.perf_counter() - t0
    pred = nifti.load_nifti_simple(os.path.join(pred_dir, "002_Segmentations",
                                                "003_postproc_fov", "%s.nii.gz" % test_case))
    gt = nifti.load_nifti_simple(test_gt[test_case])
    check(pred.shape == E2E_SHAPE and np.isfinite(pred).all(), "held-out prediction")
    heldout = released_model_checks(core, model_dir, pred_dir, test_case, test_flair)

    # a second run through the CLI: every phase resumes, nothing is trained
    stamps = _checkpoint_stamps(core)
    stdout, rerun_s = _run_cli("deepwmh_tpu_torch.cli.train", [
        "-s", ref_csv, "-t", train_csv, "-o", out,
        "--stage2-epochs", str(budget.stage2_epochs), "--stage3-epochs",
        str(budget.stage3_epochs), "--batches-per-epoch", str(budget.batches_per_epoch)],
        timeout=300)
    check(rerun_s < 60, "the train CLI's re-run took %.1f s" % rerun_s)
    check(_checkpoint_stamps(core) == stamps and "epoch " not in stdout,
          "the train CLI's re-run trained:\n%s" % stdout[-2000:])

    s2_steps = budget.stage2_epochs * budget.batches_per_epoch
    s3_steps = budget.stage3_epochs * budget.batches_per_epoch
    plan = Plan.load(os.path.join(core, "DCNN_Outputs", PipelineMultistage.STAGE2_TASK,
                                  "plan.json"))
    row = {"phase": "train_e2e", "nvidia_smi": smi, "shape": list(E2E_SHAPE),
           "spacing": list(E2E_SPACING), "references": E2E_REFS, "patients": E2E_PATIENTS,
           "registration_mode": mode, "budget": E2E_BUDGET, "batch_pairs": E2E_BATCH_PAIRS,
           "plan": {"patch_size": plan.patch_size, "batch_size": plan.batch_size,
                    "num_pools": plan.num_pools, "widths": features_per_stage(plan)},
           "setup_s": setup_s, "wall_s": wall, "peak_device_gb": peak_gb,
           "launches": launches,
           "stage_s": {"n4_s_per_volume": stats["n4"]["s"] / (E2E_REFS + E2E_PATIENTS),
                       "registration_s_per_pair": stats["registration"]["s"]
                       / (E2E_REFS * E2E_PATIENTS),
                       "label_propagation_s": stats["label_propagation"]["s"],
                       "stage1_s_per_case": stats["stage1"]["s"] / E2E_PATIENTS,
                       "stage2_s_per_step": stats["2-3_training"]["s"] / s2_steps,
                       "2-4_s": stats["2-4_raw_softmax"]["s"],
                       "2-5_2-6_s": stats["2-5_masked_softmax"]["s"]
                       + stats["2-6_ensembling"]["s"],
                       "stage3_s_per_step": stats["3-4_training"]["s"] / s3_steps,
                       "3-5_s": stats["3-5_final_fit"]["s"],
                       "release_s": stats["release"]["s"]},
           "stage_stats": stats,
           "stage1": stage1,
           "heldout_dice": hard_dice_binary(pred, gt),
           "heldout_pr": voxel_precision_recall(pred, gt),
           "released_model": heldout,
           "install_predict_s": predict_s, "cli_rerun_s": rerun_s}
    row["c3"] = n4_repeatability(root, out, core, os.path.join(data, "SUB00_flair.nii.gz"),
                                 flair, pkg, os.path.join(work, "predict"))
    emit(row)
    return launches, plan


# ---------------------------------------------------------------------- #
# the device mesh, training side: a 2-shard mesh on one card
# ---------------------------------------------------------------------- #

MESH_TRAIN_SHARDS = 2
MESH_TRAIN_STEPS = 3  # of the flagship dp Trainer, each beside an unsharded one
MESH_LEARNED_STEPS = 10
MESH_PAIR_CFGS = (dict(shrinks=(2,), iters=(60,)), dict(shrinks=(2,), iters=(10,)))
MESH_TRAIN_BUDGET = dict(stage2_epochs=1, stage3_epochs=1, batches_per_epoch=2, batch_size=2)
MESH_TRAIN_MARKERS = ("STAGE_1_INITIAL_SEGMENTATION", "STAGE_2-3_TRAINING_DENOISER",
                      "STAGE_2-4_RAW_SOFTMAX", "STAGE_2-5_MASKED_SOFTMAX",
                      "STAGE_2-6_ENSEMBLING", "STAGE_3-1_DATA_SPLIT", "STAGE_3-4_TRAINING",
                      "STAGE_3-5_FINAL_FIT", "PIPELINE_TRAINING_COMPLETE")


def grad_agreement(got, want) -> dict:
    """Cosine and norm ratio of two gradients (lists of tensors), in f64."""
    import torch

    a = torch.cat([g.detach().double().reshape(-1) for g in got])
    b = torch.cat([g.detach().double().reshape(-1) for g in want])
    return {"cosine": float(a @ b / (a.norm() * b.norm())),
            "norm_ratio": float(a.norm() / b.norm())}


def _unsharded_grads(loss, params):
    import torch

    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _replicas_equal(trainer) -> bool:
    import torch

    return all(torch.equal(a, b) for rep in trainer.replicas
               for a, b in zip(rep.parameters(), trainer.params))


def mesh_trainer_steps(work, mesh, dev) -> dict:
    """The flagship Trainer over ``mesh`` in turns with an unsharded one,
    from the same weights, batches and generator seeds: MESH_TRAIN_STEPS
    bf16 steps (the first taken apart: augmented batches, gradients), then
    one f32 step with TF32 off."""
    import torch

    from deepwmh_tpu_torch.unet.data import SegDataset
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

    plan = default_plan_1mm_iso()
    ds = SegDataset(plan.patch_size)
    for i in range(2):
        ds.add_case("train%d" % i, *_train_cohort(FLAGSHIP_SHAPE, seed=30 + i))
    np_rng = np.random.RandomState(0)
    batches = [ds.sample_batch(np_rng, 2, 0.33) for _ in range(MESH_TRAIN_STEPS)]
    cfg = TrainConfig(epochs=1, batches_per_epoch=MESH_TRAIN_STEPS, batch_size=2, augment=True)
    trainers = {"unsharded": Trainer(plan, cfg, os.path.join(work, "mt_one"), device=dev),
                "mesh": Trainer(plan, cfg, os.path.join(work, "mt_mesh"), mesh=mesh)}
    trainers["unsharded"].init_state(0)
    trainers["mesh"].load_state_trees(*trainers["unsharded"].state_trees())
    check(len(trainers["mesh"].replicas) == mesh.size and _replicas_equal(trainers["mesh"]),
          "mesh trainer: the replicas do not start from the same bits")
    gens = {name: torch.Generator(device=dev).manual_seed(1) for name in trainers}
    rows = {name: {"loss": [], "s": [], "peak_gb": []} for name in trainers}
    first = {}
    for step in range(MESH_TRAIN_STEPS):
        for name, tr in trainers.items():
            images, labels = tr._to_device(*batches[step])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if step == 0:  # train_step taken apart
                aug = tr.augment(images, labels, gens[name])
                if tr.mesh is None:
                    loss = tr.loss(*aug)
                    grads = _unsharded_grads(loss, tr.params)
                    loss = loss.detach()
                else:
                    loss, grads = tr.mesh_loss_grads(*aug)
                tr.update(grads, tr.lr_at(0))
                tr._sync_replicas()
                first[name] = (aug, grads)
            else:
                loss = tr.train_step(images, labels, tr.lr_at(step), gens[name])
            torch.cuda.synchronize()
            rows[name]["s"].append(time.perf_counter() - t0)
            rows[name]["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
            rows[name]["loss"].append(float(loss))
            check(math.isfinite(rows[name]["loss"][-1]), "%s step %d loss %r"
                  % (name, step, rows[name]["loss"][-1]))
            if tr.mesh is not None:
                check(_replicas_equal(tr), "mesh trainer: replicas differ after step %d" % step)
    (aug_one, g_one), (aug_mesh, g_mesh) = first["unsharded"], first["mesh"]
    for k, what in ((0, "images"), (1, "labels")):
        check(torch.equal(torch.cat(aug_mesh[k]), aug_one[k]),
              "mesh trainer: the augmented %s differ from the unsharded batch's" % what)
    bf16 = {"first_step_gradient": grad_agreement(g_mesh, g_one), **{
        name: dict(rows[name], s_per_step_median=float(np.median(rows[name]["s"][1:])))
        for name in rows}}
    del trainers, first, aug_one, aug_mesh, g_one, g_mesh
    torch.cuda.empty_cache()

    # one f32 step, TF32 off: the loss and gradient of the whole batch
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg32 = TrainConfig(epochs=1, batches_per_epoch=1, batch_size=2, augment=False)
        one = Trainer(plan, cfg32, os.path.join(work, "mt32_one"), device=dev,
                      dtype=torch.float32)
        one.init_state(0)
        loss_one = one.loss(*one._to_device(*batches[0]))
        g_one = _unsharded_grads(loss_one, one.params)
        loss_one = loss_one.detach()
        sharded = Trainer(plan, cfg32, os.path.join(work, "mt32_mesh"), mesh=mesh,
                          dtype=torch.float32)
        sharded.load_state_trees(*one.state_trees())
        loss_mesh, g_mesh = sharded.mesh_loss_grads(*sharded._to_device(*batches[0]))
        f32 = {"loss_unsharded": float(loss_one), "loss_mesh": float(loss_mesh),
               "loss_rel": abs(float(loss_mesh) - float(loss_one)) / abs(float(loss_one)),
               **grad_agreement(g_mesh, g_one)}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    check(f32["loss_rel"] <= 1e-5, "mesh trainer f32 loss: %r" % f32)
    check(f32["cosine"] > 0.9999, "mesh trainer f32 gradient: %r" % f32)
    del one, sharded, g_one, g_mesh
    torch.cuda.empty_cache()
    return {"plan": "default_plan_1mm_iso", "patch": list(plan.patch_size), "batch": 2,
            "steps": MESH_TRAIN_STEPS, "bf16": bf16, "f32_one_step": f32,
            "augmented_batch_equal": True, "replicas_equal_every_step": True}


def mesh_learned(mesh, dev) -> dict:
    """LearnedRegistration.train over ``mesh`` at the flagship template
    grid (batch_pairs 1 -> the mesh size): the first step's loss and
    gradient against the unsharded batch of the same pairs, then
    MESH_LEARNED_STEPS steps of each, timed in turns."""
    import io

    import torch

    from deepwmh_tpu_torch.registration.learned import LearnedRegConfig, LearnedRegistration
    from deepwmh_tpu_torch.registration.priors import synthetic_atlas
    from deepwmh_tpu_torch.registration.similarity import winsorize_rescale
    from deepwmh_tpu_torch.unet.model import init_weights

    grid = template_grid(FLAGSHIP_SHAPE, FLAGSHIP_SPACING)
    vols = [synthetic_atlas(grid, (2.0, 2.0, 2.0), seed=i)[0] for i in range(3)]
    n = mesh.size
    one = LearnedRegistration(grid, LearnedRegConfig(batch_pairs=n), device=dev)
    init_weights(one.model, torch.Generator().manual_seed(0))
    sharded = LearnedRegistration(grid, LearnedRegConfig(), device=dev)
    sharded.model.load_state_dict(one.model.state_dict())
    wins = [winsorize_rescale(torch.from_numpy(v).to(dev)) for v in vols]
    idx = np.random.RandomState(0).randint(0, len(vols), size=(n, 2))
    idx[:, 1] = np.where(idx[:, 0] == idx[:, 1], (idx[:, 1] + 1) % len(vols), idx[:, 1])
    fixed = torch.stack([wins[i] for i in idx[:, 0]])
    moving = torch.stack([wins[j] for j in idx[:, 1]])
    loss_one = one._loss(fixed, moving)
    g_one = _unsharded_grads(loss_one, list(one.model.parameters()))
    loss_one = loss_one.detach()
    loss_mesh, g_mesh = sharded.mesh_loss_grads(
        mesh, sharded.replicas(mesh), [fixed[d:d + 1] for d in range(n)],
        [moving[d:d + 1] for d in range(n)])
    first = {"loss_unsharded": float(loss_one), "loss_mesh": float(loss_mesh),
             "loss_rel": abs(float(loss_mesh) - float(loss_one)) / abs(float(loss_one)),
             **grad_agreement(g_mesh, g_one)}
    check(first["loss_rel"] <= 1e-4 and first["cosine"] > 0.99
          and 0.95 < first["norm_ratio"] < 1.05, "learned dp first step: %r" % first)
    del one, sharded, g_one, g_mesh, loss_one
    timed = {}
    for name in ("unsharded", "mesh", "mesh", "unsharded"):
        cfg = LearnedRegConfig(steps=MESH_LEARNED_STEPS, batch_pairs=1 if name == "mesh" else n)
        reg = LearnedRegistration(grid, cfg, device=dev)
        said = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            loss = reg.train(vols, rng_seed=0, mesh=mesh if name == "mesh" else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(math.isfinite(loss), "learned %s: loss %r" % (name, loss))
        if name == "mesh":
            line = "regnet: batch_pairs 1 -> %d (one pair per mesh device)" % n
            check(line in said.getvalue(), "learned over the mesh did not say %r" % line)
        timed.setdefault(name, []).append({"loss": loss, "s_per_step": wall / cfg.steps})
    return {"grid": list(grid), "batch_pairs": "1 -> %d" % n, "steps": MESH_LEARNED_STEPS,
            "first_step": first, "runs": timed}


def mesh_pairs(work, mesh, dev, cases=None) -> dict:
    """register_pairs_mesh on the group_register phase's two flagship pairs
    (its cohort, written here when absent), iterations cut, against
    _pair_core one by one on the card: every output the same bits."""
    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.registration.affine import (
        AffineConfig,
        feasible_affine_cfg,
        spacing_tensor,
    )
    from deepwmh_tpu_torch.registration.group import _pair_core, _to_host, register_pairs_mesh
    from deepwmh_tpu_torch.registration.svf import SVFConfig, _feasible_cfg

    if cases is None:
        cases = registration_cohort(os.path.join(work, "mt_reg"), FLAGSHIP_SHAPE,
                                    FLAGSHIP_SPACING, n_targets=1, seed=0, device=DEVICE)[2]
    # C order, as the launcher uploads (a pair's bits depend on the layout)
    fixed = np.ascontiguousarray(np.stack([nifti.load_nifti_simple(cases["tgt0"][0])] * 2),
                                 np.float16)
    moving = np.ascontiguousarray(np.stack([nifti.load_nifti_simple(cases[c][0])
                                            for c in ("src0", "src1")]), np.float16)
    acfg, scfg = AffineConfig(**MESH_PAIR_CFGS[0]), SVFConfig(**MESH_PAIR_CFGS[1])
    sp = spacing_tensor(FLAGSHIP_SPACING, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [_to_host(_pair_core(torch.from_numpy(fixed[i]).to(dev),
                                torch.from_numpy(moving[i]).to(dev), sp, sp,
                                feasible_affine_cfg(acfg, FLAGSHIP_SHAPE),
                                _feasible_cfg(scfg, FLAGSHIP_SHAPE), True)) for i in range(2)]
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = register_pairs_mesh(fixed, moving, FLAGSHIP_SPACING, FLAGSHIP_SPACING, mesh,
                              affine_cfg=acfg, svf_cfg=scfg)
    mesh_s = time.perf_counter() - t0
    for i in range(2):
        for k, what in enumerate(("matrix", "affine loss", "displacement", "SVF loss",
                                  "warped image")):
            check(np.array_equal(got[k][i], np.asarray(want[i][k], dtype=got[k].dtype)),
                  "register_pairs_mesh: pair %d's %s differs from one by one" % (i, what))
    return {"shape": list(FLAGSHIP_SHAPE), "pairs": 2, "affine_cfg": MESH_PAIR_CFGS[0],
            "svf_cfg": MESH_PAIR_CFGS[1], "one_by_one_s": one_s, "mesh_s": mesh_s,
            "bit_equal": True}


def mesh_run_train(kernels, work, mesh) -> tuple:
    """run_train over ``mesh`` on a 2 x 2 phantom cohort at 64x80x64 (quick
    registration, 1 / 1 epoch x 2 steps, batch 2): the kernels' launches,
    the markers, the release installed; then a resume through the train
    CLI with --mesh (this process's cards) that trains nothing."""
    import io

    import torch

    from deepwmh_tpu_torch.cli import train as train_cli
    from deepwmh_tpu_torch.cli.train import run_train
    from deepwmh_tpu_torch.eval.phantom import write_cohort
    from deepwmh_tpu_torch.pipeline.multistage import StageBudget
    from deepwmh_tpu_torch.unet.release import install_model

    root = os.path.join(work, "mesh_train_e2e")
    ref_csv, train_csv, _ = write_cohort(os.path.join(root, "data"), shape=E2E_SHAPE,
                                         spacing=E2E_SPACING, n_ref=2, n_train=2, seed=0,
                                         device=DEVICE)
    out = os.path.join(root, "out")
    stats = {}
    core, launches, wall = _counted(kernels, lambda: run_train(
        ref_csv, train_csv, out, quick_registration=True, large_deformation=False,
        budget=StageBudget(**MESH_TRAIN_BUDGET), mesh=mesh, stage_stats=stats))
    for name in ("instance_norm_stats", "instance_norm_act"):
        check(launches[name] > 0, "%s was not launched on run_train over the mesh" % name)
    check(launches["median3"] == 2, "run_train over the mesh: K2 launched %d times, expected "
          "one a case (2)" % launches["median3"])
    for m in MESH_TRAIN_MARKERS:
        check(os.path.isfile(os.path.join(core, "Checkpoints", m)), "marker %s missing" % m)
    install_model(os.path.join(core, "Model_release", "model_release.tar.gz"),
                  os.path.join(root, "model"))

    stamps = _checkpoint_stamps(core)
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        train_cli.main(["-s", ref_csv, "-t", train_csv, "-o", out, "--mesh",
                        "--skip-integrity-check", "--allow-quick-registration",
                        "--no-allow-large-deformations"] + sum(
            (["--" + k.replace("_", "-"), str(v)] for k, v in MESH_TRAIN_BUDGET.items()), []))
    resume_s = time.perf_counter() - t0
    line = "mesh: %d device(s) (%s)" % (torch.cuda.device_count(), torch.cuda.get_device_name(0))
    check(line in said.getvalue(), "the train CLI's --mesh resume did not say %r" % line)
    check(_checkpoint_stamps(core) == stamps and "epoch " not in said.getvalue(),
          "the train CLI's --mesh resume trained:\n%s" % said.getvalue()[-2000:])
    return launches, {"shape": list(E2E_SHAPE), "references": 2, "patients": 2,
                      "budget": MESH_TRAIN_BUDGET, "wall_s": wall, "launches": launches,
                      "stage_s": {k: v["s"] for k, v in stats.items()},
                      "peak_device_gb": max(st.get("peak_gb", 0.0) for st in stats.values()),
                      "cli_mesh_resume_s": resume_s}


def phase_mesh_train(kernels, work, smi, cases=None):
    """The training side of the device mesh on a 2-shard mesh whose shards
    both name this card (``Mesh([cuda:0] * 2)``): the flagship dp Trainer,
    the learned registration's dp training at the flagship template grid,
    ``register_pairs_mesh`` on two flagship pairs, and ``run_train`` over
    the mesh with a ``--mesh`` CLI resume. Returns the kernels' launches on
    run_train over the mesh."""
    import torch

    from deepwmh_tpu_torch.device import resolve_device
    from deepwmh_tpu_torch.parallel.mesh import Mesh

    dev = resolve_device(DEVICE)
    mesh = Mesh([dev] * MESH_TRAIN_SHARDS)
    out = {"phase": "mesh_train", "nvidia_smi": smi, "shards": MESH_TRAIN_SHARDS,
           "mesh_devices": sorted({str(d) for d in mesh.devices})}
    t0 = time.perf_counter()
    out["trainer"] = mesh_trainer_steps(work, mesh, dev)
    out["trainer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["learned"] = mesh_learned(mesh, dev)
    out["learned_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["pairs"] = mesh_pairs(work, mesh, dev, cases)
    out["pairs_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    launches, out["run_train"] = mesh_run_train(kernels, work, mesh)
    emit(out)
    return launches


def planted_lesions(shape, n, seed):
    """A bool mask of ``n`` balls of radius 1-3.5 voxels from a numpy seed."""
    rng = np.random.RandomState(seed)
    truth = np.zeros(shape, bool)
    g = np.ogrid[-4:5, -4:5, -4:5]
    d2 = sum(a * a for a in g)
    for _ in range(n):
        r = rng.uniform(1.0, 3.5)
        box = tuple(slice(c - 4, c + 5) for c in (rng.randint(6, s - 6) for s in shape))
        truth[box] |= d2 <= r * r
    return truth


def lesion_pair(shape, n, seed):
    """(pred, truth) f32 masks: truth ``planted_lesions``; pred that truth
    shifted one voxel, eroded, with half of the eroded rim kept at random,
    and n // 4 spurious 2x3x2 blobs."""
    from scipy import ndimage

    truth = planted_lesions(shape, n, seed)
    rng = np.random.RandomState(seed + 1)
    pred = np.roll(truth, 1, axis=0)
    pred = ndimage.binary_erosion(pred) | (pred & (rng.rand(*shape) < 0.5))
    for _ in range(n // 4):
        c = [rng.randint(2, s - 4) for s in shape]
        pred[c[0]:c[0] + 2, c[1]:c[1] + 3, c[2]:c[2] + 2] = True
    return pred.astype(np.float32), truth.astype(np.float32)


def scipy_metrics(pred, truth) -> dict:
    """The five metrics of one case by a route independent of the port:
    ``scipy.ndimage.label`` (6-connectivity, ids in raster order of each
    component's first voxel) and, per truth lesion, the reference's
    definition of its Dice on the bounding box of the lesion and of every
    predicted component touching it."""
    from scipy import ndimage

    p, t = pred > 0.5, truth > 0.5
    pl, pn = ndimage.label(p)
    tl, tn = ndimage.label(t)
    inter = int((p & t).sum())
    row = {"dice": 2 * inter / (int(p.sum()) + int(t.sum())) if p.any() or t.any() else 1.0,
           "precision": inter / int(p.sum()) if p.any() else 0.0,
           "recall": inter / int(t.sum()) if t.any() else 0.0}
    tp = int(np.count_nonzero(np.unique(pl[t])))
    found = int(np.count_nonzero(np.unique(tl[p])))
    row.update(tp=tp, fp=pn - tp, fn=tn - found)
    row["instance_f1"] = 2 * tp / (2 * tp + row["fp"] + row["fn"]) if tp or pn or tn else 1.0
    p_box, t_box = ndimage.find_objects(pl), ndimage.find_objects(tl)
    lesions = []
    for i in range(1, tn + 1):
        touching = np.unique(pl[t_box[i - 1]][tl[t_box[i - 1]] == i])
        touching = touching[touching > 0]
        boxes = [t_box[i - 1]] + [p_box[j - 1] for j in touching]
        box = tuple(slice(min(b[a].start for b in boxes), max(b[a].stop for b in boxes))
                    for a in range(3))
        ct = tl[box] == i
        cp = np.isin(pl[box], touching) & ~(t[box] & ~ct)  # mP - (yt - cT)
        lesions.append((int(ct.sum()), 2 * int((ct & cp).sum()) / (int(ct.sum()) + int(cp.sum()))))
    row["component_dice"] = sorted(lesions, key=lambda e: e[0])
    return row


def phase_convert_evaluate(kernels, work, smi):
    """A user of the reference moving to the port, through the CLIs' ``main``
    with the argv a user gives them:

    1. a Generic_UNet replica at the flagship plan's widths (seeded
       weights, non-trivial instance-norm affines) saved in the reference's
       install layout and converted by the convert CLI (discovery included);
    2. the predict CLI on one flagship FLAIR with TTA (seconds, K1's
       launches);
    3. the evaluate CLI over that mask and two synthetic pairs of >= 200
       lesions at 192x224x192 with all five metrics, with ``--device cpu``
       (in a second thread, beside 4-5) and on the card: equal reports,
       equal to a scipy reference; seconds a case, ``label_components``
       rounds a mask;
    4. the converted model against the replica on one 128x160x128 patch
       (f32 logits with TF32 off, the bf16 argmax; K1's launches counted by
       the wrappers and seen by the profiler);
    5. a rating workbook written and read back, the score histogram PDF, the
       boxplot and lightbox where matplotlib / PIL are installed.

    Returns K1's launches (both kernels) from the predict CLI run."""
    import importlib.util
    import io
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepwmh_tpu_torch.cli import convert_torch as convert_cli
    from deepwmh_tpu_torch.cli import evaluate as evaluate_cli
    from deepwmh_tpu_torch.cli import predict as predict_cli
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.core.xlsx import read_xlsx, write_xlsx
    from deepwmh_tpu_torch.eval import stats
    from deepwmh_tpu_torch.eval.metrics import METRICS
    from deepwmh_tpu_torch.ops.components import label_components
    from deepwmh_tpu_torch.unet.model import UNet3D
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.release import load_released_model

    sys.path.append(os.path.join(HERE, "tests"))
    from torch_port_nnunet import plans_dict, seeded_replica, write_reference_install

    dev = torch.device(DEVICE)
    t_phase = last = time.perf_counter()
    steps = {}  # seconds of each step of this phase

    def lap(name):
        nonlocal last
        now = time.perf_counter()
        steps[name] = now - last
        last = now

    # 1. the reference model, converted
    plan = default_plan_1mm_iso()
    net = seeded_replica(plan.pool_kernels, plan.conv_kernels, base=plan.base_features,
                         num_classes=plan.num_classes, seed=0)
    root = os.path.join(work, "reference_model")
    write_reference_install(root, net, plans_dict(plan.pool_kernels, plan.conv_kernels,
                                                  plan.patch_size, plan.target_spacing,
                                                  base=plan.base_features,
                                                  num_classes=plan.num_classes))
    lap("replica")
    pkg = os.path.join(work, "converted")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        convert_cli.main(["-i", root, "-o", pkg])
    check("nnUNetTrainerV2__nnUNetPlansv2.1/all/model_best.model" in said.getvalue(),
          "the convert CLI did not find the install's checkpoint:\n" + said.getvalue()[-1000:])
    lap("convert")

    # 2. predict through the CLI (its integrity check launches K1's statistics once)
    flair = synthetic_flair(FLAGSHIP_SHAPE, seed=21)
    lesions = (planted_lesions(FLAGSHIP_SHAPE, 40, seed=22) & (flair > 200)).astype(np.float32)
    hdr = nifti.NiftiHeader()
    hdr.set_shape(FLAGSHIP_SHAPE)
    hdr.set_zooms(FLAGSHIP_SPACING)
    image = os.path.join(work, "conv0_flair.nii")
    nifti.save_nifti(flair + 250.0 * lesions, hdr, image)
    pred_out = os.path.join(work, "convert_predict")
    for k in kernels.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict_cli.main(["-i", image, "-n", "conv0", "-m", pkg, "-o", pred_out, "--no-previews",
                      "--device", DEVICE])
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    blocks = 4 * plan.num_pools + 2
    check(launches["instance_norm_stats"] == 8 * blocks + 1
          and launches["instance_norm_act"] == 8 * blocks and launches["median3"] == 0,
          "predict launched %s, expected %d a K1 kernel (8 flips x %d blocks; + 1 statistics "
          "launch of the integrity check)" % (launches, 8 * blocks, blocks))
    lap("predict")

    # 3. evaluate: the predict output and two synthetic pairs; the CPU run
    # in a second thread while the card works
    preds, truths = os.path.join(work, "eval_pred"), os.path.join(work, "eval_truth")
    os.makedirs(preds)
    os.makedirs(truths)
    shutil.copyfile(os.path.join(pred_out, "002_Segmentations", "003_postproc_fov", "conv0.nii.gz"),
                    os.path.join(preds, "conv0.nii.gz"))
    nifti.save_nifti(lesions, hdr, os.path.join(truths, "conv0.nii"))
    for i in (1, 2):
        pred, truth = lesion_pair(FLAGSHIP_SHAPE, 260, seed=22 + 2 * i)
        nifti.save_nifti(pred, hdr, os.path.join(preds, "syn%d.nii" % i))
        nifti.save_nifti(truth, hdr, os.path.join(truths, "syn%d.nii" % i))
    cases = ["conv0", "syn1", "syn2"]
    args = ["-p", preds, "-g", truths, "--metrics"] + list(METRICS)
    lap("evaluate_inputs")
    walls, reports = {}, {}

    def evaluate(where):
        t0 = time.perf_counter()
        reports[where] = evaluate_cli.main(args + ["-o", os.path.join(work, "eval_%s.json" % where),
                                                   "--device", DEVICE if where == "card" else "cpu"])
        torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    cpu_run = pool.submit(evaluate, "cpu")
    evaluate("card")
    lap("evaluate_card")

    # 4. the converted model against the replica on one patch of the FLAIR
    lo = [(s - p) // 2 for s, p in zip(FLAGSHIP_SHAPE, plan.patch_size)]
    patch = flair[tuple(slice(a, a + p) for a, p in zip(lo, plan.patch_size))]
    x = torch.from_numpy((patch - patch.mean()) / patch.std()).to(dev)[None, None]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            model, cplan = load_released_model(pkg, device=dev, dtype=torch.float32)
            check(cplan.pad_style == "torch" and cplan.base_features == plan.base_features,
                  "converted plan %s" % cplan)
            want = net.to(dev)(x)[-1]
            before = {name: k.launches for name, k in kernels.KERNELS.items()}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                got = model(x)
                torch.cuda.synchronize()
            forward_launches = {name: k.launches - before[name]
                                for name, k in kernels.KERNELS.items()}
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            profiled = {"instance_norm_stats": sum("inorm_" in n and "inorm_act" not in n
                                                   for n in names),
                        "instance_norm_act": sum("inorm_act" in n for n in names)}
            f32_err = float((got - want).abs().max())
            f32_close = bool(torch.allclose(got, want, atol=2e-4, rtol=1e-3))
            bf16 = UNet3D(cplan)  # bf16 compute, the weights just read
            bf16.load_state_dict(model.state_dict())
            bf16 = bf16.to(dev, memory_format=torch.channels_last_3d).eval()
            del model
            agree = float((bf16(x).argmax(1) == want.argmax(1)).float().mean())
            del bf16, got, want
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    net.cpu()
    del net
    torch.cuda.empty_cache()
    check(f32_close, "converted f32 logits differ from the replica's by %.3g" % f32_err)
    check(agree > 0.98, "bf16 argmax agrees with the replica on only %.5f" % agree)
    for name in ("instance_norm_stats", "instance_norm_act"):
        check(forward_launches[name] == blocks and profiled[name] >= 1,
              "%s: %d launches (profiler saw %d) on the converted forward, expected %d"
              % (name, forward_launches[name], profiled[name], blocks))
    lap("forward_check")

    # the scipy reference and label_components' rounds
    rounds, components, refs = {}, {}, {}
    for case in cases:
        pred = nifti.load_nifti_simple(os.path.join(
            preds, case + (".nii.gz" if case == "conv0" else ".nii")))
        truth = nifti.load_nifti_simple(os.path.join(truths, case + ".nii"))
        refs[case] = scipy_metrics(pred, truth)
        components[case] = {"truth": len(refs[case]["component_dice"]),
                            "pred": refs[case]["tp"] + refs[case]["fp"]}
        rounds[case] = {name: label_components(torch.from_numpy(m > 0.5).to(dev),
                                               return_rounds=True)[1]
                        for name, m in (("pred", pred), ("truth", truth))}
        if case != "conv0":
            check(min(components[case].values()) >= 200, "%s: %s" % (case, components[case]))
    lap("reference_and_rounds")
    cpu_run.result()
    pool.shutdown()
    lap("evaluate_cpu_wait")
    for where in ("card", "cpu"):
        with open(os.path.join(work, "eval_%s.json" % where)) as f:
            check(json.load(f) == json.loads(json.dumps(reports["card"])),
                  "the %s report differs from the card's" % where)
    worst = 0.0
    for case in cases:
        got, ref = reports["card"]["cases"][case], refs[case]
        for key in ("tp", "fp", "fn"):
            check(got[key] == ref[key], "%s %s: %r, scipy %r" % (case, key, got[key], ref[key]))
        check([tuple(e) for e in got["component_dice"]] == ref["component_dice"],
              "%s: component Dice lists differ from scipy's" % case)
        for key in ("dice", "precision", "recall", "instance_f1"):
            worst = max(worst, abs(got[key] - ref[key]))
            check(abs(got[key] - ref[key]) <= 1e-12, "%s %s: %r, scipy %r"
                  % (case, key, got[key], ref[key]))

    # 5. reports: a rating workbook read back, the score histogram card, plots
    reports_dir = os.path.join(work, "reports")
    os.makedirs(reports_dir)
    methods = ["converted", "synthetic"]
    wb = stats.VisualScoreEvaluation.make_matrix_workbook(
        cases, methods, os.path.join(reports_dir, "rating.xlsx"), seed=0)
    got_methods, got_cases = stats.VisualScoreEvaluation.parse_matrix_sheet(
        wb, "Mapping", return_methods_and_subjects=True)
    check(got_cases == cases and sorted(got_methods) == sorted(methods),
          "rating workbook read back %s %s" % (got_methods, got_cases))
    score = [["case", "seg_1", "seg_2"]] + [[c, 2, 1] for c in cases]
    write_xlsx(wb, {"Score": score, "Mapping": read_xlsx(wb)["Mapping"]})
    scored = stats.VisualScoreEvaluation.parse_matrix_sheet(wb)
    check(all(sorted(scored[m][c] for m in methods) == ["1", "2"] for c in cases),
          "scored workbook parsed to %s" % scored)
    card = stats.VisualScoreEvaluation.score_histogram(
        [reports["card"]["cases"][c]["dice"] for c in cases], len(cases),
        os.path.join(reports_dir, "dice_histogram.pdf"))
    with open(card, "rb") as f:
        check(f.read(5) == b"%PDF-", "the score histogram is not a PDF")
    drawn = {"boxplot": importlib.util.find_spec("matplotlib") is not None,
             "lightbox": importlib.util.find_spec("PIL") is not None}
    written = [wb, card]
    if drawn["boxplot"]:
        lesion_dice = [[d for _s, d in reports["card"]["cases"][c]["component_dice"]]
                       for c in ("syn1", "syn2")]
        written.append(os.path.join(reports_dir, "boxplot.png"))
        stats.boxplot_compare(lesion_dice, ["syn1", "syn2"], written[-1],
                              ylabel="per-lesion Dice")
    if drawn["lightbox"]:
        from deepwmh_tpu_torch.eval.preview import lightbox

        written.append(os.path.join(reports_dir, "lightbox.png"))
        lightbox(flair, written[-1], slice_step=16,
                 lesion_mask=nifti.load_nifti_simple(os.path.join(preds, "conv0.nii.gz")))
    check(all(os.path.getsize(f) > 0 for f in written), "a report is empty")
    lap("reports")
    print("convert_evaluate reports: rating workbook and score histogram PDF written; %s"
          % ", ".join("%s %s" % (name, "drawn" if done else "not drawn (%s not installed)"
                                 % ("matplotlib" if name == "boxplot" else "PIL"))
                      for name, done in drawn.items()), flush=True)
    emit({"phase": "convert_evaluate", "nvidia_smi": smi, "plan": "default_plan_1mm_iso",
          "convert_s": steps["convert"], "patch": list(plan.patch_size),
          "f32_max_abs_err_vs_replica": f32_err, "bf16_argmax_agreement": agree,
          "forward_launches": forward_launches, "forward_profiled_launches": profiled,
          "predict_shape": list(FLAGSHIP_SHAPE), "predict_tta_flips": 8,
          "predict_s_per_volume": predict_s, "predict_launches": launches,
          "evaluate_cases": cases, "evaluate_metrics": list(METRICS),
          "evaluate_s_per_case": {w: walls[w] / len(cases) for w in walls},
          "evaluate_card_equals_cpu": True, "scipy_max_abs_diff": worst,
          "components": components, "label_components_rounds": rounds,
          "summary": reports["card"]["summary"], "drawn": drawn,
          "steps_s": steps, "phase_s": time.perf_counter() - t_phase})
    return launches


SURFACE_SPACING = (1.5, 1.5, 1.5)  # resample_nifti's target on the way down


def phase_surface(work, smi, flair):
    """The last of the JAX package's public surface on the card's machine:

    1. the main path's FLAIR saved in LPS (the sform's x and y columns
       negated, the array flipped to match) and read back with
       ``load_nifti(force_RAS=True)``: equal to the RAS array;
    2. ``resample_nifti`` of that file to 1.5 mm and back to 1 mm (order 1),
       seconds for each, the shapes and sform scales, the head mask's Dice
       and mean against the original;
    3. ``native.label_components_host`` (``cc3d.cpp``) against the card's
       ``label_components`` compacted to 1..n, on convert_evaluate's three
       truth masks: the same ids and count, host ms against card ms, the
       card's rounds.
    """
    import torch
    from scipy import ndimage

    from deepwmh_tpu_torch import native
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.ops.components import label_components

    t_phase = time.perf_counter()
    # 1. an LPS file read as RAS
    lps_data = np.flip(flair, (0, 1))
    lps = nifti.NiftiHeader()
    lps.set_shape(FLAGSHIP_SHAPE)
    lps.set_zooms(FLAGSHIP_SPACING)
    srow = np.zeros((3, 4), np.float32)
    srow[:3, :3] = np.diag(np.array((-1.0, -1.0, 1.0)) * FLAGSHIP_SPACING)
    srow[:, 3] = (95.5, 111.5, -95.5)
    lps.srow = srow
    lps.sform_code = 1
    lps_path = os.path.join(work, "surface_lps.nii.gz")
    t0 = time.perf_counter()
    nifti.save_nifti(lps_data, lps, lps_path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ras, hdr = nifti.load_nifti(lps_path, force_RAS=True)
    read_s = time.perf_counter() - t0
    check(nifti.aff2axcodes(hdr.affine) == ("L", "P", "S") and ras.shape == FLAGSHIP_SHAPE
          and np.array_equal(ras, flair),
          "the LPS file read with force_RAS differs from the RAS array")

    # 2. to 1.5 mm and back
    down = os.path.join(work, "surface_down.nii.gz")
    back = os.path.join(work, "surface_back.nii.gz")
    t0 = time.perf_counter()
    nifti.resample_nifti(lps_path, SURFACE_SPACING, down, order=1)
    down_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nifti.resample_nifti(down, FLAGSHIP_SPACING, back, order=1)
    back_s = time.perf_counter() - t0
    shapes, scales, read = {}, {}, {}
    for name, path in (("down", down), ("back", back)):
        read[name], h = nifti.load_nifti(path)
        shapes[name] = list(read[name].shape)
        scales[name] = np.linalg.norm(h.srow[:3, :3], axis=0).tolist()
    want_down = [int(np.round(s * a / b)) for s, a, b in zip(FLAGSHIP_SHAPE, FLAGSHIP_SPACING,
                                                             SURFACE_SPACING)]
    data = read["back"]
    head, head_back = lps_data > 200, data > 200
    head_dice = 2 * int((head & head_back).sum()) / (int(head.sum()) + int(head_back.sum()))
    # the texture's mean away from the blurred rim
    inner = ndimage.binary_erosion(head, iterations=3)
    mean_rel = abs(np.mean(data[inner], dtype=np.float64)
                   / np.mean(lps_data[inner], dtype=np.float64) - 1)
    check(shapes["down"] == want_down and shapes["back"] == list(FLAGSHIP_SHAPE)
          and np.allclose(scales["down"], SURFACE_SPACING) and np.allclose(scales["back"], 1.0)
          and np.isfinite(data).all() and head_dice > 0.98 and mean_rel < 0.01,
          "resample_nifti: shapes %s, sform scales %s, head Dice %.4f, mean off by %.4f"
          % (shapes, scales, head_dice, mean_rel))

    # 3. host labelling against the card's
    dev = torch.device(DEVICE)
    masks = {}
    truths = os.path.join(work, "eval_truth")
    for case in ("conv0", "syn1", "syn2"):
        masks[case] = nifti.load_nifti_simple(os.path.join(truths, case + ".nii")) > 0.5

    def card_ids(m):
        root, rounds = label_components(m, return_rounds=True)
        root = root.reshape(-1)
        N = root.numel()
        rank = torch.cumsum(root == torch.arange(N, device=root.device), 0)
        ids = torch.where(root < N, rank[root.clamp(max=N - 1)], 0)
        return ids.reshape(m.shape), int(rank[-1]), rounds

    labelling = {}
    for case, m in masks.items():
        m_dev = torch.from_numpy(m).to(dev)
        labels, n = native.label_components_host(m)
        ids, n_card, rounds = card_ids(m_dev)
        check(n == n_card and np.array_equal(ids.cpu().numpy(), labels),
              "%s: host labelling (%d components) differs from the card's (%d)" % (case, n, n_card))
        # timed on a second call each
        t0 = time.perf_counter()
        native.label_components_host(m)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_ids(m_dev)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        labelling[case] = {"components": n, "voxels": int(m.sum()), "host_ms": host_ms,
                           "card_ms": card_ms, "card_rounds": rounds}
    emit({"phase": "surface", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "force_ras": {"axcodes": "LPS", "equal_to_ras": True, "write_s": write_s,
                        "read_s": read_s},
          "resample": {"to_mm": list(SURFACE_SPACING), "order": 1, "down_s": down_s,
                       "back_s": back_s, "shapes": shapes, "sform_scales": scales,
                       "head_dice_round_trip": head_dice, "head_mean_rel_diff": mean_rel},
          "labelling": labelling, "labelling_ids_equal": True,
          "phase_s": time.perf_counter() - t_phase})


DICOM_ORIGIN = (-95.5, 130.0, -71.0)  # mm, LPS, of the flagship series' first voxel
DICOM_SMALL_SLICES = 16  # slices of each other syntax's series
DICOM_PLAIN_SLICES = 4  # slices each native route also decodes in Python
DICOM_ENCODE_WORKERS = 6
DICOM_FOV = "002_Segmentations/003_postproc_fov/dcm0.nii.gz"


def _encode_jobs(work, source):
    """Every DICOM series of phase dicom_predict as ``write_series`` /
    ``write_enhanced`` calls for a process pool: the flagship 192-slice
    JPEG Lossless SV1 series in six parts, then one 16-slice series (in-plane
    224x192, slices 88-103 of the first axis) for each other syntax.
    Returns (jobs [(name, function name, args, kwargs)], {syntax name:
    (folder, volume, syntax, lossless)})."""
    import torch_port_dicom as W

    flagship = os.path.join(work, "dicom", "flagship")
    n = source.shape[2]
    jobs = [("flagship", "write_series", (flagship, source, W.JPEG_LOSSLESS_SV1),
             {"origin": DICOM_ORIGIN, "slices": range(i, n, DICOM_ENCODE_WORKERS)})
            for i in range(DICOM_ENCODE_WORKERS)]
    lo = source.shape[0] // 2 - DICOM_SMALL_SLICES // 2  # 88 at the flagship shape
    vol16 = np.ascontiguousarray(np.moveaxis(source[lo:lo + DICOM_SMALL_SLICES], 0, -1))
    vol12 = np.minimum(vol16 * 7, 4095).astype(np.uint16)
    vol8 = np.round(vol16 * (255.0 / vol16.max())).astype(np.uint8)
    series = {
        "explicit_le": (W.EXPLICIT_LE, vol16, {}),
        "implicit_le": (W.IMPLICIT_LE, vol16, {}),
        "explicit_be": (W.EXPLICIT_BE, vol16, {}),
        "deflated": (W.DEFLATED_LE, vol16, {}),
        "rle": (W.RLE_LOSSLESS, vol16, {}),
        "jpeg_baseline_8bit": (W.JPEG_BASELINE, vol8, {}),
        "jpeg_extended_12bit": (W.JPEG_EXTENDED, vol12, {"precision": 12}),
        "jpeg_lossless_p14_pred7": (W.JPEG_LOSSLESS_P14, vol16, {"predictor": 7}),
        "jpegls_lossless": (W.JPEG_LS_LOSSLESS, vol12, {"precision": 12}),
        "jpegls_near2": (W.JPEG_LS_NEAR, vol12, {"precision": 12, "near": 2}),
        "enhanced_jpeg_lossless": (W.JPEG_LOSSLESS_SV1, vol16, {}),
    }
    out = {}
    for name, (syntax, vol, kw) in series.items():
        folder = os.path.join(work, "dicom", name)
        if name.startswith("enhanced"):
            os.makedirs(folder)
            jobs.append((name, "write_enhanced", (os.path.join(folder, "enhanced.dcm"), vol,
                                                  syntax), {"origin": DICOM_ORIGIN}))
        else:
            jobs.append((name, "write_series", (folder, vol, syntax),
                         dict(kw, origin=DICOM_ORIGIN)))
        out[name] = (folder, vol, syntax, syntax not in (W.JPEG_BASELINE, W.JPEG_EXTENDED,
                                                         W.JPEG_LS_NEAR))
    return jobs, out


def _encode_job(name, function, args, kwargs):
    """A process pool's task: one writer call; returns (name, CPU seconds)."""
    import torch_port_dicom as W

    t0 = time.process_time()
    getattr(W, function)(*args, **kwargs)
    return name, time.process_time() - t0


def _series_streams(folder, count):
    """The compressed streams of the first ``count`` slices of a series (its
    files sorted by name, which is by position)."""
    from deepwmh_tpu_torch.core.dicom import read_dicom

    paths = sorted(os.path.join(folder, f) for f in os.listdir(folder))[:count]
    return [b"".join(read_dicom(p)["pixel_data"]) for p in paths]


def _plain_route(decode, streams, route):
    """``decode`` of each stream natively, then inside ``python_path()``:
    the arrays bit-equal, the route's native calls and Python calls counted
    in their own runs; returns (native ms, Python ms) a slice."""
    from deepwmh_tpu_torch import native

    native.reset_counts()
    t0 = time.perf_counter()
    got = [decode(s)[0] for s in streams]
    native_ms = (time.perf_counter() - t0) * 1e3 / len(streams)
    check(native.CALLS[route] == len(streams) and sum(native.PYTHON_CALLS.values()) == 0,
          "%s: native %s, Python %s" % (route, native.CALLS, native.PYTHON_CALLS))
    native.reset_counts()
    t0 = time.perf_counter()
    with native.python_path():
        want = [decode(s)[0] for s in streams]
    python_ms = (time.perf_counter() - t0) * 1e3 / len(streams)
    check(native.PYTHON_CALLS[route] == len(streams) and sum(native.CALLS.values()) == 0,
          "%s in Python: native %s, Python %s" % (route, native.CALLS, native.PYTHON_CALLS))
    for g, w in zip(got, want):
        check(np.array_equal(g, w), "%s: the native decode differs from the Python one" % route)
    return native_ms, python_ms


def _predict_artifacts(out, case):
    from deepwmh_tpu_torch.core import nifti

    return {key: nifti.load_nifti_simple(os.path.join(out, rel % case)) for key, rel in (
        ("pre", "001_Preprocessed_Images/%s_0000.nii.gz"),
        ("raw", "002_Segmentations/001_raw/%s.nii.gz"),
        ("3mm", "002_Segmentations/002_postproc_3mm/%s.nii.gz"),
        ("fov", "002_Segmentations/003_postproc_fov/%s.nii.gz"))}


def flagship_package(work):
    """The flagship plan's model package with random weights from seed 0
    (phase main_path's)."""
    import torch

    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.release import write_model_package

    plan = default_plan_1mm_iso()
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(0))
    return write_model_package(os.path.join(work, "model"), model, plan, meta={"epoch": 0})


def phase_dicom_predict(kernels, work, smi, pkg):
    """A user's scanner export through the port alone: DICOM -> the
    dcm2niix CLI -> the predict CLI (in process, through ``main``).

    1. The flagship FLAIR (seed 0) quantized to uint16 and written as a
       uint16 NIfTI, and as a 192-slice JPEG Lossless SV1 series (1 mm, the
       sform of the NIfTI) by a pool of writer processes, while the predict
       CLI runs on the NIfTI;
    2. the dcm2niix CLI on the series: the source integers exactly, the
       sform within 1e-5 mm, ``jpegl_decode_diffs`` natively once a slice
       and never in Python;
    3. the predict CLI (8-flip TTA) on the converted NIfTI: K1's launches,
       seconds a volume; its N4 output, masks and foreground probability
       (the predictor on its N4 output) bit-equal to the NIfTI input's;
    4. a 16-slice series at 224x192 in each other syntax through the CLI:
       lossless ones exact, JPEG-LS near 2 within 2, the DCT ones equal to
       the port's decode of the same streams; each native route (Huffman
       pass, predictor 7 reconstruction, JPEG-LS scan) bit-equal to its
       Python version on four slices, with both times.

    Returns (K1's launches from the converted run, the converted NIfTI,
    the source NIfTI, the predict output folder)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    sys.path.append(os.path.join(HERE, "tests"))
    import torch_port_dicom as W

    from deepwmh_tpu_torch import native
    from deepwmh_tpu_torch.cli import dcm2niix as dcm2niix_cli
    from deepwmh_tpu_torch.cli import predict as predict_cli
    from deepwmh_tpu_torch.core import jlscodec, jpegcodec, nifti
    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.release import load_released_model

    t_phase = last = time.perf_counter()
    steps = {}

    def lap(name):
        nonlocal last
        now = time.perf_counter()
        steps[name] = now - last
        last = now

    native.get_lib()  # the host library's g++ build, kept out of the convert times
    lap("native_build")
    if pkg is None:
        pkg = flagship_package(work)
    source = np.round(synthetic_flair(FLAGSHIP_SHAPE, seed=0)).astype(np.uint16)
    affine = W.expected_affine(FLAGSHIP_SPACING, DICOM_ORIGIN, (1, 0, 0, 0, 1, 0))
    hdr = nifti.NiftiHeader()
    hdr.set_shape(FLAGSHIP_SHAPE)
    hdr.set_zooms(FLAGSHIP_SPACING)
    hdr.srow, hdr.sform_code = affine[:3].astype(np.float32), 1
    src_nii = os.path.join(work, "dicom_source.nii.gz")
    nifti.save_nifti(source, hdr, src_nii, dtype="uint16")
    lap("source")

    # 1. the writers in a pool beside the predict CLI on the source NIfTI
    jobs, small = _encode_jobs(work, source)
    pool = ProcessPoolExecutor(DICOM_ENCODE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    t0 = time.perf_counter()
    futures = [pool.submit(_encode_job, *job) for job in jobs]
    out_src = os.path.join(work, "dicom_predict_source")
    predict_cli.main(["-i", src_nii, "-n", "dcm0", "-m", pkg, "-o", out_src, "--no-previews",
                      "--device", DEVICE])
    torch.cuda.synchronize()
    lap("predict_source_beside_encode")
    encode_cpu_s = {}
    for f in futures:
        name, cpu_s = f.result()
        encode_cpu_s[name] = encode_cpu_s.get(name, 0.0) + cpu_s
    encode_wall_s = time.perf_counter() - t0
    pool.shutdown()
    lap("encode_wait")

    # 2. the dcm2niix CLI on the flagship series
    native.reset_counts()
    t0 = time.perf_counter()
    (converted,) = dcm2niix_cli.main(["-i", os.path.join(work, "dicom", "flagship"), "-o",
                                      os.path.join(work, "dicom_nii")])
    convert_s = time.perf_counter() - t0
    calls, python_calls = dict(native.CALLS), dict(native.PYTHON_CALLS)
    got, got_hdr = nifti.load_nifti(converted)
    differing = int((got != source.astype(np.float32)).sum())
    sform_err = float(np.abs(got_hdr.srow - affine[:3]).max())
    check(got.shape == FLAGSHIP_SHAPE and differing == 0,
          "converted flagship series: shape %s, %d voxels differ from the source"
          % (got.shape, differing))
    check(sform_err <= 1e-5, "converted sform off by %.3g mm" % sform_err)
    n = FLAGSHIP_SHAPE[2]
    check(calls["jpegl_decode_diffs"] == n and python_calls["jpegl_decode_diffs"] == 0,
          "flagship import: native %s, Python %s (want %d native Huffman passes, none in "
          "Python)" % (calls, python_calls, n))
    lap("convert")

    # 3. the predict CLI on the converted NIfTI
    plan = default_plan_1mm_iso()
    blocks = 4 * plan.num_pools + 2
    out_conv = os.path.join(work, "dicom_predict")
    for k in kernels.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict_cli.main(["-i", converted, "-n", "dcm0", "-m", pkg, "-o", out_conv, "--no-previews",
                      "--device", DEVICE])
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    check(launches["instance_norm_stats"] == 8 * blocks + 1
          and launches["instance_norm_act"] == 8 * blocks and launches["median3"] == 0,
          "predict on the converted series launched %s, expected %d / %d" %
          (launches, 8 * blocks + 1, 8 * blocks))
    lap("predict_converted")
    arts = {w: _predict_artifacts(out, "dcm0") for w, out in (("converted", out_conv),
                                                               ("source", out_src))}
    dev = torch.device(DEVICE)
    model, plan2 = load_released_model(pkg, device=dev)
    predictor = SlidingWindowPredictor(model, plan2, device=dev)
    fg = {}
    with torch.inference_mode():
        for w in arts:
            fg[w] = predictor.predict_case(arts[w]["pre"], FLAGSHIP_SPACING)[1].cpu().numpy()
    del model, predictor
    mask_diff = {key: int((arts["converted"][key] != arts["source"][key]).sum())
                 for key in ("pre", "raw", "3mm", "fov")}
    mask_diff["fg_probability"] = int((fg["converted"] != fg["source"]).sum())
    check(not any(mask_diff.values()),
          "converted vs NIfTI input: differing voxels %s" % mask_diff)
    lap("predict_compare")

    # 4. every other syntax, 16 slices at 224x192
    syntaxes = {}
    for name, (folder, vol, syntax, lossless) in small.items():
        t0 = time.perf_counter()
        (path,) = dcm2niix_cli.main(["-i", folder, "-o", os.path.join(work, "dicom_nii_" + name)])
        wall = time.perf_counter() - t0
        got = nifti.load_nifti_simple(path)
        check(got.shape == vol.shape, "%s: shape %s, want %s" % (name, got.shape, vol.shape))
        err = float(np.abs(got - vol.astype(np.float32)).max())
        row = {"convert_s": wall, "convert_s_per_slice": wall / vol.shape[2],
               "encode_cpu_s": encode_cpu_s[name], "max_abs_err": err}
        if lossless:
            check(err == 0, "%s: lossless syntax off by %g" % (name, err))
        elif syntax == W.JPEG_LS_NEAR:
            check(err <= 2, "%s: near-lossless error %g > 2" % (name, err))
        else:  # DCT: the port's own decode of the same streams
            with native.python_path():
                want = np.stack([jpegcodec.decode(s)[0] for s in
                                 _series_streams(folder, vol.shape[2])], -1)
            check(np.array_equal(got, want.astype(np.float32)),
                  "%s: differs from the decode of its own streams" % name)
        syntaxes[name] = row
    lap("syntaxes")
    flagship_streams = _series_streams(os.path.join(work, "dicom", "flagship"),
                                       DICOM_PLAIN_SLICES)
    routes = {}
    for route, decode, folder in (
            ("jpegl_decode_diffs", jpegcodec.decode, None),
            ("jpegl_reconstruct", jpegcodec.decode, small["jpeg_lossless_p14_pred7"][0]),
            ("jls_decode_scan", jlscodec.decode, small["jpegls_lossless"][0])):
        streams = flagship_streams if folder is None else _series_streams(folder,
                                                                          DICOM_PLAIN_SLICES)
        native_ms, python_ms = _plain_route(decode, streams, route)
        routes[route] = {"native_ms_per_slice": native_ms, "python_ms_per_slice": python_ms,
                         "slices": len(streams),
                         "slice": "192x224" if folder is None else "224x192"}
    lap("plain_routes")
    emit({"phase": "dicom_predict", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "syntax": "JPEG Lossless SV1 (1.2.840.10008.1.2.4.70), precision 16",
          "slices": n, "encode_wall_s": encode_wall_s, "encode_workers": DICOM_ENCODE_WORKERS,
          "encode_cpu_s": encode_cpu_s, "convert_s": convert_s,
          "convert_s_per_slice": convert_s / n, "native_calls": calls,
          "python_calls": python_calls, "differing_voxels": differing,
          "sform_max_abs_err_mm": sform_err, "predict_s_per_volume": predict_s,
          "predict_launches": launches, "converted_vs_nifti_differing": mask_diff,
          "fg_fraction": float(arts["converted"]["fov"].mean()), "syntaxes": syntaxes,
          "native_routes": routes, "steps_s": steps, "phase_s": time.perf_counter() - t_phase})
    return launches, converted, src_nii, out_conv


def _t1w_of(flair, device):
    """A T1w-like contrast remap of a flagship FLAIR, moved by a small known
    affine (``small_affine``, seed 5); returns (T1w, the affine)."""
    from deepwmh_tpu_torch.registration.affine import apply_affine

    remap = np.where(flair > 100, 1200.0 - 1.5 * flair, 0.3 * flair).astype(np.float32)
    mat = small_affine(FLAGSHIP_SHAPE, FLAGSHIP_SPACING, seed=5)
    t1 = apply_affine(remap, mat, FLAGSHIP_SHAPE, FLAGSHIP_SPACING, FLAGSHIP_SPACING, order=1,
                      device=device)
    return t1.cpu().numpy(), mat


def phase_oasis3_prep(work, smi, src_nii, dicom_mask_path, cases):
    """The OASIS-3 recipe's steps on the port (``experiments/oasis3``):

    1. ``prepare_reference_case`` (quick) for one reference subject at
       192x224x192: the uint16 FLAIR of phase dicom_predict, a T1w
       contrast remap of it under a small known affine, the first atlas of
       ``registration_cohort`` (``synthetic_atlas`` seed 0, 4 classes):
       label1's brain Dice against the phantom's head >= the floor, label2
       holding classes 1-3;
    2. ``evaluate_training_fit`` on three flagship cases (the dicom_predict
       mask and two synthetic predictions, two synthetic raters each) on the
       card and, in a second thread, on the CPU: the same CSV, number for
       number."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.experiments.oasis3.run_oasis3 import (
        evaluate_training_fit,
        prepare_reference_case,
    )
    from deepwmh_tpu_torch.registration.priors import synthetic_atlas

    t_phase = last = time.perf_counter()
    steps = {}

    def lap(name):
        nonlocal last
        now = time.perf_counter()
        steps[name] = now - last
        last = now

    root = os.path.join(work, "oasis3")
    os.makedirs(root)
    hdr = nifti.NiftiHeader()
    hdr.set_shape(FLAGSHIP_SHAPE)
    hdr.set_zooms(FLAGSHIP_SPACING)
    flair = nifti.load_nifti_simple(src_nii)
    t1, mat = _t1w_of(flair, DEVICE)
    t1_path = os.path.join(root, "t1w_raw.nii.gz")
    nifti.save_nifti(t1, hdr, t1_path)
    if cases is None:  # --dicom: the same atlas registration_cohort writes
        image, label = synthetic_atlas(FLAGSHIP_SHAPE, FLAGSHIP_SPACING, seed=0)
        cases = {"src0": (os.path.join(root, "atlas_img.nii.gz"),
                          os.path.join(root, "atlas_lbl.nii.gz"))}
        nifti.save_nifti(image, hdr, cases["src0"][0])
        nifti.save_nifti(label, hdr, cases["src0"][1])
    lap("inputs")
    torch.cuda.synchronize()
    l1_path, l2_path = prepare_reference_case("ref0", t1_path, src_nii, *cases["src0"],
                                              os.path.join(root, "prep"), quick=True,
                                              device=DEVICE)
    torch.cuda.synchronize()
    lap("prepare_reference_case")
    l1, l2 = nifti.load_nifti_simple(l1_path), nifti.load_nifti_simple(l2_path)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in FLAGSHIP_SHAPE], indexing="ij")
    head = np.sqrt(sum(a ** 2 for a in g)) < 0.85  # synthetic_flair's head
    dice = _dice(l1 > 0.5, head)
    classes = sorted(np.unique(l2).tolist())
    check(dice >= REG_BRAIN_DICE_FLOOR, "oasis3 prep: label1 brain Dice %.4f" % dice)
    check({1.0, 2.0, 3.0} <= set(classes) <= {0.0, 1.0, 2.0, 3.0},
          "oasis3 prep: label2 classes %s" % classes)

    # 2. the training-fit evaluation over three flagship cases
    fit, raters = os.path.join(root, "fit"), os.path.join(root, "raters")
    names = ["dcm0", "syn1", "syn2"]
    os.makedirs(fit)
    for i, case in enumerate(names):
        # rater 1 planted lesions, rater 2 the same shifted with half their
        # rim kept; the synthetic cases' proposal rater 2 shifted once more
        second, first = lesion_pair(FLAGSHIP_SHAPE, 120, seed=40 + 2 * i)
        os.makedirs(os.path.join(raters, case))
        nifti.save_nifti(first, hdr, os.path.join(raters, case, "rater_1.nii.gz"))
        nifti.save_nifti(second, hdr, os.path.join(raters, case, "rater_2.nii.gz"))
        fit_case = os.path.join(fit, "%s.nii.gz" % case)
        if case == "dcm0":
            shutil.copyfile(dicom_mask_path, fit_case)
        else:
            nifti.save_nifti(np.roll(second, 1, axis=2), hdr, fit_case)
    lap("evaluate_inputs")
    walls, csvs = {}, {}

    def evaluate(where):
        t0 = time.perf_counter()
        out = os.path.join(root, "eval_" + where)
        os.makedirs(out)
        csvs[where] = evaluate_training_fit(names, fit, raters, out,
                                            device=DEVICE if where == "card" else "cpu")
        torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    cpu_run = pool.submit(evaluate, "cpu")
    evaluate("card")
    cpu_run.result()
    pool.shutdown()
    lap("evaluate")
    rows = {}
    for where, path in csvs.items():
        with open(path) as f:
            rows[where] = [line.strip().split(",") for line in f]
    check(rows["card"] == rows["cpu"], "the card's CSV differs from the CPU's:\n%s\n%s"
          % (rows["card"], rows["cpu"]))
    check(rows["card"][0] == ["case", "intra-rater_variability", "proposed_vs_rater1",
                              "proposed_vs_rater2"] and [r[0] for r in rows["card"][1:]] == names,
          "evaluation CSV %s" % rows["card"])
    emit({"phase": "oasis3_prep", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "label1_brain_dice": dice, "label2_classes": classes,
          "t1w_affine": mat.tolist(), "evaluation_csv": rows["card"],
          "evaluate_s": walls, "card_csv_equals_cpu": True,
          "steps_s": steps, "phase_s": time.perf_counter() - t_phase})


def e2e_dice(smi, repeats=1) -> dict:
    """``--e2e-dice``: run_e2e_accuracy at the JAX package's e2e accuracy
    configuration (64x80x64 2 mm, 5 references, 3 patients, 2 held-out,
    default_e2e_budget()) for seeds 0, 1 and 2, each with the svf and the
    learned registration forced, ``repeats`` times: one line per run with
    the held-out and stage-1 Dice, the wall and the registration's seconds
    per pair; then each mode's means, each (seed, mode)'s run-to-run range
    of the held-out Dice, each seed's svf - learned gap of the means, and
    the policy readings at this shape."""
    import torch

    from deepwmh_tpu_torch.eval.e2e import run_e2e_accuracy
    from deepwmh_tpu_torch.registration.learned import LearnedRegConfig

    cfg = dict(n_ref=5, n_train=3, n_test=2)
    pairs = cfg["n_ref"] * cfg["n_train"]
    seeds, modes = (0, 1, 2), ("svf", "learned")
    runs = []
    for seed in seeds:
        for mode in modes:
            for rep in range(repeats):
                with tempfile.TemporaryDirectory(prefix=".chip_smoke-e2e-", dir=HERE) as work:
                    with learned_timing() as lt:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        res = run_e2e_accuracy(work, shape=E2E_SHAPE, spacing=E2E_SPACING,
                                               seed=seed, registration_mode=mode,
                                               device=DEVICE, **cfg)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                reg_s = res["stage_stats"]["registration"]["s"]
                row = {"phase": "e2e_dice", "nvidia_smi": smi, "seed": seed, "mode": mode,
                       "repeat": rep, "heldout_dice": res["dice"],
                       "heldout_per_case": res["heldout_dice"],
                       "heldout_pr": res["heldout_pr"], "stage1_dice": res["stage1_dice"],
                       "stage1_mean_dice": float(np.mean(list(res["stage1_dice"].values()))),
                       "trainfit_dice": res["trainfit_dice"], "wall_s": wall,
                       "registration_s": reg_s, "s_per_pair": reg_s / pairs,
                       "stage_stats": res["stage_stats"]}
                if mode == "learned":
                    row.update(template_s=lt["template_s"], train_s=lt["train_s"],
                               s_per_step=lt["train_s"] / LearnedRegConfig().steps,
                               first_step_s=lt["first_step_s"],
                               s_per_template_volume=lt["template_s"] / (cfg["n_ref"]
                                                                         + cfg["n_train"]),
                               s_per_learned_pair=(reg_s - lt["template_s"] - lt["train_s"])
                               / pairs)
                emit(row)
                runs.append(row)
    by_mode = {m: [r for r in runs if r["mode"] == m] for m in modes}
    summary = {m: {"heldout_dice_mean": float(np.mean([r["heldout_dice"] for r in rs])),
                   "stage1_dice_mean": float(np.mean([r["stage1_mean_dice"] for r in rs]))}
               for m, rs in by_mode.items()}
    cell = {(s, m): [r["heldout_dice"] for r in runs if r["seed"] == s and r["mode"] == m]
            for s in seeds for m in modes}
    spread = {"%d/%s" % k: float(max(v) - min(v)) for k, v in cell.items()}
    gap = {str(s): float(np.mean(cell[(s, "svf")]) - np.mean(cell[(s, "learned")]))
           for s in seeds}
    learned = by_mode["learned"]
    step = float(np.median([r["s_per_step"] for r in learned]))
    readings = {
        "shape": list(E2E_SHAPE),
        "T_SVF_PAIR_S": float(np.median([r["s_per_pair"] for r in by_mode["svf"]])),
        "T_LEARNED_PAIR_S": float(np.median([r["s_per_learned_pair"] for r in learned])),
        "LEARNED_FIXED_COMPILE_S": float(np.median([r["first_step_s"] for r in learned])) - step,
        "LEARNED_FIXED_SCALED_S": 10 * float(np.median(
            [r["s_per_template_volume"] for r in learned]))
        + LearnedRegConfig().steps * step}
    emit({"phase": "e2e_dice_summary", "nvidia_smi": smi, "by_mode": summary,
          "heldout_run_to_run_range": spread, "svf_minus_learned_by_seed": gap,
          "policy_readings": readings})
    return summary


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of deepwmh_tpu_torch on one GPU.")
    parser.add_argument("--e2e-dice", action="store_true",
                        help="Instead of the smoke phases, the train -> predict accuracy "
                        "loop at the e2e configuration, seeds 0-2, svf and learned.")
    parser.add_argument("--repeats", type=int, default=1,
                        help="--e2e-dice's runs of each (seed, mode) (default 1)")
    parser.add_argument("--convert-evaluate", action="store_true",
                        help="Instead of every phase, only convert_evaluate and surface "
                        "(after the build).")
    parser.add_argument("--dicom", action="store_true",
                        help="Instead of every phase, only dicom_predict and oasis3_prep "
                        "(after the build).")
    parser.add_argument("--mesh", action="store_true",
                        help="Instead of every phase, only mesh and mesh_train (after the "
                        "build).")
    parser.add_argument("--k1", action="store_true",
                        help="Instead of every phase, only k1 (K1 and its backward) and "
                        "train (after the build).")
    parser.add_argument("--crossover", choices=("svf", "learned"),
                        help="Instead of the phases, the 12 x 14 = 168-pair crossover study "
                        "with this registration mode forced (about 33 min for svf).")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(HERE, "deepwmh_tpu_torch", "csrc",
                                       "instance_norm_stats.cu")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deepwmh_tpu_torch.ops import kernels
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso

    check(os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))
          == os.path.join(HERE, "deepwmh_tpu_torch"),
          "deepwmh_tpu_torch imported from outside this checkout")
    t_start = time.perf_counter()
    phase_s = {}

    def run(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__[len("phase_"):]] = time.perf_counter() - t0
        return out

    smi = run(phase_device, kernels)
    if args.e2e_dice:
        e2e_dice(smi, args.repeats)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.crossover:
        from deepwmh_tpu_torch.experiments.studies import crossover_e2e_study

        with tempfile.TemporaryDirectory(prefix=".chip_smoke-crossover-", dir=HERE) as work:
            row = crossover_e2e_study.run(args.crossover, DEVICE, work=work)
        check(0.0 <= row["heldout_dice"] <= 1.0 and row["n_pairs"] == 168,
              "crossover: %r" % row)
        emit({"phase": "crossover", "nvidia_smi": smi, **row})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.convert_evaluate:
        with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=HERE) as work:
            run(phase_convert_evaluate, kernels, work, smi)
            run(phase_surface, work, smi, synthetic_flair(FLAGSHIP_SHAPE, seed=0))
        emit({"phase": "done", "total_s": time.perf_counter() - t_start, "phase_s": phase_s,
              "nvidia_smi": smi})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.dicom:
        with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=HERE) as work:
            _, _, src_nii, dicom_out = run(phase_dicom_predict, kernels, work, smi, None)
            run(phase_oasis3_prep, work, smi, src_nii, os.path.join(dicom_out, DICOM_FOV), None)
        emit({"phase": "done", "total_s": time.perf_counter() - t_start, "phase_s": phase_s,
              "nvidia_smi": smi})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.mesh:
        with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=HERE) as work:
            run(phase_mesh, kernels, work, smi, flagship_package(work),
                synthetic_flair(FLAGSHIP_SHAPE, seed=0))
            run(phase_mesh_train, kernels, work, smi)
        emit({"phase": "done", "total_s": time.perf_counter() - t_start, "phase_s": phase_s,
              "nvidia_smi": smi})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.k1:
        with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=HERE) as work:
            k1_entry, act_entry, bwd_entry = run(phase_k1, kernels, default_plan_1mm_iso())
            step_launches = run(phase_train, kernels, work, smi)
        bwd_entry.update(launches={n: step_launches[n] for n in step_launches
                                   if n.startswith("instance_norm_act_bwd")},
                         launches_per="six flagship train steps")
        emit({"phase": "done", "total_s": time.perf_counter() - t_start, "phase_s": phase_s,
              "nvidia_smi": smi})
        emit({"kernels": [k1_entry, act_entry, bwd_entry]})
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    k1_entry, act_entry, bwd_entry = run(phase_k1, kernels, default_plan_1mm_iso())
    k1_learned = run(phase_k1_learned, kernels)
    k2_entry = run(phase_k2, kernels)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=HERE) as work:
        launches, flair, pkg = run(phase_main_path, kernels, work, smi)
        run(phase_card_vs_cpu, kernels, work)
        stage1_launches, stage1, stage1_batch_launches = run(phase_stage1, kernels, work, smi)
        run(phase_serve, kernels, work, pkg, smi)
        mesh_launches = run(phase_mesh, kernels, work, smi, pkg, flair, stage1)
        step_launches = run(phase_train, kernels, work, smi)
        run(phase_train_card_vs_cpu, kernels, work)
        src_csv, tgt_csv, cases, reg_out, reg = run(phase_group_register, kernels, work, smi)
        run(phase_warm, work, smi, src_csv, tgt_csv, cases, reg_out)
        learned_launches, learned_row = run(phase_learned, kernels, work, smi, cases)
        run(phase_priors, work, smi, cases)
        run(phase_reg_card_vs_cpu, work)
        mesh_train_launches = run(phase_mesh_train, kernels, work, smi, cases)
        train_launches, train_plan = run(phase_train_e2e, kernels, work, smi, flair, pkg)
        convert_launches = run(phase_convert_evaluate, kernels, work, smi)
        run(phase_surface, work, smi, flair)
        dicom_launches, _, src_nii, dicom_out = run(phase_dicom_predict, kernels, work, smi, pkg)
        run(phase_oasis3_prep, work, smi, src_nii, os.path.join(dicom_out, DICOM_FOV), cases)
    t0 = time.perf_counter()
    k1_train, act_train, _ = phase_k1(kernels, train_plan, E2E_SHAPE, "k1_train",
                                      "%dx%dx%d train-path" % E2E_SHAPE)
    phase_s["k1_train"] = time.perf_counter() - t0
    run(phase_postproc_exact, flair)
    run(phase_stage1_card_vs_cpu, kernels)
    # each kernel's launches on its own path: K1's two on predict (and on
    # the learned registration), K2 on stage-1
    k1_entry["launches"] = launches["instance_norm_stats"]
    act_entry["launches"] = launches["instance_norm_act"]
    k2_entry["launches"] = stage1_launches["median3"]
    # and on stage-1 over a case batch (phase stage1: two flagship cases, one launch)
    k2_entry["batch_stage1_launches"] = stage1_batch_launches["median3"]
    learned_per = "one learned-registration forward on the %dx%dx%d template grid (%d calls)" % (
        template_grid(FLAGSHIP_SHAPE, FLAGSHIP_SPACING) + (k1_learned["learned_forward_calls"],))
    k1_entry.update(learned_launches=learned_launches["instance_norm_stats"],
                    learned_max_abs_err=k1_learned["learned_max_abs_err"],
                    learned_ms=k1_learned["learned_forward_ms"],
                    learned_plain_ms=k1_learned["learned_forward_plain_ms"],
                    learned_library_ms=k1_learned["learned_forward_library_ms"],
                    learned_bound_ms=k1_learned["learned_forward_bound_ms"], learned_per=learned_per)
    act_entry.update(learned_launches=learned_launches["instance_norm_act"],
                     learned_ms=k1_learned["learned_forward_act_ms"],
                     learned_plain_ms=k1_learned["learned_forward_act_plain_ms"],
                     learned_bound_ms=k1_learned["learned_forward_act_bound_ms"],
                     learned_per=learned_per)
    # and on the train path (stage 2-4 and 3-5 sweeps; stage-1's median)
    for entry, train_entry in ((k1_entry, k1_train), (act_entry, act_train)):
        entry.update({"train_" + key: train_entry[key] for key in
                      ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "per")})
        entry["train_launches"] = train_launches[entry["name"]]
    k2_entry["train_launches"] = train_launches["median3"]
    # and on the converted model's predict CLI run (phase convert_evaluate)
    # and on the predict CLI run on the converted DICOM series (dicom_predict)
    for entry in (k1_entry, act_entry):
        entry["convert_launches"] = convert_launches[entry["name"]]
        entry["dicom_launches"] = dicom_launches[entry["name"]]
    # and on the mesh paths (phase mesh): the 8-shard predict_case_full for
    # K1's two, the halo-sharded median for K2
    # and on run_train over the 2-shard mesh (phase mesh_train): K1's two in
    # the stage 2-4 / 3-5 sweeps, K2 once a stage-1 case
    for entry in (k1_entry, act_entry, k2_entry):
        entry["mesh_launches"] = mesh_launches[entry["name"]]
        entry["mesh_train_launches"] = mesh_train_launches[entry["name"]]
    check(set(launches) == set(stage1_launches) == set(stage1_batch_launches)
          == set(learned_launches) == set(train_launches)
          == set(convert_launches) == set(dicom_launches) == set(mesh_launches)
          == set(mesh_train_launches) == set(kernels.KERNELS),
          "unlisted kernels: %s" % sorted(launches))
    # the policy's readings at the flagship shape (registration/policy.py
    # holds those of --e2e-dice at 64x80x64)
    emit({"phase": "policy_readings", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "T_SVF_PAIR_S": reg["s_per_pair"], "T_LEARNED_PAIR_S": learned_row["s_per_pair"],
          "LEARNED_FIXED_COMPILE_S": learned_row["first_step_s"] - learned_row["s_per_step"],
          "LEARNED_FIXED_SCALED_S": 10 * learned_row["s_per_template_volume"]
          + 300 * learned_row["s_per_step"],
          "scaled_from_steps": LEARNED_STEPS})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "phase_s": phase_s,
          "nvidia_smi": smi})
    # K1's backward: its two kernels' launches over phase train's six
    # flagship steps and on the train path
    bwd = ("instance_norm_act_bwd_stats", "instance_norm_act_bwd_dx")
    bwd_entry.update(launches={n: step_launches[n] for n in bwd},
                     launches_per="six flagship train steps",
                     train_launches={n: train_launches[n] for n in bwd})
    emit({"kernels": [k1_entry, act_entry, bwd_entry, k2_entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
