"""Smoke run of the PyTorch/CUDA port (deepwmh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines to stdout:

1. device: the card's name and power limit (``nvidia-smi``), and the build
   of every CUDA kernel of the port from ``deepwmh_tpu_torch/csrc`` (and of
   the min/max rate probe ``fmnmx_rate.cu``), with registers and spills;
2. k1: K1's two kernels at every [N, M, C] the flagship forward gives them:
   the statistics kernel against its plain PyTorch version (and the same
   bits on a second call) with its back-to-back, device-only (profiler) and
   host-per-call times beside ``torch.var_mean``'s (the two measured in
   turns, medians of five) and the memory bound;
   the apply kernel (normalize + affine + leaky ReLU) bit for bit against
   the plain chain, with both times and its memory bound;
3. main_path: ``DeepWMH_predict`` through ``run_predict`` at the flagship plan
   (192x224x192 1 mm FLAIR, 8-flip whole-volume TTA, random weights from a
   seed) on two cases, with the kernels' launch counts from that run, then a
   per-stage timing of the same pipeline and a profile of one TTA sweep;
4. card_vs_cpu: the card (kernel path, f32, no TF32) against the CPU (plain
   path) on a small plan, whole-volume and patch sweeps;
5. k2: the 3x3x3 median kernel against its plain version (value equality)
   at the flagship stage-1 call, an odd shape and 1x1x1, with the kernel's,
   the plain version's and an unfold + torch.median route's times beside
   its bound, its min/max per output (counted and from the SASS) and the
   card's min/max rate measured by the probe;
6. stage1: stage-1 NLL lesion analysis through ``LesionAnalyzer`` at
   192x224x192 1 mm with K = 10 synthetic registered references (two
   cases), K2's launches from that run, the artifacts checked against the
   planted lesions, then the device stages and host I/O of one case;
7. postproc_exact: spark removal and the brain mask on the card equal to the
   CPU's at 192x224x192;
8. stage1_card_vs_cpu: the stage-1 core on the card against the CPU at
   96x112x96, 2 mm, K = 4;
9. kernels: one line listing each kernel with its launches on its path
   (K1's statistics and apply kernels on the predict path, K2 on the
   stage-1 path).

The last line of stdout is ``{"ok": true, "device": {...}}``. A failed phase
raises, and the script exits non-zero before printing it; so it does with no
CUDA device, or outside a checkout of the repository.
"""

from __future__ import annotations

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


def forward_flops(plan, shape) -> int:
    """Conv MACs x 2 of one batch-1 forward at ``shape`` without deep
    supervision: two convs per encoder stage; per decoder stage the
    transpose conv (one tap per output voxel) and two convs; the head."""
    from deepwmh_tpu_torch.unet.plan import features_per_stage

    feats = features_per_stage(plan)
    spatial = [tuple(shape)]
    for k in plan.pool_kernels:
        spatial.append(tuple(-(-a // int(s)) for a, s in zip(spatial[-1], k)))
    vox = [math.prod(s) for s in spatial]
    kv = [math.prod(k) for k in plan.conv_kernels]
    macs = vox[0] * feats[0] * plan.num_classes
    cin = plan.in_channels
    for i in range(plan.num_pools + 1):
        macs += vox[i] * kv[i] * (cin + feats[i]) * feats[i]
        cin = feats[i]
    for i in range(plan.num_pools):
        macs += vox[i] * feats[i] * (feats[i + 1] + 3 * feats[i] * kv[i])
    return 2 * macs


def phase_device(kernels):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # every kernel of the port, and the min/max rate probe of phase k2
    sources = sorted({k.source for k in kernels.KERNELS.values()} | {"fmnmx_rate.cu"})
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


def phase_k1(kernels, plan):
    """K1's statistics kernel against its plain version and torch.var_mean,
    and K1's apply kernel against the plain chain it replaces, at every
    [N, M, C] of the flagship forward. Returns the kernels-line entries of
    both: times summed over the 22 calls of one forward."""
    import torch

    stats, act = kernels.instance_norm_stats, kernels.instance_norm_act
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    keys = ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bytes_ms", "ops_ms", "act_ms", "act_plain_ms", "act_bytes_ms")
    total = {k: 0.0 for k in keys}
    max_err = act_err = 0.0
    calls_per_forward = 0
    slope = float(torch.tensor(0.01, dtype=torch.bfloat16))  # the bf16 model's slope
    for spatial, c, calls in stats_shapes(plan, FLAGSHIP_SHAPE):
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
        emit({"phase": "k1", "shape_nmc": [n, m, c], "calls_per_forward": calls,
              "max_abs_err": err, "act_max_abs_err": row_act_err, **row})
        for key in total:
            total[key] = None if total[key] is None or row[key] is None else (
                total[key] + calls * row[key])
        max_err = max(max_err, err)
        act_err = max(act_err, row_act_err)
        calls_per_forward += calls
        del x, x3, mean, var, ref_mean, ref_var, out, want
    check(calls_per_forward == 4 * plan.num_pools + 2, "K1 shape table is off")
    per = "one flagship forward (%d calls)" % calls_per_forward
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
    return stats_entry, act_entry


def _timed(name, fn, times):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
    return out


def phase_main_path(kernels, work, smi):
    """The flagship DeepWMH_predict through run_predict on two cases; the
    kernels' launch counts are those of this run only."""
    import torch

    from deepwmh_tpu_torch.cli.predict import run_predict
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.ops.brain import brain_extract
    from deepwmh_tpu_torch.ops.components import remove_3mm_sparks
    from deepwmh_tpu_torch.ops.n4 import n4_bias_correction
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.preprocess import preprocess_case, resample_to_shape
    from deepwmh_tpu_torch.unet.release import load_released_model, write_model_package

    plan = default_plan_1mm_iso()
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(0))
    pkg = write_model_package(os.path.join(work, "model"), model, plan, meta={"epoch": 0})
    del model
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_predict(images, cases, pkg, out, make_previews=False, device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

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
    agree = float((fov.cpu().numpy() == first["fov"]).mean())
    # N4's histogram sums with float atomics, so a rerun may differ in the
    # last bits; the masks must still agree almost everywhere
    check(agree > 0.999, "staged rerun agrees with the main path on only %.5f" % agree)
    emit({"phase": "main_path", "nvidia_smi": smi, "plan": "default_plan_1mm_iso",
          "shape": list(FLAGSHIP_SHAPE), "cases": len(cases), "tta_flips": len(ALL_FLIPS),
          "wall_s": wall_s, "s_per_volume": wall_s / len(cases),
          "peak_device_gb": peak_gb, "launches": launches, "fg_fraction": fracs,
          "stage_s": times, "stage_sum_s": sum(times.values()), "host_io_s": io,
          "tta_sweep_profile": profile, "staged_vs_main_fov_agreement": agree,
          **sweep_rate(plan2, profile, times["tta_sweep"])})
    return launches, vols[0]


def sweep_rate(plan, profile, sweep_s):
    """Conv FLOP rate of the 8-flip sweep, over its wall time and over the
    time the profiler saw in convolution kernels."""
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

    D, H, W = vol.shape
    win = F.pad(vol, (1, 1, 1, 1, 1, 1)).unfold(0, 3, 1).unfold(1, 3, 1).unfold(2, 3, 1)
    return win.reshape(D, H, W, 27).median(-1).values


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


def fmnmx_rate(kernels) -> dict:
    """The card's f32 min/max issue rate, from csrc/fmnmx_rate.cu (64
    min/max per round per thread on every SM)."""
    import ctypes

    import torch

    lib_path = kernels.build(["fmnmx_rate.cu"])["fmnmx_rate.cu"]
    lib = ctypes.CDLL(lib_path)
    lib.fmnmx_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fmnmx_rate.restype = ctypes.c_int
    out = torch.empty(1, device=DEVICE)
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 8
    threads, rounds = 256, 4096
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        check(lib.fmnmx_rate(out.data_ptr(), blocks, threads, rounds, 0.5, stream) == 0,
              "the FMNMX probe did not launch")

    ms = cuda_ms(run, iters=5)
    ops = 64 * rounds * blocks * threads
    return {"fmnmx_per_s": ops / (ms / 1e3), "probe_ms": ms,
            "probe_sass_fmnmx": sass_count(lib_path, "FMNMX")}


def phase_k2(kernels):
    """K2 against its plain version (value equality) and the unfold+median
    library route at the flagship stage-1 call, an odd shape and 1x1x1,
    beside the card's measured min/max rate. Returns the kernels-line entry,
    timed at the flagship shape (one call per stage-1 case)."""
    import torch

    k2 = kernels.median3
    rate = fmnmx_rate(kernels)
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
            # the executed min/max at the rate measured on this card
            "ops_ms_measured_rate": executed / rate["fmnmx_per_s"] * 1e3,
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        err = float((got - want).abs().max())
        emit({"phase": "k2", "shape": list(shape),
              "minmax_per_voxel_pr2": kernels.median27_minmax_ops(),
              "minmax_per_output": shared["per_output"],
              "minmax_executed_per_output": executed / n,
              "outputs_per_thread": _cu_constant("median3.cu", "kChunk"),
              "sass_fmnmx": fmnmx, "sass_minmax_per_output": sass_per_output,
              **rate, "max_abs_err": err,
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
    return entry


def _dice(a, b):
    return 2.0 * float((a & b).sum()) / max(float(a.sum() + b.sum()), 1.0)


def phase_stage1(kernels, work, smi):
    """Stage-1 NLL lesion analysis through LesionAnalyzer at the flagship
    geometry with K = 10 references, two cases (the same cohort under two
    names); K2's launch count is that of this run only. Then the same case
    stage by stage for where the time goes."""
    import torch

    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.pipeline.analysis import LesionAnalyzer

    t0 = time.perf_counter()
    *inputs, lesions = write_cohort(os.path.join(work, "cohort"), FLAGSHIP_SHAPE,
                                    FLAGSHIP_SPACING, STAGE1_K, seed=0)
    setup_s = time.perf_counter() - t0
    cases = ["case0", "case1"]
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
    first, second = arts[cases[0]], arts[cases[1]]
    check(all(np.array_equal(first[k], second[k]) for k in STAGE1_ARTIFACTS + ("threshold",)),
          "the same inputs gave two different results")
    avg = first["averaged_label"]
    in_cb = float((lesions * (avg == 2)).sum())
    check(in_cb > 0, "no planted lesion lies in the class-2 (median) region")

    # the same case stage by stage: host reads, the core's device stages
    # (each between two synchronisations), artifact writes, segmentation
    an2 = LesionAnalyzer(os.path.join(work, "stage1_staged"), device=DEVICE)
    an2.add_case(cases[0], *inputs)
    io, stage_s = {}, {}
    loaded = _timed("read_inputs", lambda: an2._load_case(cases[0]), io)
    result, hdr, _ = _timed("analyze_case", lambda: an2.analyze_case(
        cases[0], loaded=loaded, stage_s=stage_s), io)
    _timed("write_artifacts", lambda: an2._save_case_artifacts(cases[0], result, hdr, "+"), io)
    _timed("segmentation_and_pp", lambda: an2.analyze_and_do_segmentation("+"), io)
    check(result.threshold == first["threshold"] and np.array_equal(result.anomaly,
                                                                   first["anomaly_score"]),
          "the staged rerun differs from the main run")
    stage_sum = sum(stage_s.values())
    emit({"phase": "stage1", "nvidia_smi": smi, "shape": list(FLAGSHIP_SHAPE),
          "spacing": list(FLAGSHIP_SPACING), "K": STAGE1_K, "cases": len(cases),
          "setup_s": setup_s, "wall_s": wall_s, "s_per_case": wall_s / len(cases),
          "peak_device_gb": peak_gb, "launches": launches, "threshold": first["threshold"],
          "dice_pp": first["dice_pp"], "lesion_voxels": float(lesions.sum()),
          "lesion_voxels_in_class2": in_cb,
          "seg_fraction": float(first["segmentation"].mean()),
          "seg_pp_fraction": float(first["segmentation_pp"].mean()),
          "device_stage_s": stage_s, "device_stage_sum_s": stage_sum,
          "median3_share_of_device": stage_s["median_3mm"] / stage_sum,
          # analyze_case outside the device stages: the host's stacking and
          # label-count work and the copies to and from the card
          "host_s": io, "analyze_case_outside_stages_s": io["analyze_case"] - stage_sum})
    return launches


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


def main() -> int:
    import torch

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
    smi = phase_device(kernels)
    k1_entry, act_entry = phase_k1(kernels, default_plan_1mm_iso())
    k2_entry = phase_k2(kernels)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=HERE) as work:
        launches, flair = phase_main_path(kernels, work, smi)
        phase_card_vs_cpu(kernels, work)
        stage1_launches = phase_stage1(kernels, work, smi)
    phase_postproc_exact(flair)
    phase_stage1_card_vs_cpu(kernels)
    # each kernel's launches on its own path: K1's two on predict, K2 on
    # stage-1
    k1_entry["launches"] = launches["instance_norm_stats"]
    act_entry["launches"] = launches["instance_norm_act"]
    k2_entry["launches"] = stage1_launches["median3"]
    check(set(launches) == set(stage1_launches)
          == {"instance_norm_stats", "instance_norm_act", "median3"},
          "unlisted kernels: %s" % sorted(launches))
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "nvidia_smi": smi})
    emit({"kernels": [k1_entry, act_entry, k2_entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
