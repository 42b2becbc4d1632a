"""Smoke run of the PyTorch/CUDA port (deepwmh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines to stdout:

1. device: the card's name and power limit (``nvidia-smi``), and the build
   of every CUDA kernel of the port from ``deepwmh_tpu_torch/csrc``;
2. k1: the instance-norm statistics kernel against its plain PyTorch version
   at every [N, M, C] the flagship forward gives it, with the kernel's, the
   plain version's and ``torch.var_mean``'s times beside the memory bound;
3. main_path: ``DeepWMH_predict`` through ``run_predict`` at the flagship plan
   (192x224x192 1 mm FLAIR, 8-flip whole-volume TTA, random weights from a
   seed) on two cases, with the kernels' launch counts from that run, then a
   per-stage timing of the same pipeline;
4. card_vs_cpu: the card (kernel path, f32, no TF32) against the CPU (plain
   path) on a small plan, whole-volume and patch sweeps;
5. postproc_exact: spark removal and the brain mask on the card equal to the
   CPU's at 192x224x192;
6. kernels: one line listing each kernel with its launches on the main path.

The last line of stdout is ``{"ok": true, "device": {...}}``. A failed phase
raises, and the script exits non-zero before printing it; so it does with no
CUDA device, or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM, NVIDIA's data sheet: HBM rate and the f32 rate outside the
# tensor cores (the statistics kernel does f32 adds and FMAs)
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
    sources = sorted({k.source for k in kernels.KERNELS.values()})
    t0 = time.perf_counter()
    libs = kernels.build(sources)
    build_s = time.perf_counter() - t0
    for k in kernels.KERNELS.values():
        k.lib()
    emit({"phase": "device", "nvidia_smi": smi, "sources": sources,
          "libraries": [os.path.relpath(p, HERE) for p in libs.values()],
          "build_s": build_s})
    return smi


def phase_k1(kernels, plan):
    """K1 against its plain version and torch.var_mean at the flagship
    forward's shapes. Returns the kernels-line entry: times summed over the
    22 calls of one forward."""
    import torch

    k1 = kernels.instance_norm_stats
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    total = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
             "bytes_ms": 0.0, "ops_ms": 0.0}
    max_err = 0.0
    calls_per_forward = 0
    for spatial, c, calls in stats_shapes(plan, FLAGSHIP_SHAPE):
        x = (torch.randn((1,) + spatial + (c,), generator=gen, device=DEVICE) * 2
             + 0.5).to(torch.bfloat16)
        n, m = 1, int(np.prod(spatial))
        mean, var = k1(x)
        ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
        torch.cuda.synchronize()
        # f32 sums in another order than torch's reduction: both are within
        # a few ulps of the exact moments (var ~ 4 here)
        torch.testing.assert_close(mean, ref_mean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(var, ref_var, atol=1e-4, rtol=1e-4)
        err = max(float((mean - ref_mean).abs().max()), float((var - ref_var).abs().max()))
        x3 = x.view(n, m, c)
        row = {
            "kernel_ms": cuda_ms(lambda: k1(x)),
            "plain_ms": cuda_ms(lambda: kernels.instance_norm_stats_reference(x)),
            "library_ms": cuda_ms(lambda: torch.var_mean(x3, dim=1, correction=0)),
            # each input element read once, mean and var written once
            "bytes_ms": (x.numel() * x.element_size() + 2 * n * c * 4) / HBM_BYTES_PER_S * 1e3,
            # per element: an add for the sum, an FMA (2) for the squares
            "ops_ms": 3 * x.numel() / F32_FLOP_PER_S * 1e3,
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        emit({"phase": "k1", "shape_nmc": [n, m, c], "calls_per_forward": calls,
              "max_abs_err": err, **row})
        for key in total:
            total[key] += calls * row[key]
        max_err = max(max_err, err)
        calls_per_forward += calls
        del x, x3, mean, var, ref_mean, ref_var
    check(calls_per_forward == 4 * plan.num_pools + 2, "K1 shape table is off")
    return {
        "name": "instance_norm_stats", "route": "cuda",
        "source": "deepwmh_tpu_torch/csrc/instance_norm_stats.cu",
        "replaces": "deepwmh_tpu/ops/pallas_kernels.py:127",
        "max_abs_err": max_err,
        "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
        "library_ms": total["library_ms"],
        "per": "one flagship forward (%d calls)" % calls_per_forward,
    }


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
    check(launches["instance_norm_stats"] == expect,
          "K1 launched %d times on the main path, expected %d (2 cases x 8 flips x %d blocks)"
          % (launches["instance_norm_stats"], expect, blocks))

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
                before = kernels.instance_norm_stats.launches
                outs[dev] = [o.cpu().numpy() for o in pred.predict_case_full(vol, spacing, apply_n4=True)]
                if dev == DEVICE:
                    check(kernels.instance_norm_stats.launches > before,
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
    k1_entry = phase_k1(kernels, default_plan_1mm_iso())
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=HERE) as work:
        launches, flair = phase_main_path(kernels, work, smi)
        phase_card_vs_cpu(kernels, work)
    phase_postproc_exact(flair)
    k1_entry["launches"] = launches["instance_norm_stats"]
    check(set(launches) == {"instance_norm_stats"}, "unlisted kernels: %s" % sorted(launches))
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "nvidia_smi": smi})
    emit({"kernels": [k1_entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
