"""K1 on against K1 off over the 8-flip whole-volume sweep (the port of the
JAX package's ``experiments/studies/fused_stats_study.py``).

The JAX study decided whether inference turns its Pallas statistics kernel
on. The port's model runs K1 (``csrc/instance_norm_stats.cu`` and its apply
pass) whenever it is not training; this study measures what that buys: the
flagship 8-flip TTA sweep at 192x224x192 with ``fused_norm`` on and off
(the same weights), seconds per sweep and the difference of the
probabilities. ``chip_smoke.py`` phase ``k1`` runs ``measure`` on the card;
this script prints the same reading on its own.

Usage:
  python -m deepwmh_tpu_torch.experiments.studies.fused_stats_study [--device cpu]

Prints JSON to stdout, progress to stderr.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from deepwmh_tpu_torch.experiments.studies import device_name, emit, log, progress_to_stderr

BENCH_SHAPE = (192, 224, 192)
REPEATS = 6


def _synced(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(plan=None, shape=BENCH_SHAPE, device=None, repeats: int = REPEATS) -> dict:
    """The sweep with K1 (``fused_norm=True``) and with the plain norm chain
    (``False``) on one preprocessed random volume at ``shape``: median and
    best seconds of ``repeats`` timed sweeps each after one warm-up, their
    ratio, the largest probability difference and the argmax agreement."""
    import torch

    from deepwmh_tpu_torch.device import resolve_device
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, fullvol_shape, fullvol_tta
    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.preprocess import pad_to, preprocess_case

    dev = resolve_device(device)
    plan = plan or default_plan_1mm_iso()
    vol = (np.random.RandomState(0).rand(*shape) * 400).astype(np.float32)
    with torch.inference_mode():
        pre = preprocess_case(torch.from_numpy(vol).to(dev), [1.0, 1.0, 1.0], plan)
        padded = pad_to(pre, fullvol_shape(tuple(pre.shape), plan))
    log("padded whole-volume shape: %s" % (tuple(padded.shape),))
    weights = init_weights(UNet3D(plan), torch.Generator().manual_seed(0)).state_dict()
    results, probs = {}, {}
    for name, fused in (("baseline", False), ("fused_stats", True)):
        model = UNet3D(plan, fused_norm=fused)
        model.load_state_dict(weights)
        model = model.to(dev, memory_format=torch.channels_last_3d).eval()
        with torch.inference_mode():
            probs[name] = fullvol_tta(model, padded, int(plan.num_classes), ALL_FLIPS)
            ts = []
            for _ in range(repeats):
                _synced(dev)
                t0 = time.perf_counter()
                fullvol_tta(model, padded, int(plan.num_classes), ALL_FLIPS)
                _synced(dev)
                ts.append(time.perf_counter() - t0)
        log("%s: median %.4f s, best %.4f s" % (name, statistics.median(ts), min(ts)))
        results[name] = {"median_s": statistics.median(ts), "best_s": min(ts), "all_s": ts}
        del model
    diff = float((probs["baseline"] - probs["fused_stats"]).abs().max())
    agree = float((probs["baseline"].argmax(-1) == probs["fused_stats"].argmax(-1))
                  .float().mean())
    return {"shape": list(shape), "padded_shape": list(padded.shape), "flips": len(ALL_FLIPS),
            "sweep": results,
            "speedup_median": results["baseline"]["median_s"] / results["fused_stats"]["median_s"],
            "speedup_best": results["baseline"]["best_s"] / results["fused_stats"]["best_s"],
            "max_abs_prob_diff": diff, "argmax_agreement": agree,
            "device": device_name(dev)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default), cuda:i or cpu")
    args = parser.parse_args(argv)
    with progress_to_stderr():
        out = measure(device=args.device)
    emit(out)
    return out


if __name__ == "__main__":
    main()
