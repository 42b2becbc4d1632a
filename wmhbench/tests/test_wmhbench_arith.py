"""The benchmark's frozen copies against the port: the FLOP count, the
plans its configurations state, the reference U-Net and its initial
weights."""

from __future__ import annotations

import dataclasses
import os

import pytest
import torch

from wmhbench import harness
from wmhbench.arith import unet as arith
from wmhbench.reference import unet as ref_unet

CONFIGS = {c["name"]: harness.load_json(os.path.join(harness.ROOT, c["file"]))
           for c in harness.benchmark_spec()["configs"]}


def _port_plan(cfg):
    from deepwmh_tpu_torch.unet.plan import plan_experiment

    return plan_experiment([cfg["volume_shape"]], [cfg["spacing"]],
                           batch_size=cfg["plan"]["batch_size"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_plan_is_the_planners(name):
    cfg = CONFIGS[name]
    assert dataclasses.asdict(_port_plan(cfg)) == cfg["plan"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frozen_flops_agree_with_the_port(name):
    from deepwmh_tpu_torch.unet import flops
    from deepwmh_tpu_torch.unet.infer import fullvol_shape
    from deepwmh_tpu_torch.unet.plan import Plan

    cfg = CONFIGS[name]
    plan = Plan(**cfg["plan"])
    for shape in (cfg["plan"]["patch_size"], fullvol_shape(cfg["volume_shape"], plan)):
        assert arith.forward_flops(cfg["plan"], shape, 2) == flops.forward_flops(plan, shape, 2)
    assert arith.fullvol_shape(cfg["volume_shape"], cfg["plan"]) == fullvol_shape(
        cfg["volume_shape"], plan)
    assert arith.resampled_shape(cfg["volume_shape"], cfg["spacing"], cfg["plan"]) == tuple(
        cfg["volume_shape"])


def test_flops_and_k1_bytes_of_the_known_shapes():
    flag, utr = CONFIGS["flagship_1mm_iso"]["plan"], CONFIGS["wmh2017_utrecht"]["plan"]
    # 8-flip sweeps: 30.13 TFLOP on the flagship, 13.47 at 256x256x48
    assert round(8 * arith.forward_flops(flag, (192, 224, 192)) / 1e12, 2) == 30.13
    assert round(8 * arith.forward_flops(utr, (256, 256, 48)) / 1e12, 2) == 13.47
    work = arith.k1_work(flag, (192, 224, 192), passes=1)
    # one flagship forward: 22 blocks, the statistics' bytes bound 0.840 ms
    assert work["launches"] == 22
    assert round(work["stats_bytes"] / 3.35e12 * 1e3, 2) == 0.84


def _tiny_plan():
    return {"target_spacing": [1.0, 1.0, 1.0], "patch_size": [16, 16, 16], "batch_size": 2,
            "pool_kernels": [[2, 2, 2], [2, 2, 1]], "conv_kernels": [[3, 3, 1], [3, 3, 3],
                                                                       [3, 3, 3]],
            "base_features": 4, "max_features": 8, "num_classes": 2, "in_channels": 1,
            "normalization": "zscore", "median_shape": [16, 16, 16], "pad_style": "same"}


def test_reference_init_and_forward_match_the_port():
    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.plan import Plan

    plan = _tiny_plan()
    port = init_weights(UNet3D(Plan(**plan), dtype=torch.float32, fused_norm=False),
                        torch.Generator().manual_seed(7))
    ref = ref_unet.init_weights(ref_unet.UNet3D(plan), torch.Generator().manual_seed(7))
    ps, rs = port.state_dict(), ref.state_dict()
    assert list(ps) == list(rs) and list(dict(port.named_parameters())) == list(
        dict(ref.named_parameters()))
    assert all(torch.equal(ps[k], rs[k]) for k in ps)
    x = torch.randn(2, 1, 16, 16, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for got, want in zip(port(x, deep_supervision=True), ref(x, deep_supervision=True)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fp8_control_rounds_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    err8 = float((ref_unet.fp8_round(x) - x).abs().max())
    err16 = float((x.to(torch.bfloat16).float() - x).abs().max())
    assert err8 > 4 * err16 > 0


def test_derived_seeds_take_any_whole_number():
    seeds = {harness.derive_seed(s, "train") for s in (0, 1, 2**31 + 5, 2**40, -3)}
    assert len(seeds) == 5 and all(0 <= s < 2**31 for s in seeds)
    assert harness.derive_seed(2**31 + 5, "a") == harness.derive_seed(2**31 + 5, "a")
