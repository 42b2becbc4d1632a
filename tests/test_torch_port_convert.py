"""deepwmh_tpu_torch's checkpoint conversion, flops and runtime utilities
against deepwmh_tpu's on the CPU.

The Generic_UNet replica and plans of ``tests/test_torch_convert.py``
(imported) are converted by both packages: the port's state_dict equals
``params_from_flax`` of JAX's converted tree bit for bit, the port's f32
forward matches the replica's (atol 2e-4, rtol 1e-3) and its bf16 argmax
agrees on > 98% of voxels, and a package converted by either package
loads and predicts in the other. ``tests/torch_port_nnunet.py``'s
parametrised replica (the one ``chip_smoke.py`` converts at full width) is
held to the imported one.
"""

import dataclasses
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deepwmh_tpu.cli import convert_torch as jcli
from deepwmh_tpu.unet import checkpoint as jckpt
from deepwmh_tpu.unet import flops as jflops
from deepwmh_tpu.unet import torch_convert as jtc
from deepwmh_tpu.unet.infer import SlidingWindowPredictor as JPredictor
from deepwmh_tpu.unet.plan import Plan as JPlan
from deepwmh_tpu.unet import release as jrelease
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu.utils import misc as jmisc
from deepwmh_tpu.utils import profiling as jprof
from deepwmh_tpu.utils import table as jtable
from deepwmh_tpu_torch.cli import convert_torch as cli
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet import flops, torch_convert
from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
from deepwmh_tpu_torch.unet.model import UNet3D
from deepwmh_tpu_torch.unet.plan import Plan, default_plan_1mm_iso
from deepwmh_tpu_torch.unet.release import load_released_model
from deepwmh_tpu_torch.utils import misc, profiling, table
from test_torch_convert import BASE, CONVS, POOLS, _GenericUNetReplica, _plans_dict
from torch_port_nnunet import GenericUNetReplica, plans_dict, seeded_replica, write_reference_install


@pytest.fixture(scope="module")
def install(tmp_path_factory):
    """test_torch_convert's replica (its seed and norm affines) in the
    reference's install layout, converted by both packages' CLIs."""
    root = tmp_path_factory.mktemp("ref")
    torch.manual_seed(0)
    net = _GenericUNetReplica().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.InstanceNorm3d):
                m.weight.copy_(0.5 + torch.rand_like(m.weight))
                m.bias.copy_(torch.randn_like(m.bias) * 0.1)
    write_reference_install(str(root / "install"), net, _plans_dict())
    cli.main(["-i", str(root / "install"), "-o", str(root / "port_pkg")])
    jcli.main(["-i", str(root / "install"), "-o", str(root / "jax_pkg")])
    return net, str(root / "port_pkg"), str(root / "jax_pkg"), str(root / "install")


@pytest.mark.parametrize("plans", [
    _plans_dict(),
    plans_dict(default_plan_1mm_iso().pool_kernels, default_plan_1mm_iso().conv_kernels,
               (128, 160, 128), (1.0, 1.0, 1.0)),
    {**_plans_dict(), "plans_per_stage": {0: {**_plans_dict()["plans_per_stage"][1],
                                              "conv_kernel_sizes": CONVS[:1]}}},
])
def test_plan_from_plans_matches_jax(plans):
    plan = torch_convert.plan_from_nnunet_plans(plans)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jtc.plan_from_nnunet_plans(plans))
    assert plan.pad_style == "torch"


@pytest.mark.parametrize("prefix", ["", "module."])
def test_state_dict_equals_params_from_flax_of_jax(install, prefix):
    net = install[0]
    plan = torch_convert.plan_from_nnunet_plans(_plans_dict())
    sd = {prefix + k: v for k, v in net.state_dict().items()}
    got = torch_convert.state_dict_from_nnunet(sd, plan)
    want = ckpt.params_from_flax(jtc.params_from_nnunet_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jtc.plan_from_nnunet_plans(_plans_dict())))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    # the transpose convs are torch's own tensors, unflipped
    assert torch.equal(got["ups.0.weight"], net.tu[0].weight)


def test_both_packages_write_the_same_package(install):
    _net, port_pkg, jax_pkg, _root = install
    a, b = ckpt.load_flax_params(port_pkg), ckpt.load_flax_params(jax_pkg)

    def flat(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, p + k + "/") if isinstance(v, dict) else {p + k: v})
        return out

    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert Plan.load(os.path.join(port_pkg, "plan.json")) == Plan.load(
        os.path.join(jax_pkg, "plan.json"))
    for pkg in (port_pkg, jax_pkg):
        with open(os.path.join(pkg, "framework.json")) as f:
            assert '"converted_from_torch": true' in f.read()
        meta = ckpt.load_checkpoint(pkg, "model_best")[2]
        assert meta == {"converted_from": "model_best.model", "epoch": 5}


@pytest.mark.parametrize("shape", [(12, 16, 16), (10, 24, 8), (16, 16, 16)])
def test_forward_matches_replica(install, shape):
    """f32 logits within atol 2e-4 / rtol 1e-3 of the replica at every
    level (even sizes are where torch's symmetric strided padding differs
    from SAME), and the bf16 model's argmax on > 98% of voxels."""
    net, port_pkg = install[0], install[1]
    x = np.random.RandomState(1).rand(1, 1, *shape).astype(np.float32) * 2 - 1
    with torch.no_grad():
        segs = net(torch.from_numpy(x))
        model, _plan = load_released_model(port_pkg, device="cpu", dtype=torch.float32)
        got = model(torch.from_numpy(x), deep_supervision=True)
        for level, want in enumerate(reversed(segs)):
            np.testing.assert_allclose(got[level].numpy(), want.numpy(), atol=2e-4, rtol=1e-3)
        bf16, _ = load_released_model(port_pkg, device="cpu")
        agree = float((bf16(torch.from_numpy(x)).argmax(1) == segs[-1].argmax(1)).float().mean())
    assert agree > 0.98, agree


def test_packages_load_and_predict_across(install):
    """Each package converted by either loads in both: JAX's f32 forward
    matches the replica (atol 2e-4 / rtol 1e-3), and the two packages'
    predictors (f32, no TTA) give the same masks on > 99.9% of voxels and
    foreground probabilities within 5e-3 on one volume; both predict at
    bf16 too. (JAX's weights are read with its checkpoint loader on the
    stored tree as template: ``init_params`` would trace the model first.)"""
    net, port_pkg, jax_pkg, _root = install
    vol = np.random.RandomState(2).rand(18, 20, 16).astype(np.float32) * 100
    x = np.random.RandomState(5).rand(1, 12, 16, 16).astype(np.float32) * 2 - 1
    with torch.no_grad():
        want = net(torch.from_numpy(x[:, None]))[-1].numpy()
    for pkg in (port_pkg, jax_pkg):
        jrelease.validate_model_dir(pkg)
        jplan = JPlan.load(os.path.join(pkg, "plan.json"))
        jparams, _ = jckpt.load_params_only(pkg, "model_best", ckpt.load_flax_params(pkg))
        got = JUNet3D(plan=jplan, dtype=jnp.float32).apply({"params": jparams},
                                                           jnp.asarray(x[..., None]))
        np.testing.assert_allclose(np.moveaxis(np.asarray(got), -1, 1), want,
                                   atol=2e-4, rtol=1e-3)
        jseg, jfg = JPredictor(JUNet3D(plan=jplan, dtype=jnp.float32), jparams, jplan,
                               tta=False).predict_case(vol, (1.0, 1.0, 1.0))
        model, plan = load_released_model(pkg, device="cpu", dtype=torch.float32)
        seg, fg = SlidingWindowPredictor(model, plan, tta=False, device="cpu").predict_case(
            vol, (1.0, 1.0, 1.0))
        np.testing.assert_allclose(fg.numpy(), np.asarray(jfg), atol=5e-3)
        assert float((seg.numpy() == np.asarray(jseg)).mean()) > 0.999
        bf16, plan = load_released_model(pkg, device="cpu")
        seg16, _ = SlidingWindowPredictor(bf16, plan, tta=False, device="cpu").predict_case(
            vol, (1.0, 1.0, 1.0))
        jseg16, _ = JPredictor(JUNet3D(plan=jplan), jparams, jplan, tta=False).predict_case(
            vol, (1.0, 1.0, 1.0))
        assert seg16.shape == np.asarray(jseg16).shape == vol.shape


def test_parametrised_replica_is_the_reference_one():
    """torch_port_nnunet's replica at test_torch_convert's widths: the same
    keys and shapes, and the same forward bits on the same weights."""
    ref = _GenericUNetReplica().eval()
    rep = GenericUNetReplica(POOLS, CONVS, base=BASE).eval()
    a, b = ref.state_dict(), rep.state_dict()
    assert list(a) == list(b) and all(a[k].shape == b[k].shape for k in a)
    rep.load_state_dict(a)
    x = torch.from_numpy(np.random.RandomState(4).rand(1, 1, 8, 12, 12).astype(np.float32))
    with torch.no_grad():
        assert all(torch.equal(u, v) for u, v in zip(ref(x), rep(x)))
    plan = torch_convert.plan_from_nnunet_plans(plans_dict(POOLS, CONVS, (16, 16, 16), (1, 1, 1),
                                                           base=BASE))
    assert plan.base_features == BASE and plan.pool_kernels == POOLS


def test_full_width_replica_converts():
    """The flagship plan's widths (chip_smoke's convert_evaluate model):
    every tensor maps, the shapes fit the plan, the seeds are fixed."""
    p = default_plan_1mm_iso()
    net = seeded_replica(p.pool_kernels, p.conv_kernels, seed=0)
    plan = torch_convert.plan_from_nnunet_plans(
        plans_dict(p.pool_kernels, p.conv_kernels, p.patch_size, p.target_spacing))
    sd = torch_convert.state_dict_from_nnunet(net.state_dict(), plan)
    assert len(sd) == len(UNet3D(plan).state_dict()) == 4 * 22 + 5 + 2 * 5
    again = seeded_replica(p.pool_kernels, p.conv_kernels, seed=0).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in net.state_dict().items())


def test_layout_errors_and_discovery_match_jax(install, tmp_path):
    net, _p, _j, root = install
    plan = torch_convert.plan_from_nnunet_plans(_plans_dict())
    jplan = jtc.plan_from_nnunet_plans(_plans_dict())
    sd = dict(net.state_dict())
    # a missing key: JAX's message with the nearby keys
    missing = {k: v for k, v in sd.items() if k != "tu.0.weight"}
    with pytest.raises(KeyError) as port_err:
        torch_convert.state_dict_from_nnunet(missing, plan)
    with pytest.raises(KeyError) as jax_err:
        jtc.params_from_nnunet_state_dict({k: v.numpy() for k, v in missing.items()}, jplan)
    assert str(port_err.value) == str(jax_err.value) and "Nearby keys" in str(port_err.value)
    # an unmapped tensor is an error, not a silent drop
    extra = dict(sd, **{"conv_blocks_context.0.blocks.2.conv.weight": torch.zeros(4, 4, 3, 3, 3)})
    with pytest.raises(RuntimeError, match="did not map"):
        torch_convert.state_dict_from_nnunet(extra, plan)
    # a tensor of the wrong shape for the plan
    wide = dict(sd, **{"seg_outputs.1.weight": torch.zeros(3, BASE, 1, 1, 1)})
    with pytest.raises(RuntimeError, match="do not fit"):
        torch_convert.state_dict_from_nnunet(wide, plan)
    # discovery: the same picks and refusals as JAX's
    found = torch_convert.find_nnunet_checkpoint(root)
    assert found == jtc.find_nnunet_checkpoint(root) and found[1].endswith("plans.pkl")
    multi = tmp_path / "multi"
    for task in ("TaskA", "TaskB"):
        (multi / task / "all").mkdir(parents=True)
        torch.save({"state_dict": sd}, str(multi / task / "all" / "model_best.model"))
    for mod in (torch_convert, jtc):
        with pytest.raises(RuntimeError, match="several"):
            mod.find_nnunet_model(str(multi))
    torch.save({"state_dict": sd}, str(multi / "TaskA" / "all" / "model_latest.model"))
    assert torch_convert.find_nnunet_model(str(multi), which="model_latest.model") == \
        jtc.find_nnunet_model(str(multi), which="model_latest.model")
    with pytest.raises(RuntimeError, match="no plans"):
        torch_convert.find_nnunet_plans(str(multi / "TaskA" / "all" / "model_latest.model"))
    # -p with a lone file, and the mask-normalisation warning
    plans = dict(_plans_dict(), use_mask_for_norm={0: True})
    with open(tmp_path / "p.pkl", "wb") as f:
        pickle.dump(plans, f)
    lone = str(multi / "TaskA" / "all" / "model_latest.model")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cli.main(["-i", lone, "-p", str(tmp_path / "p.pkl"), "-o", str(tmp_path / "pkg")])
    assert any("nonzero-mask" in str(x.message) for x in w)
    assert ckpt.load_checkpoint(str(tmp_path / "pkg"), "model_best")[2]["epoch"] == -1


@pytest.mark.parametrize("plan", [
    default_plan_1mm_iso(),
    Plan(target_spacing=[1.0, 1.0, 3.0], patch_size=[96, 96, 24], batch_size=2,
         pool_kernels=[[2, 2, 1], [2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 1]] + [[3, 3, 3]] * 3,
         base_features=16, max_features=96, num_classes=3, in_channels=2),
    Plan(target_spacing=[1.0] * 3, patch_size=[8] * 3, batch_size=1, pool_kernels=[],
         conv_kernels=[[3, 3, 3]]),
])
def test_flops_equal_jax(plan):
    jplan = JPlan(**dataclasses.asdict(plan))
    for shape in [(192, 224, 192), (128, 160, 128), (33, 47, 21), (64, 80, 64)]:
        assert flops.conv_output_shape(shape, (2, 2, 1)) == jflops.conv_output_shape(shape, (2, 2, 1))
        assert flops.forward_conv_shapes(plan, shape) == jflops.forward_conv_shapes(jplan, shape)
        for batch in (1, 3):
            n = flops.forward_flops(plan, shape, batch)
            assert type(n) is int and n == jflops.forward_flops(jplan, shape, batch)
    for tta in (False, True):
        for fullvol in (False, True):
            args = ((60, 70, 50), [32, 32, 32], 0.5, tta, fullvol)
            assert flops.case_model_flops(plan, *args) == jflops.case_model_flops(jplan, *args)


def test_table_misc_profiling_equal_jax(tmp_path):
    rows = [["a", 1.5, None], ["x" * 60, "ü", 3], [0, "", "end"]]
    for kw in ({}, {"max_col_width": 5}):
        assert table.render_table(["h1", "header two", 3], rows, **kw) == \
            jtable.render_table(["h1", "header two", 3], rows, **kw)
    seq = [3, 1, 3, "a", 1, "b", "a"]
    assert misc.remove_duplicates(seq) == jmisc.remove_duplicates(seq)
    assert misc.contain_duplicates(seq) == jmisc.contain_duplicates(seq) is True
    assert misc.contain_duplicates([1, 2]) == jmisc.contain_duplicates([1, 2]) is False
    for p in (-1.0, 0.0, 0.333, 0.5, 1.0, 2.0):
        assert misc.minibar(p, msg="m") == jmisc.minibar(p, msg="m")
        assert misc.minibar(p, width=7) == jmisc.minibar(p, width=7)
    caches = [misc.BoundedCache(2), jmisc.BoundedCache(2)]
    for c in caches:
        c["a"], c["b"] = 1, 2
        _ = c["a"]
        c["c"] = 3
    assert caches[0].keys() == caches[1].keys() == ["a", "c"] and len(caches[0]) == 2
    assert ("b" in caches[0]) == ("b" in caches[1]) is False
    with misc.ignore_sigint(), jmisc.ignore_sigint():
        pass
    timers = [profiling.StageTimer(), jprof.StageTimer()]
    for t in timers:
        with t.stage("b"):
            pass
        with t.stage("a"):
            pass
        t.durations = {"b": 1.25, "a": 0.004}
    assert timers[0].summary() == timers[1].summary()
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    (trace,) = os.listdir(tmp_path / "trace")
    assert trace.endswith(".json") and os.path.getsize(tmp_path / "trace" / trace) > 0
