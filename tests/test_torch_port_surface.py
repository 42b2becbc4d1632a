"""The JAX package's public surface in the port, name by name.

``test_every_public_name_has_a_counterpart`` reads both packages with
``ast`` (importing neither) and holds every public name of
``deepwmh_tpu`` to the port's module at the same relative path: module-level
functions, classes and upper-case constants, public methods (inherited ones
count), the names an ``__init__.py`` re-exports, and each public function's
and method's parameter names. A name the port covers by PyTorch idiom
stands in ``BY_IDIOM`` with its counterpart, which must exist, and a
one-line reason; an entry no longer needed fails the test too.

The rest holds what the last of that surface added to the port against the
JAX functions on the CPU, inputs from numpy seeds: the NIfTI utilities of
PARITY C14 (RAS+ reorientation, NaN replacement, axis codes, resampling,
the main axis, the simple writer; arrays and written bytes equal), the
native host labelling of ``cc3d.cpp`` (labels and counts equal to the JAX
package's native ones and to ``eval/metrics._labels``' ids), the samplers'
fill value and output shape (within atol 1e-6; ``cval=0`` the default's
bits), the joint histogram's chunks (within 1e-6), and the small names.
The whole file takes a few seconds on one worker.
"""

import ast
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepwmh_tpu import native as jnative
from deepwmh_tpu.core import nifti as jnifti
from deepwmh_tpu.ops import warp as jwarp
from deepwmh_tpu_torch import native
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.ops import warp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors run single-threaded: with the test workers sharing the
    cores, torch's thread pool turns them into milliseconds."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


JAX_ROOT = os.path.join(REPO, "deepwmh_tpu")
PORT_ROOT = os.path.join(REPO, "deepwmh_tpu_torch")

# ---------------------------------------------------------------------- #
# the audit
# ---------------------------------------------------------------------- #

# JAX name -> (the port's counterpart, why the port does it its own way).
# Keys: "module.py" (the whole module), "module.py:name", "module.py:Class.method",
# "module.py:function(parameter)". Counterparts name what the port has.
BY_IDIOM = {
    # modules
    "ops/pallas_kernels.py": (
        "ops/kernels.py:CudaKernel",
        "the Pallas kernels are CUDA C++ in csrc/, built and launched by ops/kernels.py"),
    "utils/compilation_cache.py": (
        "ops/kernels.py:build",
        "XLA's persistent compile cache; the port's kernels build once into the hashed _build/"),
    # names
    "unet/augment.py:augment_batch": (
        "unet/augment.py:augment_samples",
        "one key split per sample; the port draws the samples in order from one generator"),
    "unet/model.py:create_model": (
        "unet/model.py:UNet3D", "a torch module is made by its constructor"),
    "unet/model.py:init_params": (
        "unet/model.py:init_weights",
        "UNet3D(plan) holds its weights; init_weights draws flax's initialisers from a generator"),
    "unet/checkpoint.py:load_params_only": (
        "unet/checkpoint.py:load_flax_params",
        "no templates to restore into: the port reads the params tree whole"),
    "unet/torch_convert.py:params_from_nnunet_state_dict": (
        "unet/torch_convert.py:state_dict_from_nnunet",
        "the port's model takes a state dict, not a flax params tree"),
    "registration/warm.py:warm_pair_core_jit": (
        "registration/warm.py:warm_pair_core", "the jit wrapper; eager torch runs the function"),
    "unet/infer.py:CaseProgramMixin": (
        "unet/infer.py:SlidingWindowPredictor",
        "the jit-cached case programs; the port's predictors share them by inheritance"),
    "unet/infer.py:CaseProgramMixin.predict_case": (
        "unet/infer.py:SlidingWindowPredictor.predict_case", "as CaseProgramMixin"),
    "unet/infer.py:CaseProgramMixin.predict_case_full": (
        "unet/infer.py:SlidingWindowPredictor.predict_case_full", "as CaseProgramMixin"),
    "unet/infer.py:CaseProgramMixin.predict_case_full_batch": (
        "unet/infer.py:SlidingWindowPredictor.predict_case_full_batch", "as CaseProgramMixin"),
    # parameters: flax params and apply functions -> modules
    "unet/infer.py:SlidingWindowPredictor.__init__(params)": (
        "unet/infer.py:SlidingWindowPredictor.__init__(model)", "the module holds its weights"),
    "parallel/infer_sharded.py:ShardedSlidingWindowPredictor.__init__(params)": (
        "parallel/infer_sharded.py:ShardedSlidingWindowPredictor.__init__(model)",
        "the module holds its weights"),
    "unet/infer.py:accumulate_patches(params)": (
        "unet/infer.py:accumulate_patches(model)", "the module holds its weights"),
    "unet/infer.py:accumulate_patches(apply_fn)": (
        "unet/infer.py:accumulate_patches(model)", "the module is its forward"),
    "unet/infer.py:flip_forward(params)": (
        "unet/infer.py:flip_forward(model)", "the module holds its weights"),
    "unet/infer.py:flip_forward(apply_fn)": (
        "unet/infer.py:flip_forward(model)", "the module is its forward"),
    "unet/infer.py:fullvol_tta(params)": (
        "unet/infer.py:fullvol_tta(model)", "the module holds its weights"),
    "unet/infer.py:fullvol_tta(apply_fn)": (
        "unet/infer.py:fullvol_tta(model)", "the module is its forward"),
    "parallel/infer_sharded.py:build_fullvol_tta_sharded(apply_fn)": (
        "parallel/infer_sharded.py:build_fullvol_tta_sharded(replicas)",
        "one module replica a shard's device"),
    "unet/model.py:count_params(params)": (
        "unet/model.py:count_params(module_or_state_dict)",
        "a module, or its state dict, holds the weights"),
    "unet/checkpoint.py:load_checkpoint(params_template)": (
        "unet/checkpoint.py:load_checkpoint",
        "flax restores into a template; the port returns the stored trees"),
    "unet/checkpoint.py:load_checkpoint(opt_state_template)": (
        "unet/checkpoint.py:load_checkpoint",
        "flax restores into a template; the port returns the stored trees"),
    # parameters: traced values -> eager ones
    "unet/infer.py:flip_forward(volume)": (
        "unet/infer.py:flip_forward(volumes)", "a batch [N,D,H,W] in one forward"),
    "unet/infer.py:flip_forward(flip_flags)": (
        "unet/infer.py:flip_forward(flip)",
        "traced booleans select flips under jit; the port flips by a static tuple"),
    "unet/infer.py:flip_forward(num_classes)": (
        "unet/infer.py:flip_forward(model)",
        "unused by the JAX function too; the classes are the model's channels"),
    # parameters: JAX PRNG keys -> torch generators and seeds
    "unet/augment.py:augment_sample(key)": (
        "unet/augment.py:augment_sample(gen)", "a torch.Generator for a PRNG key"),
    "unet/augment.py:augment_samples(keys)": (
        "unet/augment.py:augment_samples(gen)", "one generator for the per-sample keys"),
    "unet/augment.py:percentile_noise(key)": (
        "unet/augment.py:percentile_noise(gen)", "a torch.Generator for a PRNG key"),
    "unet/train.py:Trainer.init_state(rng)": (
        "unet/train.py:Trainer.init_state(seed)", "a seed for a PRNG key"),
    # parameters: named mesh axes inside shard_map -> the port's Mesh
    "parallel/spatial.py:HaloShardedOps.__init__(axis_name)": (
        "parallel/mesh.py:Mesh", "the port's mesh has one axis; no named axis to pick"),
    "parallel/spatial.py:halo_pad_local(x_local)": (
        "parallel/spatial.py:halo_pad_local(slabs)",
        "shard_map gives each device its local slab; one process holds every shard's slab"),
    "parallel/spatial.py:halo_pad_local(axis_name)": (
        "parallel/spatial.py:halo_pad_local(mesh)", "the mesh, not a named axis"),
    "parallel/spatial.py:halo_pad_local(n_shards)": (
        "parallel/spatial.py:halo_pad_local(mesh)", "the mesh knows its size"),
    "registration/group.py:register_pairs_mesh(axis)": (
        "parallel/mesh.py:Mesh", "the port's mesh has one axis; no named axis to pick"),
    "unet/infer.py:accumulate_patches(varying_axis)": (
        "parallel/infer_sharded.py:ShardedSlidingWindowPredictor",
        "marks shard_map's carry as varying; the port adds the shards' partial sums itself"),
    # parameters: buffer sizing
    "native/__init__.py:gzip_inflate_host(expected_size)": (
        "native/__init__.py:gzip_isize", "the first buffer is the gzip trailer's ISIZE"),
}

_SKIP_PARAMS = ("self", "cls")


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in _SKIP_PARAMS]


def _modules(root) -> dict:
    """relative path -> parsed module, public subpackages only."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(("_", ".")))
        for name in sorted(filenames):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    out[os.path.relpath(path, root)] = ast.parse(f.read(), path)
    return out


def _own_names(rel, tree) -> dict:
    """name -> ClassDef for the classes, else None: public module-level
    functions, classes and upper-case constants, public methods as
    "Class.method", parameters as "function(parameter)" and
    "Class.method(parameter)", and an __init__.py's re-exports."""
    names = {}

    def function(prefix, fn):
        if not fn.name.startswith("_") or fn.name == "__init__":
            key = prefix + fn.name
            if fn.name != "__init__":
                names[key] = None
            for p in _params(fn):
                names["%s(%s)" % (key, p)] = None

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            function("", node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names[node.name] = node
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    function(node.name + ".", sub)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id.isupper() and not t.id.startswith("_"):
                    names[t.id] = None
        elif isinstance(node, ast.ImportFrom) and rel.endswith("__init__.py"):
            for alias in node.names:
                names[alias.asname or alias.name] = None
    return names


def _surface(root, package) -> dict:
    """relative path -> set of public names (see ``_own_names``); a class
    also has the methods and parameters of its bases in the package."""
    trees = _modules(root)
    own = {rel: _own_names(rel, tree) for rel, tree in trees.items()}

    def module_of(dotted):
        parts = dotted.split(".")
        if parts[0] != package:
            return None
        base = os.path.join(*parts[1:]) if len(parts) > 1 else ""
        for rel in (base + ".py", os.path.join(base, "__init__.py")):
            if rel in own:
                return rel
        return None

    def imported(rel, name):
        for node in trees[rel].body:
            if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    if (alias.asname or alias.name) == name:
                        return module_of(node.module), alias.name
        return None, None

    def inherited(rel, cls, seen=()):
        """"method" / "method(parameter)" names of ``cls``'s bases."""
        got = set()
        for base in cls.bases:
            if not isinstance(base, ast.Name):
                continue
            where, name = (rel, base.id) if isinstance(own[rel].get(base.id), ast.ClassDef) \
                else imported(rel, base.id)
            if where is None or (where, name) in seen:
                continue
            node = own[where].get(name)
            if not isinstance(node, ast.ClassDef):
                continue
            prefix = name + "."
            got |= {k[len(prefix):] for k in own[where] if k.startswith(prefix)}
            got |= inherited(where, node, seen + ((where, name),))
        return got

    surface = {}
    for rel, names in own.items():
        out = set(names)
        for name, node in names.items():
            if isinstance(node, ast.ClassDef):
                # a method the class defines itself keeps its own parameters
                overridden = {k[len(name) + 1:].split("(")[0] for k in names
                              if k.startswith(name + ".")}
                out |= {"%s.%s" % (name, m) for m in inherited(rel, node)
                        if m.split("(")[0] not in overridden}
        surface[rel] = out
    return surface


def _idiom_for(rel, name):
    """The BY_IDIOM key covering ``name``: its own, else that of its
    function or method (its parameters go with it), its class, its module."""
    base = name.split("(")[0]
    for key in ("%s:%s" % (rel, name), "%s:%s" % (rel, base),
                "%s:%s" % (rel, base.split(".")[0]), rel):
        if key in BY_IDIOM:
            return key
    return None


def test_every_public_name_has_a_counterpart():
    jax_surface = _surface(JAX_ROOT, "deepwmh_tpu")
    port_surface = _surface(PORT_ROOT, "deepwmh_tpu_torch")
    assert len(jax_surface) > 60 and sum(map(len, jax_surface.values())) > 1000
    missing, used = [], set()
    for rel, names in sorted(jax_surface.items()):
        for name in sorted(names):
            if name in port_surface.get(rel, ()):
                continue
            key = _idiom_for(rel, name)
            if key is None:
                missing.append("%s:%s" % (rel, name))
            else:
                used.add(key)
    assert not missing, "public names of deepwmh_tpu without a counterpart: %s" % missing
    unneeded = sorted(set(BY_IDIOM) - used)
    assert not unneeded, "BY_IDIOM entries nothing needs: %s" % unneeded
    absent = []
    for key, (counterpart, reason) in BY_IDIOM.items():
        rel, _, name = counterpart.partition(":")
        if name not in port_surface.get(rel, ()):
            absent.append("%s -> %s" % (key, counterpart))
        assert reason and "\n" not in reason
    assert not absent, "counterparts the port does not have: %s" % absent


def test_audit_sees_inherited_methods_and_parameters():
    """The audit's own reading: a subclass has its base's methods, a
    function its parameters, an __init__.py its re-exports."""
    port = _surface(PORT_ROOT, "deepwmh_tpu_torch")
    sharded = port["parallel/infer_sharded.py"]
    assert "ShardedSlidingWindowPredictor.predict_volume" in sharded
    assert "ShardedSlidingWindowPredictor.__init__(mesh)" in sharded
    assert "affine_warp(out_shape)" in port["ops/warp.py"]
    assert "median_filter" in port["ops/__init__.py"] and "load_nifti" in port["core/__init__.py"]
    assert "LEARNED_CROSSOVER_PAIRS" in port["registration/policy.py"]
    assert "_resample_volume" not in port["core/nifti.py"]


# ---------------------------------------------------------------------- #
# core/nifti.py: PARITY C14
# ---------------------------------------------------------------------- #

SHAPE = (10, 12, 8)
ZOOMS = (1.0, 1.25, 2.0)


def _header(module, shape=SHAPE, zooms=ZOOMS, signs=(1, 1, 1), srow=None):
    hdr = module.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms(zooms)
    if srow is None:
        srow = np.zeros((3, 4))
        srow[:3, :3] = np.diag(np.array(signs) * np.array(zooms))
        srow[:, 3] = (-90.0, 126.0, -72.0)
    hdr.srow = np.asarray(srow, np.float32)
    hdr.sform_code = 1
    return hdr


def _volume(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) * 100


@pytest.mark.parametrize("signs", list(itertools.product((1, -1), repeat=3)),
                         ids=lambda s: "".join("+" if v > 0 else "-" for v in s))
def test_load_nifti_force_ras_matches_jax(tmp_path, signs):
    vol = _volume(1)
    path = str(tmp_path / "v.nii.gz")
    jnifti.save_nifti(vol, _header(jnifti, signs=signs), path)
    got, hdr = nifti.load_nifti(path, force_RAS=True)
    want, _ = jnifti.load_nifti(path, force_RAS=True)
    np.testing.assert_array_equal(got, want)
    flipped = [a for a, s in enumerate(signs) if s < 0]
    np.testing.assert_array_equal(got, np.flip(vol, flipped) if flipped else vol)
    assert nifti.aff2axcodes(hdr.affine) == tuple(
        c if s > 0 else {"R": "L", "A": "P", "S": "I"}[c] for c, s in zip("RAS", signs))


@pytest.mark.parametrize("return_type", ["float32", None])
def test_load_nifti_nan_and_scaling_match_jax(tmp_path, return_type):
    """NaN replacement after the slope and intercept, then the RAS flip,
    then the cast, as the JAX function orders them."""
    raw = _volume(2).astype(np.float32)
    raw[np.random.RandomState(3).rand(*SHAPE) < 0.1] = np.nan
    hdr = _header(jnifti, signs=(-1, 1, -1))
    hdr.scl_slope, hdr.scl_inter = 2.5, -7.0
    payload = jnifti._serialize_header(hdr, 16) + b"\x00" * 4 + raw.tobytes(order="F")
    path = str(tmp_path / "scaled.nii")
    with open(path, "wb") as f:
        f.write(payload)
    for force in (False, True):
        got, _ = nifti.load_nifti(path, return_type=return_type, force_RAS=force, nan=-1.0)
        want, _ = jnifti.load_nifti(path, return_type=return_type, force_RAS=force, nan=-1.0)
        assert got.dtype == want.dtype and not np.isnan(got).any()
        np.testing.assert_array_equal(got, want)
    assert (got == -1.0).sum() == np.isnan(raw).sum()


def test_aff2axcodes_and_ras_fix_on_oblique_affines_match_jax():
    """Rotated affines and columns whose two largest entries tie: the same
    codes (the tie broken by the same argsort) and the same flips."""
    rs = np.random.RandomState(4)
    affines = []
    for _ in range(20):
        q, _ = np.linalg.qr(rs.randn(3, 3))
        a = np.eye(4)
        a[:3, :3] = q * rs.uniform(0.5, 2.0, 3)
        affines.append(a)
    tie = np.eye(4)
    tie[:3, :3] = [[1.0, 1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 0.0, -1.0]]
    affines += [tie, tie[[1, 0, 2, 3]], -tie]
    vol = _volume(5)
    for a in affines:
        assert nifti.aff2axcodes(a) == jnifti.aff2axcodes(a)
        np.testing.assert_array_equal(nifti.ras_fix(vol, a), jnifti.ras_fix(vol, a))
    assert nifti.aff2axcodes(tie) == jnifti.aff2axcodes(tie)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("new", [(0.8, 1.0, 1.5), (1.5, 2.0, 2.5)], ids=["up", "down"])
def test_resample_nifti_writes_jax_bytes(tmp_path, order, new):
    srow = [[0.0, 0.0, -2.0, 80.0], [-1.0, 0.1, 0.0, 120.0], [0.05, 1.25, 0.0, -60.0]]
    src = str(tmp_path / "src.nii.gz")
    nifti.save_nifti(_volume(6), _header(nifti, srow=srow), src)
    nifti.resample_nifti(src, new, str(tmp_path / "port.nii.gz"), order=order)
    jnifti.resample_nifti(src, new, str(tmp_path / "jax.nii.gz"), order=order)
    assert (tmp_path / "port.nii.gz").read_bytes() == (tmp_path / "jax.nii.gz").read_bytes()
    out, hdr = nifti.load_nifti(str(tmp_path / "port.nii.gz"))
    assert out.shape == tuple(int(np.round(s * z / n)) for s, z, n in zip(SHAPE, ZOOMS, new))
    np.testing.assert_allclose(np.linalg.norm(hdr.srow[:3, :3], axis=0), new, rtol=1e-6)


def test_resample_volume_edges_match_jax():
    """Axes kept, grown from one voxel and shrunk to one voxel."""
    vol = _volume(7, (1, 5, 6))
    for shape in [(3, 5, 1), (1, 9, 6), (4, 2, 11)]:
        for order in (0, 1):
            np.testing.assert_array_equal(nifti._resample_volume(vol, shape, order),
                                          jnifti._resample_volume(vol, shape, order))


def test_nifti_main_axis_matches_jax():
    for pixdim in [(1.0, 1.0, 3.0), (0.9, 5.0, 1.0), (6.0, 1.0, 1.0), (1.0, 1.0, 1.0),
                   (2.0, 2.0, 1.0)]:
        assert nifti.nifti_main_axis(pixdim) == jnifti.nifti_main_axis(pixdim)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_save_nifti_simple_writes_jax_bytes(tmp_path, suffix):
    vol = _volume(8)
    nifti.save_nifti_simple(vol, str(tmp_path / ("port" + suffix)))
    jnifti.save_nifti_simple(vol, str(tmp_path / ("jax" + suffix)))
    assert (tmp_path / ("port" + suffix)).read_bytes() == (tmp_path / ("jax" + suffix)).read_bytes()


# ---------------------------------------------------------------------- #
# native: cc3d.cpp's labelling
# ---------------------------------------------------------------------- #


def _mask(density, seed=0, shape=(20, 24, 18)):
    return np.random.RandomState(seed).rand(*shape) < density


@pytest.mark.parametrize("density", [0.05, 0.3, 0.6])
def test_label_components_host_matches_jax_and_the_card_route(density):
    from deepwmh_tpu_torch.eval.metrics import _labels

    m = _mask(density, seed=int(density * 100))
    native.reset_counts()
    labels, n = native.label_components_host(m)
    assert native.CALLS["label_components_3d"] == 1
    want, want_n = jnative.label_components_host(m)
    assert labels.dtype == np.int32 and n == want_n > 0
    np.testing.assert_array_equal(labels, want)
    ids, ids_n = _labels(torch.from_numpy(m))
    assert ids_n == n
    np.testing.assert_array_equal(ids.numpy(), labels)
    # f32 input thresholded at 0.5 as a mask
    np.testing.assert_array_equal(native.label_components_host(m * 0.75)[0], labels)


@pytest.mark.parametrize("density", [0.05, 0.3, 0.6])
def test_remove_small_components_host_matches_jax(density):
    m = _mask(density, seed=1 + int(density * 100))
    for min_volume in (1, 3, 10):
        got = native.remove_small_components_host(m, min_volume)
        want = jnative.remove_small_components_host(m, min_volume)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_labelling_raises_without_the_library(tmp_path, monkeypatch):
    """No quiet route: without a compiler both functions raise, and
    ``available()`` says so; ``python_path()`` does not touch them."""
    m = _mask(0.3)
    native.reset_counts()
    with native.python_path():
        native.label_components_host(m)
    assert native.CALLS["label_components_3d"] == 1 and native.available()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "no-such-compiler-for-deepwmh")
    assert not native.available()
    with pytest.raises(native.NativeLibraryError, match="C\\+\\+ compiler"):
        native.label_components_host(m)
    with pytest.raises(native.NativeLibraryError):
        native.remove_small_components_host(m, 3)


# ---------------------------------------------------------------------- #
# ops/warp.py: the fill value and the output shape
# ---------------------------------------------------------------------- #

CVAL = 7.5
VOL_SHAPE = (7, 8, 6)


def _coords(seed, shape=(5, 6, 4)):
    """Coordinates spilling about two voxels past every face."""
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(-2.5, s + 1.5, shape) for s in VOL_SHAPE]).astype(np.float32)


def _sampler_calls(name):
    """(port call, JAX call) of one sampler on seeded inputs; each takes
    ``cval`` keyword arguments."""
    rs = np.random.RandomState(len(name))
    vol = rs.rand(*VOL_SHAPE).astype(np.float32)
    T = torch.from_numpy
    if name.startswith("sample_volume"):
        order, c = int(name[-1]), _coords(1)
        return (lambda **k: warp.sample_volume(T(vol), T(c), order=order, **k),
                lambda **k: jwarp.sample_volume(vol, c, order=order, **k))
    if name == "sample_channels":
        vols, c = rs.rand(3, *VOL_SHAPE).astype(np.float32), _coords(2)
        return (lambda **k: warp.sample_channels(T(vols), T(c), **k),
                lambda **k: jwarp.sample_channels(vols, c, **k))
    if name.startswith("affine_warp"):
        # dyadic entries: both packages form the same coordinates exactly, so
        # the fill value alone is compared (other matrices round their
        # coordinates in another order: test_torch_port_train's 1e-5)
        order = int(name[-1])
        mat = np.array([[0.875, 0.125, 0.0, 1.5], [-0.125, 1.125, 0.0625, -2.0],
                        [0.0, 0.0625, 0.9375, 0.75]], np.float32)
        center = (3.0, 3.5, 2.5)
        return (lambda **k: warp.affine_warp(T(vol), mat, order=order, center=center, **k),
                lambda **k: jwarp.affine_warp(vol, mat, order=order, center=center, **k))
    order = int(name[-1])
    disp = (rs.randn(3, *VOL_SHAPE) * 2).astype(np.float32)
    return (lambda **k: warp.displacement_warp(T(vol), T(disp), order=order, **k),
            lambda **k: jwarp.displacement_warp(vol, disp, order=order, **k))


@pytest.mark.parametrize("name", ["sample_volume_0", "sample_volume_1", "sample_channels",
                                  "affine_warp_0", "affine_warp_1", "displacement_warp_0",
                                  "displacement_warp_1"])
def test_samplers_fill_value_matches_jax(name):
    port, jax_fn = _sampler_calls(name)
    got = port(cval=CVAL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_fn(cval=CVAL)), rtol=0, atol=1e-6)
    assert (got.numpy() != port().numpy()).any(), "no sample fell outside the volume"
    assert torch.equal(port(cval=0.0), port())


def test_batched_samplers_fill_value_per_volume():
    """The batch axis keeps the fill value: each volume as sampled alone."""
    rs = np.random.RandomState(9)
    vols = torch.from_numpy(rs.rand(2, 3, *VOL_SHAPE).astype(np.float32))
    coords = torch.from_numpy(np.stack([_coords(10), _coords(11)]))
    got = warp.sample_channels(vols, coords, cval=CVAL)
    got_v = warp.sample_volume(vols[:, 0], coords, order=1, cval=CVAL)
    for b in range(2):
        np.testing.assert_allclose(
            got[b].numpy(), warp.sample_channels(vols[b], coords[b], cval=CVAL).numpy(),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            got_v[b].numpy(), warp.sample_volume(vols[b, 0], coords[b], cval=CVAL).numpy(),
            rtol=0, atol=1e-6)


def test_sample_channels_gradient_with_fill_value_matches_jax():
    rs = np.random.RandomState(12)
    vols = rs.rand(3, *VOL_SHAPE).astype(np.float32)
    coords = _coords(13)
    w = rs.randn(3, *coords.shape[1:]).astype(np.float32)

    def jloss(v, c):
        return jnp.sum(jwarp.sample_channels(v, c, cval=CVAL) * w)

    want_v, want_c = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(vols),
                                                               jnp.asarray(coords))
    v = torch.from_numpy(vols).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    (warp.sample_channels(v, c, cval=CVAL) * torch.from_numpy(w)).sum().backward()
    # sums of a few products: f32 rounding in another order
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_v), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_c), rtol=0, atol=1e-4)


def test_affine_warp_out_shape_matches_jax():
    """JAX's positional order (vol, matrix, out_shape, order, cval); a
    dyadic matrix, as above."""
    vol = np.random.RandomState(14).rand(*VOL_SHAPE).astype(np.float32)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] *= 0.625
    mat[:3, 3] = (0.5, -1.0, 0.25)
    for out_shape, order, cval in [((11, 13, 9), 1, CVAL), ((4, 5, 3), 0, -1.0)]:
        got = warp.affine_warp(torch.from_numpy(vol), mat, out_shape, order, cval)
        want = np.asarray(jwarp.affine_warp(vol, mat, out_shape, order, cval))
        assert got.shape == out_shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #
# registration/similarity.py: the joint histogram's chunks
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("masked", [False, True])
def test_soft_joint_histogram_chunks_match_jax(masked):
    from deepwmh_tpu.registration import similarity as jsim
    from deepwmh_tpu_torch.registration import similarity as sim

    rs = np.random.RandomState(15)
    a, b = (rs.rand(9, 10, 11).astype(np.float32) for _ in range(2))
    mask = (rs.rand(9, 10, 11) < 0.7).astype(np.float32) if masked else None
    T = (lambda x: None if x is None else torch.from_numpy(x))
    whole = sim.soft_joint_histogram(T(a), T(b), 16, T(mask))
    for chunk in (333,):  # 990 samples: two whole chunks and a short last one
        got = sim.soft_joint_histogram(T(a), T(b), 16, T(mask), chunk)
        want = jsim.soft_joint_histogram(jnp.asarray(a), jnp.asarray(b), 16,
                                         None if mask is None else jnp.asarray(mask), chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-6)
    # the gradient through the recomputed chunks equals the whole product's

    def grad(chunk):
        x = T(a).requires_grad_(True)
        p = sim.soft_joint_histogram(x, T(b), 16, T(mask), chunk)
        (p * torch.log(p + 1e-10)).sum().backward()
        return x.grad

    np.testing.assert_allclose(grad(128).numpy(), grad(1 << 21).numpy(), rtol=0, atol=1e-5)
    batch = sim.soft_joint_histogram(torch.stack([T(a), T(b)]), torch.stack([T(b), T(a)]), 16,
                                     chunk=128, batch=True)
    np.testing.assert_allclose(batch[1].numpy(), sim.soft_joint_histogram(T(b), T(a), 16).numpy(),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #
# the package exports and the small names
# ---------------------------------------------------------------------- #

_EXPORTS = r"""
import ctypes, subprocess, sys
import numpy, torch

def refuse(*args, **kwargs):
    raise AssertionError("an import built or loaded a library")

subprocess.run = subprocess.Popen = ctypes.CDLL = refuse
import deepwmh_tpu_torch.ops as ops
import deepwmh_tpu_torch.core as core
from deepwmh_tpu_torch.ops import median_filter, label_components, nll, z_score
from deepwmh_tpu_torch.core import load_nifti, resample_nifti, NiftiHeader
from deepwmh_tpu_torch.ops import kernels
from deepwmh_tpu_torch import native
import deepwmh_tpu_torch.unet.model
assert all(k._lib is None for k in kernels.KERNELS.values()) and native._lib is None
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "deepwmh_tpu."))]
"""


def test_ops_and_core_exports_import_and_build_nothing():
    proc = subprocess.run([sys.executable, "-c", _EXPORTS], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import deepwmh_tpu.core as jcore
    import deepwmh_tpu.ops as jops
    import deepwmh_tpu_torch.core as core
    import deepwmh_tpu_torch.ops as ops

    for jmod, mod in ((jops, ops), (jcore, core)):
        tree = ast.parse(open(jmod.__file__).read())
        exported = [(node.module.split(".")[-1], a.name) for node in tree.body
                    if isinstance(node, ast.ImportFrom) for a in node.names]
        assert len(exported) >= 10
        for module, name in exported:
            obj = getattr(mod, name)
            assert obj.__module__.endswith("." + module) or module == "nifti", (name, obj)
            assert obj.__module__.startswith("deepwmh_tpu_torch.")


def test_check_system_integrity_require_accelerator(capsys):
    from deepwmh_tpu_torch.cli.integrity import check_system_integrity

    assert check_system_integrity(device="cpu", verbose=False)
    assert not check_system_integrity("cpu", True, require_accelerator=True)
    assert "[!!] no CUDA device" in capsys.readouterr().out


def test_small_names_match_jax(tmp_path):
    from deepwmh_tpu.registration import policy as jpolicy
    from deepwmh_tpu.unet import model as jmodel
    from deepwmh_tpu.unet import preprocess as jpre
    from deepwmh_tpu.unet.plan import Plan as JPlan
    from deepwmh_tpu_torch.registration import policy
    from deepwmh_tpu_torch.unet import checkpoint, model, preprocess
    from deepwmh_tpu_torch.unet.plan import Plan

    pairs = [((192, 224, 192), (1.0, 1.0, 1.0)), ((160, 200, 48), (0.9, 0.9, 3.0))]
    for got, want in zip(preprocess.fingerprint_dataset(pairs), jpre.fingerprint_dataset(pairs)):
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    assert policy.LEARNED_CROSSOVER_PAIRS == jpolicy.LEARNED_CROSSOVER_PAIRS
    kw = dict(target_spacing=[2.0] * 3, patch_size=[16] * 3, batch_size=2,
              pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
              base_features=4, max_features=8)
    jnet = jmodel.UNet3D(plan=JPlan(**kw))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 16, 1), jnp.bfloat16))["params"]
    net = model.UNet3D(Plan(**kw))
    assert model.count_params(net) == jmodel.count_params(shapes) > 1000
    assert model.count_params(net.state_dict()) == model.count_params(net)
    # save_checkpoint's weights by JAX's keyword
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    checkpoint.save_checkpoint(str(tmp_path), "ck", params=tree, meta={"epoch": 1})
    params, opt, meta = checkpoint.load_checkpoint(str(tmp_path), "ck")
    np.testing.assert_array_equal(params["w"], tree["w"])
    assert opt is None and meta["epoch"] == 1
