"""Shared inputs of the deepwmh_tpu_torch parity tests (tests/test_torch_port_*.py).

A 48x48x40 FLAIR-like phantom at 2 mm (two tissues inside a head, a smooth
multiplicative bias, 3% noise) and a tiny model package, built with the JAX
package. Random U-Net weights leave most voxels near p = 0.5, where bf16
rounding alone decides them (the JAX package's own depth-decomposed and
plain conv lowerings already disagree there), so the fixture
network is made decisive: small random weights plus an identity path
through channel 0, and a head bias that puts the threshold between the two
tissues — the inner one, about a third of the head, is foreground.
"""

import numpy as np

import jax
import jax.numpy as jnp

from deepwmh_tpu.core import nifti
from deepwmh_tpu.unet import checkpoint as ckpt
from deepwmh_tpu.unet.model import UNet3D
from deepwmh_tpu.unet.plan import Plan, features_per_stage
from deepwmh_tpu.unet.preprocess import preprocess_case
from deepwmh_tpu.unet.release import release_model

SHAPE = (48, 48, 40)
SPACING = (2.0, 2.0, 2.0)


def tiny_plan(cls=Plan):
    return cls(target_spacing=[2.0, 2.0, 2.0], patch_size=[16, 16, 16], batch_size=2,
               pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
               base_features=4, max_features=8)


def _radius(shape):
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    return np.sqrt(sum(a**2 for a in g)), g


def phantom(shape=SHAPE, seed=0):
    r, g = _radius(shape)
    rng = np.random.RandomState(seed)
    tissue = np.where(r < 0.55, 300.0, np.where(r < 0.8, 150.0, 0.0))
    vol = tissue * (1 + 0.03 * rng.randn(*shape)) * np.exp(0.3 * g[0])
    return np.clip(vol, 0, None).astype(np.float32)


def decisive_params(plan, vol, seed=0):
    """JAX param tree (numpy leaves) of the decisive fixture network."""
    x0 = jnp.zeros((1,) + tuple(plan.patch_size) + (1,), jnp.bfloat16)
    params = jax.tree_util.tree_map(
        np.array, jax.jit(UNet3D(plan=plan).init)(jax.random.PRNGKey(seed), x0)["params"])
    feats = features_per_stage(plan)
    P = plan.num_pools
    for name, sub in params.items():
        if name.startswith("ConvNormAct_"):
            n = int(name.split("_")[1])
            k = sub["Conv_0"]["kernel"]
            k *= 0.05
            # a decoder step's first block reads concat([up, skip]): follow
            # the skip's channel 0; every other block follows channel 0
            dec_first = n >= 2 * (P + 1) and n % 2 == 0
            src = feats[P - 1 - (n - 2 * (P + 1)) // 2] if dec_first else 0
            centre = tuple(s // 2 for s in k.shape[:3])
            k[centre + (src, 0)] += 1.0
        else:
            sub["kernel"] *= 0.05
    params["seg_head_0"]["kernel"][..., 0, 1] += 4.0
    x = preprocess_case(jnp.asarray(vol), SPACING, plan)[None, ..., None]
    logits = np.asarray(jax.jit(UNet3D(plan=plan).apply)({"params": params}, x))[0]
    diff = logits[..., 1] - logits[..., 0]
    r, _ = _radius(diff.shape)
    inner = np.quantile(diff[r < 0.5], 0.01)
    shell = np.quantile(diff[(r > 0.6) & (r < 0.75)], 0.99)
    assert inner > shell + 2.0, (inner, shell)
    params["seg_head_0"]["bias"][1] -= (inner + shell) / 2
    return params


def write_case(root, seed=0):
    """Writes <root>/subj01.nii.gz and the model package <root>/pkg.
    Returns (image path, package dir, JAX params, plan)."""
    vol = phantom(seed=seed)
    hdr = nifti.NiftiHeader()
    hdr.set_shape(SHAPE)
    hdr.set_zooms(SPACING)
    image = str(root / "subj01.nii.gz")
    nifti.save_nifti(vol, hdr, image)
    plan = tiny_plan()
    params = decisive_params(plan, vol, seed)
    ckpt.save_checkpoint(str(root / "train"), "model_best", params, meta={"epoch": 1})
    pkg = release_model(str(root / "train"), plan, str(root / "pkg"), make_tarball=False)
    return image, pkg, params, plan
