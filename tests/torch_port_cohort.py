"""The training cohort of tests/test_train_pipeline_e2e.py, written with the
port's own I/O (no JAX import), for the port's whole-run tests on the CPU
(test_torch_port_train_cli.py) and on the card (test_torch_port_cuda.py):
24x24x20 at 2 mm, two healthy references (label1 = label2 = the brain) and
two patients with a planted 4x4x4 lesion."""

import os

import numpy as np

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.manifests import write_csv_simple

SHAPE = (24, 24, 20)
MARKERS = ("STAGE_1_INITIAL_SEGMENTATION", "STAGE_2-3_TRAINING_DENOISER",
           "STAGE_2-4_RAW_SOFTMAX", "STAGE_2-5_MASKED_SOFTMAX", "STAGE_2-6_ENSEMBLING",
           "STAGE_3-1_DATA_SPLIT", "STAGE_3-4_TRAINING", "STAGE_3-5_FINAL_FIT",
           "PIPELINE_TRAINING_COMPLETE")
# the e2e test's budget, at base 4 / max 8
BUDGET = dict(stage2_epochs=2, stage3_epochs=2, batches_per_epoch=2, batch_size=2,
              voxel_budget=16 * 16 * 16, base_features=4, max_features=8)


def _head(shape, seed, lesion=False):
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    r = np.sqrt(sum(a**2 for a in g))
    brain = (r < 0.8).astype(np.float32)
    vol = brain * (200 + 30 * np.cos(3 * g[0]) + 8 * rng.randn(*shape))
    les = np.zeros(shape, np.float32)
    if lesion:
        les[10:14, 10:14, 8:12] = 1.0
        les *= brain
        vol = vol + 160 * les
    return vol.astype(np.float32), brain, les


def write_e2e_cohort(root):
    """Returns (reference csv, training csv, {case: lesion mask})."""
    hdr = nifti.NiftiHeader()
    hdr.set_shape(SHAPE)
    hdr.set_zooms((2.0, 2.0, 2.0))
    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    ref = {"case": [], "desc": [], "flair": [], "label1": [], "label2": []}
    for i in range(2):
        vol, brain, _ = _head(SHAPE, seed=i)
        paths = [os.path.join(data, "ref%d%s.nii.gz" % (i, s)) for s in ("", "_l1", "_l2")]
        for arr, p in zip((vol, brain, brain), paths):  # tissue class 1 == cerebrum
            nifti.save_nifti(arr, hdr, p)
        for k, v in zip(ref, ["REF%d" % i, "healthy"] + paths):
            ref[k].append(v)
    tr = {"case": [], "desc": [], "flair": []}
    lesions = {}
    for i in range(2):
        vol, _, les = _head(SHAPE, seed=10 + i, lesion=True)
        fp = os.path.join(data, "sub%d.nii.gz" % i)
        nifti.save_nifti(vol, hdr, fp)
        for k, v in zip(tr, ("SUB%d" % i, "patient", fp)):
            tr[k].append(v)
        lesions["SUB%d" % i] = les
    ref_csv, tr_csv = os.path.join(root, "reference.csv"), os.path.join(root, "training.csv")
    write_csv_simple(ref_csv, ref)
    write_csv_simple(tr_csv, tr)
    return ref_csv, tr_csv, lesions
