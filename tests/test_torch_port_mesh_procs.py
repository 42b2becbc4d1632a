"""A device mesh across processes, on the CPU: two gloo processes with two
CPU shards each (``global_mesh``: ranks (0, 0, 1, 1)) against one
process's 4-shard mesh. A data-parallel train step, a learned-registration
step and ``register_pairs_mesh`` each give the one-process mesh's bits on
both ranks; ``launch(mesh=)`` writes each process's own pairs, and after
its barrier every pair is complete. Both sides run single-threaded
(torch's CPU kernels may split their sums by thread count)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deepwmh_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = textwrap.dedent('''
    import numpy as np
    import torch

    from deepwmh_tpu_torch.registration import group, learned
    from deepwmh_tpu_torch.registration.affine import AffineConfig
    from deepwmh_tpu_torch.registration.svf import SVFConfig
    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.plan import Plan
    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer


    def run_all(mesh, out_dir):
        """The three steps on ``mesh``: {name: array}."""
        torch.set_num_threads(1)
        res = {}
        plan = Plan(target_spacing=[2.0] * 3, patch_size=[16, 16, 16], batch_size=4,
                    pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
                    base_features=4, max_features=8)
        tr = Trainer(plan, TrainConfig(epochs=1, batches_per_epoch=1, batch_size=4),
                     out_dir, device="cpu", dtype=torch.float32, mesh=mesh)
        tr.init_state(0)
        rng = np.random.RandomState(0)
        images = rng.randn(4, 16, 16, 16).astype(np.float32)
        labels = (images + 0.5 * rng.randn(4, 16, 16, 16) > 1.0).astype(np.int32)
        loss = tr.train_step(*tr._to_device(images, labels), tr.lr_at(0),
                             torch.Generator().manual_seed(3))
        res["train_loss"] = loss.numpy()
        res["train_params"] = torch.cat([p.detach().reshape(-1) for p in tr.params]).numpy()
        res["train_trace"] = torch.cat([t.reshape(-1) for t in tr.trace]).numpy()

        reg = learned.LearnedRegistration((16, 16, 16), learned.LearnedRegConfig(
            base_features=4, max_features=8, num_pools=2, steps=2, batch_pairs=4,
            int_steps=2), device="cpu")
        reg.model = init_weights(UNet3D(reg.plan, dtype=torch.float32, fused_norm=False),
                                 torch.Generator().manual_seed(0))
        vols = [np.random.RandomState(10 + i).rand(16, 16, 16).astype(np.float32) * 100
                for i in range(3)]
        res["learned_loss"] = np.float64(reg.train(vols, verbose=False, mesh=mesh))
        res["learned_params"] = torch.cat([p.detach().reshape(-1)
                                           for p in reg.model.parameters()]).numpy()

        fx = (np.random.RandomState(20).rand(5, 20, 22, 18) * 100).astype(np.float32)
        mv = (np.random.RandomState(21).rand(5, 20, 22, 18) * 100).astype(np.float32)
        outs = group.register_pairs_mesh(fx, mv, (1.0, 1.2, 1.0), (1.0, 1.0, 1.1), mesh,
                                         affine_cfg=AffineConfig(shrinks=(2,), iters=(3,)),
                                         svf_cfg=SVFConfig(shrinks=(2,), iters=(3,)))
        for k, o in enumerate(outs):
            res["pairs_%d" % k] = np.asarray(o)
        return res
''')

WORKER = COMMON + textwrap.dedent('''
    import os
    import sys

    from deepwmh_tpu_torch.parallel.mesh import (
        global_mesh, init_distributed_from_env, make_mesh)

    assert init_distributed_from_env()
    rank = int(os.environ["DEEPWMH_PROCESS_ID"])
    mesh = global_mesh(["cpu", "cpu"])
    assert mesh.ranks == (0, 0, 1, 1) and mesh.local_shards == (2 * rank, 2 * rank + 1)
    out = sys.argv[1]
    res = run_all(mesh, os.path.join(out, "train_%d" % rank))
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)

    # launch(mesh=): this process writes its own shards' pairs, then waits
    from deepwmh_tpu_torch.registration.group import GroupRegistration
    cases = [(c, os.path.join(out, "cohort", c + ".nii.gz"))
             for c in ("s0", "s1", "t0", "t1")]
    reg = GroupRegistration(cases[:2], cases[2:], os.path.join(out, "pairs"), device="cpu")
    reg.affine_cfg, reg.svf_cfg = AffineConfig(shrinks=(2,), iters=(2,)), SVFConfig(
        shrinks=(2,), iters=(2,))
    reg.launch(verbose=True, batch_pairs=4, mesh=mesh)
    assert all(reg.pair_complete(s, t) for s in ("s0", "s1") for t in ("t0", "t1"))
    try:
        make_mesh()
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    print("rank %d ok" % rank, flush=True)
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_give_the_one_process_bits(tmp_path):
    from deepwmh_tpu_torch.core import nifti

    hdr = nifti.NiftiHeader()
    hdr.set_shape((20, 22, 18))
    hdr.set_zooms((1.0, 1.0, 1.0))
    os.makedirs(tmp_path / "cohort")
    for i, c in enumerate(("s0", "s1", "t0", "t1")):
        vol = (np.random.RandomState(30 + i).rand(20, 22, 18) * 100).astype(np.float32)
        nifti.save_nifti(vol, hdr, str(tmp_path / "cohort" / (c + ".nii.gz")))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DEEPWMH_")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               DEEPWMH_COORDINATOR="127.0.0.1:%d" % _free_port(), DEEPWMH_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(env, DEEPWMH_PROCESS_ID=str(r))) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d:\n%s" % (rank, out)
        assert "rank %d ok" % rank in out
    # each rank registered and announced only the chunk it shares, wrote its own pairs
    assert outs[0].count("[4/4] registering") == outs[1].count("[4/4] registering") == 1

    namespace = {}
    exec(COMMON, namespace)
    saved = torch.get_num_threads()
    try:
        want = namespace["run_all"](pmesh.Mesh(["cpu"] * 4), str(tmp_path / "one"))
    finally:
        torch.set_num_threads(saved)
    for rank in (0, 1):
        got = np.load(str(tmp_path / ("rank%d.npz" % rank)))
        assert set(got.files) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg="rank %d %s" % (rank, key))


def test_a_mesh_across_processes_is_checked():
    """Ranks must be in order, each holding as many contiguous shards; a
    world of one needs no ranks."""
    m = pmesh.Mesh(["cpu"] * 2, ranks=(0, 0))
    assert m.ranks is None and m.local_shards == (0, 1) and m.writer
    assert not m.spans_processes and m.local() is m
    with pytest.raises(ValueError, match="contiguous"):
        pmesh.Mesh(["cpu"] * 2, ranks=(0, 1))
    assert pmesh.global_mesh(["cpu", "cpu"]).size == 2
    assert pmesh.gather_shards(m, [torch.ones(1), torch.zeros(1)])[1].item() == 0.0
    pmesh.barrier(m)
