"""deepwmh_tpu_torch's ``run_train`` and its CLIs over a device mesh, on the
CPU (``Mesh([cpu] * n)``; the CLIs' ``make_mesh`` stood in by a CPU mesh,
as tests/test_torch_port_parallel.py's ``test_predict_cli_mesh`` does).

- ``run_train(mesh=)`` on tests/torch_port_cohort.py's 2 x 2 cohort (quick
  registration, 1 / 1 epoch x 1 step, batch 2) over 4 shards, as the JAX
  package's tests/test_train_mesh_e2e.py: spies show that
  ``register_pairs_mesh`` ran with the mesh and all four pairs in one
  chunk and that every Trainer was built with it; every marker is set,
  the release written; the registration artifacts are byte-equal to the
  group CLI's without a mesh;
- the train CLI's automatic mesh, ``-g``, ``--device`` and ``--mesh`` /
  ``--no-mesh``; the group CLI's ``--mesh`` in the classic and the learned
  mode; ``run_e2e_accuracy(mesh=)`` handing the mesh to ``run_train`` and
  ``run_predict``.
"""

import os

import pytest
import torch

from deepwmh_tpu_torch.cli import group_register as group_cli
from deepwmh_tpu_torch.cli import train
from deepwmh_tpu_torch.parallel.mesh import Mesh
from deepwmh_tpu_torch.pipeline import multistage
from deepwmh_tpu_torch.pipeline.multistage import StageBudget
from deepwmh_tpu_torch.registration import group, learned_group
from torch_port_cohort import MARKERS, write_e2e_cohort

CPU = torch.device("cpu")
MESH_BUDGET = dict(stage2_epochs=1, stage3_epochs=1, batches_per_epoch=1, batch_size=2,
                   voxel_budget=16 * 16 * 16, base_features=4, max_features=8)


def cpu_mesh(n):
    return Mesh([CPU] * n)


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """One run_train over a 4-shard CPU mesh, with spies on the mesh paths."""
    root = str(tmp_path_factory.mktemp("mesh_train"))
    ref_csv, tr_csv, _ = write_e2e_cohort(root)
    mesh = cpu_mesh(4)
    calls = []
    real_rpm, real_trainer = group.register_pairs_mesh, multistage.Trainer

    def spy_rpm(fixed, moving, f_sp, m_sp, m, *a, **kw):
        calls.append(("reg", m, int(fixed.shape[0])))
        return real_rpm(fixed, moving, f_sp, m_sp, m, *a, **kw)

    class SpyTrainer(real_trainer):
        def __init__(self, *a, **kw):
            calls.append(("train", kw.get("mesh")))
            super().__init__(*a, **kw)

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    group.register_pairs_mesh, multistage.Trainer = spy_rpm, SpyTrainer
    try:
        core = train.run_train(ref_csv, tr_csv, os.path.join(root, "out"), skip_bfc=True,
                               quick_registration=True, large_deformation=False,
                               budget=StageBudget(**MESH_BUDGET), mesh=mesh, device="cpu")
    finally:
        group.register_pairs_mesh, multistage.Trainer = real_rpm, real_trainer
        torch.set_num_threads(saved)
    return {"root": root, "core": core, "mesh": mesh, "calls": calls,
            "out": os.path.join(root, "out")}


def test_run_train_shards_registration_and_training(meshed):
    calls, mesh = meshed["calls"], meshed["mesh"]
    reg = [c for c in calls if c[0] == "reg"]
    trainers = [c for c in calls if c[0] == "train"]
    assert reg and all(c[1] is mesh for c in reg)
    assert reg[0][2] == 4  # batch_pairs raised to the mesh size: one chunk of 4 pairs
    assert trainers and all(c[1] is mesh for c in trainers)
    for m in MARKERS:
        assert os.path.isfile(os.path.join(meshed["core"], "Checkpoints", m)), m
    assert os.path.isfile(os.path.join(meshed["core"], "Model_release",
                                       "model_release.tar.gz"))


def test_registration_artifacts_equal_the_run_without_mesh(meshed, tmp_path, monkeypatch,
                                                           capsys):
    """The group CLI on run_train's own pair lists, without a mesh and with
    run_train's preset: byte-equal artifacts. Then the CLI's --mesh in the
    classic mode (affine only) and in the learned mode."""
    out = meshed["out"]
    src, tgt = os.path.join(out, "regsource.csv"), os.path.join(out, "regtarget.csv")
    plain = str(tmp_path / "plain")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        group_cli.main(["-s", src, "-t", tgt, "-o", plain, "--keep-deformation",
                        "--allow-quick-registration", "--device", "cpu"])
        reg_dir = os.path.join(out, "002_Registration")
        files = sorted(os.path.relpath(os.path.join(d, f), plain)
                       for d, _, fs in os.walk(plain) for f in fs)
        assert len(files) == 4 * 3
        for rel in files:
            with open(os.path.join(plain, rel), "rb") as a, \
                    open(os.path.join(reg_dir, rel), "rb") as b:
                assert a.read() == b.read(), rel

        monkeypatch.setattr(group_cli, "make_mesh", lambda: cpu_mesh(4))
        capsys.readouterr()
        with pytest.raises(SystemExit):
            group_cli.main(["-s", src, "-t", tgt, "-o", str(tmp_path / "x"), "--mesh",
                            "--device", "cpu"])
        group_cli.main(["-s", src, "-t", tgt, "-o", str(tmp_path / "affine"), "--mesh",
                        "--affine-only", "--allow-quick-registration"])
        said = capsys.readouterr().out
        assert "mesh: sharding pair batches over 4 device(s)" in said
        assert "[4/4] registering" in said
        assert group.GroupRegistration([], [], str(tmp_path / "affine"), deformable=False,
                                       device="cpu").pair_complete("REF1", "SUB1")
    finally:
        torch.set_num_threads(saved)

    seen = []
    monkeypatch.setattr(learned_group.LearnedGroupRegistration, "launch",
                        lambda self: seen.append((self.mesh, self.device)))
    group_cli.main(["-s", src, "-t", tgt, "-o", str(tmp_path / "learned"), "--learned",
                    "--mesh"])
    assert "mesh: dp pair batches over 4 device(s) for network training" in \
        capsys.readouterr().out
    assert len(seen) == 1 and seen[0][0].size == 4 and seen[0][1] == CPU


def _mesh_args(argv):
    parser = train.make_parser()
    return parser, parser.parse_args(["-s", "r.csv", "-t", "t.csv", "-o", "o"] + argv)


def test_train_cli_mesh_choice(monkeypatch, capsys):
    """The automatic mesh with more than one card, off with -g or
    --device; --mesh / --no-mesh force it; --mesh excludes -g / --device
    and needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device for a mesh"):
        train.mesh_from_args(*_mesh_args(["--mesh"]))
    assert train.mesh_from_args(*_mesh_args([])) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(train, "make_mesh", lambda: cpu_mesh(2))
    capsys.readouterr()
    auto = train.mesh_from_args(*_mesh_args([]))
    assert auto is not None and auto.size == 2
    assert "mesh: 2 device(s) (cpu)" in capsys.readouterr().out
    for argv in (["-g", "0"], ["--device", "cpu"], ["--no-mesh"]):
        assert train.mesh_from_args(*_mesh_args(argv)) is None, argv
    assert train.mesh_from_args(*_mesh_args(["--mesh"])).size == 2
    for argv in (["--mesh", "-g", "0"], ["--mesh", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            train.mesh_from_args(*_mesh_args(argv))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert train.mesh_from_args(*_mesh_args([])) is None


def test_e2e_accuracy_hands_the_mesh_on(meshed, tmp_path, monkeypatch):
    """run_e2e_accuracy(mesh=) gives the mesh to run_train (stood in by the
    meshed run's core folder) and to run_predict, which predicts the
    held-out phantom over it."""
    from deepwmh_tpu_torch.cli import predict
    from deepwmh_tpu_torch.eval.e2e import run_e2e_accuracy

    seen = {}

    def fake_train(*a, **kw):
        seen["train"] = kw["mesh"]
        return meshed["core"]

    real_predict = predict.run_predict

    def spy_predict(*a, **kw):
        seen["predict"] = kw["mesh"]
        return real_predict(*a, **kw)

    monkeypatch.setattr(train, "run_train", fake_train)
    monkeypatch.setattr(predict, "run_predict", spy_predict)
    mesh = cpu_mesh(2)
    res = run_e2e_accuracy(str(tmp_path / "e2e"), shape=(24, 24, 20), n_ref=1, n_train=1,
                           n_test=1, skip_bfc=True, mesh=mesh, device="cpu")
    assert seen == {"train": mesh, "predict": mesh}
    assert set(res["heldout_dice"]) == {"TEST00"} and 0.0 <= res["dice"] <= 1.0
