"""deepwmh_tpu_torch model packages against the JAX package: the stdlib
msgpack codec bit-exact against flax's, packages moving both ways with
identical weights, and the package-folder rules."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from deepwmh_tpu.unet import checkpoint as jckpt
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu.unet.release import load_released_model as jload
from deepwmh_tpu.unet.release import release_model
from deepwmh_tpu_torch.unet import msgpack_codec
from deepwmh_tpu_torch.unet.checkpoint import params_from_flax, params_to_flax
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.unet.release import (
    load_released_model,
    resolve_model_dir,
    validate_model_dir,
    write_model_package,
)

from torch_port_fixture import tiny_plan


@pytest.fixture(scope="module")
def jax_params():
    """JAX init of the tiny plan plus noise (numpy leaves)."""
    from deepwmh_tpu.unet.plan import Plan as JPlan

    x = jnp.zeros((1, 16, 16, 16, 1), jnp.bfloat16)
    params = jax.jit(JUNet3D(plan=tiny_plan(JPlan)).init)(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32), params)


def _assert_trees_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_decoder_matches_msgpack_restore(tmp_path, jax_params):
    jckpt.save_checkpoint(str(tmp_path), "model_best", jax_params, meta={"epoch": 3})
    with open(tmp_path / "model_best.msgpack", "rb") as f:
        blob = f.read()
    _assert_trees_equal(msgpack_codec.unpackb(blob), serialization.msgpack_restore(blob))


def test_codec_matches_flax_on_mixed_values():
    tree = {
        "arrays": {"f": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                   "i": np.arange(70000, dtype=np.int64), "b": np.ones((2, 2), bool)},
        "ints": [0, 127, 128, -1, -33, 300, -300, 70000, 2**40, -(2**40)],
        "misc": [1.5, "s" * 40, "x" * 300, None, True, False, b"raw"],
        "scalar": np.float32(3.0),
        "k" * 20: {str(i): i for i in range(20)},
    }
    blob = serialization.msgpack_serialize(tree, in_place=True)
    assert msgpack_codec.packb(tree) == blob
    got = msgpack_codec.unpackb(blob)
    want = serialization.msgpack_restore(blob)
    assert got["ints"] == want["ints"] and got["misc"] == want["misc"]
    assert type(got["scalar"]) is type(want["scalar"]) and got["scalar"] == want["scalar"]
    _assert_trees_equal(got["arrays"], want["arrays"])
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(blob[:-3])


def test_flax_tree_roundtrips_through_state_dict(jax_params):
    sd = params_from_flax(jax_params)
    model = UNet3D(tiny_plan(Plan))
    model.load_state_dict(sd, strict=True)
    _assert_trees_equal(params_to_flax(model.state_dict()), jax_params)
    with pytest.raises(KeyError):
        params_from_flax({"Dense_0": {}})


def test_port_package_loads_in_jax_with_identical_params(tmp_path):
    plan = tiny_plan(Plan)
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(1))
    pkg = write_model_package(str(tmp_path / "pkg"), model, plan, meta={"epoch": 1})
    _jmodel, jparams, jplan = jload(pkg)
    assert jplan.to_json() == plan.to_json()
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jparams),
                        params_to_flax(model.state_dict()))
    # and back: the port reloads the same weights, channels-last, on the CPU
    model2, plan2 = load_released_model(pkg, device="cpu", dtype=torch.float32)
    assert plan2 == plan
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k])


def test_jax_package_loads_in_port(tmp_path, jax_params):
    from deepwmh_tpu.unet.plan import Plan as JPlan

    jplan = tiny_plan(JPlan)
    jckpt.save_checkpoint(str(tmp_path / "train"), "model_best", jax_params)
    pkg = release_model(str(tmp_path / "train"), jplan, str(tmp_path / "pkg"),
                        make_tarball=False)
    model, plan = load_released_model(pkg, device="cpu")
    assert plan.to_json() == jplan.to_json()
    _assert_trees_equal(params_to_flax(model.state_dict()), jax_params)


def test_model_dir_rules(tmp_path):
    plan = tiny_plan(Plan)
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(0))
    root = tmp_path / "root"
    task_a = write_model_package(str(root / "TaskA"), model, plan)
    assert resolve_model_dir(task_a) == task_a
    assert resolve_model_dir(str(root)) == task_a
    task_b = write_model_package(str(root / "TaskB"), model, plan)
    with pytest.raises(RuntimeError, match="custom-task-name"):
        resolve_model_dir(str(root))
    assert resolve_model_dir(str(root), "TaskB") == task_b
    with pytest.raises(RuntimeError, match="not found"):
        resolve_model_dir(str(root), "TaskC")
    with pytest.raises(RuntimeError):
        resolve_model_dir(str(tmp_path / "nope"))
    os.remove(os.path.join(task_b, "plan.json"))
    with pytest.raises(RuntimeError, match="missing plan.json"):
        validate_model_dir(task_b)
    with open(os.path.join(task_a, "framework.json"), "w") as f:
        f.write('{"package": "other"}')
    with pytest.raises(RuntimeError, match="not a deepwmh_tpu model package"):
        validate_model_dir(task_a)
