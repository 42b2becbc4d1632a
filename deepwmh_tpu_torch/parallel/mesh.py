"""Device mesh and the collectives of the sharded modules (port of
``deepwmh_tpu.parallel.mesh``).

The JAX package's mesh has a single controller: one process drives every
local device through ``shard_map``. The port keeps that model. A ``Mesh``
is an ordered tuple of ``torch.device``s, one per shard, and one process
runs every shard: a sharded value is a list of per-shard tensors, shard
``d`` on ``mesh.devices[d]``, and the collectives below are plain
functions of the mesh and that list. A device may appear more than once:
``Mesh([torch.device("cuda", 0)] * 8)`` runs an 8-way mesh on one card (the
role of JAX's ``--xla_force_host_platform_device_count``), and
``Mesh([torch.device("cpu")] * n)`` is the CPU tests' mesh.

Between distinct cards a copy is enqueued ``non_blocking`` on the source
card's current stream, and the destination's current stream waits on an
event recorded after it: no host synchronisation per shard. Between shards
of one device a tensor is handed over as it is (the receiver never writes
into it).

``torch.distributed`` stands where the JAX package uses
``jax.distributed``: ``init_distributed`` / ``init_distributed_from_env``
join the processes of a multi-host run (gloo on the CPU, NCCL with cards).
A mesh spanning processes is ROADMAP A13, second half: ``make_mesh`` raises
under a world of more than one process unless ``local=True``.
"""

from __future__ import annotations

import os

import torch

from deepwmh_tpu_torch.device import resolve_device


class Mesh:
    """A 1-D device mesh: ``devices`` (shard order) and one axis name.
    Mirrors ``jax.sharding.Mesh``'s ``.devices``, ``.axis_names``,
    ``.shape`` ({axis: size}) and ``.size``."""

    def __init__(self, devices, axis_names=("dp",)):
        devs = tuple(self._device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError("the port's mesh is 1-D (got axes %s)" % (axis_names,))
        self.devices = devs
        self.axis_names = axis_names

    @staticmethod
    def _device(d) -> torch.device:
        d = torch.device(d)
        return d if d.type == "cpu" else resolve_device(d)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def __repr__(self):
        return "Mesh(%s, %s)" % ([str(d) for d in self.devices], self.axis_names)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_devices: int = None, axis: str = "dp", local: bool = False) -> Mesh:
    """A 1-D mesh over the first n (or all) visible CUDA devices. Raises
    without one: a CPU mesh is built explicitly, ``Mesh([cpu] * n)``.

    local=True takes this process's cards, as single-process CLIs
    (``--mesh``) do; a mesh over the cards of several processes is not
    ported (ROADMAP A13, second half) and raises."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for a mesh; a CPU mesh is built explicitly: "
            "Mesh([torch.device('cpu')] * n)")
    if not local and _world_size() > 1:
        raise NotImplementedError(
            "a mesh across %d processes is not ported yet (ROADMAP A13, second half); "
            "use local=True" % _world_size())
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None) -> bool:
    """Join ``num_processes`` processes through ``torch.distributed``
    (``tcp://coordinator``; gloo without a card, NCCL with one). A world of
    one is a no-op. Returns True when the process group was formed."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return False
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method="tcp://%s" % coordinator,
        world_size=int(num_processes),
        rank=int(process_id),
    )
    return True


def init_distributed_from_env() -> bool:
    """CLI hook: join a multi-host run when the environment carries the
    contract

      DEEPWMH_COORDINATOR   host:port of process 0
      DEEPWMH_NUM_PROCESSES total process count
      DEEPWMH_PROCESS_ID    this process's rank

    Returns True when the process group was formed."""
    num = os.environ.get("DEEPWMH_NUM_PROCESSES")
    if not num:
        return False
    pid = os.environ.get("DEEPWMH_PROCESS_ID")
    if int(num) > 1 and pid is None:
        # defaulting the rank to 0 would make every host claim rank 0 and
        # hang the coordinator with no hint of the cause — fail fast
        raise ValueError(
            "DEEPWMH_NUM_PROCESSES=%s but DEEPWMH_PROCESS_ID is unset — "
            "every process must export its rank (0..%d)" % (num, int(num) - 1))
    return init_distributed(
        coordinator=os.environ.get("DEEPWMH_COORDINATOR", "127.0.0.1:12355"),
        num_processes=int(num),
        process_id=int(pid or 0),
    )


def select_device(index: int) -> torch.device:
    """Make ``cuda:index`` this process's current device (the CLIs' ``-g``
    role); raises for an index outside the local cards."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= index < count:
        raise ValueError("device index %d out of range (0..%d local devices)"
                         % (index, count - 1))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def device_info() -> dict:
    """The JAX package's keys: backend, device counts, process count and
    platforms. ``device_count`` counts every process's devices as this
    process's (the processes of a run are alike)."""
    cuda = torch.cuda.is_available()
    local = torch.cuda.device_count() if cuda else 1
    world = _world_size()
    return {
        "backend": "cuda" if cuda else "cpu",
        "device_count": local * world,
        "local_device_count": local,
        "process_count": world,
        "platforms": ["cuda" if cuda else "cpu"],
    }


# ---------------------------------------------------------------------- #
# collectives over one process's mesh
# ---------------------------------------------------------------------- #


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself on its own device; between two cards a
    copy on the source card's stream that the destination's stream waits
    for; otherwise a plain copy."""
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        with torch.cuda.device(t.device):
            out = t.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(device).wait_event(done)
        return out
    return t.to(device)


def broadcast(mesh: Mesh, t: torch.Tensor) -> list:
    """``t`` replicated: one view per shard, on that shard's device."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = to_device(t, dev)
    return [copies[dev] for dev in mesh.devices]


def psum(mesh: Mesh, parts) -> torch.Tensor:
    """Sum of the per-shard ``parts``, added in shard order 0..n-1 on the
    first shard's device, so a run repeats bit for bit."""
    if len(parts) != mesh.size:
        raise ValueError("psum: %d parts for a %d-shard mesh" % (len(parts), mesh.size))
    dev = mesh.devices[0]
    total = parts[0]
    for p in parts[1:]:
        total = total + to_device(p, dev)
    return total


def all_gather(mesh: Mesh, parts) -> torch.Tensor:
    """The per-shard ``parts`` stacked along a new leading axis (shard
    order) on the first shard's device."""
    if len(parts) != mesh.size:
        raise ValueError("all_gather: %d parts for a %d-shard mesh" % (len(parts), mesh.size))
    dev = mesh.devices[0]
    return torch.stack([to_device(p, dev) for p in parts])


def ppermute(mesh: Mesh, parts, perm) -> list:
    """``jax.lax.ppermute``: for each (source, destination) pair, shard
    ``destination`` receives ``parts[source]``; a shard that no pair
    reaches receives zeros shaped like its own part."""
    out = [None] * mesh.size
    for src, dst in perm:
        out[dst] = to_device(parts[src], mesh.devices[dst])
    return [torch.zeros_like(parts[d]) if o is None else o for d, o in enumerate(out)]
