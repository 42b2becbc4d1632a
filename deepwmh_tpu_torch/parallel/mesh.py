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
A mesh may then span the processes: ``make_mesh()`` (``local=False``) under
a world of several processes is every rank's local devices in rank order,
and ``Mesh.ranks`` names the process of each shard. Every process holds
the whole shard list but computes only its own shards (``local_shards``);
a per-shard list carries ``None`` for another process's shard, and
``psum`` / ``all_gather`` fetch those parts through ``torch.distributed``
and add or stack every shard's part in global shard order on every
process, so a run over 2 processes x 2 shards gives the bits of one
process's 4-shard mesh. The training modules use this; the inference
side (sweeps, halo exchange) runs on a mesh of one process.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from deepwmh_tpu_torch.device import resolve_device


class Mesh:
    """A 1-D device mesh: ``devices`` (shard order) and one axis name.
    Mirrors ``jax.sharding.Mesh``'s ``.devices``, ``.axis_names``,
    ``.shape`` ({axis: size}) and ``.size``.

    ``ranks``: the process of each shard, for a mesh across processes:
    ranks 0..world-1 in order, each holding the same number of contiguous
    shards. None (the default) puts every shard in this process."""

    def __init__(self, devices, axis_names=("dp",), ranks=None):
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError("the port's mesh is 1-D (got axes %s)" % (axis_names,))
        if ranks is not None:
            ranks = tuple(int(r) for r in ranks)
            world = _world_size()
            per = len(devices) // world
            if ranks != tuple(r for r in range(world) for _ in range(per)) \
                    or per * world != len(devices):
                raise ValueError("mesh ranks %s: each of the %d processes must hold the same "
                                 "number of contiguous shards, in rank order" % (ranks, world))
            if world == 1:
                ranks = None
        self.ranks = ranks
        rank = _rank()
        # another process's device is only named here, never resolved
        self.devices = tuple(self._device(d) if ranks is None or ranks[i] == rank
                             else torch.device(d) for i, d in enumerate(devices))
        self.axis_names = axis_names
        self.local_shards = tuple(i for i in range(len(devices))
                                  if ranks is None or ranks[i] == rank)

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

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None

    @property
    def home(self) -> torch.device:
        """This process's first shard's device: where collectives land."""
        return self.devices[self.local_shards[0]]

    @property
    def writer(self) -> bool:
        """Whether this process writes the run's shared files (rank 0 of a
        mesh across processes; always on a mesh of one process)."""
        return self.ranks is None or _rank() == 0

    def local(self) -> "Mesh":
        """This process's shards as a mesh of one process."""
        if not self.spans_processes:
            return self
        return Mesh([self.devices[d] for d in self.local_shards], self.axis_names)

    def submesh(self, n: int) -> "Mesh":
        """The first n shards (a mesh of one process only)."""
        if self.spans_processes:
            raise ValueError("a mesh across processes has no submesh")
        return Mesh(self.devices[:n], self.axis_names)

    def __repr__(self):
        return "Mesh(%s, %s%s)" % ([str(d) for d in self.devices], self.axis_names,
                                   "" if self.ranks is None else ", ranks=%s" % (self.ranks,))


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def global_mesh(local_devices, axis: str = "dp") -> Mesh:
    """The mesh over every process's ``local_devices``, in rank order (the
    processes exchange their device lists); this process's alone in a world
    of one."""
    import torch.distributed as dist

    local_devices = [str(torch.device(d)) for d in local_devices]
    world = _world_size()
    if world == 1:
        return Mesh(local_devices, (axis,))
    lists = [None] * world
    dist.all_gather_object(lists, local_devices)
    if len({len(x) for x in lists}) != 1:
        raise ValueError("a mesh across processes needs as many devices on every process: %s"
                         % [len(x) for x in lists])
    return Mesh([d for x in lists for d in x], (axis,),
                ranks=[r for r, x in enumerate(lists) for _ in x])


def make_mesh(n_devices: int = None, axis: str = "dp", local: bool = False) -> Mesh:
    """A 1-D mesh over the first n (or all) visible CUDA devices. Raises
    without one: a CPU mesh is built explicitly, ``Mesh([cpu] * n)``.

    Under a world of several processes (``init_distributed``) the mesh
    spans them: every rank's first n (or all) cards, in rank order.
    local=True takes this process's cards only, as the single-process CLIs
    (predict and serve ``--mesh``) do."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for a mesh; a CPU mesh is built explicitly: "
            "Mesh([torch.device('cpu')] * n)")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    if local:
        return Mesh(devs, (axis,))
    return global_mesh(devs, axis)


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
# collectives
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


def gather_shards(mesh: Mesh, parts) -> list:
    """Every shard's part, given this process's (``None`` for another
    process's shard): on a mesh across processes the others' parts are
    fetched through ``torch.distributed`` (as bytes, so every dtype travels
    unchanged; the parts of all shards must have one shape and dtype) and
    land on ``mesh.home``. On a mesh of one process, ``parts`` itself."""
    if len(parts) != mesh.size:
        raise ValueError("%d parts for a %d-shard mesh" % (len(parts), mesh.size))
    if not mesh.spans_processes:
        return list(parts)
    import torch.distributed as dist

    comm = mesh.home if dist.get_backend() == "nccl" else torch.device("cpu")
    local = [parts[d] for d in mesh.local_shards]
    like = local[0]
    mine = torch.stack([p.detach().to(comm) for p in local]).contiguous()
    flat = mine.reshape(-1).view(torch.uint8)
    bufs = [torch.empty_like(flat) for _ in range(_world_size())]
    dist.all_gather(bufs, flat)
    out = []
    for r, buf in enumerate(bufs):
        got = buf.view(like.dtype).reshape(mine.shape)
        for i in range(got.shape[0]):
            d = r * len(local) + i
            out.append(parts[d] if mesh.ranks[d] == _rank() else got[i].to(mesh.home))
    return out


def psum(mesh: Mesh, parts) -> torch.Tensor:
    """Sum of the per-shard ``parts``, added in shard order 0..n-1 on the
    first shard's device (``mesh.home`` on a mesh across processes, where
    every process adds every shard's part in that order), so a run repeats
    bit for bit. No gradient crosses a process boundary."""
    parts = gather_shards(mesh, parts)
    dev = mesh.home
    total = to_device(parts[0], dev)
    for p in parts[1:]:
        total = total + to_device(p, dev)
    return total


def all_gather(mesh: Mesh, parts) -> torch.Tensor:
    """The per-shard ``parts`` stacked along a new leading axis (shard
    order) on the first shard's device (``mesh.home``)."""
    parts = gather_shards(mesh, parts)
    dev = mesh.home
    return torch.stack([to_device(p, dev) for p in parts])


def map_blocks(mesh: Mesh, stacks, fn) -> tuple:
    """Data parallelism over a leading batch axis: the host tensors
    ``stacks`` [B, ...] are padded to a multiple of the mesh size by
    repeating the last row (each block gathered alone, no padded copy of a
    stack), and shard d's contiguous block of rows goes through
    ``fn(device, *blocks)``, which returns a tuple of host arrays
    or tensors with the block's leading axis (``None`` for a field it does
    not fill). The shards of one device run in order, each distinct device
    on a thread of its own; this process computes only its own shards. Each
    field is gathered across processes in shard order and the padding
    dropped, so every process returns all B rows as host tensors."""
    n, B = mesh.size, int(stacks[0].shape[0])
    rows = -(-B // n)

    def run(dev, shards):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            out = {}
            for d in shards:
                idx = torch.arange(d * rows, (d + 1) * rows).clamp(max=B - 1)
                out[d] = fn(dev, *(a[idx] for a in stacks))
            return out

    by_device = {}
    for d in mesh.local_shards:
        by_device.setdefault(mesh.devices[d], []).append(d)
    per_shard = {}
    with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
        for done in [pool.submit(run, dev, shards) for dev, shards in by_device.items()]:
            per_shard.update(done.result())
    out = []
    for k in range(len(per_shard[mesh.local_shards[0]])):
        if per_shard[mesh.local_shards[0]][k] is None:
            out.append(None)
            continue
        parts = [torch.as_tensor(per_shard[d][k]).cpu() if d in per_shard else None
                 for d in range(n)]
        out.append(torch.cat([p.cpu() for p in gather_shards(mesh, parts)])[:B])
    return tuple(out)


def barrier(mesh: Mesh) -> None:
    """Wait for every process of a mesh across processes (a no-op on a mesh
    of one process)."""
    if mesh.spans_processes:
        import torch.distributed as dist

        dist.barrier()


def ppermute(mesh: Mesh, parts, perm) -> list:
    """``jax.lax.ppermute``: for each (source, destination) pair, shard
    ``destination`` receives ``parts[source]``; a shard that no pair
    reaches receives zeros shaped like its own part."""
    out = [None] * mesh.size
    for src, dst in perm:
        out[dst] = to_device(parts[src], mesh.devices[dst])
    return [torch.zeros_like(parts[d]) if o is None else o for d, o in enumerate(out)]


# ---------------------------------------------------------------------- #
# data-parallel training: a replica of the model a shard
# ---------------------------------------------------------------------- #


def replicate(mesh: Mesh, model) -> list:
    """One replica of ``model`` a local shard (``None`` for another
    process's): ``model`` itself on the home shard, which must hold it,
    copies on the others, also where shards share a device (a shared
    module would take every shard's gradient)."""
    import copy

    reps = [None] * mesh.size
    for d in mesh.local_shards:
        reps[d] = model if d == mesh.local_shards[0] else copy.deepcopy(model).to(
            mesh.devices[d], memory_format=torch.channels_last_3d)
    return reps


@torch.no_grad()
def copy_params(replicas, params) -> None:
    """Every replica takes ``params`` (the home replica's, in parameter
    order); the home replica itself is left as it is."""
    for rep in replicas:
        if rep is not None:
            for p, q in zip(rep.parameters(), params):
                if p is not q:
                    p.copy_(to_device(q, p.device))


def psum_grads(mesh: Mesh, grads, params) -> list:
    """Per-shard gradient lists (``None`` for another process's shard; a
    ``None`` gradient counts as zeros) summed in shard order on the home
    shard in one flat psum, shaped as ``params``."""
    flat = [None if g is None else torch.cat([
        (torch.zeros_like(p) if gi is None else gi).reshape(-1) for p, gi in zip(params, g)])
        for g in grads]
    total = psum(mesh, flat).split([p.numel() for p in params])
    return [t.view_as(p) for t, p in zip(total, params)]
