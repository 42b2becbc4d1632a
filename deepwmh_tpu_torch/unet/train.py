"""The U-Net trainer on one card (the port of ``deepwmh_tpu.unet.train``).

The recipe the JAX package runs (nnUNetTrainerV2's): ``epochs`` x
``batches_per_epoch`` steps of CE + batch soft Dice with deep supervision,
per-sample augmentation on the device, poly LR ``lr * (1 - step /
total)^0.9`` computed on the host, and the update of
``optax.chain(clip_by_global_norm(12), add_decayed_weights(wd),
sgd(1.0, momentum=0.99, nesterov=True))`` written out term by term:

    g <- g                 if ||g|| < clip, else g / ||g|| * clip
    u  = g + wd * p
    t <- u + m * t         (the momentum trace)
    p <- p + (u + m * t) * (-lr)

(``clip_grad_norm_`` adds 1e-6 to the norm; it is not that.) Validation is
hard Dice on ``val_batches`` sampled batches; ``noval`` makes the metric
epoch + 1 and model_best a hard link of model_latest. Checkpoints are in
the JAX package's layout, the optimizer state as flax stores optax's
chain, so either package resumes the other's model_latest. The model
trains on K1 (``fused_norm``: K1's kernels forward, its backward kernels
for the gradient, their plain versions on the CPU; the JAX trainer keeps
flax GroupNorm, which XLA differentiates) with remat on stages 0-1.

With ``mesh`` (a ``parallel.mesh.Mesh``) the step is data parallel, as the
JAX trainer's over its 'dp' axis: shard d takes rows d*B/n .. (d+1)*B/n - 1
of the batch and runs them on its own replica of the model (one a shard,
also where shards share a device: a shared module would take every
shard's gradient). The loss is the whole batch's, not the mean of the
shards': each shard gives the sums of every level's CE and batch Dice
(``losses.deep_supervision_parts``), ``psum`` adds them in shard order and
the loss is formed from the total on the home shard. Its gradient with
respect to that total goes back to every shard, each shard's backward
gives its replica's gradient, ``psum`` adds those in shard order, and the
update runs on the home shard; the other replicas copy its parameters, so
every replica holds the same bits after a step. The augmentation draws
every sample's values from the one generator in sample order and applies
sample i on its shard: the augmented batch is the unsharded one. A batch
that the mesh size does not divide shards over the first gcd(B, n) shards
(unsharded at a gcd of 1), with the JAX trainer's log line.

On a card no host-device transfer inside a step waits on the compute
stream, so the host never waits for the card between two epoch ends.
The prefetch thread copies each batch into pinned memory and uploads it on
a copy stream of its own; the loop orders the batch on the compute stream
by that copy's event before the step. The step's draws run on a side
stream (``augment.draw_samples``): the host waits for their scalars alone.
On the CPU the same code copies nothing and waits for nothing.

A step's draws' wait, augmentation, forward and backward, and update, the
prefetch's sampling and the loop's wait on it, the checkpoints and
validation are spans ``train.*`` (``utils/profiling.span``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    copy_params,
    psum,
    psum_grads,
    replicate,
    to_device,
)
from deepwmh_tpu_torch.unet.augment import (
    AugmentConfig,
    apply_augment,
    apply_samples,
    draw_samples,
)
from deepwmh_tpu_torch.unet.data import SegDataset
from deepwmh_tpu_torch.unet.losses import (
    deep_supervision_loss,
    deep_supervision_loss_from_parts,
    deep_supervision_parts,
    hard_dice,
    hard_dice_from_parts,
    hard_dice_parts,
)
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.utils.logging import SimpleTxtLog, Timer
from deepwmh_tpu_torch.utils.profiling import span


@dataclass
class TrainConfig:
    epochs: int = 100
    batches_per_epoch: int = 150  # reference DCNN_batches_in_each_epoch
    batch_size: int = 2
    lr: float = 1e-2
    momentum: float = 0.99
    weight_decay: float = 3e-5
    grad_clip: float = 12.0
    noval: bool = False
    save_every_epoch: bool = False
    oversample_fg: float = 0.33
    augment: bool = True
    aug: AugmentConfig = field(default_factory=AugmentConfig)
    val_batches: int = 10
    seed: int = 0


def opt_state_tree(trace_tree: dict) -> dict:
    """optax's chain state (clip, decay, (trace, scale)) in flax's
    ``to_state_dict`` layout, around the momentum trace's param tree."""
    return {"0": {}, "1": {}, "2": {"0": {"trace": trace_tree}, "1": {}}}


def augment_seed(seed: int, start_epoch: int) -> int:
    """The augmentation generator's seed: ``seed`` from scratch, a value of
    (seed, start_epoch) on resume, so a resumed run draws new coins."""
    return seed if not start_epoch else (seed * 1_000_003 + start_epoch) % 2**63


class Trainer:
    def __init__(self, plan: Plan, cfg: TrainConfig, out_dir: str, device=None,
                 dtype=torch.bfloat16, logger: SimpleTxtLog = None, mesh: Mesh = None):
        """``device``: CUDA by default, the CPU only when asked for; with
        ``mesh`` its home shard's device (``device``, if given, must be
        that one). ``dtype``: the compute dtype (bf16 as the JAX trainer;
        f32 for exact comparisons). ``logger``: where the epoch lines go
        (the pipeline passes its run log), ``training_log.txt`` in
        ``out_dir`` by default. ``mesh``: data-parallel steps over its
        shards (see the module's docstring)."""
        self.plan = plan
        self.cfg = cfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.logger = logger or SimpleTxtLog(os.path.join(out_dir, "training_log.txt"))
        self.mesh = None
        self.mesh = mesh = self._fit_mesh(mesh)
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.home:
                raise ValueError("device %s is not the mesh's home shard's (%s)"
                                 % (device, mesh.home))
            device = mesh.home
        self.device = resolve_device(device)
        self.model = UNet3D(plan, dtype=dtype, remat=True).to(
            self.device, memory_format=torch.channels_last_3d)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.trace = [torch.zeros_like(p) for p in self.params]
        # one replica a local shard, the home shard's being self.model
        self.replicas = None if mesh is None else replicate(mesh, self.model)
        # a stream a local card for the batches' uploads
        devices = [self.device] if mesh is None else [mesh.devices[d] for d in mesh.local_shards]
        self._copy_streams = {d: torch.cuda.Stream(d) for d in devices if d.type == "cuda"}
        self.total_steps = cfg.epochs * cfg.batches_per_epoch
        self.history = []  # per epoch: {"epoch", "losses", "train_loss", "metric"}

    def _fit_mesh(self, mesh):
        """The mesh the batch shards over: all of it when its size divides
        the batch, else the first gcd(B, n) shards, or none at a gcd of 1
        (the global batch is part of the recipe, as in the JAX trainer)."""
        if mesh is None or self.cfg.batch_size % mesh.size == 0:
            return mesh
        if mesh.spans_processes:
            raise ValueError("batch %d does not divide by the %d shards of a mesh across "
                             "processes" % (self.cfg.batch_size, mesh.size))
        d = math.gcd(self.cfg.batch_size, mesh.size)
        self.log("batch %d not divisible by mesh size %d: %s"
                 % (self.cfg.batch_size, mesh.size,
                    "sharding over %d device(s)" % d if d > 1 else "running unsharded"))
        return mesh.submesh(d) if d > 1 else None

    def log(self, msg: str):
        if self.mesh is None or self.mesh.writer:
            self.logger.write(msg)
        print(msg, flush=True)

    def lr_at(self, step: int) -> float:
        """Poly LR as the f32 value the JAX trainer passes to its step."""
        cfg = self.cfg
        return float(np.float32(cfg.lr * (1.0 - step / max(self.total_steps, 1)) ** 0.9))

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int):
        """Fresh weights (flax's initialisers, from ``seed``) and a zero
        momentum trace."""
        init_weights(self.model, torch.Generator().manual_seed(seed))
        for t in self.trace:
            t.zero_()
        self._sync_replicas()

    def state_trees(self):
        """(params tree, optimizer state tree) in flax's layout."""
        params = ckpt.params_to_flax(dict(zip(self.names, self.params)))
        trace = ckpt.params_to_flax(dict(zip(self.names, self.trace)))
        return params, opt_state_tree(trace)

    def load_state_trees(self, params_tree, opt_state=None):
        self.model.load_state_dict(ckpt.params_from_flax(params_tree), strict=True)
        if opt_state is not None:
            trace = ckpt.params_from_flax(opt_state["2"]["0"]["trace"])
            if set(trace) != set(self.names):
                raise KeyError("momentum trace names differ from the model's")
            with torch.no_grad():
                for name, t in zip(self.names, self.trace):
                    t.copy_(trace[name])
        self._sync_replicas()

    def _sync_replicas(self):
        """Every other replica takes the home replica's parameters."""
        if self.mesh is not None:
            copy_params(self.replicas, self.params)

    # -- one step ---------------------------------------------------------

    def augment(self, images, labels, gen: torch.Generator):
        """Per-sample augmentation. On a mesh ``images`` / ``labels`` are
        per-shard lists (``None`` for another process's shard): every
        sample's values are drawn in sample order, sample i is augmented on
        its shard."""
        return self._apply_augment(images, labels, self._draw(images, gen))

    def _draw(self, images, gen: torch.Generator) -> list:
        """The draws of every sample of the batch, in sample order
        (``draw_samples``: on a card the host waits for their scalars
        alone)."""
        x = images if self.mesh is None else images[self.mesh.local_shards[0]]
        n = x.shape[0] * (1 if self.mesh is None else self.mesh.size)
        return draw_samples(gen, tuple(x.shape[1:]), n, self.cfg.aug)

    def _apply_augment(self, images, labels, draws: list):
        if self.mesh is None:
            return apply_samples(images, labels, draws)
        rows = len(draws) // self.mesh.size
        out_i, out_l = [None] * self.mesh.size, [None] * self.mesh.size
        for d in range(self.mesh.size):
            if images[d] is None:
                continue  # another process's rows: their draws only advanced gen
            dev = images[d].device
            outs = [apply_augment(images[d][r], labels[d][r], dataclasses.replace(
                dr, noise=to_device(dr.noise, dev)))
                for r, dr in enumerate(draws[d * rows:(d + 1) * rows])]
            out_i[d] = torch.stack([o[0] for o in outs])
            out_l[d] = torch.stack([o[1] for o in outs])
        return out_i, out_l

    def loss(self, images, labels):
        """Deep-supervision loss of [N,D,H,W] images against their labels."""
        outs = self.model(images[:, None], deep_supervision=True)
        return deep_supervision_loss(outs, labels, self.plan.pool_kernels)

    def mesh_loss_grads(self, images, labels):
        """The whole batch's loss and the gradient of every parameter (on
        the home shard, psum'd in shard order) from per-shard lists."""
        mesh = self.mesh
        parts, level_shapes = [None] * mesh.size, None
        for d in mesh.local_shards:
            outs = self.replicas[d](images[d][:, None], deep_supervision=True)
            parts[d] = deep_supervision_parts(outs, labels[d], self.plan.pool_kernels)
            level_shapes = [o.shape[2:] for o in outs]
        total = psum(mesh, [None if p is None else p.detach() for p in parts])
        total.requires_grad_(True)
        batch = images[mesh.local_shards[0]].shape[0] * mesh.size
        loss = deep_supervision_loss_from_parts(total, level_shapes, batch)
        (g_total,) = torch.autograd.grad(loss, total)
        grads = [None] * mesh.size
        for d in mesh.local_shards:
            grads[d] = torch.autograd.grad(parts[d], list(self.replicas[d].parameters()),
                                           to_device(g_total, parts[d].device), allow_unused=True)
        grads = psum_grads(mesh, grads, self.params)
        return loss.detach(), grads

    @torch.no_grad()
    def update(self, grads, lr: float):
        """The clip -> decay -> Nesterov -> scale chain on every parameter."""
        cfg = self.cfg
        g_norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        keep = g_norm < cfg.grad_clip
        for p, g, t in zip(self.params, grads, self.trace):
            g = torch.where(keep, g, g / g_norm * cfg.grad_clip)
            u = g + cfg.weight_decay * p
            t.mul_(cfg.momentum).add_(u)
            p.add_((u + cfg.momentum * t) * (-lr))

    def train_step(self, images, labels, lr: float, gen: torch.Generator | None = None):
        """One step on a batch already on the device; returns the loss
        (detached, not synchronised). ``gen`` drives the augmentation
        (required when it is on)."""
        if self.cfg.augment:
            draws = self._draw(images, gen)
            with span("train.augment"):
                images, labels = self._apply_augment(images, labels, draws)
        if self.mesh is not None:
            with span("train.forward_backward"):
                loss, grads = self.mesh_loss_grads(images, labels)
            with span("train.update"):
                self.update(grads, lr)
                self._sync_replicas()
            return loss
        with span("train.forward_backward"):
            loss = self.loss(images, labels)
            # the lowest-resolution head has deep-supervision weight 0: a
            # zero gradient, which still takes weight decay and momentum
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        with span("train.update"):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self.params, grads)]
            self.update(grads, lr)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, images, labels):
        """Hard Dice of the batch; on a mesh its sums are psum'd."""
        if self.mesh is None:
            logits = self.model(images[:, None])
            return hard_dice(logits.argmax(1), labels)
        parts = [None] * self.mesh.size
        for d in self.mesh.local_shards:
            logits = self.replicas[d](images[d][:, None])
            parts[d] = hard_dice_parts(logits.argmax(1), labels[d])
        return hard_dice_from_parts(psum(self.mesh, parts))

    def _to_device(self, images, labels):
        """A host batch on the device, ready for the compute stream; on a
        mesh, shard d's rows on its device (``None`` for another process's
        shard)."""
        return self._take(*self._upload(images, labels))

    def _upload(self, images, labels):
        """Starts a host batch's copy to the device (on a mesh, shard d's
        rows to its device): (images, labels, copies), ``copies`` the
        (tensor, event) of each copy to a card, for ``_take``. To a card an
        array goes through pinned memory and is copied on the card's copy
        stream, so the copy waits for no kernel and the host for no copy."""
        copies = []

        def put(a, dev):
            if dev.type != "cuda":
                return torch.from_numpy(a).to(dev)
            stream = self._copy_streams[dev]
            with torch.cuda.stream(stream):
                t = torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            copies.append((t, done))
            return t

        if self.mesh is None:
            return put(images, self.device), put(labels, self.device), copies
        n = self.mesh.size
        rows = images.shape[0] // n
        out_i, out_l = [None] * n, [None] * n
        for d in self.mesh.local_shards:
            dev = self.mesh.devices[d]
            out_i[d] = put(images[d * rows:(d + 1) * rows], dev)
            out_l[d] = put(labels[d * rows:(d + 1) * rows], dev)
        return out_i, out_l, copies

    @staticmethod
    def _take(images, labels, copies):
        """An uploaded batch ordered on each card's current stream: that
        stream waits for the copies' events, and the tensors, allocated on
        the copy stream, are recorded as used on it."""
        for t, done in copies:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(done)
            t.record_stream(stream)
        return images, labels

    # -- the loop ---------------------------------------------------------

    def fit(self, train_ds: SegDataset, val_ds: SegDataset = None, resume: bool = True):
        """Run the training budget; returns (model, best_metric). With a
        model_latest in ``out_dir`` (and ``resume``) it continues from it."""
        cfg = self.cfg
        self.init_state(cfg.seed)
        start_epoch = 0
        best_metric = -float("inf")  # noval metrics may be below -1
        if resume and ckpt.checkpoint_exists(self.out_dir, ckpt.MODEL_LATEST):
            params, opt_state, meta = ckpt.load_checkpoint(self.out_dir, ckpt.MODEL_LATEST)
            self.load_state_trees(params, opt_state)
            start_epoch = int(meta.get("epoch", 0))
            best_metric = float(meta.get("best_metric", -float("inf")))
            self.log("resumed from model_latest at epoch %d" % start_epoch)

        # both random streams move on with the epoch on resume: the batches
        # (np_rng, as the JAX trainer) and the augmentation coins
        np_rng = np.random.RandomState(cfg.seed + start_epoch)
        gen = torch.Generator(device=self.device).manual_seed(
            augment_seed(cfg.seed, start_epoch))
        noval_mode = cfg.noval or val_ds is None or len(val_ds) == 0
        writer = self.mesh is None or self.mesh.writer

        # the next batch is sampled and its upload started while the step
        # runs; one worker keeps np_rng's draws in the unprefetched order
        def next_batch():  # on the prefetch thread
            with span("train.sample"):
                return self._upload(*train_ds.sample_batch(np_rng, cfg.batch_size,
                                                           cfg.oversample_fg))

        with ThreadPoolExecutor(max_workers=1) as prefetcher:
            for epoch in range(start_epoch, cfg.epochs):
                timer = Timer()
                losses = []
                # the epoch's last batch is taken before validation draws from np_rng
                pending = prefetcher.submit(next_batch)
                for b in range(cfg.batches_per_epoch):
                    with span("train.data_wait"):
                        # ordered on the compute stream before the step sees it
                        images, labels = self._take(*pending.result())
                    if b + 1 < cfg.batches_per_epoch:
                        pending = prefetcher.submit(next_batch)
                    lr = self.lr_at(epoch * cfg.batches_per_epoch + b)
                    losses.append(self.train_step(images, labels, lr, gen))
                losses = torch.stack(losses).tolist() if losses else []
                mean_loss = float(np.mean(losses)) if losses else float("nan")

                if noval_mode:
                    metric = float(epoch + 1)  # monotonic: best == latest
                else:
                    with span("train.validate"):
                        dices = [self.eval_step(*self._to_device(
                            *val_ds.sample_batch(np_rng, cfg.batch_size, 0.5)))
                            for _ in range(cfg.val_batches)]
                        metric = float(torch.stack(dices).mean())

                meta = {"epoch": epoch + 1, "best_metric": max(best_metric, metric),
                        "train_loss": mean_loss, "val_metric": None if noval_mode else metric}
                with span("train.checkpoint"):
                    params, opt_state = self.state_trees()
                    # across processes rank 0 writes the shared checkpoints
                    if writer:
                        ckpt.save_checkpoint(self.out_dir, ckpt.MODEL_LATEST, params,
                                             opt_state, meta)
                        if cfg.save_every_epoch:
                            ckpt.save_checkpoint(self.out_dir,
                                                 ckpt.MODEL_EPOCH_FMT % (epoch + 1),
                                                 params, meta=meta)
                    if noval_mode:
                        best_metric = metric
                        if writer:
                            ckpt.link_checkpoint(self.out_dir, ckpt.MODEL_LATEST,
                                                 ckpt.MODEL_BEST)
                    elif metric > best_metric:
                        best_metric = metric
                        if writer:
                            ckpt.save_checkpoint(self.out_dir, ckpt.MODEL_BEST, params,
                                                 meta=meta)
                self.history.append({"epoch": epoch + 1, "losses": losses,
                                     "train_loss": mean_loss, "metric": metric})
                self.log("epoch %d/%d loss=%.4f metric=%.4f best=%.4f (%.1fs)"
                         % (epoch + 1, cfg.epochs, mean_loss, metric, best_metric,
                            timer.elapsed()))

        if writer and (noval_mode or not ckpt.checkpoint_exists(self.out_dir, ckpt.MODEL_BEST)):
            with span("train.checkpoint"):
                ckpt.save_checkpoint(self.out_dir, ckpt.MODEL_BEST, self.state_trees()[0],
                                     meta={"epoch": cfg.epochs, "best_metric": best_metric})
        if self.mesh is not None:
            barrier(self.mesh)
        return self.model, best_metric
