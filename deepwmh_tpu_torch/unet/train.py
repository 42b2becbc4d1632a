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
trains with ``fused_norm`` off (K1's kernels have no backward; the JAX
trainer keeps flax GroupNorm for the same reason) and remat on stages 0-1.
No mesh: multi-GPU training is not ported (ROADMAP A13, second half).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet.augment import AugmentConfig, augment_samples
from deepwmh_tpu_torch.unet.data import SegDataset
from deepwmh_tpu_torch.unet.losses import deep_supervision_loss, hard_dice
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.utils.logging import SimpleTxtLog, Timer


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
                 dtype=torch.bfloat16, logger: SimpleTxtLog = None):
        """``device``: CUDA by default, the CPU only when asked for.
        ``dtype``: the compute dtype (bf16 as the JAX trainer; f32 for
        exact comparisons). ``logger``: where the epoch lines go (the
        pipeline passes its run log), ``training_log.txt`` in ``out_dir``
        by default."""
        self.plan = plan
        self.cfg = cfg
        self.out_dir = out_dir
        self.device = resolve_device(device)
        os.makedirs(out_dir, exist_ok=True)
        self.model = UNet3D(plan, dtype=dtype, fused_norm=False, remat=True).to(
            self.device, memory_format=torch.channels_last_3d)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.logger = logger or SimpleTxtLog(os.path.join(out_dir, "training_log.txt"))
        self.total_steps = cfg.epochs * cfg.batches_per_epoch
        self.history = []  # per epoch: {"epoch", "losses", "train_loss", "metric"}

    def log(self, msg: str):
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

    # -- one step ---------------------------------------------------------

    def augment(self, images, labels, gen: torch.Generator):
        return augment_samples(gen, images, labels, self.cfg.aug)

    def loss(self, images, labels):
        """Deep-supervision loss of [N,D,H,W] images against their labels."""
        outs = self.model(images[:, None], deep_supervision=True)
        return deep_supervision_loss(outs, labels, self.plan.pool_kernels)

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
            images, labels = self.augment(images, labels, gen)
        loss = self.loss(images, labels)
        # the lowest-resolution head has deep-supervision weight 0: a zero
        # gradient, which still takes weight decay and momentum
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        self.update(grads, lr)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, images, labels):
        logits = self.model(images[:, None])
        return hard_dice(logits.argmax(1), labels)

    def _to_device(self, images, labels):
        return (torch.from_numpy(images).to(self.device),
                torch.from_numpy(labels).to(self.device))

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

        # the next batch is sampled and copied while the step runs; one
        # worker keeps np_rng's draws in the unprefetched order
        def next_batch():
            return self._to_device(*train_ds.sample_batch(np_rng, cfg.batch_size,
                                                          cfg.oversample_fg))

        with ThreadPoolExecutor(max_workers=1) as prefetcher:
            for epoch in range(start_epoch, cfg.epochs):
                timer = Timer()
                losses = []
                # the epoch's last batch is taken before validation draws from np_rng
                pending = prefetcher.submit(next_batch)
                for b in range(cfg.batches_per_epoch):
                    images, labels = pending.result()
                    if b + 1 < cfg.batches_per_epoch:
                        pending = prefetcher.submit(next_batch)
                    lr = self.lr_at(epoch * cfg.batches_per_epoch + b)
                    losses.append(self.train_step(images, labels, lr, gen))
                losses = torch.stack(losses).tolist() if losses else []
                mean_loss = float(np.mean(losses)) if losses else float("nan")

                if noval_mode:
                    metric = float(epoch + 1)  # monotonic: best == latest
                else:
                    dices = [self.eval_step(*self._to_device(
                        *val_ds.sample_batch(np_rng, cfg.batch_size, 0.5)))
                        for _ in range(cfg.val_batches)]
                    metric = float(torch.stack(dices).mean())

                meta = {"epoch": epoch + 1, "best_metric": max(best_metric, metric),
                        "train_loss": mean_loss, "val_metric": None if noval_mode else metric}
                params, opt_state = self.state_trees()
                ckpt.save_checkpoint(self.out_dir, ckpt.MODEL_LATEST, params, opt_state, meta)
                if cfg.save_every_epoch:
                    ckpt.save_checkpoint(self.out_dir, ckpt.MODEL_EPOCH_FMT % (epoch + 1),
                                         params, meta=meta)
                if noval_mode:
                    best_metric = metric
                    ckpt.link_checkpoint(self.out_dir, ckpt.MODEL_LATEST, ckpt.MODEL_BEST)
                elif metric > best_metric:
                    best_metric = metric
                    ckpt.save_checkpoint(self.out_dir, ckpt.MODEL_BEST, params, meta=meta)
                self.history.append({"epoch": epoch + 1, "losses": losses,
                                     "train_loss": mean_loss, "metric": metric})
                self.log("epoch %d/%d loss=%.4f metric=%.4f best=%.4f (%.1fs)"
                         % (epoch + 1, cfg.epochs, mean_loss, metric, best_metric,
                            timer.elapsed()))

        if noval_mode or not ckpt.checkpoint_exists(self.out_dir, ckpt.MODEL_BEST):
            ckpt.save_checkpoint(self.out_dir, ckpt.MODEL_BEST, self.state_trees()[0],
                                 meta={"epoch": cfg.epochs, "best_metric": best_metric})
        return self.model, best_metric
