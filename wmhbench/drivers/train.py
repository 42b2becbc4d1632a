"""Driver of the train cells: the port's ``Trainer.fit`` on a seeded cohort.

Set-up builds one ``Trainer`` and calls ``fit``; its first
``check_steps`` steps run inside set-up (they also warm every shape), and
the window is the rest of the same ``fit`` call: its steps, its prefetch,
its epoch ends. One unit is one train step. The window closes at the first
step enqueued after ``--seconds``; the device is synchronised before the
clock stops. One step of the window, drawn from the seed among its first
``window_check_span``, is checked too: the trainer's state, batch and
augmentation generator are copied on the device before it and the state
after it (if the window closes first, the run steps on, untimed, to it).

The check: the plain reference (``reference/train.py``) works out the
same initial weights, batches and augmentation from the cases and the
seed and takes the same first steps in float32. Compared: the initial
weights (exact), each step's loss, the first gradient as the update took
it (from the momentum trace after one step: t1 = g1 + wd * p0) and the
change of the parameters over the checked steps, the last two by the
worst and by the median leaf's gap of norms. The window's step is
replayed by the reference from the program's state before it (its own
batch, generator state and learning rate) and compared the same way.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wmhbench import compare
from wmhbench.drivers import base
from wmhbench.harness import StopWindow, derive_seed
from wmhbench.traffic.synthetic import train_case


def _cpu(leaves) -> list:
    return [t.detach().cpu() for t in leaves]


def leaf_numbers(prefix: str, got, want, keep) -> dict:
    return {prefix + "_worst_leaf_gap": compare.worst_leaf_gap(got, want, keep),
            prefix + "_median_leaf_gap": compare.median_leaf_gap(got, want, keep)}


class Driver(base.Driver):
    # state_unchanged: every step leaves the state as it was;
    # window_state_unchanged: only the window's steps do (a path that
    # changes once the step is warm)
    FAULTS = ("half_batch", "state_unchanged", "window_state_unchanged")

    def __init__(self, cell, seed: int, device, workdir: str):
        super().__init__(cell, seed, device, workdir)
        self.steps = 0
        self.losses = []
        self.p0 = self.trace1 = self.p_end = None
        self.closed = False
        rng = np.random.RandomState(derive_seed(self.seed, "window_step"))
        self.win_step = int(self.tr["check_steps"]) + int(
            rng.randint(int(self.tr["window_check_span"])))
        self.win_in = self.win_out = None

    def hyper(self) -> dict:
        t = self.trainer
        return {"batch_size": t.cfg.batch_size, "oversample_fg": t.cfg.oversample_fg,
                "lr": t.cfg.lr, "momentum": t.cfg.momentum,
                "weight_decay": t.cfg.weight_decay, "grad_clip": t.cfg.grad_clip,
                "total_steps": t.total_steps}

    def setup(self):
        from deepwmh_tpu_torch.unet.data import SegDataset
        from deepwmh_tpu_torch.unet.plan import Plan
        from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

        tr = self.tr
        plan = Plan(**self.plan)
        shape = self.cfg["volume_shape"]
        self.cases = [("case%d" % i,) + train_case(shape, derive_seed(self.seed, "case", i),
                                                   tr["label_noise"])
                      for i in range(tr["cases"])]
        self.ds = SegDataset(plan.patch_size)
        for case in self.cases:
            self.ds.add_case(*case)
        tcfg = TrainConfig(epochs=tr["epochs"], batches_per_epoch=tr["batches_per_epoch"],
                           batch_size=plan.batch_size, noval=True,
                           oversample_fg=tr["oversample_fg"], augment=True, seed=self.seed)
        dtype = getattr(torch, self.cfg["compute_dtype"])
        self.trainer = Trainer(plan, tcfg, os.path.join(self.workdir, "train"),
                               device=self.device, dtype=dtype)
        if self.fault == "half_batch":
            full = self.trainer.loss
            self.trainer.loss = lambda im, lb: full(im[: im.shape[0] // 2],
                                                    lb[: lb.shape[0] // 2])
        elif self.fault == "state_unchanged":
            self.trainer.update = lambda grads, lr: None
        elif self.fault == "window_state_unchanged":
            update, check_steps = self.trainer.update, int(tr["check_steps"])
            self.trainer.update = lambda grads, lr: (
                update(grads, lr) if self.steps < check_steps else None)

    def run(self, win):
        trainer, check_steps = self.trainer, int(self.tr["check_steps"])
        step = trainer.train_step

        def timed_step(images, labels, lr, gen=None):
            k = self.steps
            if k == 0:
                self.p0 = [p.detach().cpu().clone() for p in trainer.params]
            if k == self.win_step:  # copies on the device, no wait
                self.win_in = {"params": [p.detach().clone() for p in trainer.params],
                               "trace": [t.clone() for t in trainer.trace],
                               "images": images.clone(), "labels": labels.clone(),
                               "gen": gen.get_state()}
            loss = step(images, labels, lr, gen)
            self.steps += 1
            if k == self.win_step:
                self.win_out = {"loss": loss.clone(),
                                "params": [p.detach().clone() for p in trainer.params],
                                "trace": [t.clone() for t in trainer.trace]}
            if self.steps <= check_steps:
                self.attempted += 1
                self.losses.append(float(loss))
                if self.steps == 1:
                    self.trace1 = [t.detach().cpu().clone() for t in trainer.trace]
                if self.steps == check_steps:
                    self.p_end = [p.detach().cpu().clone() for p in trainer.params]
                    win.begin()
            elif not self.closed:
                self.attempted += 1
                if win.unit_done():
                    win.end()
                    self.closed = True
            if self.closed and self.win_out is not None:
                raise StopWindow
            return loss

        trainer.train_step = timed_step
        try:
            trainer.fit(self.ds, None, resume=False)
        except StopWindow:
            pass
        if not self.closed:
            win.end()

    def release(self):
        self.wd = self.trainer.cfg.weight_decay
        self.momentum = self.trainer.cfg.momentum
        self.hyper_ = self.hyper()
        for snap in (self.win_in, self.win_out):
            if snap is not None:
                for k, v in snap.items():
                    snap[k] = _cpu(v) if isinstance(v, list) else (
                        v.cpu() if isinstance(v, torch.Tensor) else v)
        del self.trainer
        self.trainer = None

    def reference(self, precision: str) -> dict:
        """The first steps from scratch and the window's step from the
        program's state, in ``precision`` (f32, bf16, or the control)."""
        from wmhbench.reference.train import first_steps, replay_step
        from wmhbench.reference.unet import no_tf32

        no_tf32()
        prec = "fp8" if precision == "control" else precision
        out = first_steps(self.plan, self.hyper_, self.cases, self.seed,
                          int(self.tr["check_steps"]), self.device, prec)
        if self.win_in is not None:
            out["window"] = replay_step(self.plan, self.hyper_, self.win_step, self.win_in,
                                        self.device, prec)
        return out

    def numbers(self, got: dict, want: dict) -> dict:
        keep = compare.moving_leaves(want["grad1"])
        change_got = [b - a for a, b in zip(got["p0"], got["p_end"])]
        change_want = [b - a for a, b in zip(want["p0"], want["p_end"])]
        out = {"loss_rel": max(abs(a - b) / abs(b)
                               for a, b in zip(got["losses"], want["losses"]))}
        out.update(leaf_numbers("grad1", got["grad1"], want["grad1"], keep))
        out.update(leaf_numbers("change", change_got, change_want, keep))
        gw, ww = got.get("window"), want.get("window")
        if gw is not None and ww is not None:
            keep = compare.moving_leaves(ww["grad"])
            p_k = self.win_in["params"]
            out["window_loss_rel"] = abs(gw["loss"] - ww["loss"]) / abs(ww["loss"])
            out.update(leaf_numbers("window_grad", gw["grad"], ww["grad"], keep))
            out.update(leaf_numbers("window_change", [b - a for a, b in zip(p_k, gw["p_end"])],
                                    [b - a for a, b in zip(p_k, ww["p_end"])], keep))
        return out

    def diagnose(self, got: dict, want: dict) -> dict:
        """The three worst leaves of each leaf comparison, with the median
        leaf's gradient norm: what a reading's worst leaf is made of."""
        names = want["names"]
        norms = compare._norms(want["grad1"])
        keep = compare.moving_leaves(want["grad1"])
        change_got = [b - a for a, b in zip(got["p0"], got["p_end"])]
        change_want = [b - a for a, b in zip(want["p0"], want["p_end"])]
        out = {"init_max_abs": compare.max_abs(got["p0"], want["p0"]),
               "left_out": [n for n, k in zip(names, keep) if not k]}
        pairs = [("grad1", got["grad1"], want["grad1"], norms, keep),
                 ("change", change_got, change_want, norms, keep)]
        gw, ww = got.get("window"), want.get("window")
        if gw is not None and ww is not None:
            p_k = self.win_in["params"]
            wn, wk = compare._norms(ww["grad"]), compare.moving_leaves(ww["grad"])
            pairs += [("window_grad", gw["grad"], ww["grad"], wn, wk),
                      ("window_change", [b - a for a, b in zip(p_k, gw["p_end"])],
                       [b - a for a, b in zip(p_k, ww["p_end"])], wn, wk)]
        for what, g, w, n, k in pairs:
            gaps = compare.leaf_gaps(g, w)
            order = sorted((i for i in range(len(gaps)) if k[i]), key=lambda i: -gaps[i])
            out[what + "_worst"] = [[names[i], gaps[i], n[i], int(w[i].numel())]
                                    for i in order[:3]]
        out["median_grad_norm"] = sorted(norms)[len(norms) // 2]
        return out

    def program(self) -> dict:
        grad1 = [t - self.wd * p for t, p in zip(self.trace1, self.p0)]
        out = {"p0": self.p0, "losses": self.losses, "grad1": grad1, "p_end": self.p_end}
        if self.win_out is not None:
            # g_k = (t_k+1 - m t_k) - wd p_k, as the update took it
            m, wi, wo = self.momentum, self.win_in, self.win_out
            out["window"] = {"loss": float(wo["loss"]), "p_end": wo["params"],
                             "grad": [(b - m * a) - self.wd * p for a, b, p in
                                      zip(wi["trace"], wo["trace"], wi["params"])]}
        return out

    def check(self) -> dict:
        if self.p_end is None or self.win_out is None:  # a checked step never completed
            self.failed += 1
            return {}
        self.ref = self.reference("f32")
        return self.numbers(self.program(), self.ref)

    def control(self) -> dict:
        """The control put in the program's place, judged as it is."""
        self.ctl = self.reference("control")
        return self.numbers(self.ctl, self.ref)

    def look(self, control: bool = False) -> dict:
        if control:
            return self.diagnose(self.ctl, self.ref)
        out = self.diagnose(self.program(), self.ref)
        # the witness: the reference's own code in the stated bfloat16
        bf16 = self.reference("bf16")
        out["bf16_witness"] = self.numbers(bf16, self.ref)
        out["bf16_witness_look"] = {k: v for k, v in self.diagnose(bf16, self.ref).items()
                                    if k.endswith("_worst")}
        return out

    def context(self, win):
        return super().context(win, batch=int(self.plan["batch_size"]))
