"""A "train" mix: `train.task.train_step` with the optimizer and schedule of
`make_optimizer` / `make_scheduler`, at the reference's setting of
microbatches x crops x frames.

Set-up builds a log-mel click corpus on the device (synthetic music, its
beats and downbeats as targets), makes the weights and the program's one
training object (model, AdamW, schedule, dropout generator), and drives it
through its first `check_steps` steps, fed as the window feeds it: a
prefetch thread of the harness's own assembles each step's batch of crops
in pinned host memory from the seed and the step's index, and the step
uploads it. The window then runs whole steps. The first steps' losses, the
first gradient (from AdamW's first moment after one step) and the change of
the parameters are compared, once the window has closed, with the
reference's steps from the same weights and batches."""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np
import torch

from harness import audio, weights
from reference.mel import log_mel
from reference.quant import Quant
from reference.train import Step

BETA1 = 0.9


class Training:
    work_name = "frames"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: Path, spans=None):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.spans = spans
        self.seeds = np.random.SeedSequence(int(seed)).generate_state(4, np.uint64).tolist()
        self.forwards: list[tuple] = []  # the program's calls (rows, frames, masked)
        self.model_work: list[tuple] = []  # the forwards the steps stand for (rows, frames)
        self.attempted = self.failed = 0
        self.tr = dict(traffic["train"])

    # -- the corpus and the feed ---------------------------------------
    def _corpus(self) -> None:
        c = self.traffic["corpus"]
        gen = torch.Generator(device=self.device).manual_seed(int(self.seeds[1] % 2**63))
        seconds = (c["frames"] - 1) / audio.FPS
        mels, beats, downs = [], [], []
        for _ in range(c["pieces"]):
            pcm, beat, down = audio.song(seconds, gen, self.device)
            mel = log_mel(pcm)[: c["frames"]]
            mels.append(mel.cpu())
            t = np.zeros((2, c["frames"]), np.float32)
            t[0, beat[beat < c["frames"]]] = 1.0
            t[1, down[down < c["frames"]]] = 1.0
            beats.append(t[0])
            downs.append(t[1])
        self.mel = torch.stack(mels).numpy()  # (pieces, frames, mels)
        self.targets = np.stack([np.stack(beats), np.stack(downs)])  # (2, pieces, frames)
        pos = self.targets.sum((1, 2))
        neg = self.targets[0].size - pos
        self.tr["pos_weight_beat"] = float(neg[0] / pos[0])
        self.tr["pos_weight_downbeat"] = float(neg[1] / pos[1])

    def batch(self, step: int) -> dict:
        """Step `step`'s batch (host): microbatches x crops of `frames`
        frames at offsets drawn from the seed and the step's index."""
        tr = self.traffic
        m, b, t = tr["micro_batches"], tr["crops"], tr["frames"]
        rng = np.random.default_rng([self.seeds[2], step])
        piece = rng.integers(0, self.mel.shape[0], m * b)
        start = rng.integers(0, self.mel.shape[1] - t + 1, m * b)
        idx = start[:, None] + np.arange(t)
        spect = self.mel[piece[:, None], idx]
        truth = self.targets[:, piece[:, None], idx]
        out = {"spect": torch.from_numpy(spect.reshape(m, b, t, -1)),
               "truth_beat": torch.from_numpy(truth[0].reshape(m, b, t)),
               "truth_downbeat": torch.from_numpy(truth[1].reshape(m, b, t)),
               "padding_mask": torch.ones((m, b, t), dtype=torch.bool),
               "downbeat_mask": torch.ones((m, b), dtype=torch.bool)}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _feed(self) -> None:
        step = 0
        while not self.stop.is_set():
            item = self.batch(step)
            while not self.stop.is_set():
                try:
                    self.queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass
            step += 1

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
        from beat_this_tpu_torch.train import task

        self._corpus()
        self.state = weights.make_state(self.cfg, self.seeds[0] % 2**63, self.device)
        keys = ("spect_dim", "transformer_dim", "ff_mult", "n_layers", "head_dim", "stem_dim",
                "dropout_frontend", "dropout_transformer", "sum_head", "partial_transformers")
        with torch.device(self.device):
            model = BeatThis(BeatThisConfig(**{k: self.cfg[k] for k in keys}))
        model.load_state_dict(self.state)
        tr = self.tr
        self.tc = task.TrainConfig(
            lr=tr["lr"], weight_decay=tr["weight_decay"], warmup_steps=tr["warmup_steps"],
            max_steps=tr["max_steps"], accum_steps=self.traffic["micro_batches"],
            pos_weight_beat=tr["pos_weight_beat"], pos_weight_downbeat=tr["pos_weight_downbeat"],
            compute_dtype=self.traffic["precision"])
        self.model = model
        self.opt = task.make_optimizer(model, self.tc)
        self.sched = task.make_scheduler(self.opt, self.tc)
        self.gen = torch.Generator().manual_seed(int(self.seeds[3] % 2**63))
        self.train_step = task.train_step
        if self.spans is not None:  # AdamW and the schedule: one span name
            self.opt.step = self.spans.wrap("optimizer", self.opt.step)
            self.sched.step = self.spans.wrap("optimizer", self.sched.step)
        self.queue = queue.Queue(maxsize=2)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._feed, daemon=True)
        self.thread.start()

    def prime(self) -> None:
        """The first `check_steps` steps, through the window's own call and
        feed: their losses, the first gradient and the parameters after
        them are kept for the comparison."""
        model = self.model
        self.losses, self.first_grad, self.after = [], None, None
        for i in range(self.traffic["check_steps"]):
            self.losses.append(self.unit(record=True))
            if i == 0:  # a step that kept no state got no gradient
                self.first_grad = {
                    n: self.opt.state[p]["exp_avg"] / (1.0 - BETA1)
                    if "exp_avg" in self.opt.state.get(p, {}) else torch.zeros_like(p)
                    for n, p in model.named_parameters()}
        self.after = {n: p.detach().clone() for n, p in model.named_parameters()}

    # -- the window -----------------------------------------------------
    def unit(self, record: bool = False):
        tr = self.traffic
        self.forwards += [(tr["crops"], tr["frames"], False)] * tr["micro_batches"]
        self.model_work += [(tr["crops"], tr["frames"])] * tr["micro_batches"]
        if self.spans is None:
            return self._step(record)
        with self.spans.span("step"):
            return self._step(record)

    def _step(self, record: bool):
        tr = self.traffic
        batch = {k: v.to(self.device, non_blocking=True) for k, v in self.queue.get().items()}
        losses = self.train_step(self.model, self.opt, self.sched, batch, self.gen, self.tc)
        loss = float(losses["total"])  # waits for the step
        self.attempted += 1
        if not np.isfinite(loss):
            self.failed += 1
        return loss if record else tr["micro_batches"] * tr["crops"] * tr["frames"]

    def window_started(self) -> None:
        self.attempted = self.failed = 0

    def e2e(self, work: float, elapsed: float) -> dict:
        return {"train_frames_per_s": work / elapsed}

    def counters(self) -> dict:
        return {}

    def free(self) -> None:
        self.stop.set()
        self.thread.join(timeout=30)
        del self.model, self.opt, self.sched
        self.forwards, self.model_work = [], []

    # -- the comparison -------------------------------------------------
    def _reference(self, quant: Quant):
        """The reference's losses, first gradients and parameters after
        `check_steps` steps from the same weights and batches."""
        params = {k: v.detach().clone().requires_grad_(not k.endswith(("running_mean",
                                                                        "running_var")))
                  for k, v in self.state.items()}
        step = Step(self.cfg, params, self.tr, quant)
        gen = torch.Generator().manual_seed(int(self.seeds[3] % 2**63))
        losses, first = [], None
        for i in range(self.traffic["check_steps"]):
            b = {k: v.to(self.device) for k, v in self.batch(i).items()}
            micro = [{k: v[j] for k, v in b.items()} for j in range(self.traffic["micro_batches"])]
            seeds = torch.randint(0, 2**31 - 1, (len(micro),), generator=gen).tolist()
            loss, grads = step.grads(micro, seeds)
            losses.append(loss)
            if i == 0:
                first = grads
            step.update(grads)
        return losses, first, {k: v.detach() for k, v in params.items()}

    def check(self) -> dict:
        """loss_gap: the widest relative gap of a step's loss; grad_gap and
        update_gap: the widest gap, over the leaves, between the norms of
        the program's and the reference's first gradient and change of the
        parameters, over the larger of the reference leaf's norm and the
        median leaf's. Leaves whose reference gradient is under a
        thousandth of the median leaf's move by round-off alone and are
        left out. grad_dev: the median leaf's norm of the difference of the
        first gradients over the reference's norm (the norms' gaps above are
        second order in noise and leave the control of a bfloat16 cell
        inside the program's own spread)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        losses, first, after = self._reference(Quant("float32"))
        self.ref = (losses, first, after)
        return self._gaps(self.losses, self.first_grad, self.after, losses, first, after)

    def _gaps(self, p_losses, p_first, p_after, losses, first, after) -> dict:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_losses, losses))
        g_norm = {k: float(v.norm()) for k, v in first.items()}
        med_g = float(np.median(list(g_norm.values())))
        leaves = [k for k, v in g_norm.items() if v >= 1e-3 * med_g]
        p_g = {k: float(p_first[k].norm()) for k in leaves}
        ref_d = {k: float((after[k] - self.state[k]).norm()) for k in leaves}
        p_d = {k: float((p_after[k] - self.state[k]).norm()) for k in leaves}
        med_d = float(np.median(list(ref_d.values())))
        grad_gap = max(abs(p_g[k] - g_norm[k]) / max(g_norm[k], med_g) for k in leaves)
        update_gap = max(abs(p_d[k] - ref_d[k]) / max(ref_d[k], med_d) for k in leaves)
        grad_dev = float(np.median([float((p_first[k] - first[k]).norm()) / g_norm[k]
                                    for k in leaves]))
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
                "grad_dev": grad_dev}

    def control(self, kind: str) -> dict:
        losses, first, after = self._reference(Quant(kind))
        return self._gaps(losses, first, after, *self.ref)
