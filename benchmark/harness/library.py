"""A "library" mix: `BatchedFile2File.process_many` over a library of wav
files, group after group (the CLI's directory mode).

Set-up writes the library under the run's work directory, makes the
weights, saves them as a checkpoint the program loads, and warms the
forward shapes of the mix's groups. One unit of the window is one group of
`group_files` files, pass after pass over the library. Every file's logits
(through `after_each`) and `.beats` text are kept and compared, once the
window has closed, with the reference."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from harness import audio, weights
from reference import chunks, post
from reference.mel import log_mel, num_frames
from reference.model import Reference
from reference.quant import Quant

HPARAMS = ("spect_dim", "transformer_dim", "ff_mult", "n_layers", "head_dim", "stem_dim",
           "sum_head", "partial_transformers")
FIT_FILES = 16  # files, spread over the lengths, that set the input statistics and the head


class Library:
    work_name = "audio_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: Path, spans=None):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.workdir, self.spans = workdir, spans
        self.seeds = np.random.SeedSequence(int(seed)).generate_state(4, np.uint64).tolist()
        self.order_rng = np.random.default_rng(self.seeds[2])
        self.sequence: list[list[int]] = []
        self.answers: dict[int, list] = {}
        self.forwards: list[tuple] = []  # the program's calls (rows, frames, masked)
        self.model_work: list[tuple] = []  # the reference rule's forwards (rows, frames)
        self.attempted = self.failed = 0
        self.errors: list[str] = []
        self.bf16 = traffic["precision"] == "bfloat16"

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        tr = self.traffic
        durs = audio.durations(tr["durations"], tr["files"])
        fit_files = set(range(0, len(durs), max(1, len(durs) // FIT_FILES)))
        gen = torch.Generator(device=self.device).manual_seed(int(self.seeds[1] % 2**63))
        lib = self.workdir / "library"
        lib.mkdir(parents=True)
        self.paths, fit = [], []
        for i, d in enumerate(durs):
            pcm, beat, _ = audio.song(d, gen, self.device)
            path = lib / f"song{i:04d}.wav"
            audio.write_wav(path, pcm.cpu().numpy())
            self.paths.append(path)
            if i in fit_files:
                mel = log_mel(pcm)[:chunks.CHUNK]
                fit.append((mel, beat[beat < len(mel)]))
        self.frames = [num_frames(int(d * audio.SR)) for d in durs]
        g = tr["group_files"]
        perm = np.random.default_rng(0).permutation(len(durs)).tolist()
        self.groups = [perm[i : i + g] for i in range(0, len(perm), g)]
        state = weights.make_state(self.cfg, self.seeds[0] % 2**63, self.device)
        weights.set_input_stats(state, [m for m, _ in fit])
        weights.fit_head(self.cfg, state, fit)
        self.state = state
        ckpt = self.workdir / "model.ckpt"
        hp = {k: self.cfg[k] for k in HPARAMS}
        hp["dropout"] = {"frontend": self.cfg["dropout_frontend"],
                         "transformer": self.cfg["dropout_transformer"]}
        torch.save({"state_dict": {"model." + k: v.cpu() for k, v in state.items()},
                    "hyper_parameters": hp}, ckpt)
        self._program(ckpt)

    def _program(self, ckpt: Path) -> None:
        from beat_this_tpu_torch.inference import BatchedFile2File

        if not self.bf16:  # float32 means float32, as the CLI sets it
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.f2f = f2f = BatchedFile2File(str(ckpt), self.device, self.bf16, False,
                                          group_size=self.traffic["group_files"])
        self.cls = type(f2f)
        if self.spans is not None:
            s = self.spans
            f2f._decode_group = s.wrap("decode_group", f2f._decode_group)
            f2f._batched_spects_device = s.wrap("mel", f2f._batched_spects_device)
            f2f.predictor.predict_many_device = s.wrap("forward",
                                                       f2f.predictor.predict_many_device)
            f2f.frames2beats = s.wrap("post", f2f.frames2beats)
            forward = f2f.predictor._forward

            def recorded(batch, valid_lengths=None):
                self.forwards.append((int(batch.shape[0]), int(batch.shape[1]),
                                      valid_lengths is not None))
                return forward(batch, valid_lengths)

            f2f.predictor._forward = recorded

    def prime(self) -> None:
        self._warm()

    def _warm(self) -> None:
        """The forwards of every distinct group of the mix (its pieces'
        lengths, on a zero log-mel), then one group through
        `process_many`."""
        pred = self.f2f.predictor
        for n in sorted({tuple(self.frames[i] for i in grp) for grp in self.groups}):
            mel = torch.zeros((sum(n), self.cfg["spect_dim"]), device=self.device)
            pred.predict_many_device(mel, np.cumsum((0,) + n[:-1]).tolist(), list(n))
        self._group(self.groups[0])

    # -- the window -----------------------------------------------------
    def _group(self, files: list[int]) -> float:
        out = self.workdir / "beats"
        tasks = [(self.paths[i], out / f"{self.paths[i].stem}.beats") for i in files]

        def after_each(path, beats_path, beat, down):
            i = int(Path(path).stem[4:])
            self.model_work += [(1, w) for w in chunks.own_windows(self.frames[i])]
            self.answers.setdefault(i, []).append(
                (np.array(beat, np.float32), np.array(down, np.float32),
                 Path(beats_path).read_text()))

        def on_error(path, exc):
            self.failed += 1
            self.errors.append(f"{Path(path).name}: {type(exc).__name__}: {exc}")

        self.attempted += len(tasks)
        return self.f2f.process_many(tasks, on_error=on_error, after_each=after_each)

    def unit(self) -> float:
        """One group. The library is cut into the same groups for every seed
        and every pass (a permutation drawn from 0), so every seed runs the
        same batches of lengths, the ones set-up warmed; the seed draws the
        order of each pass's groups."""
        if not self.sequence:
            order = self.order_rng.permutation(len(self.groups))
            self.sequence = [self.groups[j] for j in order]
        files = self.sequence.pop(0)
        if self.spans is None:
            return self._group(files)
        with self.spans.span("group"):
            return self._group(files)

    def window_started(self) -> None:
        self.answers, self.attempted, self.failed, self.errors = {}, 0, 0, []
        self.host_groups0 = self.cls.host_groups

    def e2e(self, work: float, elapsed: float) -> dict:
        return {"audio_x_realtime": work / elapsed}

    def counters(self) -> dict:
        return {"host_groups": self.cls.host_groups - self.host_groups0}

    def free(self) -> None:
        del self.f2f
        self.forwards, self.model_work = [], []

    # -- the comparison -------------------------------------------------
    def _reference_logits(self, quant: Quant) -> dict[int, tuple]:
        model = Reference(self.cfg, self.state, quant)
        out = {}
        with torch.no_grad():
            for i in sorted(self.answers):
                pcm = torch.from_numpy(audio.read_wav(self.paths[i]).copy()).to(self.device)
                out[i] = chunks.predict(model, log_mel(pcm, quant))
        return out

    def check(self) -> dict:
        """logit_gap: the widest gap between a logit the program gave for a
        file in the window and the reference's; beats_mismatch: answers
        whose `.beats` text is not what the reference's postprocessor makes
        of the program's own logits (exact); unanswered: files of the
        window's groups that never came back (exact)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = self._reference_logits(Quant("float32"))
        gap, mismatch = 0.0, 0
        for i, answers in self.answers.items():
            rb, rd = ref[i]
            for b, d, text in answers:
                gap = max(gap, float(np.abs(b - rb).max(initial=0.0)),
                          float(np.abs(d - rd).max(initial=0.0)))
                want_b, want_d = post.beats(b, d)
                got_b, got_d = post.read_beats(text)
                if not (np.array_equal(want_b, got_b) and np.array_equal(want_d, got_d)):
                    mismatch += 1
        self.ref = ref
        answered = sum(len(a) for a in self.answers.values())
        return {"logit_gap": gap, "beats_mismatch": float(mismatch),
                "unanswered": float(self.attempted - answered)}

    def control(self, kind: str) -> dict:
        """The control's readings: the reference computed in `kind` in the
        program's place, held to the float32 reference."""
        ctl = self._reference_logits(Quant(kind))
        gap = max(max(float(np.abs(ctl[i][0] - self.ref[i][0]).max(initial=0.0)),
                      float(np.abs(ctl[i][1] - self.ref[i][1]).max(initial=0.0)))
                  for i in ctl)
        return {"logit_gap": gap}

