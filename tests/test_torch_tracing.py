"""The port's own spans and counters (`beat_this_tpu_torch/profiler.py`) on
the CPU with a tiny model:

* with no profiler recording, `span` is one shared null context and
  records nothing;
* `process_many`'s `.beats` bytes and logits and `train_step`'s losses and
  parameters are bit-identical with the spans off and on;
* under `torch.profiler.profile`, a two-group `process_many` and a
  `train_step` of 2 microbatches record the span trees the program
  documents (names, nesting, `group.audio_s` summing to what
  `process_many` returns);
* a span on a second thread, which the profiler's thread-local state does
  not reach, records in the window's session and does not end it;
* the forward counters read the reckoned padding of a short piece in its
  time bucket and of an unmasked chunked piece;
* a new profiler window starts a new session, which replaces the old one;
* every `bt.*` range of an exported Chrome trace lies inside its recorded
  span to within 1 ms, and the ranges start a median of under 1 ms after
  their spans (`ts` x 1000 + `baseTimeNanoseconds` is `time.time_ns()`); a
  span opens before its range and closes after it, so a thread preempted
  between the two widens the span and moves no range out of it.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from beat_this_tpu_torch import profiler
from beat_this_tpu_torch.inference import BatchedFile2File, ChunkedPredictor, plan_chunks
from beat_this_tpu_torch.io.audio import save_wav
from beat_this_tpu_torch.io.checkpoint import init_beat_this
from beat_this_tpu_torch.model import BeatThis, BeatThisConfig
from beat_this_tpu_torch.train.task import (
    TrainConfig,
    make_optimizer,
    make_scheduler,
    train_step,
)

SMALL = dict(transformer_dim=64, n_layers=1, partial_transformers=False)
GROUP_SIZE = 2
SECONDS = (2.0, 3.5, 1.5)  # three files: two groups


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh(monkeypatch):
    """No session yet, whatever ran before in this process."""
    monkeypatch.setitem(profiler._state, "session", None)
    monkeypatch.setitem(profiler._state, "on", False)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """A tiny checkpoint and three click wavs."""
    root = tmp_path_factory.mktemp("tracing")
    config = BeatThisConfig(**SMALL)
    state = init_beat_this(3, config)
    torch.save({"state_dict": {"model." + k: v for k, v in state.items()},
                "hyper_parameters": SMALL}, root / "tiny.ckpt")
    rng = np.random.default_rng(0)
    tasks = []
    for i, seconds in enumerate(SECONDS):
        t = np.arange(int(seconds * 22050)) / 22050
        clicks = (np.sin(2 * np.pi * 2.0 * t) > 0.99).astype(np.float32)
        save_wav(root / f"f{i}.wav", 0.3 * clicks + 0.02 * rng.standard_normal(len(t)), 22050)
        tasks.append((root / f"f{i}.wav", root / f"f{i}.beats"))
    return root, tasks


def _process(library):
    root, tasks = library
    f2f = BatchedFile2File(root / "tiny.ckpt", "cpu", group_size=GROUP_SIZE)
    logits = []
    seconds = f2f.process_many(tasks, after_each=lambda p, o, b, d: logits.append((b, d)))
    return seconds, [o.read_bytes() for _, o in tasks], logits


def _train():
    cfg = BeatThisConfig(**SMALL)
    tc = TrainConfig(accum_steps=2, max_steps=10, warmup_steps=2)
    model = BeatThis(cfg)
    model.load_state_dict(init_beat_this(1, cfg))
    opt = make_optimizer(model, tc)
    sched = make_scheduler(opt, tc)
    rng = np.random.RandomState(0)
    batch = {"spect": torch.from_numpy(rng.randn(2, 2, 64, 128).astype(np.float32)),
             "truth_beat": torch.zeros(2, 2, 64), "truth_downbeat": torch.zeros(2, 2, 64),
             "padding_mask": torch.ones(2, 2, 64), "downbeat_mask": torch.ones(2, 2)}
    batch["truth_beat"][..., ::10] = 1.0
    batch["truth_downbeat"][..., ::40] = 1.0
    losses = train_step(model, opt, sched, batch, torch.Generator().manual_seed(0), tc)
    return {k: v.clone() for k, v in losses.items()}, {
        n: p.detach().clone() for n, p in model.named_parameters()}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _forest(spans):
    """The (name, [children's trees]) trees of spans recorded on one thread,
    in the order they were entered: a span is the child of the innermost
    span still open when it starts."""
    roots, stack = [], []
    for s in spans:
        while stack and stack[-1][0].end_ns <= s.start_ns:
            stack.pop()
        node = (s.name, [])
        (stack[-1][1][1] if stack else roots).append(node)
        if stack:
            assert s.end_ns <= stack[-1][0].end_ns, (s.name, stack[-1][0].name)
        stack.append((s, node))
    return roots


def test_spans_are_off_without_a_profiler(fresh, library):
    assert profiler.span("x") is profiler.span("y")
    _process(library)
    _train()
    assert profiler.session() is None


def test_outputs_are_bit_identical_with_spans_off_and_on(fresh, library):
    seconds, beats, logits = _process(library)
    losses, params = _train()
    with _cpu_profile():
        seconds_on, beats_on, logits_on = _process(library)
        losses_on, params_on = _train()
    assert profiler.session() is not None
    assert seconds_on == seconds and beats_on == beats
    for (b, d), (b_on, d_on) in zip(logits, logits_on, strict=True):
        assert np.array_equal(b, b_on) and np.array_equal(d, d_on)
    for k in losses:
        assert torch.equal(losses[k], losses_on[k]), k
    for n in params:
        assert torch.equal(params[n], params_on[n]), n


def test_process_many_span_tree(fresh, library):
    with _cpu_profile():
        seconds, _, _ = _process(library)
    session = profiler.session()
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in session.spans)
    groups = _forest(session.spans)
    assert [g[0] for g in groups] == ["group", "group"]
    assert sum(g.audio_s for g in session.named("group")) == pytest.approx(seconds, rel=1e-12)
    for (name, kids), files in zip(groups, [2, 1], strict=True):
        assert [k[0] for k in kids] == ["load", "mel", "forward", "post"] + ["write"] * files
        mel, forward, post = kids[1], kids[2], kids[3]
        assert [k[0] for k in mel[1]] == ["upload"]
        models = [k for k in forward[1] if k[0] == "model"]
        assert models and [k[0] for k in forward[1]] == ["model", "wait"] * len(models)
        assert [k[0] for k in post[1]] == ["wait"]
    assert all(s.audio_s is None for s in session.spans if s.name != "group")


def test_train_step_span_tree(fresh):
    with _cpu_profile():
        _train()
    ((name, kids),) = _forest(profiler.session().spans)
    assert name == "step"
    assert [k[0] for k in kids] == ["micro", "micro", "optimizer"]
    for micro in kids[:2]:
        assert [k[0] for k in micro[1] if k[0] == "backward"] == ["backward"]


def test_a_span_on_a_second_thread_records_in_the_window(fresh):
    seen = {}

    def work():
        # a plain thread: the profiler's thread-local state does not reach it
        seen["enabled"] = torch._C._autograd._profiler_enabled()
        with profiler.span("side"):
            seen["session"] = profiler.session()

    with _cpu_profile() as prof:
        with profiler.span("main"):
            pass
        first = profiler.session()
        t = threading.Thread(target=work)
        t.start()
        t.join()
        with profiler.span("after"):
            pass
    assert seen["enabled"] is False
    assert seen["session"] is first and profiler.session() is first
    assert [s.name for s in first.spans] == ["main", "side", "after"]
    assert all(s.end_ns >= s.start_ns for s in first.spans)
    # the range reaches the trace only from the thread the profiler records
    ranges = {e.name for e in prof.events() if e.name.startswith("bt.")}
    assert ranges == {"bt.main", "bt.after"}


@pytest.mark.parametrize("frames,want", [
    # a 10 s clip: 501 frames in the 768 bucket, valid 501 + 2 x 6
    (501, (768, 768 - 513)),
    # a 278 s track: 13,901 frames as 10 unmasked 1500-frame chunks
    (13901, (10 * 1500, 0)),
])
def test_forward_counters_read_the_reckoned_padding(frames, want):
    config = BeatThisConfig(**SMALL)
    model = BeatThis(config)
    model.load_state_dict(init_beat_this(0, config))
    pred = ChunkedPredictor(model.eval().requires_grad_(False))
    if frames > pred.stride:
        assert len(plan_chunks(frames)) == 10
    before = dict(profiler.counters)
    pred.predict_many_device(torch.zeros(frames, 128), [0], [frames])
    got = tuple(profiler.counters[k] - before[k] for k in ("forward_frames", "masked_frames"))
    assert got == want


def test_a_new_profiler_window_replaces_the_session(fresh):
    with _cpu_profile():
        with profiler.span("first"):
            pass
    first = profiler.session()
    with profiler.span("between"):  # off: no profiler records
        pass
    assert profiler.session() is first and [s.name for s in first.spans] == ["first"]
    profiler.count(forward_frames=2)
    with _cpu_profile():
        with profiler.span("second"):
            pass
    second = profiler.session()
    assert second is not first
    assert [s.name for s in second.spans] == ["second"]
    assert second.counters["forward_frames"] == first.counters["forward_frames"] + 2


def test_exported_ranges_start_with_their_spans(fresh, library, tmp_path):
    with _cpu_profile() as prof:
        _process(library)
        _train()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                e["name"].startswith("bt."):
            start = float(e["ts"]) * 1e3 + base
            ranges.setdefault(e["name"][3:], []).append((start, start + float(e["dur"]) * 1e3))
    spans = {}
    for s in profiler.session().spans:
        spans.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    assert {"group", "load", "write", "step", "micro", "optimizer"} <= set(spans)
    assert set(ranges) == set(spans)
    lags = []
    for name, recorded in spans.items():
        got = sorted(ranges[name])
        assert len(got) == len(recorded), name
        for (a, b), (start, end) in zip(got, sorted(recorded)):
            assert start - 1e6 < a <= b < end + 1e6, (name, a - start, b - end)
            lags.append(a - start)
    assert -1e6 < np.median(lags) < 1e6
