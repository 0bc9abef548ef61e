"""The port's kernel gate (`beat_this_tpu_torch.check_all`) on the CPU, where
every wrapper runs its plain version:

* its copies of the gate's fixtures equal tools/check_all_tpu.py's: the
  16-piece suite (`_gate_suite`), the decision boundary (`_gate_boundary`)
  and the trained fixture's click batch, bit for bit;
* the directional gradchecks hold the plain versions of B10 / B11, B12,
  B8 / B9, B6 / B7 and B4 / B5 under the gate's 8e-2 at small sizes;
* `main(["--device", "cpu", "--only", ...])` at a small geometry runs every
  check but the beat-level one (the DBN decoding of 16 pieces of 1500
  frames takes a minute on the CPU) and writes the report's JSON layout;
* without CUDA, `main` refuses unless `--device cpu` is given.
"""

import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from beat_this_tpu_torch import check_all
from beat_this_tpu_torch.model.beat_this import BeatThisConfig

TOOLS = Path(__file__).resolve().parent.parent / "tools"
SMALL = check_all.Geometry(
    config=BeatThisConfig(transformer_dim=64, n_layers=1), frames=64,
    time_cases=((1, 2), (2, 1)), time_train_cases=((1, 2), (2, 1)), micro=1, accum=2, steps=3,
    grad_layers=1, stats=(2, 256, 32), flash=(2, 128, 32), small=(32, 16, 32), ff=(64, 64, 256),
    freq_items=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' dropout masks and the DBN are loops of many small
    torch operations: where several test processes share the cores, torch's
    thread hand-off costs far more than the threads gain (minutes, not
    seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("check_all_tpu", TOOLS / "check_all_tpu.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_gate_suite_matches_the_tool(tool):
    got, got_specs = check_all._gate_suite()
    want, want_specs = tool._gate_suite()
    assert got_specs == want_specs and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(2, 180), (30, 180), (25, 3000), (1, 2)])
def test_gate_boundary_matches_the_tool(tool, lo, hi):
    logits = np.random.default_rng(lo).standard_normal(1500).astype(np.float32)
    logits[::25] += 8.0
    assert check_all._gate_boundary(logits, lo, hi) == tool._gate_boundary(logits, lo, hi)


def test_click_batch_matches_the_tool(tool, monkeypatch):
    """The tool builds its batch inside `_flagship_trained`; its training
    step is replaced by one that keeps the batch."""
    import jax

    import beat_this_tpu.model as jax_model
    import beat_this_tpu.train.task as jax_task

    seen = {}

    def make_step(config, tc):
        def step(ts, batch, key):
            seen.update({k: np.asarray(v) for k, v in batch.items()})
            return ts, {"total": 0.0}

        return step

    monkeypatch.setattr(jax, "jit", lambda fn: fn)
    monkeypatch.setattr(jax_model, "init_beat_this", lambda seed, config: (None, None))
    monkeypatch.setattr(jax_task, "init_train_state",
                        lambda p, s, tc: types.SimpleNamespace(params=None, bn_state=None))
    monkeypatch.setattr(jax_task, "make_train_step", make_step)
    monkeypatch.setattr(tool, "_FLAGSHIP", {})
    tool._flagship_trained(steps=1)
    got = check_all.click_batch(8, 8, 1500)
    assert sorted(got) == sorted(seen)
    for k, v in got.items():
        assert v.dtype == seen[k].dtype and np.array_equal(v, seen[k]), k


@pytest.mark.parametrize("name", ["flash_dropout_gradcheck", "small_attention_dropout_gradcheck",
                                  "fused_ff_dropout_gradcheck", "fused_freq_dropout_gradcheck",
                                  "fused_time_dropout_gradcheck"])
def test_directional_gradcheck_holds_the_plain_versions(name):
    out = dict(check_all.CHECKS)[name](SMALL, torch.device("cpu"))
    rels = [v for k, v in out.items() if k.startswith("rel")]
    assert rels and all(0 <= r < check_all.GRAD_LIMIT for r in rels), out


def test_main_on_the_cpu_writes_the_report(tmp_path, capsys):
    names = [n for n, _ in check_all.CHECKS if n != "beat_level_kernel_parity"]
    out = tmp_path / "gate.json"
    assert check_all.main(["--device", "cpu", "--out", str(out), "--only", *names],
                          geometry=SMALL) == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True and report["platform"] == "cpu"
    assert list(report["checks"]) == names
    for status in report["checks"].values():
        assert status["ok"] is True and isinstance(status["elapsed_s"], float)
    flagship = report["checks"]["flagship_train_steps"]
    assert flagship["steps"] == len(flagship["curve"]) == SMALL.steps
    assert flagship["loss_last"] < flagship["loss_first"] and flagship["peak_gib"] is None
    assert report["checks"]["eval_logit_parity"]["rel_dev"] == 0.0  # plain on both sides
    text = capsys.readouterr().out
    assert "flagship_train_steps: OK" in text and "ALL OK" in text


def test_main_refuses_without_cuda(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "gate.json"
    assert check_all.main(["--out", str(out)]) == 2
    assert not out.exists()
    assert "CUDA is not available" in capsys.readouterr().err
