"""The port's five benches of directory mode, the DBN, the evaluation
protocol and the small model (`beat_this_tpu_torch/bench/{mel_stage,
cli_dir,dbn,eval_protocol,small}.py`) through their `main` on the CPU at
tiny sizes (`main(argv, sizes)`): each prints one JSON line with its keys
and writes `--out` only when asked. The DBN bench decodes its clicks at mean beat F >= 0.9, and the
mel bench's corpus is tools/profile_mel_stage.py's."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.bench import cli_dir, dbn, eval_protocol, mel_stage, small
from beat_this_tpu_torch.check_all import Geometry
from beat_this_tpu_torch.model.beat_this import BeatThisConfig

TOOLS = Path(__file__).resolve().parent.parent / "tools"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The DBN's per-frame loop is thousands of tiny operations per piece:
    threads add only their hand-off where several test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_synth_corpus_matches_the_tool():
    spec = importlib.util.spec_from_file_location("profile_mel_stage",
                                                  TOOLS / "profile_mel_stage.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for args in ((), (3, 30.0, 2)):
        got, want = mel_stage.synth_corpus(*args), tool.synth_corpus(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_mel_stage(capsys, tmp_path):
    out = tmp_path / "mel.json"
    record = mel_stage.main(["--device", "cpu", "--out", str(out)],
                            sizes=mel_stage.Sizes(files=2, total_sec=16.0, reps=1))
    assert _last_json(capsys) == record == json.loads(out.read_text())
    for recipe in ("stacked", "flat"):
        for stage in ("host", "upload", "compute", "download", "e2e"):
            assert record[f"{recipe}_{stage}_ms"] >= 0
    assert record["flat_upload_mb"] < record["stacked_upload_mb"]
    assert record["production_f32_ms"] > 0 and record["production_int16_ms"] > 0
    assert record["max_abs_stacked_vs_flat"] < 1e-4 and record["production_equals_flat"]


def test_cli_dir(capsys, tmp_path):
    record = cli_dir.main(["--device", "cpu", "--files", "1", "--dim", "32", "--layers", "1"],
                          sizes=cli_dir.Sizes(total_sec=8.0))
    assert _last_json(capsys) == record
    assert record["host_path_groups"] == 0 and record["device_vs_host_max_abs"] == 0.0
    for key in ("cli_cold_s", "cli_warm_s", "load_s", "mel_s", "forward_s", "postprocess_s",
                "group_logits_s", "host_mel_s", "host_forward_s"):
        assert record[key] > 0, key


def test_dbn_decodes_its_clicks(capsys, tmp_path):
    record = dbn.main(["--device", "cpu", "--pieces", "2", "--frames", "600"],
                      sizes=dbn.Sizes(reps=1))
    assert _last_json(capsys) == record
    assert record["pieces"] == 2 and record["audio_seconds"] == pytest.approx(25.3)
    assert record["mean_f_beat_clicks"] >= 0.9 and record["min_f_beat_clicks"] > 0
    assert record["warm_decode_s"] > 0 and record["cold_decode_s"] > 0


def test_eval_protocol(capsys):
    geo = Geometry(config=BeatThisConfig(transformer_dim=32, n_layers=1), frames=64, micro=1,
                   accum=1)
    record = eval_protocol.main(["--device", "cpu", "--pieces", "1", "--frames", "320",
                                 "--fixture-steps", "2"], sizes=geo)
    assert _last_json(capsys) == record
    assert record["pieces"] == 1 and record["fixture_steps"] == 2
    assert 0.0 <= record["mean_f_beat_trained"] <= 1.0
    assert record["warm_protocol_s"] > 0 and record["cold_protocol_s"] > 0
    plumbing = eval_protocol.main(["--device", "cpu", "--pieces", "1", "--frames", "320",
                                   "--random-weights"], sizes=geo)
    assert "mean_f_beat_randomweights" in plumbing and "fixture_steps" not in plumbing


def test_small(capsys):
    record = small.main(["--device", "cpu"], sizes=small.Sizes(
        dim=32, layers=1, batches=1, chunks=1, frames=64, micro=1, accum=1, steps=1))
    assert _last_json(capsys) == record
    assert set(record) == {"model", "params", "eval_x_realtime", "eval_x_realtime_median",
                           "train_step_s", "train_step_s_median", "train_peak_gib"}
    assert "mfu_pct" not in record and record["train_peak_gib"] is None
    assert record["eval_x_realtime"] > 0 and record["train_step_s"] > 0


@pytest.mark.parametrize("bench", [mel_stage, cli_dir, dbn, eval_protocol, small])
def test_command_line_is_the_tools(bench):
    """Each bench's flags are its JAX tool's, plus `--device` and `--out`:
    the sizes tests shrink are no flags."""
    tool_flags = {mel_stage: set(), cli_dir: {"files", "dim", "layers"},
                  dbn: {"pieces", "frames", "out"},
                  eval_protocol: {"pieces", "frames", "random_weights", "fixture_steps", "out"},
                  small: {"out"}}[bench]
    flags = {a.dest for a in bench.get_parser()._actions if a.dest != "help"}
    assert flags == tool_flags | {"device", "out"}
