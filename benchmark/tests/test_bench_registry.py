"""Cells, configurations, mixes, metrics and kernel families are found by
name: adding one is adding files and entries, editing no file."""

import hashlib
import json
from types import SimpleNamespace

from conftest import HERE, tiny_registry


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_config_mix_and_metric_need_no_edit(tmp_path):
    reg = tiny_registry(tmp_path)
    here = reg.here
    before = digest(here)
    cfg = json.loads((here / "configs" / "small.json").read_text())
    (here / "configs" / "mid.json").write_text(json.dumps({**cfg, "name": "mid",
                                                           "transformer_dim": 256}))
    traffic = json.loads((here / "traffic" / "library_f32.json").read_text())
    (here / "traffic" / "albums_f32.json").write_text(json.dumps({**traffic, "files": 12}))
    (here / "limits" / "mid.albums_f32.json").write_text(
        (here / "limits" / "final.library_f32.json").read_text())
    (here / "metrics" / "infer.groups.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mid", "source": "x", "file": "benchmark/configs/mid.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mid.albums_f32", "config": "mid",
                               "traffic": "albums_f32", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "infer.groups", "unit": "groups", "better": "higher",
                               "source": "program_counter", "layer": "inference",
                               "moves": "audio_x_realtime", "workloads": ["mid.albums_f32"]})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_x_realtime":
            m["workloads"].append("mid.albums_f32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    from harness.registry import Registry

    reg = Registry(root=tmp_path, here=here)
    after = digest(here)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    cell = reg.cell("mid.albums_f32")
    assert reg.config(cell["config"])["transformer_dim"] == 256
    assert reg.traffic(cell["traffic"])["files"] == 12
    assert reg.limits("mid.albums_f32")["beats_mismatch"]["limit"] == 0
    names = [m["name"] for m in reg.metrics("per_layer", "mid.albums_f32")]
    assert "infer.groups" in names and "b5.roofline" not in names
    assert [m["name"] for m in reg.metrics("end_to_end", "mid.albums_f32")] == [
        "audio_x_realtime", "peak_mem_gib", "setup_s"]
    assert reg.reader("infer.groups").read(SimpleNamespace(units=7)) == 7.0


def test_a_new_kernel_family_is_a_file(tmp_path):
    reg = tiny_registry(tmp_path)
    (reg.here / "work" / "k1.py").write_text(
        "NAMES = ('ff_pre_kernel',)\nANCHOR = 'ff_pre_kernel'\n"
        "COUNTERS = (('beat_this_tpu_torch.ops.fused_ff', 'fused_ff'),)\n"
        "def calls(cfg, forwards):\n    return []\n"
        "def work(call, act_bytes):\n    return 0, 0\n")
    fam = reg.family("k1")
    assert fam.ANCHOR == "ff_pre_kernel" and fam.calls({}, []) == []
