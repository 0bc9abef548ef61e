"""The port's `overfit_smoke` driver on the CPU (the plain versions of the
training kernels; the card runs it from chip_smoke.py): a fast twin at tiny
width whose report has the JAX script's keys (`pallas_kernels` named
`cuda_kernels`), whose loss falls, and whose checkpoint scores the same
per-piece beat F-measure through `compute_paper_metrics`; and, marked slow as
tests/test_overfit.py is, the convergence run at the JAX script's defaults."""

import json
from pathlib import Path

import pytest

from beat_this_tpu_torch import compute_paper_metrics, overfit_smoke

# a report of the JAX script (launch_scripts/overfit_smoke.py), kept in the repository
JAX_REPORT = Path(__file__).resolve().parent.parent / "OVERFIT_r05.json"


def _run(tmp_path: Path, *flags: str) -> tuple[int, dict]:
    out = tmp_path / "OVERFIT.json"
    args = overfit_smoke.get_parser().parse_args(
        ["--device", "cpu", "--out", str(out), "--workdir", str(tmp_path / "work"), *flags])
    return overfit_smoke.main(args), json.loads(out.read_text())


def test_parser_keeps_the_jax_scripts_defaults():
    args = overfit_smoke.get_parser().parse_args([])
    assert (args.epochs, args.transformer_dim, args.n_layers, args.train_length, args.lr,
            args.compute_dtype, args.out, args.workdir, args.device) == (
        45, 64, 1, 512, 1e-3, "float32", "OVERFIT.json", None, "cuda")


def test_fast_twin_reports_learns_and_its_checkpoint_scores(tmp_path, monkeypatch):
    rc, report = _run(tmp_path, "--transformer-dim", "32", "--n-layers", "1", "--epochs", "3",
                      "--train-length", "192")
    want = {"cuda_kernels" if k == "pallas_kernels" else k
            for k in json.loads(JAX_REPORT.read_text())}
    assert set(report) == want
    assert report["platform"] == "cpu" and report["cuda_kernels"] is False
    assert (report["transformer_dim"], report["n_layers"], report["epochs"]) == (32, 1, 3)
    assert [r["epoch"] for r in report["curve"]] == [0, 1, 2]
    assert report["loss_last"] < report["loss_first"]
    assert len(report["f_measure_beat"]) == len(report["f_measure_downbeat"]) == 4
    assert rc == (0 if report["ok"] else 1)

    # the trained checkpoint, in the trainer's format, through the eval driver
    ckpt = tmp_path / "work" / "ckpts" / "overfit-S0.ckpt"
    calls, orig = [], compute_paper_metrics.compute_predictions
    monkeypatch.setattr(compute_paper_metrics, "compute_predictions",
                        lambda *a, **k: calls.append(orig(*a, **k)) or calls[-1])
    compute_paper_metrics.main(compute_paper_metrics.get_parser().parse_args(
        ["--models", str(ckpt), "--datasplit", "train", "--data-dir", str(tmp_path / "work"),
         "--device", "cpu"]))
    (metrics, _, _, pieces), = calls
    assert [Path(p).parent.name for p in pieces] == [f"click{i}" for i in range(4)]
    assert [round(float(f), 4) for f in metrics["F-measure_beat"]] == report["f_measure_beat"]


@pytest.mark.slow
def test_converges_at_the_jax_scripts_defaults(tmp_path):
    """64 x 1, 45 epochs of 512-frame crops, lr 1e-3: mean F beat >= 0.95 and
    downbeat >= 0.90, the script's own pass rule (about ten minutes on the
    CPU, where the plain attention forms (n, n) scores with their dropout
    masks)."""
    rc, report = _run(tmp_path)
    assert rc == 0 and report["ok"], report
    assert report["loss_last"] < 0.5 * report["loss_first"]
