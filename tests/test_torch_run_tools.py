"""The port's run tools: `utils/profiling.py`, `scripts/summarize_run.py` and
`scripts/verify_openvla.py`, against the JAX package's
(`openvla_oft_tpu/utils/profiling.py`, `vla_scripts/summarize_run.py`,
`vla_scripts/verify_openvla.py`), as `tests/test_runner_and_profiling.py`
tests those. Everything runs on the CPU: the trace has CPU activity only, and
`verify` runs `random:tiny` with `device="cpu"`.
"""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu.utils.profiling import StepTimer as JaxStepTimer
from openvla_oft_tpu_torch.scripts import summarize_run as port_summarize
from openvla_oft_tpu_torch.scripts import verify_openvla as port_verify
from openvla_oft_tpu_torch.training.metrics import JSONLinesTracker, VLAMetrics
from openvla_oft_tpu_torch.utils import profiling as P
from openvla_oft_tpu_torch.utils.cli import parse_args
from vla_scripts import summarize_run as jax_summarize
from vla_scripts.verify_openvla import VerifyConfig as JaxVerifyConfig


def test_step_timer_summary():
    """The window, p50, p90, mean and steps/s, equal to the JAX timer's on
    the same times; start/stop measures wall time."""
    t, j = P.StepTimer(window=3), JaxStepTimer(window=3)
    assert t.summary() == {}
    for timer in (t, j):
        for dt in (0.01, 0.02, 0.03, 0.04):       # the window drops the first
            timer.times.append(dt)
        timer.times = timer.times[-timer.window:]
    s = t.summary()
    assert s == j.summary()
    np.testing.assert_allclose(s["p50"], 0.03)
    np.testing.assert_allclose(s["mean"], 0.03, rtol=1e-9)
    np.testing.assert_allclose(s["steps_per_sec"], 1 / 0.03, rtol=1e-9)
    t2 = P.StepTimer()
    t2.start()
    time.sleep(0.01)
    assert t2.stop() >= 0.009
    assert t2._t0 is None


def test_verify_config_fields_and_defaults_match_jax():
    """Every field of the JAX `VerifyConfig` with its default, and the
    port's own: `device` ("cuda" unless the caller asks for the CPU) and
    `zero_init`; the reference-style flags parse."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxVerifyConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(port_verify.VerifyConfig)}
    assert {k: port_fields[k] for k in jax_fields} == jax_fields
    assert set(port_fields) - set(jax_fields) == {"device", "zero_init"}
    assert port_fields["device"] == "cuda" and port_fields["zero_init"] is False
    cfg = parse_args(port_verify.VerifyConfig, [
        "--pretrained_checkpoint", "random:tiny", "--num_iterations", "3",
        "--quant", "int8", "--use_proprio", "false", "--device", "cpu"])
    assert (cfg.num_iterations, cfg.quant, cfg.use_proprio, cfg.device) == (3, "int8", False,
                                                                            "cpu")


def test_profiler_trace_writes_events(tmp_path):
    """trace() writes a Chrome trace with the annotated region's events."""
    with P.trace(str(tmp_path)):
        with P.annotate("matmul_region"):
            x = torch.ones((64, 64))
            P.host_sync(x @ x)
    produced = [p for p in Path(tmp_path).rglob("*") if p.is_file() and p.stat().st_size > 0]
    assert produced, f"no trace files under {tmp_path}"
    events = json.loads(produced[0].read_text())["traceEvents"]
    assert any(e.get("name") == "matmul_region" for e in events)


def test_host_sync_reads_the_sum():
    assert P.host_sync(torch.arange(5, dtype=torch.int32)) == 10.0
    assert P.host_sync(torch.full((3, 2), 0.5, dtype=torch.bfloat16)) == 3.0


def _write_run(path: Path, n: int = 40) -> None:
    """A metrics JSONL as the fine-tuning CLI writes it (`VLAMetrics` over a
    `JSONLinesTracker`), with a validation record without a loss."""
    run_dir, run_id = path.parent, path.name[:-len("-metrics.jsonl")]
    metrics = VLAMetrics([JSONLinesTracker(str(run_dir), run_id)], window=1)
    rng = np.random.default_rng(0)
    for step in range(n):
        metrics.commit(loss=2.0 * np.exp(-step / 15) + 0.05 * rng.random(),
                       curr_action_l1_loss=0.5 * np.exp(-step / 20), grad_norm=1.0)
        metrics.push(step)
        if step == n // 2:
            JSONLinesTracker(str(run_dir), run_id).write(step, {"val_loss": 0.7})


def test_metrics_records_carry_the_names_summarize_reads(tmp_path):
    path = tmp_path / "demo-metrics.jsonl"
    _write_run(path, n=3)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert {"step", "loss", "curr_action_l1_loss", "step_time"} <= set(recs[0])


def test_summarize_run_matches_jax(tmp_path, capsys):
    """The table and the summary JSON of a run's JSONL: the port's script
    prints what the JAX script prints on the same file."""
    path = tmp_path / "demo-metrics.jsonl"
    _write_run(path)
    got = port_summarize.summarize(str(path), window=5)
    printed = capsys.readouterr().out
    ref = jax_summarize.summarize(str(path), window=5)
    assert got == ref and printed == capsys.readouterr().out
    assert got["n_records"] == 40 and got["descent_ratio"] < 1
    assert json.loads(printed.strip().splitlines()[-1]) == got


@pytest.mark.parametrize("quant", ["", "int8"])
def test_verify_runs_tiny_on_the_cpu(quant, capsys):
    """`verify` at random:tiny on the CPU, 2 calls: finite actions of the
    chunk's shape, p50 and p90 of the timed call printed."""
    stats = port_verify.verify(port_verify.VerifyConfig(
        pretrained_checkpoint="random:tiny", num_iterations=2, device="cpu", quant=quant))
    out = capsys.readouterr().out
    assert set(stats) == {"p50", "p90", "mean", "steps_per_sec"}
    assert all(np.isfinite(v) and v > 0 for v in stats.values())
    assert "finite: True" in out and "action chunk shape: (8, 7)" in out
