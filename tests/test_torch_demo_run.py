"""Gate over the port's committed 3,000-step demo run
(examples/torch_demo_run/summary.json): the JAX package's demo recipe,
unchanged, through radmmm_torch's training CLI on one NVIDIA H100 80GB
HBM3 at 700.00 W (examples/torch_demo_run/run.sh, then finish.py).

The bounds are the JAX package's gate over its own run
(tests/test_quality_metrics.py::test_demo_calibration_baseline_gates):
F0 RMSE <= 0.07, voicing F1 >= 0.78, val loss <= 33, train loss <= -1.5;
and MCD <= 57.6 dB, which that gate leaves out: the JAX run's 55.6 dB plus
the 2 dB that examples/demo_run/README.md calls a regression. The rate
floor is half the H100 run's own median, 6.27 steps/s (B 8, megastep_k 8);
the TPU run's rate does not apply to this card."""
import json
from pathlib import Path

import pytest
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DEMO = Path(__file__).resolve().parents[1] / "examples" / "torch_demo_run"
STEPS_PER_SEC_FLOOR = 3.1


@pytest.fixture(scope="module")
def summary():
    return json.loads((DEMO / "summary.json").read_text())


def test_demo_run_is_the_recipe_on_the_card(summary):
    assert summary["steps"] == 3000
    assert summary["device"].startswith("NVIDIA H100"), summary["device"]
    assert summary["device"].endswith(" W"), summary["device"]
    assert len(summary["commit"]) == 40
    for name in summary["artifacts"]:
        assert (DEMO / name).is_file(), name


@pytest.mark.parametrize("key,bound,kind", [
    ("f0_rmse", 0.07, "max"), ("voicing_f1", 0.78, "min"),
    ("mcd_db", 57.6, "max")])
def test_demo_quality_within_the_jax_bounds(summary, key, bound, kind):
    value = summary["val_quality_final"][key]
    assert value <= bound if kind == "max" else value >= bound, (key, value)


def test_demo_losses_within_the_jax_bounds(summary):
    assert summary["val_loss_final"] <= 33.0, summary["val_loss_final"]
    assert summary["train_loss_final"] <= -1.5, summary["train_loss_final"]
    # the flow learned: the train loss fell over the run
    assert summary["train_loss_final"] < summary["train_loss_first"]


def test_demo_rate_floor(summary):
    assert summary["median_steps_per_sec"] >= STEPS_PER_SEC_FLOOR, \
        summary["median_steps_per_sec"]


def test_demo_directory_stays_small():
    size = sum(p.stat().st_size for p in DEMO.iterdir() if p.is_file())
    assert size < 1_000_000, size
    assert len(list(DEMO.glob("*.wav"))) <= 2
