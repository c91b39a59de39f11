"""The port's quickstart end to end (the mirror of `tests/test_quickstart.py`).

`openvla_oft_tpu_torch/scripts/quickstart.py::main` on the committed
observation fixture (`experiments/robot/libero/sample_libero_spatial_observation.pkl`)
with `random:tiny` weights on the CPU, and the synthetic observation it
falls back to where a checkout lacks the fixture.
"""

import numpy as np

from openvla_oft_tpu_torch.scripts import quickstart as Q


def test_fixture_schema():
    assert Q.FIXTURE.exists(), "committed quickstart fixture missing"
    obs = Q.load_observation(None)
    assert obs["full_image"].shape == (256, 256, 3) and obs["full_image"].dtype == np.uint8
    assert obs["wrist_image"].shape == (256, 256, 3)
    assert obs["state"].shape == (8,)
    assert "black bowl" in obs["task_description"]


def test_synthetic_observation_without_the_fixture(monkeypatch, tmp_path):
    monkeypatch.setattr(Q, "FIXTURE", tmp_path / "absent.pkl")
    obs = Q.load_observation(None)
    assert obs["full_image"].shape == (224, 224, 3) and obs["state"].shape == (8,)
    assert "black bowl" in obs["task_description"]


def test_quickstart_end_to_end(capsys):
    actions = np.asarray(Q.main(Q.QuickstartConfig(checkpoint="random:tiny", device="cpu")))
    assert actions.shape == (8, 7)                      # LIBERO chunk x action dim
    assert np.isfinite(actions).all()
    assert np.abs(actions).max() <= 5.0
    out = capsys.readouterr().out
    assert "black bowl" in out and "t+7:" in out
