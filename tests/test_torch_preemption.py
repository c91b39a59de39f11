"""The port's `PreemptionGuard` (`training/preemption.py`) and the
fine-tuning CLI's preemption path, mirroring tests/test_preemption.py: a
SIGTERM latches a flag, the loop saves a checkpoint after the micro-step in
flight and returns, and a resumed run picks up from it. Also what the
reference leaves out: a second signal re-raises through the previous
handler, the guard degrades to a flag outside the main thread, and the
CLI restores the handlers when its loop raises.
"""

import os
import signal
import threading
from pathlib import Path

import pytest

from openvla_oft_tpu_torch.training import preemption as P
from openvla_oft_tpu_torch.training.checkpoint import latest_step
from openvla_oft_tpu_torch.training import finetune as FT
from openvla_oft_tpu.training.preemption import PreemptionGuard as JaxGuard

# tests/test_torch_finetune_cli.py's tiny CPU run.
TINY_RUN = ["--device", "cpu", "--vla_path", "random:tiny", "--data_root_dir", "dummy",
            "--robot_platform", "libero", "--use_l1_regression", "True",
            "--use_proprio", "True", "--num_images_in_input", "2", "--lora_rank", "4",
            "--merge_lora_during_training", "False", "--wandb_log_freq", "1"]


def test_guard_latches_sigterm_and_restores_handler():
    before = signal.getsignal(signal.SIGTERM)
    with P.PreemptionGuard() as guard:
        assert not guard.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.should_stop
        assert guard.received_signal == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_programmatic_stop():
    with P.PreemptionGuard(signals=[]) as guard:
        assert not guard.should_stop
        guard.request_stop()
        assert guard.should_stop
        assert guard.received_signal is None


def test_second_signal_reaches_the_previous_handler():
    """The first SIGUSR1 latches; the second restores the handler installed
    before the guard and re-raises into it (as the JAX guard does)."""
    seen = []
    old = signal.signal(signal.SIGUSR1, lambda signum, frame: seen.append(signum))
    try:
        for guard_cls in (P.PreemptionGuard, JaxGuard):
            seen.clear()
            with guard_cls(signals=[signal.SIGUSR1]) as guard:
                os.kill(os.getpid(), signal.SIGUSR1)
                assert guard.should_stop and not seen
                os.kill(os.getpid(), signal.SIGUSR1)
                assert seen == [signal.SIGUSR1]
    finally:
        signal.signal(signal.SIGUSR1, old)


def test_guard_outside_the_main_thread_is_a_flag():
    out = {}

    def body():
        before = signal.getsignal(signal.SIGTERM)
        with P.PreemptionGuard() as guard:
            out["installed"] = signal.getsignal(signal.SIGTERM) is not before
            guard.request_stop()
            out["stop"] = guard.should_stop

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert out == {"installed": False, "stop": True}


def _base(tmp_path):
    return TINY_RUN + ["--batch_size", "2", "--save_freq", "100", "--wandb_log_freq", "100",
                       "--run_root_dir", str(tmp_path)]


def test_finetune_checkpoints_on_preemption(tmp_path, monkeypatch):
    """Mirrors tests/test_preemption.py::test_finetune_checkpoints_on_preemption:
    preempted at the 3rd poll, the loop saves step 3 and returns; the resumed
    run continues from it to max_steps."""
    polls = {"n": 0}

    def fake_should_stop(self):
        polls["n"] += 1
        return polls["n"] >= 3

    monkeypatch.setattr(P.PreemptionGuard, "should_stop", property(fake_should_stop))
    out = FT.main(_base(tmp_path) + ["--max_steps", "8"])
    assert out["final_step"] == 3
    ckpt_dir = Path(out["run_dir"]) / "ckpt"
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["000003.pt"]
    monkeypatch.undo()
    out2 = FT.main(_base(tmp_path) + ["--max_steps", "5", "--resume", "True",
                                      "--run_id_override", Path(out["run_dir"]).name])
    assert out2["final_step"] == 5 and latest_step(str(ckpt_dir)) == 5


def test_sigterm_mid_accumulation_saves_grad_step_plus_one(tmp_path):
    """A real SIGTERM from on_step at the third micro-step of windows of 2:
    the checkpoint is labelled grad_step + 1 = 2, as in the JAX CLI, and
    holds the optimizer's partial sums; the handler is restored after."""
    before = signal.getsignal(signal.SIGTERM)

    def on_step(step, metrics, state):
        if state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    out = FT.main(_base(tmp_path) + ["--max_steps", "4", "--grad_accumulation_steps", "2"],
                  on_step=on_step)
    assert out["final_step"] == 3
    assert latest_step(str(Path(out["run_dir"]) / "ckpt")) == 2
    from openvla_oft_tpu_torch.training.checkpoint import restore_checkpoint

    opt = restore_checkpoint(str(Path(out["run_dir"]) / "ckpt"))["optimizer"]
    assert opt["micro"] == 3 and opt["accum"] is not None
    assert signal.getsignal(signal.SIGTERM) is before


def test_handlers_are_restored_when_the_loop_raises(tmp_path):
    """The JAX CLI calls guard.__exit__ only on the clean path; the port's
    loop restores the handlers on an exception too."""
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)

    def on_step(step, metrics, state):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        FT.main(_base(tmp_path) + ["--max_steps", "2"], on_step=on_step)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
