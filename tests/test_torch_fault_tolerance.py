"""The port's training launcher under faults (the reference's
``tests/test_fault_tolerance.py``): kill training mid-run, restart it
with ``--resume`` and check that it goes on from the checkpoint; a
stalled step turns into exit code 42 through ``Watchdog``."""
import os
import signal
import subprocess
import sys
import time

from repro_torch.training import checkpoint as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, PYTHONPATH="src" + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _train_cmd(ckpt_dir, steps):
    return [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "llama3-8b", "--tiny", "--device", "cpu",
            "--steps", str(steps), "--seq-len", "32", "--global-batch", "2",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "5",
            "--log-every", "5", "--resume"]


def test_kill_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    # run 1: train, killed once the first checkpoint has landed
    p = subprocess.Popen(_train_cmd(ckpt, 40), env=_env(), cwd=ROOT,
                         stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 240
        while time.time() < deadline and ck.latest_step(ckpt) is None:
            time.sleep(0.2)
        assert ck.latest_step(ckpt) is not None, \
            "no checkpoint before timeout"
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
    step_after_kill = ck.latest_step(ckpt)

    # run 2, the supervisor's restart: resumes and reaches the target
    out = subprocess.run(_train_cmd(ckpt, step_after_kill + 5), env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-1000:]
    assert f"resumed from step {step_after_kill}" in out.stdout
    assert ck.latest_step(ckpt) == step_after_kill + 5


def test_watchdog_exits_nonzero_on_stall():
    """A stalled step becomes a fast exit with code 42, so a supervisor
    restarts the job."""
    code = r"""
import time
from repro_torch.launch.train import Watchdog
dog = Watchdog(timeout_s=1.0)
dog.start()
time.sleep(10)   # a wedged step: never beats
print("should not reach here")
"""
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 42
    assert "WATCHDOG" in out.stderr
    assert "should not reach here" not in out.stdout
