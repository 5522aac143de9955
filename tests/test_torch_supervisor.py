"""The supervisor (``training/supervisor.py``) against the JAX package's,
and signal checkpointing through the train CLI, on the CPU.

* Restarts, backoff, the restart budget and the event log: the port's
  Supervisor and the JAX one, each given the same scripted children, a
  fake clock and a recording sleep, log the same events, sleep the same
  backoffs and return the same codes.
* A SIGTERM to a supervised CPU train process (``python -m
  unidisc_tpu_torch.training.supervisor -- python -m
  unidisc_tpu_torch.train ...``) mid-run: the child checkpoints and exits
  143, the supervisor relaunches it, it resumes and finishes; its final
  checkpoint equals a straight run's bit for bit (both in subprocesses
  with one thread each).
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from unidisc_tpu.training import supervisor as jsup
from unidisc_tpu_torch.training import supervisor as tsup
from unidisc_tpu_torch.training.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPTS = {
    "recovers": [(1, 5.0), (3, 100.0), (0, 10.0)],
    "crash_loop": [(1, 1.0)] * 6,
    "long_runs_reset_backoff": [(2, 70.0), (2, 70.0), (2, 5.0), (0, 1.0)],
}


def supervise(module, script, policy):
    clock = [0.0]
    slept = []
    runs = iter(script)

    def run_child():
        code, runtime = next(runs)
        clock[0] += runtime
        return code, runtime

    def sleep(s):
        slept.append(s)
        clock[0] += s

    sup = module.Supervisor(["train"], module.SupervisorPolicy(**policy),
                            sleep_fn=sleep, clock=lambda: clock[0])
    code = sup.run(run_child)
    return code, sup.events, slept


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_policy_and_events_match_jax(name):
    policy = dict(max_restarts=4, window_s=1000.0, backoff_s=2.0,
                  backoff_max_s=6.0, min_healthy_s=60.0)
    assert supervise(tsup, SCRIPTS[name], policy) == \
        supervise(jsup, SCRIPTS[name], policy)


def test_stop_request_ends_supervision():
    for module in (tsup, jsup):
        sup = module.Supervisor(["x"], module.SupervisorPolicy(),
                                sleep_fn=lambda s: None)
        sup.request_stop()
        assert sup.run(lambda: (143, 1.0)) == 143
        assert [e["event"] for e in sup.events] == ["launch", "stopped"]


TRAIN = ["--device", "cpu", "--batch-size", "2", "--log-every", "1",
         "--ckpt-every", "0", "--overfit", "model=tiny",
         "model.hidden_size=64", "model.n_heads=1", "model.length=24",
         "model.txt_length=8", "model.img_length=16",
         "model.text_vocab_size=24", "model.image_vocab_size=40",
         "model.dropout=0.1", "trainer.warmup_steps=0",
         "trainer.optimizer=lion", "trainer.max_steps=60"]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
       "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}


def final_state(run_dir):
    mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    return mgr.latest_step(), mgr.read_state()


def test_sigterm_checkpoints_and_the_relaunch_resumes(tmp_path):
    straight = str(tmp_path / "straight")
    subprocess.run([sys.executable, "-m", "unidisc_tpu_torch.train",
                    "--run-dir", straight, *TRAIN], env=ENV, check=True,
                   cwd=ROOT, capture_output=True, timeout=300)
    run = str(tmp_path / "supervised")
    log = str(tmp_path / "events.jsonl")
    sup = subprocess.Popen(
        [sys.executable, "-m", "unidisc_tpu_torch.training.supervisor",
         "--backoff-s", "0.1", "--log", log, "--",
         sys.executable, "-m", "unidisc_tpu_torch.train", "--run-dir", run,
         *TRAIN], env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    metrics = os.path.join(run, "metrics.jsonl")
    deadline = time.time() + 240
    while time.time() < deadline:
        if os.path.exists(metrics) and len(open(metrics).readlines()) >= 5:
            break
        time.sleep(0.05)
    pid = json.loads(open(log).readline())["pid"]
    os.kill(pid, signal.SIGTERM)
    out = sup.communicate(timeout=300)[0].decode()
    assert sup.returncode == 0, out
    events = [json.loads(x) for x in open(log)]
    assert [e["event"] for e in events] == ["launch", "restart", "launch",
                                            "clean_exit"], events
    assert events[1]["code"] == 128 + signal.SIGTERM
    assert "checkpointing then stopping" in out
    assert "resumed from step" in out
    steps = CheckpointManager(os.path.join(run, "checkpoints")).all_steps()
    assert len(steps) == 2 and 5 <= steps[0] < 60 and steps[1] == 60
    (s1, a), (s2, b) = final_state(straight), final_state(run)
    assert s1 == s2 == 60
    for key in ("params", "ema_params"):
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    for name, value in a["opt_state"].items():
        assert torch.equal(value, b["opt_state"][name]), name
