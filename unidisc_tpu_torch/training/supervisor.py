"""Training supervisor: relaunch on failure, with resume (port of
``unidisc_tpu/training/supervisor.py``).

Run the training command; when it dies (preemption, a fault, a SIGTERM
that made it checkpoint and exit non-zero) relaunch it with the same argv:
the train CLI resumes from the latest checkpoint. Bounded restarts within
a sliding window (a crash loop stops the job), exponential backoff, and a
JSONL event log. Exit code 0 from the child ends supervision. A SIGTERM or
SIGINT to the supervisor is forwarded to the child, which checkpoints, and
ends supervision once it exits.

    python -m unidisc_tpu_torch.training.supervisor [--max-restarts N]
        [--window-s S] [--backoff-s S] [--log FILE] -- <command> [args...]

Each "launch" event also records the child's pid (a port addition).
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class SupervisorPolicy:
    max_restarts: int = 10          # within the window
    window_s: float = 3600.0        # sliding window for the restart budget
    backoff_s: float = 5.0          # initial backoff
    backoff_max_s: float = 300.0
    min_healthy_s: float = 60.0     # runs shorter than this count double


class Supervisor:
    """Supervise one child command; restart on failure until the restart
    budget is spent or the child exits cleanly."""

    def __init__(self, argv: List[str], policy: SupervisorPolicy = None,
                 log_path: Optional[str] = None, sleep_fn=time.sleep,
                 clock=time.monotonic):
        self.argv = list(argv)
        self.policy = policy or SupervisorPolicy()
        self.log_path = log_path
        self._sleep = sleep_fn
        self._clock = clock
        self.restarts: List[float] = []   # restart timestamps
        self.events: List[dict] = []
        self._stop = False
        self._child = None                # the live subprocess.Popen

    def _log(self, **event):
        event["t"] = round(self._clock(), 3)
        self.events.append(event)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(event) + "\n")

    def _budget_left(self) -> bool:
        now = self._clock()
        self.restarts = [t for t in self.restarts
                         if now - t < self.policy.window_s]
        return len(self.restarts) < self.policy.max_restarts

    def request_stop(self, *_):
        """Graceful stop: forward SIGTERM to the child so it checkpoints,
        then stop supervising once it exits."""
        self._stop = True
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def run(self, run_child=None) -> int:
        """Supervise until a clean exit, the budget is spent or a stop is
        requested. run_child() -> (exit_code, runtime_s); by default the
        command runs as a subprocess. Returns the final exit code."""
        p = self.policy
        backoff = p.backoff_s
        attempt = 0
        while True:
            attempt += 1
            if run_child is None:
                t0 = self._clock()
                proc = subprocess.Popen(self.argv)
                self._child = proc
                self._log(event="launch", attempt=attempt, argv=self.argv,
                          pid=proc.pid)
                try:
                    code = proc.wait()
                finally:
                    self._child = None
                runtime = self._clock() - t0
            else:
                self._log(event="launch", attempt=attempt, argv=self.argv)
                code, runtime = run_child()
            if code == 0:
                self._log(event="clean_exit", attempt=attempt)
                return 0
            if self._stop:
                self._log(event="stopped", attempt=attempt, code=code)
                return code
            # short-lived failures burn the budget faster (a crash loop)
            now = self._clock()
            self.restarts.append(now)
            if runtime < p.min_healthy_s:
                self.restarts.append(now)
            else:
                backoff = p.backoff_s      # a healthy run resets backoff
            if not self._budget_left():
                self._log(event="budget_exhausted", attempt=attempt,
                          code=code, restarts_in_window=len(self.restarts))
                return code
            self._log(event="restart", attempt=attempt, code=code,
                      runtime_s=round(runtime, 1), backoff_s=backoff,
                      restarts_in_window=len(self.restarts))
            self._sleep(backoff)
            backoff = min(backoff * 2, p.backoff_max_s)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="unidisc_tpu_torch.training.supervisor",
        description="relaunch-on-failure wrapper for the train CLI")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--window-s", type=float, default=3600.0)
    ap.add_argument("--backoff-s", type=float, default=5.0)
    ap.add_argument("--log", default="supervisor_events.jsonl")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- <command> [args...]")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (use: supervisor -- python -m "
                 "unidisc_tpu_torch.train ...)")
    sup = Supervisor(cmd, SupervisorPolicy(
        max_restarts=args.max_restarts, window_s=args.window_s,
        backoff_s=args.backoff_s),
        log_path=args.log)
    signal.signal(signal.SIGTERM, sup.request_stop)
    signal.signal(signal.SIGINT, sup.request_stop)
    sys.exit(sup.run())


if __name__ == "__main__":
    main()
