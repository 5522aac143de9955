#!/usr/bin/env python3
"""Where chip_smoke.py's time goes: its main() under a sampling profiler.

    python3 scripts/chip_smoke_profile.py [chip_smoke.py's arguments]

Every 0.1 s a thread reads the main thread's stack and counts, for the
chain of chip_smoke.py's functions on it, every prefix of the chain
(seconds spent in or under each), and the pair (the chain's first five
functions, the innermost frame of any file). The spawned mesh ranks and
the subprocesses are seen as the main thread waiting on them. Writes
chiprun_out/chip_smoke_profile.json every 20 s and at the end, and exits
with chip_smoke's code. The profiler holds no frame past a sample: a
held frame keeps its locals (an engine, a CUDA graph) alive, and their
release in this thread during a later capture would invalidate it.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.json")
DT = 0.1


def main() -> int:
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke
    main_id = threading.get_ident()
    paths, ctx = collections.Counter(), collections.Counter()
    stop = threading.Event()
    t0 = time.perf_counter()

    def dump():
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        with open(OUT, "w") as f:
            json.dump({"interval_s": DT,
                       "elapsed_s": time.perf_counter() - t0,
                       "paths": paths.most_common(600),
                       "innermost": ctx.most_common(800)}, f)

    def sample():
        last = time.perf_counter()
        while not stop.wait(DT):
            frame = sys._current_frames().get(main_id)
            chain, inner = [], None
            while frame is not None:
                code = frame.f_code
                if inner is None:
                    inner = (f"{os.path.basename(code.co_filename)}:"
                             f"{code.co_name}")
                if code.co_filename.endswith("chip_smoke.py"):
                    chain.append(code.co_name)
                frame = frame.f_back
            chain.reverse()
            for i in range(1, len(chain) + 1):
                paths["/".join(chain[:i])] += 1
            if inner is not None:
                ctx["/".join(chain[:5]) + " :: " + inner] += 1
            if time.perf_counter() - last > 20:
                dump()
                last = time.perf_counter()

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    sys.argv = ["chip_smoke.py", *sys.argv[1:]]
    try:
        return chip_smoke.main()
    finally:
        stop.set()
        thread.join()
        dump()


if __name__ == "__main__":
    sys.exit(main())
