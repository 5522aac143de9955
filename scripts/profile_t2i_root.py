#!/usr/bin/env python3
"""Profile a served text->image batch of another tree's package with this
repository's ``unidisc_tpu_torch/profile_t2i.py``, so that two trees are
measured by the same code.

    python3 scripts/profile_t2i_root.py --root DIR [profile_t2i arguments]

--root is a repository root, e.g. a ``git archive`` of another commit
unpacked into a git-ignored directory; its ``unidisc_tpu_torch`` is
imported and its kernels build into DIR/build. The other arguments go to
profile_t2i (``--int8``, ``--out``, ...).
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    args, rest = ap.parse_known_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import unidisc_tpu_torch
    if Path(unidisc_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {unidisc_tpu_torch.__file__}, not the "
                           f"package under {root}")
    spec = importlib.util.spec_from_file_location(
        "profile_t2i_here", HERE / "unidisc_tpu_torch" / "profile_t2i.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.argv = [sys.argv[0], *rest]
    return mod.main()


if __name__ == "__main__":
    sys.exit(main())
