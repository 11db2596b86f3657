"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload group-a.paper --seed 7 \
        --seconds 30 --trace 0

The cell's configuration's ``kind`` picks the runner
(``manifest.KINDS``): the multi-job FL loop (``harness.py``, the default)
or one LM training step of the port in a closed loop
(``lm_harness.py``).

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Exits non-zero, printing no result, without
a CUDA card, without the program's sources, or if a module of JAX or of
the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """This process's start, in Unix seconds (the kernel's record where it
    can be read, else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def main(argv=None) -> int:
    start = min(process_start(), time.time())
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(cache / "kernels"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)

    from portbench import guard, harness, manifest

    try:
        guard.check("at start")
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise harness.Failed(f"no program sources under {ROOT / 'src'}")
        cell = manifest.load_cell(args.workload)
        out = manifest.runner(cell).run(cell, args.seed, args.seconds,
                                        bool(args.trace), start)
        guard.check("before the result")
    except (harness.Failed, ImportError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
