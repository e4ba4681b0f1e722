"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It needs the CUDA cards the cell asks
for, and exits 2 without a result when they are missing.  Earlier lines of
standard output say how set-up went and what the window saw; the last
line is the result (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and `checks`: each number the
comparison with the reference read, beside its limit); the same numbers
close standard error.  The program's kernel build stays inside the
checkout (`voice_tts_tpu_torch/_build/`), and so do the caches this
sets (`.perfbench_cache/`).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voice_tts_tpu")


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port `voice_tts_tpu_torch` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from perfbench.cell import NoDevice, run_cell

    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                       ROOT)
    except NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = jax_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
