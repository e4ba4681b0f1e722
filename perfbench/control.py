"""The control and the lower readings of a cell, at the cell's own size:
for each seed, one run of the cell (a short window at the cell's load),
then its sample judged twice, the program against the reference (the
numbers `correct` compares, whose largest over seeds is a limit's lower
reading) and the control against the reference (the reference computed
one step below the configuration's precision, put in the program's place;
its smallest over seeds is the upper reading).  The benchmark's own runs
never run it.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

One line of JSON a seed: {"seed", "program": {...}, "control": {...}}.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def one_seed(cell: str, seed: int, seconds: float, t0: float, device: str = "cuda",
             root=None) -> dict:
    from perfbench import judge
    from perfbench.cell import Run

    run = Run(cell, seed, seconds, False, t0, root or ROOT, device)
    try:
        run.setup()
        run.window()
        sample, units, served = run.finish()
        ref = run.reference()
        program, detail = judge.judge(ref, run.cfg, sample, units, run.voices, served)
        control, ctl_detail = judge.judge_control(ref, run.reference(control=True), run.cfg,
                                                  sample, units, run.voices)
    finally:
        run.close()
    return {"seed": seed, "cell": cell, "judged": len(sample), "program": program,
            "control": control, "program_parts": detail, "control_parts": ctl_detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    t0 = T_START
    for seed in args.seeds:
        print(json.dumps(one_seed(args.workload, seed, args.seconds, t0)), flush=True)
        t0 = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
