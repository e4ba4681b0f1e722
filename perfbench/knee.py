"""The knee of an open-loop cell: the highest offered rate the system
sustains, found by a sweep on the card (run once; the cell's mix then
holds a fixed rate).  One process builds the cell and then offers each
rate for `--seconds` in turn, every window with its own schedule:

    python3 perfbench/knee.py --workload sample.poisson --seed <n> --seconds 40 \
        --rates 0.8 1.0 1.2 1.4

A rate is sustained when every request finished, the completed rate is
within 5% of the offered one, the backlog does not grow (the last third's
median latency at most twice the first third's), and p90 latency is at
or under the clip's own duration.  One line of JSON a rate.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def sweep(run, rates, seed: int, seconds: float):
    """Offer each rate in turn on `run`'s set-up service; yield a row a
    rate."""
    from perfbench import traffic
    from perfbench.cell import latencies, percentile

    base = dict(run.mix)
    run.child.stdin.close()
    run.child.wait(30)
    for i, rate in enumerate(rates):
        run.mix = {**base, "rate_per_s": rate}
        run.sched = traffic.schedule(run.mix, seed + i, seconds)
        run.voices = traffic.voices(run.mix, seed, run.sched)
        run.service.calls = []
        run.start_loadgen()
        run.window()
        run._tell([])
        run._hear()
        run.child.stdin.close()
        run.child.wait(30)
        recs = sorted(run.recs, key=lambda r: r["due"])
        ok = [r for r in recs if r["ok"]]
        t0 = recs[0]["due"]
        close = t0 + seconds
        lat = latencies(run.sched, recs)
        clip = sum(r["audio_s"] for r in ok) / max(len(ok), 1)
        span = max(r["done"] for r in ok) - t0 if ok else float("inf")
        third = max(1, len(recs) // 3)
        first, last = ([r["done"] - r["due"] if r["ok"] else float("inf") for r in part]
                       for part in (recs[:third], recs[-third:]))
        row = {"offered_per_s": len(run.sched) / seconds,
               "completed_per_s": len(ok) / span, "requests": len(run.sched),
               "finished": len(ok), "p50_s": percentile(lat, 0.5),
               "p90_s": percentile(lat, 0.9), "clip_s": clip,
               "p50_first_third_s": percentile(first, 0.5),
               "p50_last_third_s": percentile(last, 0.5),
               "backlog_at_close": sum(1 for r in recs if r["due"] < close
                                       and (not r["ok"] or r["done"] > close)),
               "groups_mean": sum(run.batch_sizes) / max(len(run.batch_sizes), 1),
               "graphs_in_window": run.graphs_delta, "card": run.card}
        row["sustained"] = (row["completed_per_s"] >= 0.95 * row["offered_per_s"]
                            and row["p90_s"] <= clip and len(ok) == len(run.sched)
                            and row["p50_last_third_s"] <= 2 * row["p50_first_third_s"])
        yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.cell import Run

    run = Run(args.workload, args.seed, args.seconds, False, T_START, ROOT)
    try:
        run.setup()
        for row in sweep(run, args.rates, args.seed, args.seconds):
            print(json.dumps(row), flush=True)
    finally:
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
