"""One run of one cell: set-up, the measured window through `POST /tts`,
the metrics, and the comparison that decides `correct`.

Set-up (all of it counted in `setup_s`, from the process's start to the
hand-off to the load generator): the imports and the CUDA context; the
benchmark's weights, made on the card from the seed
(`reference/<name>/weights.py`) and handed to the program's own modules and
`TTSEngine`; the engine's packs; the service (`TTSService` in grouped
mode, under a `BackgroundServer` on a loopback port) and its `minimal`
warm-up; the mix's voices conditioned and cached; one pass over the
mix's shapes (`warm_groups`), which captures every graph the window
replays; the load generator's process, with every request body ready.

The window: the load generator (`loadgen.py`, a child process) sends the
mix (`traffic.py`); the service records its engine calls and the engine's
stage inputs and outputs (`service.py`).  After the window the program is
stopped and freed, and the reference judges a sample of the finished
requests (`judge.py`).
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench import costs, judge, traffic
from perfbench import trace as tracing
from perfbench.reference.indextts2.pipeline import hash_ids, pick_bucket
from perfbench.registry import Registry

HERE = Path(__file__).resolve().parent


class NoDevice(RuntimeError):
    """The cell needs more cards than this machine has."""


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile; inf (a request that failed or never came)
    sorts after every finite value."""
    if not values:
        return math.inf
    s = sorted(values)
    return s[max(0, math.ceil(p * len(s)) - 1)]


def window_bounds(recs: List[Dict], t_go: float) -> tuple:
    """The window: from the first send to the last reply's last byte.  A
    closed loop sends only while `--seconds` have not passed since its first
    send, so the window closes when the last request sent before then
    completes."""
    sent = [r["sent"] for r in recs if r["sent"] is not None]
    done = [r["done"] for r in recs if r["done"] is not None]
    return (min(sent) if sent else t_go), (max(done) if done else t_go)


def rtf(recs: List[Dict], start: float, end: float) -> float:
    """The window's seconds over the audio seconds of every request finished
    in it."""
    audio = sum(r["audio_s"] for r in recs if r["ok"])
    return (end - start) / audio if audio > 0 else math.inf


def latencies(sched: List[Dict], recs: List[Dict]) -> List[float]:
    """Every scheduled request's seconds from its due time to its reply's
    last byte; inf for one that failed or never came."""
    got = {r["id"]: r for r in recs}
    return [got[q["id"]]["done"] - got[q["id"]]["due"]
            if q["id"] in got and got[q["id"]]["ok"] else math.inf for q in sched]


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "unknown"


def launches_of(call: Dict, cfg: Dict) -> List[Dict]:
    """The K1 / K3 decode runs of an engine call, as the engine's grouping
    makes them: rows, requests, first write position, executed steps (the
    call's chunks x 16, split evenly over its runs), int8 KV, ancestor
    table, kernel.  Beam search: K3 over beams x requests (at most
    `beam_batch_rows` rows, a power of 2 of requests a run); sampling: K1
    for a group of one, K3 over the rows with `use_fused_batch_decode`,
    else the unfused step (no K1 / K3)."""
    e, g = cfg["engine"], cfg["generation"]
    m = call["metrics"]
    runs, chunks = int(m.get("decode_runs", 0)), int(m.get("decode_chunks", 0))
    if not runs or not chunks:
        return []
    buckets: Dict[int, int] = {}
    for text in call["texts"]:
        b = pick_bucket(len(hash_ids(text, cfg["gpt"]["number_text_tokens"])),
                        e["text_buckets"])
        buckets[b] = buckets.get(b, 0) + 1
    k, n = g["num_beams"], call["n"]
    decodes = []                                   # (rows, requests, bucket, kernel)
    if k > 1:
        r_cap = max(1, e["beam_batch_rows"] // k)
        while r_cap & (r_cap - 1):
            r_cap &= r_cap - 1
        for b, cnt in buckets.items():
            for ofs in range(0, cnt, r_cap):
                rn = min(r_cap, cnt - ofs)
                decodes.append((k * rn, rn, b, "K3"))
    elif n == 1:
        decodes = [(1, 1, next(iter(buckets)), "K1")]
    elif e["use_fused_batch_decode"]:
        decodes = [(cnt, cnt, b, "K3") for b, cnt in buckets.items()]
    steps = chunks * costs.CHUNK // max(runs, len(decodes), 1)
    return [{"rows": r, "requests": q, "start": costs.prompt_len(cfg, b) + 1,
             "steps": steps, "kv_int8": bool(e["use_int8_kv"]), "table": k > 1,
             "kernel": kern} for r, q, b, kern in decodes]


def warm_groups(mix: Dict, buckets, texts: List[str], voices: Dict[str, bytes],
                seed: int, vocab: int) -> List[List[Dict]]:
    """The engine calls of the warm pass: every decode and synthesis shape
    the mix makes.  Closed loops: one request a text bucket.  Jobs: groups
    of `job_size` whose split over the buckets gives each bucket every
    sub-batch the engine can make of a job (1, 2 and `job_size` requests).
    Open loops: groups of 1, 2, 4 and 8, some with new voices (the batched
    conditioning at one and two new voices)."""
    warm = [v for k, v in voices.items() if not k.startswith("cold")]
    by_bucket: Dict[int, List[str]] = {}
    for t in texts:
        by_bucket.setdefault(pick_bucket(len(hash_ids(t, vocab)), buckets), []).append(t)
    bs = sorted(by_bucket)

    def req(i, b, j):
        return {"spk_audio_prompt": warm[i % len(warm)], "text": by_bucket[b][j]}
    loop = mix["loop"]
    if loop == "closed":
        return [[req(0, b, 0)] for b in bs]
    if loop == "jobs":
        n = int(mix["job_size"])
        if len(bs) == 1:
            return [[req(i, bs[0], i) for i in range(n)]]
        if len(bs) > 2:
            raise ValueError("the jobs warm-up covers texts of one or two buckets")
        return [[req(i, bs[0], i) for i in range(j)] + [req(j + i, bs[1], i)
                                                        for i in range(n - j)]
                for j in range(1, n)]
    cold = (traffic.voice_wav(seed, 900000 + i, float(mix["prompt_seconds"]))
            for i in range(64))
    n_cold = {1: 1, 2: 1, 4: 2, 8: 0} if int(mix.get("cold_every", 0)) else {}
    groups = []
    for b in bs:
        for size in (1, 2, 4, 8):
            grp = [req(i, b, i) for i in range(size)]
            for i in range(n_cold.get(size, 0)):
                grp[i] = {**grp[i], "spk_audio_prompt": next(cold)}
            groups.append(grp)
    return groups


class Run:
    """One process's run of one cell: `setup`, `window`, `end_to_end`,
    `judge` (see `run_cell`), and `close` whatever happened."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, t_start: float,
                 root: Optional[Path] = None, device: str = "cuda"):
        self.reg = Registry(root)
        self.cell = self.reg.cell(cell)
        self.conf = self.reg.config(self.cell["config"])
        self.cfg = self.conf["config"]
        self.limits = self.reg.limits(self.cell["config"])
        self.mix = self.reg.traffic(self.cell["traffic"])
        self.stop_bias = float(self.conf.get("weights", {}).get("stop_logit_bias", 0.0))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.t0 = self.last = t_start
        self.phases: Dict[str, float] = {}

    def mark(self, phase: str) -> None:
        now = time.monotonic()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self.last
        self.last = now

    @staticmethod
    def say(msg: str) -> None:
        print(msg, flush=True)

    # ---- set-up -----------------------------------------------------------

    def setup(self) -> None:
        import torch

        dev = self.dev = torch.device(self.device)
        if dev.type == "cuda" and (not torch.cuda.is_available()
                                   or torch.cuda.device_count() < int(self.cell["chips"])):
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoDevice(f"{self.cell['name']} needs {self.cell['chips']} CUDA "
                           f"device(s); this machine has {have}")
        from voice_tts_tpu_torch.config import TTSConfig
        from voice_tts_tpu_torch.engine.engine import (HashTokenizer, TTSEngine,
                                                       build_models)
        from voice_tts_tpu_torch.ops import counters
        from voice_tts_tpu_torch.serving.app import BackgroundServer

        from perfbench.service import Capture, TracedService
        weights = __import__(f"perfbench.reference.{self.conf['reference']}.weights",
                             fromlist=["make_models"])
        self.counters = counters
        if dev.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=dev)
        self.card = card_name_and_limit() if dev.type == "cuda" else "cpu"
        self.mark("imports_and_context")

        made = weights.make_models(weights.TTSConfig.from_dict(self.cfg), dev, self.seed,
                                   self.stop_bias)
        self._sync()
        self.mark("weights")
        pcfg = TTSConfig.from_dict(json.loads(json.dumps(self.cfg)))
        with torch.device("meta"):
            models = build_models(pcfg)
        for name, mod in models.items():
            mod.load_state_dict(made[name].state_dict(), strict=True, assign=True)
        del made
        engine = self.engine = TTSEngine(pcfg, models,
                                         HashTokenizer(pcfg.gpt.number_text_tokens), {}, dev)
        del models
        self._sync()
        self.mark("packs")

        self.service = TracedService(engine, self.conf["profile"], Capture(engine),
                                     self.trace, self.mix.get("trace_seconds"),
                                     dev.type == "cuda")
        mix = self.mix
        self.sched = traffic.schedule(mix, self.seed, self.seconds)
        self.voices = traffic.voices(mix, self.seed, self.sched)
        self.service._warm_replica(
            0, engine, traffic.voice_wav(self.seed, 999999, float(mix["prompt_seconds"])),
            "minimal")
        self.mark("warmup_minimal")
        for key, wav in self.voices.items():
            if not key.startswith("cold"):
                engine._prepare(wav, None, 1.0, None, False, "预热", 120)
        self.mark("voices")
        buckets = engine.cfg.engine.text_buckets
        texts = traffic.warm_texts(mix, self.seed, buckets, 8)
        g0 = self._graphs()
        for grp in warm_groups(mix, buckets, texts, self.voices, self.seed,
                               engine.cfg.gpt.number_text_tokens):
            self.service._infer_batch(engine, grp)
        self.warm_graphs = self._graphs() - g0
        self.mark("warmup_shapes")

        self.server = BackgroundServer(self.service)
        self.port = self.server.start()
        self.start_loadgen()
        self.mark("loadgen")

    def start_loadgen(self) -> None:
        """The load generator's process, every request body ready."""
        mix = self.mix
        self.child = subprocess.Popen(
            [sys.executable, str(HERE / "loadgen.py")], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        self._tell({"port": self.port, "loop": mix["loop"],
                    "clients": int(mix.get("clients", 1)),
                    "job_size": int(mix.get("job_size", 1)), "seconds": self.seconds,
                    "drain_s": float(mix["drain_s"]), "requests": self.sched,
                    "voices": {k: v.hex() for k, v in self.voices.items()}})
        if self._hear().get("ready") is not True:
            raise RuntimeError("the load generator did not start")

    def _sync(self) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _graphs(self) -> int:
        loops = self.engine.loops
        return loops.stats["graphs"] if loops is not None else 0

    def _tell(self, obj) -> None:
        self.child.stdin.write((obj if isinstance(obj, str) else json.dumps(obj)) + "\n")
        self.child.stdin.flush()

    def _hear(self):
        line = self.child.stdout.readline()
        if not line:
            raise RuntimeError("the load generator exited early")
        return json.loads(line)

    # ---- the window ---------------------------------------------------------

    def window(self) -> None:
        import torch

        engine, service = self.engine, self.service
        self.launches0 = self.counters.snapshot()
        n_batches0 = len(service.batch_sizes)
        g0 = self._graphs()
        self._sync()
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        service.recording = True
        self.t_go = time.monotonic()
        self.setup_s = self.t_go - self.t0
        self._tell("go")
        records = self._hear()["records"]
        self._sync()
        service.recording = False
        if self.trace:
            # on the replica's thread, after its calls
            service._executors[0].submit(service.stop_trace).result()
        self.memory_peak = (torch.cuda.max_memory_allocated(self.dev)
                            if self.dev.type == "cuda" else 0)
        self.launches = {k: v - self.launches0[k]
                         for k, v in self.counters.snapshot().items()}
        self.graphs_delta = self._graphs() - g0
        self.batch_sizes = service.batch_sizes[n_batches0:]
        self.spk_cache = (len(engine._spk_cache), engine._SPK_CACHE_CAP)
        by_id = {r["id"]: r for r in self.sched}
        vocab = self.cfg["gpt"]["number_text_tokens"]
        self.recs = []
        for r in records:
            q = by_id[r["id"]]
            ok = r["status"] == 200 and r["done"] is not None and r["error"] is None
            self.recs.append({**r, "ok": ok, "text": q["text"], "voice": q["voice"],
                              "text_len": len(hash_ids(q["text"], vocab)),
                              "cold": q["voice"].startswith("cold"),
                              "audio_s": r["n_samples"] / r["sr"] if ok and r["sr"] else 0.0})
        self.w_start, self.w_end = window_bounds(self.recs, self.t_go)
        self.calls = list(service.calls)
        for c in self.calls:
            c["launches"] = launches_of(c, self.cfg)
        self.dev_trace = None
        if service.prof is not None:
            self.dev_trace = tracing.read(service.prof, *service.trace_span,
                                          service.capture.spans)

    # ---- metrics ------------------------------------------------------------

    def end_to_end(self) -> Dict[str, float]:
        out = {"rtf": rtf(self.recs, self.w_start, self.w_end)}
        if self.mix["loop"] == "open":
            lat = latencies(self.sched, self.recs)
            out["latency_p90_s"] = percentile(lat, 0.90)
            out["latency_p50_s"] = percentile(lat, 0.50)
        out["setup_s"] = self.setup_s
        return out

    def context(self) -> Dict:
        """The per-layer readers' view (`reduce.py`): the traced engine
        calls and the requests they served, over the trace's span."""
        calls = [c for c in self.calls if c["traced"]]
        texts = {t for c in calls for t in c["texts"]}
        start, end = self.service.trace_span
        return {"cell": self.cell, "config": self.cfg, "mix": self.mix,
                "seconds": self.seconds,
                "window": {"start": start, "end": end, "seconds": end - start},
                "requests": [r for r in self.recs if r["text"] in texts],
                "calls": calls, "batch_sizes": [c["n"] for c in calls],
                "graphs_delta": self.graphs_delta, "launches": self.launches,
                "device": self.dev_trace, "card": self.card,
                "prompt_frames": costs.mel_frames(self.cfg, float(self.mix["prompt_seconds"])),
                "prompt_seconds": float(self.mix["prompt_seconds"])}

    def report_window(self, e2e: Dict) -> None:
        recs, mix = self.recs, self.mix
        n_ok = sum(r["ok"] for r in recs)
        self.say("setup phases (s): " + ", ".join(f"{k} {v:.4f}"
                                                  for k, v in self.phases.items())
                 + f"; setup_s {self.setup_s:.4f}; the warm pass captured "
                 f"{self.warm_graphs} graphs")
        self.say(f"card: {self.card}; window {self.w_end - self.w_start:.4f} s; "
                 f"{len(recs)} sent, {n_ok} finished; audio "
                 f"{sum(r['audio_s'] for r in recs):.4f} s; groups {self.batch_sizes}")
        if mix["loop"] == "open":
            late = [r["sent"] - r["due"] for r in recs if r["sent"] is not None]
            self.say(f"generator lateness: p50 {percentile(late, 0.5):.6f} s, p90 "
                     f"{percentile(late, 0.9):.6f} s, max {max(late, default=0.0):.6f} s "
                     f"over {len(late)} sends")
        cached = sum(not r["cold"] for r in recs)
        self.say(f"speaker cache: {cached} of {len(recs)} requests brought a voice "
                 f"cached at set-up (hit share {cached / max(len(recs), 1):.4f}); the "
                 f"cache held {self.spk_cache[0]} voices at the window's end "
                 f"(cap {self.spk_cache[1]})")
        self.say(f"window: {self.graphs_delta} graphs captured; launches "
                 + json.dumps({k: v for k, v in self.launches.items() if v}))
        self.say("end-to-end: " + json.dumps(e2e))

    # ---- after the window -------------------------------------------------

    def finish(self) -> tuple:
        """Stop and free the program: (the sample, the engine calls' stage
        records, the WAVs served to the sample)."""
        import torch

        self.server.stop()
        sample = self.sample()
        self._tell([r["id"] for r in sample])
        served = {int(k): bytes.fromhex(v) for k, v in self._hear().items()}
        self.child.stdin.close()
        self.child.wait(60)
        units = [{"units": c.pop("units")} for c in self.calls]
        self.service.capture.units = None
        self.engine = self.service = self.server = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return sample, units, served

    def reference(self, control: bool = False):
        pipeline = __import__(f"perfbench.reference.{self.conf['reference']}.pipeline",
                              fromlist=["Reference"])
        return pipeline.Reference(self.cfg, self.dev, self.seed, control=control,
                                  stop_logit_bias=self.stop_bias)

    def judge(self) -> Dict[str, Dict]:
        """Stop and free the program, then compare a sample with the
        reference (see `judge.py`)."""
        sample, units, served = self.finish()
        t = time.monotonic()
        numbers, detail = judge.judge(self.reference(), self.cfg, sample, units,
                                      self.voices, served)
        self.say("reference detail (worst a part): " + json.dumps(detail))
        failed = self.attempted() - sum(r["ok"] for r in self.recs)
        checks = {k: {"value": numbers[k], "limit": self.limits[k]}
                  for k in judge.NUMBERS if k in self.limits}
        checks["never_came"] = {"value": failed, "limit": 0}
        checks["judged"] = {"value": len(sample), "limit": 1}
        self.say(f"reference: {len(sample)} requests judged in "
                 f"{time.monotonic() - t:.4f} s")
        return checks

    def attempted(self) -> int:
        return len(self.sched) if self.mix["loop"] == "open" else len(self.recs)

    def sample(self) -> List[Dict]:
        """`sample` finished requests drawn from the seed, the longest
        (most audio, then most text) among them."""
        ok = sorted((r for r in self.recs if r["ok"]), key=lambda r: r["id"])
        if not ok:
            return []
        longest = max(ok, key=lambda r: (r["n_samples"], r["text_len"], -r["id"]))
        rest = [r for r in ok if r is not longest]
        k = min(int(self.mix["sample"]) - 1, len(rest))
        rng = np.random.default_rng([self.seed & (2 ** 64 - 1), 99])
        return [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]

    def close(self) -> None:
        """Stop what set-up started, whatever state the run is in."""
        if getattr(self, "server", None) is not None:
            self.server.stop()
        child = getattr(self, "child", None)
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(30)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             root: Optional[Path] = None, device: str = "cuda") -> Dict:
    """One run: {"result": the last line's object, "checks": the numbers
    compared with their limits}.  Raises NoDevice without the card."""
    run = Run(cell, seed, seconds, trace, t_start, root, device)
    try:
        run.setup()
        run.window()
        e2e = run.end_to_end()
        run.report_window(e2e)
        per_layer = {}
        if run.trace:
            per_layer, silent = run.reg.read_per_layer(run.cell["name"], run.context())
            for name, why in silent.items():
                run.say(f"per-layer {name}: {why}")
        checks = run.judge()
    finally:
        run.close()
    run.say(f"run: {time.monotonic() - t_start:.4f} s from the process's start")
    is_cuda = run.dev.type == "cuda"
    import torch
    device_info = {"platform": "gpu" if is_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.dev) if is_cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    if run.trace:
        metrics = per_layer
        if run.dev_trace is not None:
            device_info["busy_s"] = run.dev_trace["busy_s"]
            device_info["window_s"] = run.dev_trace["window_s"]
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in run.reg.end_to_end(run.cell["name"])}
    correct = all(v["value"] <= v["limit"] and not math.isnan(v["value"])
                  for k, v in checks.items() if k != "judged") and \
        checks["judged"]["value"] >= checks["judged"]["limit"]
    result = {"correct": bool(correct), "attempted": run.attempted(),
              "failed": checks["never_came"]["value"], "metrics": metrics,
              "device": device_info}
    if run.trace and run.dev_trace is not None:
        result["breakdown"] = run.dev_trace["breakdown"]
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    return {"result": result, "checks": checks}
