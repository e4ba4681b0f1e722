"""The TTS HTTP service on the PyTorch port: a queued multi-replica server
that groups concurrent requests (`voice_tts_tpu/serving/app.py`).

Endpoints: `GET /`, `GET /health`, `GET /debug/worker-info` (per replica:
device, flags, profile and the batching mode it runs), `GET /metrics`
(Prometheus text: the JAX server's counters and `tts_queue_depth`) and
`POST /tts` with the JAX server's error taxonomy (400 invalid JSON / input,
422 schema violation, 500 inference failure, 504 past
`server.request_timeout_s`).

Each engine replica has an asyncio queue and a worker task.  `--workers N`
loads min(N, cards) replicas, replica i on `cuda:i` (`to_device`), one on
the CPU; `/tts` requests go round-robin over the queues.  Every thread that
drives replica i (its executor, its batcher's threads, its warm-up) makes
`cuda:i` its current device first, since the kernels launch on the current
device's streams.  A worker runs in
one of two modes:

- grouped (default): it drains up to `server.max_batch_size` queued
  requests within a 20 ms gather window into one `engine.infer_batch` (a
  group of one into `engine.infer`, the single-request path), run on the
  replica's own one-thread executor (the engine is not thread-safe).  A watchdog rebuilds the replica from its factory after a
  fatal device error (`is_fatal_engine_error`) or
  `server.max_consecutive_failures` failures in a row: the old engine is
  dropped, then `gc.collect()` and `torch.cuda.empty_cache()` run, then the
  factory; a replica whose rebuild fails becomes an `_OfflineReplica`, and
  the next batch retries the rebuild.  A sticky CUDA error leaves the
  process's context unusable, so on the card such a rebuild fails and the
  replica stays offline: nothing here restarts the process;
- continuous (`--continuous-batching`, the sampling path with the fused
  decode pack): requests stream into a `ContinuousBatcher`
  (`engine/continuous.py`), whose slots admit new work mid-decode; its
  threads wake each request's future with `loop.call_soon_threadsafe`.  An
  engine that cannot run it (beam search, no fused pack) falls back to
  grouped mode with a warning, and worker-info reports the grouped mode.

Boot warm-up (`server.warmup`, `server.warmup_mode`) runs the request paths
before the workers start: "workload" one request per text bucket (a text of
each bucket, `_warm_texts`), through `infer` in grouped mode and through the
replica's ContinuousBatcher in continuous mode (its chunk graph, which the
worker then replays); in grouped mode `infer_batch` at every power-of-2
batch up to `max_batch_size`, then the same with the code-bucket estimate
off (the full-cap graphs); and in both modes the s2mel / vocoder of every
code bucket up to the cap at every batch, from synthetic codes (the JAX
warm-up relies on its decodes' lengths, and a decode that stops early
leaves the longer buckets to traffic); "minimal" one short request.
The graphs of other prompt buckets (a prompt of another length) are still
captured by their first request.  It logs
its time and the graphs it captured.  `amain` drains the queues on SIGTERM
/ SIGINT (`server.graceful_timeout_s`), then `shutdown` cancels and joins
the worker tasks, stops the batchers (failing what they still hold) and
shuts the executors down.

The flagship engine serves the production profile by default, as the JAX
server does (`serving_config`: beam search with 3 beams through K3 with the
ancestor table, int8 KV, folded readout, bf16 conditioning); `--profile
bench` serves the bench decode configuration (`bench_config`: sampling,
num_beams = 1 through K1, or K3 at per-row positions with
`--continuous-batching`).  `--tiny` takes the tiny config whatever the
profile.  `--model-dir DIR` serves a converted model directory
(`utils.artifacts`, written by `python -m voice_tts_tpu_torch.utils.onboard
--out DIR`) through `TTSEngine.from_artifacts`, each replica loading it onto
its own card: in the production profile by default, `--profile bench` the
bench profile, `--profile stock` the directory's config as saved.

    python -m voice_tts_tpu_torch.serving.app --port 8020            # flagship
    python -m voice_tts_tpu_torch.serving.app --model-dir /models/converted
    python -m voice_tts_tpu_torch.serving.app --profile bench --continuous-batching
    python -m voice_tts_tpu_torch.serving.app --workers 4            # 4 cards
    python -m voice_tts_tpu_torch.serving.app --tiny --device cpu    # demo
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import gc
import inspect
import os
import threading
import time
from typing import Callable, List, Optional

from voice_tts_tpu_torch.engine.device_loop import GATE
from voice_tts_tpu_torch.logging import logger
from voice_tts_tpu_torch.ops.fused_decode import MAX_ROWS
from voice_tts_tpu_torch.serving.audio_input import ApiError, get_audio_data
from voice_tts_tpu_torch.serving.http import HttpServer, Request, Response
from voice_tts_tpu_torch.serving.schemas import (TTSRequest, TTSResponse,
                                                 ValidationError)
from voice_tts_tpu_torch.text.emotion import create_emotion_vector

# the engine flags that select the port's code paths
_SERVED_FLAGS = ("use_fp16", "use_int8_decode", "use_fused_decode",
                 "use_int4_decode", "use_fused_batch_decode", "use_fused_beam_decode",
                 "fold_readout", "use_int8_kv", "use_bf16_conditioning",
                 "release_master_trees", "spec_decode_k", "use_bf16_s2mel",
                 "fuse_pipeline")
PROFILES = ("serving", "bench")
# a model directory may also be served with its config as saved
MODEL_DIR_PROFILES = PROFILES + ("stock",)
# seconds a grouped worker waits for more requests to join a batch
GATHER_WINDOW_S = 0.02

_FATAL_TAGS = ("CUDA error", "CUBLAS_STATUS", "device-side assert",
               "illegal memory access", "simulated device failure")


def is_fatal_engine_error(exc: BaseException) -> bool:
    """Errors that mean the ENGINE (not the request) is wedged: device or
    runtime failures after which a replica needs rebuilding (the in-process
    analogue of gunicorn's worker recycling)."""
    import torch

    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError, ReplicaOfflineError)):
        return True
    msg = str(exc)
    return any(tag in msg for tag in _FATAL_TAGS)


class ReplicaOfflineError(RuntimeError):
    """A batch sent to a replica whose rebuild failed (fatal: the watchdog
    retries the rebuild)."""


class _OfflineReplica:
    """Placeholder for a replica whose rebuild failed: every batch raises a
    fatal error so the worker's watchdog retries the rebuild."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = None

    def infer_batch(self, reqs):
        raise ReplicaOfflineError("replica offline (rebuild failed); retrying rebuild")

    def infer(self, *args, **kwargs):
        return self.infer_batch([kwargs])[0]


_SUSPENDABLE = (inspect.CO_COROUTINE | inspect.CO_GENERATOR | inspect.CO_ASYNC_GENERATOR
                | inspect.CO_ITERABLE_COROUTINE)


def _drop_frame_locals(exc: BaseException) -> None:
    """Clear the locals of the finished function frames in `exc`'s traceback
    (the failed engine is among them, and the futures keep the error), so
    that the rebuild can free it.  Coroutine and generator frames are left
    alone: clearing one would close it."""
    tb = exc.__traceback__
    while tb is not None:
        if not tb.tb_frame.f_code.co_flags & _SUSPENDABLE:
            try:
                tb.tb_frame.clear()
            except RuntimeError:         # a frame still executing
                pass
        tb = tb.tb_next


def _settle(fut: asyncio.Future, value) -> None:
    if fut.done():
        return
    if isinstance(value, BaseException):
        fut.set_exception(value)
    else:
        fut.set_result(value)


class TTSService:
    def __init__(self, engine=None, profile: Optional[str] = None):
        self.server = HttpServer()
        self.engines: List = [] if engine is None else [engine]
        self.profile = profile
        self._queues: List[asyncio.Queue] = []
        self._tasks: List[asyncio.Task] = []
        self._executors: List[concurrent.futures.ThreadPoolExecutor] = []
        self._batchers: dict = {}
        self._modes: dict = {}         # replica -> the mode its worker runs
        self._next = 0
        self._engine_factory: Optional[Callable[[int], object]] = None
        self.metrics = {
            "tts_requests_total": 0, "tts_requests_failed": 0,
            "tts_inference_seconds_total": 0.0,
            "tts_audio_seconds_total": 0.0, "tts_batches_total": 0,
            "tts_batched_requests_total": 0,
            "tts_replica_rebuilds_total": 0,
        }
        self.batch_sizes: List[int] = []   # requests of each grouped batch
        self.warmup_stats: dict = {}
        self._register_routes()

    # ------------------------------------------------------------------
    # replicas
    # ------------------------------------------------------------------

    def load_engines(self, workers: int = 1, tiny: bool = False, continuous: bool = False,
                     profile: str = "serving", device: str = "cuda",
                     model_dir: Optional[str] = None):
        """Build min(workers, cards) replicas (one off the card), replica i
        on cuda:i (from `model_dir` when given, see `build_engine`), then
        warm them up unless `server.warmup` is off (the tiny engine skips
        it, as in the JAX server)."""
        import torch

        from voice_tts_tpu_torch.engine.engine import on_device, resolve_device

        dev = resolve_device(device)
        n = max(1, min(workers, torch.cuda.device_count())) if dev.type == "cuda" else 1
        self.profile = "tiny" if tiny else profile

        def factory(i: int):
            # replica i on card i (every replica on one card would serialise
            # on it), built there from whichever thread calls
            card = f"cuda:{i}" if n > 1 else None
            with on_device(card):
                engine = build_engine(tiny, device, profile=profile, continuous=continuous,
                                      model_dir=model_dir)
                if continuous:
                    engine.cfg.server.continuous_batching = True
                if card is not None:
                    engine.to_device(card)
            return engine

        self._engine_factory = factory
        for i in range(n):
            self.engines.append(factory(i))
        logger.success("loaded %d engine replica(s) on %s", len(self.engines),
                       [str(e.device) for e in self.engines])
        if not tiny and self.engines[0].cfg.server.warmup:
            self._warmup()

    @staticmethod
    def _warm_texts(engine) -> List[str]:
        """One text per configured text bucket (its token count lands in the
        bucket), so every decode graph a request can touch is captured
        before /health goes ready; a bucket the unit step overshoots is
        left to its first request."""
        buckets = engine.cfg.engine.text_buckets
        unit = "预热一下模型编译。"
        texts, lo = [], 0
        for tb in buckets:
            txt = unit
            while (len(engine.tokenizer.tokenize(txt)) <= lo
                   and len(txt) < 8 * (tb + len(unit))):
                txt += unit
            n = len(engine.tokenizer.tokenize(txt))
            if lo < n <= tb:
                texts.append(txt)
            else:
                logger.warning("warmup: no text landed in bucket %d (unit step too "
                               "coarse); it will capture on first use", tb)
            lo = tb
        return texts or ["预热。"]

    def _warmup(self):
        """Run the request paths BEFORE /health goes ready, so that traffic
        captures no graph (`server.warmup_mode`, see the module docstring),
        then the synthesis of every code bucket at every batch
        (`_warm_synthesis`).  Continuous mode sends its warm-up requests
        through the replica's ContinuousBatcher (the conditioning, the
        chunk graph) and runs no `infer` / `infer_batch`: its slots run none
        of those decodes."""
        import numpy as np

        from voice_tts_tpu_torch.audio import encode_wav_int16
        from voice_tts_tpu_torch.engine.engine import on_device

        sr = 16000
        t = np.arange(2 * sr) / sr
        wav = encode_wav_int16((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr)
        t0 = time.time()
        mode = self.engines[0].cfg.server.warmup_mode
        graphs0 = sum(e.loops.stats["graphs"] for e in self.engines if e.loops is not None)
        for i, engine in enumerate(self.engines):
            try:
                with on_device(engine.device):
                    self._warm_replica(i, engine, wav, mode)
            except Exception as exc:  # noqa: BLE001 - warm-up is best-effort
                logger.warning("warmup failed on replica %d: %s", i, exc)
                batcher = self._batchers.pop(i, None)
                if batcher is not None:
                    batcher.stop()
        graphs = sum(e.loops.stats["graphs"] for e in self.engines
                     if e.loops is not None) - graphs0
        self.warmup_stats = {"mode": mode, "seconds": time.time() - t0, "graphs": graphs}
        logger.info("warmup (%s) done in %.1f s, %d graphs captured", mode,
                    self.warmup_stats["seconds"], graphs)

    def _warm_replica(self, i: int, engine, wav: bytes, mode: str) -> None:
        """Replica i's warm-up (see `_warmup`), on its card."""
        texts = ["预热。"] if mode == "minimal" else self._warm_texts(engine)
        max_b = max(1, engine.cfg.server.max_batch_size)
        if self._continuous(engine):
            batcher = self._batcher(i, engine)
            pairs = [batcher.submit({"spk_audio_prompt": wav, "text": txt})
                     for txt in texts]
            batcher.run()
            for holder, _ in pairs:
                if isinstance(holder[0], Exception):
                    raise holder[0]
            if mode != "minimal":
                self._warm_synthesis(engine, wav, texts[0], min(max_b, MAX_ROWS))
            return
        for txt in texts:
            engine.infer(wav, txt)
        if mode == "minimal":
            return
        b = 2
        while b <= max_b:
            for txt in texts:
                engine.infer_batch([{"spk_audio_prompt": wav, "text": txt}] * b)
            b *= 2
        # the full-cap graphs: with real weights the decodes above stop
        # before the estimated cap, so the full-cap retry an over-long
        # request needs would capture mid-traffic
        auto = engine.cfg.engine.auto_code_bucket
        if auto:
            engine.cfg.engine.auto_code_bucket = False
            try:
                for txt in texts:
                    engine.infer(wav, txt)
                for b in {2, max_b} - {1}:
                    engine.infer_batch(
                        [{"spk_audio_prompt": wav, "text": texts[-1]}] * b)
            finally:
                engine.cfg.engine.auto_code_bucket = auto
        self._warm_synthesis(engine, wav, texts[0], max_b)

    @staticmethod
    def _warm_synthesis(engine, wav: bytes, text: str, max_b: int) -> None:
        """The s2mel / vocoder graphs of every code bucket up to the cap's
        at every power-of-2 batch up to max_b.  A decode's length depends on
        its data (a warm-up request may stop long before the cap), so jobs
        of synthetic codes, each bucket's length, stand in for decodes."""
        import numpy as np
        import torch

        from voice_tts_tpu_torch.engine import post

        cfg, e = engine.cfg, engine.cfg.engine
        spk, emovec, segments = engine._prepare(wav, None, 1.0, None, False, text, 120)
        ids = engine.tokenizer.convert_tokens_to_ids(segments[0])
        bucket = post.pick_bucket(len(ids), e.text_buckets)
        ids = ids[:bucket]
        cap = post.pick_bucket(cfg.generation.max_mel_tokens, tuple(e.code_buckets))
        vocab = min(cfg.gpt.number_mel_codes - 2, cfg.semantic_codec.codebook_size)
        for cbucket in (c for c in e.code_buckets if c <= cap):
            codes = np.arange(cbucket) % vocab
            b = 1
            while b <= max_b:
                engine._mel_jobs([{"bucket": bucket, "text_row": torch.tensor(ids),
                                   "text_len": len(ids), "codes": codes,
                                   "code_len": cbucket, "spk": spk, "emovec": emovec}
                                  for _ in range(b)], cbucket)
                b *= 2

    @staticmethod
    def _continuous(engine) -> bool:
        """Whether a worker of `engine` runs continuous batching: asked for,
        and the engine can (one beam, a fused decode pack)."""
        return bool(engine.cfg.server.continuous_batching
                    and engine.cfg.generation.num_beams == 1
                    and getattr(engine, "fused_pack", None) is not None)

    # ------------------------------------------------------------------
    # workers
    # ------------------------------------------------------------------

    async def start_workers(self):
        from voice_tts_tpu_torch.engine.engine import use_device

        for i, engine in enumerate(self.engines):
            q: asyncio.Queue = asyncio.Queue()
            self._queues.append(q)
            # the replica's thread runs on its card (the kernels launch on
            # the current device's streams)
            self._executors.append(concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"tts-replica-{i}",
                initializer=use_device, initargs=(engine.device,)))
            self._tasks.append(asyncio.create_task(self._worker(i, engine, q)))

    async def _worker(self, idx: int, engine, q: asyncio.Queue):
        loop = asyncio.get_running_loop()
        scfg = engine.cfg.server
        if scfg.continuous_batching:
            try:
                await self._continuous_worker(idx, engine, q)
                return
            except ValueError as e:
                # beam search or no fused pack: grouped fallback
                logger.warning("continuous batching unavailable on replica %d (%s); "
                               "falling back to grouped infer_batch", idx, e)
        self._modes[idx] = "grouped"
        failures = 0
        while True:
            fut, req = await q.get()
            batch = [(fut, req)]
            try:
                # a short gather window lets concurrent requests coalesce
                deadline = loop.time() + GATHER_WINDOW_S
                while len(batch) < max(1, scfg.max_batch_size):
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(q.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                reqs = [r for _, r in batch]
                self.metrics["tts_batches_total"] += 1
                self.metrics["tts_batched_requests_total"] += len(reqs)
                self.batch_sizes.append(len(reqs))
                try:
                    results = await loop.run_in_executor(
                        self._executors[idx], self._infer_batch, engine, reqs)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 - fail this batch
                    for f, _ in batch:
                        _settle(f, e)
                    failures += 1
                    if not (is_fatal_engine_error(e)
                            or failures >= scfg.max_consecutive_failures):
                        continue
                    # watchdog: a fatal device error, or a replica that keeps
                    # failing whatever it is fed, is REBUILT from the factory
                    logger.warning("replica %d wedged (%r, %d consecutive failures); "
                                   "rebuilding", idx, e, failures)
                    _drop_frame_locals(e)
                    old_cfg = engine.cfg
                    self.engines[idx] = engine = None
                    try:
                        engine = await loop.run_in_executor(
                            self._executors[idx], self._rebuild, idx)
                        self.metrics["tts_replica_rebuilds_total"] += 1
                        failures = 0
                        logger.success("replica %d rebuilt", idx)
                    except Exception:  # noqa: BLE001
                        logger.exception("replica %d rebuild failed; replica offline - "
                                         "the next batch retries the rebuild", idx)
                        engine = _OfflineReplica(old_cfg)
                    self.engines[idx] = engine
                    scfg = engine.cfg.server
                    continue
                for (f, _), res in zip(batch, results):
                    _settle(f, res)
                failures = 0
            except asyncio.CancelledError:
                for f, _ in batch:
                    _settle(f, RuntimeError("the service is shutting down"))
                raise

    @staticmethod
    def _infer_batch(engine, reqs):
        """A group through `infer_batch`; a group of one through `infer`,
        the single-request path (speculative decode, the segment routing,
        the stage timers in `last_metrics`), which `infer_batch` lacks."""
        with GATE.shared():
            if len(reqs) == 1:
                return [engine.infer(**reqs[0])]
            return engine.infer_batch(reqs)

    def _rebuild(self, idx: int):
        """Free what the dropped engine held, then build replica idx anew."""
        import torch

        with GATE.shared():
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            return self._engine_factory(idx)

    def _batcher(self, idx: int, engine):
        """Replica idx's ContinuousBatcher, made at its first use (the
        warm-up's, whose chunk graph traffic then replays); ValueError when
        the engine cannot run it."""
        from voice_tts_tpu_torch.engine.continuous import ContinuousBatcher

        if idx not in self._batchers:
            self._batchers[idx] = ContinuousBatcher(
                engine, chunk_steps=engine.cfg.server.chunk_steps)
        return self._batchers[idx]

    async def _continuous_worker(self, idx: int, engine, q: asyncio.Queue):
        """Stream requests into the replica's ContinuousBatcher (ValueError
        when the engine cannot run it)."""
        loop = asyncio.get_running_loop()
        batcher = self._batcher(idx, engine)
        self._modes[idx] = "continuous"
        batcher.start()

        def waker(fut):
            def wake(holder):
                try:
                    loop.call_soon_threadsafe(_settle, fut, holder[0])
                except RuntimeError:     # the loop has closed: nobody waits
                    pass
            return wake

        while True:
            fut, req = await q.get()
            self.metrics["tts_batches_total"] += 1
            self.metrics["tts_batched_requests_total"] += 1
            batcher.submit(req, callback=waker(fut))

    async def submit(self, req: dict, timeout: Optional[float] = None):
        q = self._queues[self._next % len(self._queues)]
        self._next += 1
        fut = asyncio.get_running_loop().create_future()
        await q.put((fut, req))
        if timeout:
            return await asyncio.wait_for(fut, timeout)
        return await fut

    async def drain(self, graceful_timeout: float = 30.0) -> bool:
        """Wait for queued work to finish (the reference's
        `graceful_timeout=30`).  Returns True if everything drained in
        time."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + graceful_timeout
        while any(q.qsize() for q in self._queues):
            if loop.time() >= deadline:
                return False
            await asyncio.sleep(0.05)
        # one gather window, so that in-flight batches finish dispatching
        await asyncio.sleep(0.1)
        return True

    async def shutdown(self) -> None:
        """Cancel and join the worker tasks (their in-flight requests and
        the queued ones fail), stop the batchers and shut the executors
        down, on the loop that runs the workers."""
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        for q in self._queues:
            while not q.empty():
                fut, _ = q.get_nowait()
                _settle(fut, RuntimeError("the service is shutting down"))
        await asyncio.get_running_loop().run_in_executor(None, self.close)

    def close(self) -> None:
        """Stop the batchers and shut the executors down (blocking)."""
        for batcher in self._batchers.values():
            batcher.stop()
        self._batchers = {}
        for ex in self._executors:
            ex.shutdown(wait=True)
        self._executors = []

    # ------------------------------------------------------------------
    # routes
    # ------------------------------------------------------------------

    def _replica_info(self, i: int, e) -> dict:
        mode = self._modes.get(i) or ("continuous" if self._continuous(e) else "grouped")
        info = {"replica": i,
                "device": str(e.device) if e.device is not None else "default",
                "offline": isinstance(e, _OfflineReplica),
                "profile": self.profile,
                "mode": mode, "continuous_batching": mode == "continuous",
                "num_beams": e.cfg.generation.num_beams,
                "tensor_parallel": e.cfg.engine.tensor_parallel,
                "engine_flags": {k: getattr(e.cfg.engine, k) for k in _SERVED_FLAGS}}
        batcher = self._batchers.get(i)
        if batcher is not None:
            info["slots"] = batcher.slots
            info["chunk_steps"] = batcher.chunk_steps
        return info

    def _register_routes(self):
        s = self.server

        @s.route("GET", "/")
        async def root(req: Request) -> Response:
            return Response({"status": "running", "model_loaded": bool(self.engines),
                             "service": "voice-tts-tpu API Server (PyTorch port)",
                             "version": "2.0"})

        @s.route("GET", "/health")
        async def health(req: Request) -> Response:
            if not self.engines:
                return Response({"detail": "Model not loaded"}, 503)
            return Response({"status": "healthy", "model_loaded": True,
                             "deepspeed_enabled": False})

        @s.route("GET", "/debug/worker-info")
        async def worker_info(req: Request) -> Response:
            import torch

            return Response({
                "worker_id": os.environ.get("WORKER_ID", "0"),
                "pid": os.getpid(),
                "backend": "torch",
                "torch": torch.__version__,
                "devices": [{"id": i, "platform": "gpu",
                             "kind": torch.cuda.get_device_name(i)}
                            for i in range(torch.cuda.device_count())],
                "model_info": {"loaded": bool(self.engines),
                               "replicas": len(self.engines)},
                "replicas": [self._replica_info(i, e) for i, e in enumerate(self.engines)
                             if e is not None],   # None: mid-rebuild
            })

        @s.route("GET", "/metrics")
        async def metrics(req: Request) -> Response:
            """Prometheus text exposition."""
            lines = []
            for key, val in self.metrics.items():
                lines += [f"# TYPE {key} counter", f"{key} {val}"]
            lines.append("# TYPE tts_queue_depth gauge")
            lines.append(f"tts_queue_depth {sum(q.qsize() for q in self._queues)}")
            return Response("\n".join(lines) + "\n",
                            content_type="text/plain; version=0.0.4")

        @s.route("POST", "/tts")
        async def tts(req: Request) -> Response:
            if not self.engines:
                return Response({"detail": "Model not loaded"}, 503)
            try:
                body = req.json()
            except ValueError:
                return Response({"detail": "invalid JSON body"}, 400)
            try:
                request = TTSRequest.from_json(body)
            except ValidationError as e:
                return Response({"detail": e.errors()}, 422)
            loop = asyncio.get_running_loop()
            try:
                spk_audio = await loop.run_in_executor(None, get_audio_data,
                                                       request.spk_audio)
                emo_audio = emo_vector = None
                if request.emo_audio:
                    emo_audio = await loop.run_in_executor(None, get_audio_data,
                                                           request.emo_audio)
                elif request.emotion is not None:
                    if isinstance(request.emotion, str):
                        emo_vector = create_emotion_vector(request.emotion,
                                                           request.emo_alpha)
                    else:
                        emo_vector = create_emotion_vector(request.emotion)
                start = time.time()
                self.metrics["tts_requests_total"] += 1
                live = next((e for e in self.engines if e is not None), None)
                timeout = live.cfg.server.request_timeout_s if live is not None else None
                try:
                    result = await self.submit({
                        "spk_audio_prompt": spk_audio, "text": request.text,
                        "emo_audio_prompt": emo_audio,
                        "emo_alpha": request.emo_alpha if emo_audio else 1.0,
                        "emo_vector": emo_vector}, timeout=timeout)
                except asyncio.TimeoutError:
                    self.metrics["tts_requests_failed"] += 1
                    return Response({"detail": "inference timed out"}, 504)
                inference_time = time.time() - start
                self.metrics["tts_inference_seconds_total"] += inference_time
                from voice_tts_tpu_torch.audio import encode_wav_int16

                wav_bytes = encode_wav_int16(result.wav, result.sample_rate)
                audio_length = len(result.wav) / result.sample_rate
                self.metrics["tts_audio_seconds_total"] += audio_length
                return Response(TTSResponse(
                    audio_hex=wav_bytes.hex(), audio_length=audio_length,
                    inference_time=inference_time,
                    rtf=inference_time / audio_length if audio_length else 0.0,
                    text=request.text).model_dump())
            except ApiError as e:
                self.metrics["tts_requests_failed"] += 1
                return Response({"detail": e.detail}, e.status)
            except ValueError as e:
                self.metrics["tts_requests_failed"] += 1
                return Response({"detail": str(e)}, 400)
            except Exception as e:  # noqa: BLE001 - request boundary
                self.metrics["tts_requests_failed"] += 1
                logger.exception("TTS inference failed")
                return Response({"detail": f"TTS inference failed: {e}"}, 500)


class BackgroundServer:
    """Run a service's workers and HTTP server on an event loop of their
    own in a thread (`start` returns once the port is bound; `stop` shuts
    the service down on that loop, then stops it)."""

    def __init__(self, service: TTSService, host: str = "127.0.0.1", port: int = 0):
        self.service, self.host, self.port = service, host, port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, timeout: float = 30.0) -> int:
        ready = threading.Event()
        errors = []

        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            try:
                loop.run_until_complete(self.service.start_workers())
                self._server = loop.run_until_complete(asyncio.start_server(
                    self.service.server._handle, self.host, self.port))
                self.port = self._server.sockets[0].getsockname()[1]
            except OSError as e:
                errors.append(e)
                ready.set()
                loop.run_until_complete(self.service.shutdown())
                loop.close()
                return
            ready.set()
            try:
                loop.run_forever()
            finally:
                self._server.close()
                loop.run_until_complete(self._server.wait_closed())
                loop.run_until_complete(loop.shutdown_default_executor())
                loop.close()

        self._thread = threading.Thread(target=run, name="tts-http", daemon=True)
        self._thread.start()
        if not ready.wait(timeout):
            raise TimeoutError("HTTP server did not start")
        if errors:
            raise errors[0]
        return self.port

    def run(self, coro, timeout: Optional[float] = None):
        """Run a coroutine on the server's loop from another thread."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout)

    def stop(self, timeout: float = 60.0) -> None:
        if self._loop is not None and self._thread is not None:
            self.run(self.service.shutdown(), timeout)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("HTTP server thread did not stop")


def build_engine(tiny: bool, device: str, seed: int = 0, profile: str = "serving",
                 continuous: bool = False, model_dir: Optional[str] = None):
    """The served engine: with `model_dir` the converted model directory
    there (`TTSEngine.from_artifacts`) in the production profile
    (`serving`, the default), the bench profile (`bench`) or its config as
    saved (`stock`); else random weights at the flagship widths in the
    production profile or the bench configuration, or the tiny
    configuration for demos (with `continuous`, the int8 trunk and fused
    decode pack the slot scheduler needs)."""
    from voice_tts_tpu_torch.engine.engine import (TTSEngine, bench_config,
                                                   serving_config)

    if model_dir:
        if profile not in MODEL_DIR_PROFILES:
            raise ValueError(f"unknown profile {profile!r} "
                             f"(expected one of {MODEL_DIR_PROFILES})")
        return TTSEngine.from_artifacts(model_dir, profile=profile, device=device)
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r} (expected one of {PROFILES}; "
                         f"'stock' needs --model-dir)")
    if tiny:
        flags = dict(use_int8_decode=True, use_fused_decode=True) if continuous else {}
        return TTSEngine.tiny(device=device, seed=seed, **flags)
    cfg = serving_config() if profile == "serving" else bench_config()
    return TTSEngine.random(cfg, device=device, seed=seed)


async def amain(args):
    import signal

    service = TTSService()
    service.load_engines(args.workers, tiny=args.tiny, continuous=args.continuous_batching,
                         profile=args.profile, device=args.device, model_dir=args.model_dir)
    await service.start_workers()
    cfg = service.engines[0].cfg
    logger.info("serving on %s:%d (%d replica(s), profile %s, num_beams %d, modes %s, "
                "flags %s)", args.host, args.port, len(service.engines), service.profile,
                cfg.generation.num_beams,
                [service._replica_info(i, e)["mode"] for i, e in enumerate(service.engines)],
                {k: getattr(cfg.engine, k) for k in _SERVED_FLAGS})
    # graceful shutdown: SIGTERM / SIGINT stop the accept loop and queued
    # work drains for up to graceful_timeout_s
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    serve_task = asyncio.create_task(service.server.serve(args.host, args.port))
    stop_task = asyncio.create_task(stop.wait())
    done, _ = await asyncio.wait({serve_task, stop_task},
                                 return_when=asyncio.FIRST_COMPLETED)
    if stop_task in done:
        logger.info("shutdown signal received; draining request queues")
        drained = await service.drain(cfg.server.graceful_timeout_s)
        logger.info("drained" if drained else "graceful timeout hit")
    serve_task.cancel()
    stop_task.cancel()
    await asyncio.gather(serve_task, stop_task, return_exceptions=True)
    await service.shutdown()
    if serve_task in done and not serve_task.cancelled():
        serve_task.result()


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="voice-tts-tpu API server (PyTorch port)")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8020)
    parser.add_argument("--workers", type=int, default=1,
                        help="engine replicas, one a card (at most the cards present)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--model-dir", type=str, default=None,
                        help="converted model directory (utils.onboard --out)")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random-weight engine (demo / testing)")
    parser.add_argument("--profile", type=str, default="serving",
                        choices=MODEL_DIR_PROFILES,
                        help="'serving' (default): the production profile, "
                             "beam-3 with int8 KV; 'bench': sampling, one beam; "
                             "'stock' (with --model-dir): the directory's config "
                             "as saved")
    parser.add_argument("--continuous-batching", action="store_true",
                        help="slot-based continuous batching: requests join a "
                             "running decode batch mid-flight (needs the fused "
                             "decode pack and one beam: --profile bench)")
    parser.add_argument("--log-level", type=str, default="info",
                        choices=["critical", "error", "warning", "info",
                                 "debug", "trace"])
    return parser.parse_args(argv)


def main():
    args = parse_args()
    logger.set_level(args.log_level)
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
