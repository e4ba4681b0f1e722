"""The port's queued service (`voice_tts_tpu_torch/serving/app.py`) on tiny
engines, mirroring the JAX server's tests (`tests/test_serving.py`): root,
health and worker-info, a `/tts` round trip and the same body through the
JAX service (the same status, the WAV within 8 LSB with the JAX engine's
CFM noise handed to the port), the error taxonomy over HTTP, `/metrics`,
concurrent requests coalesced into one `infer_batch` (a lone one through
`infer`), the watchdog
(a simulated `torch.cuda.OutOfMemoryError`, a "CUDA error" message,
`max_consecutive_failures`, an offline replica retrying its rebuild),
drain, warm-up coverage, continuous mode and the beam profile's grouped
fallback as worker-info reports them, and a shutdown that leaves no task
pending and no request waiting."""

import asyncio
import http.client
import json
import logging
import time

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.audio import decode_audio_bytes, encode_wav_int16
from voice_tts_tpu_torch.engine.engine import InferenceResult, TTSEngine, tiny_config
from voice_tts_tpu_torch.serving import app
from voice_tts_tpu_torch.serving.http import Request

pytest_plugins = ("port_fixtures",)


def prompt_wav(f0: float = 220.0) -> bytes:
    """1 s at 16 kHz: a tone plus white noise (as `test_torch_engine.py`)."""
    sr = 16000
    t = np.arange(sr) / sr
    noise = np.random.default_rng(int(f0)).standard_normal(sr)
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * noise
    return encode_wav_int16((x * 32767).astype(np.float32), sr)


def _greedy(engine, max_new: int = 16):
    g = engine.cfg.generation
    g.do_sample, g.num_beams, g.max_mel_tokens = False, 1, max_new
    return engine


def _request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    payload = raw if raw is not None else (json.dumps(body) if body is not None else None)
    conn.request(method, path, body=payload,
                 headers={"Content-Type": "application/json"} if payload else {})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    try:
        data = json.loads(data)
    except ValueError:
        pass
    return resp.status, data


@pytest.fixture(scope="module")
def server():
    """A tiny port engine served over HTTP in grouped mode."""
    service = app.TTSService(_greedy(TTSEngine.tiny(device="cpu")), profile="tiny")
    srv = app.BackgroundServer(service)
    port = srv.start()
    yield service, port
    srv.stop()


def test_root_health_and_worker_info(server):
    _, port = server
    status, data = _request(port, "GET", "/")
    assert status == 200 and data["model_loaded"] is True
    status, data = _request(port, "GET", "/health")
    assert status == 200 and data["status"] == "healthy"
    status, data = _request(port, "GET", "/debug/worker-info")
    assert status == 200 and data["model_info"] == {"loaded": True, "replicas": 1}
    info = data["replicas"][0]
    assert {"replica", "device", "tensor_parallel", "engine_flags", "num_beams",
            "offline", "profile", "mode", "continuous_batching"} <= set(info)
    assert info["mode"] == "grouped" and info["continuous_batching"] is False
    assert info["device"] == "cpu" and not info["offline"]
    assert {"use_int8_decode", "use_fused_decode", "use_fused_batch_decode",
            "use_fused_beam_decode", "use_int8_kv", "fuse_pipeline"} <= set(info["engine_flags"])


def test_error_taxonomy_over_http(server):
    _, port = server
    prompt = prompt_wav().hex()
    assert _request(port, "POST", "/tts", {"text": "x.", "spk_audio": "not-audio"})[0] == 400
    assert _request(port, "POST", "/tts", {"text": "x.", "spk_audio": prompt,
                                           "emo_alpha": 3.0})[0] == 422
    assert _request(port, "POST", "/tts", raw="{not json")[0] == 400
    assert _request(port, "GET", "/nope")[0] == 404
    assert _request(port, "GET", "/tts")[0] == 405
    # a decodable hex string that is no WAV fails inside the engine: 400
    assert _request(port, "POST", "/tts", {"text": "x.", "spk_audio": "ab" * 80})[0] == 400


def test_tts_roundtrip_and_metrics(server):
    """A round trip (a decodable 22.05 kHz WAV and the response fields),
    one with an emotion label, then the counters of /metrics."""
    service, port = server
    before = dict(service.metrics)
    status, data = _request(port, "POST", "/tts", {"text": "hi there.",
                                                   "spk_audio": prompt_wav().hex()})
    assert status == 200, data
    assert {"audio_hex", "audio_length", "inference_time", "rtf", "text"} <= set(data)
    wav, sr = decode_audio_bytes(bytes.fromhex(data["audio_hex"]))
    assert sr == 22050 and wav.size > 0 and data["audio_length"] > 0
    status, data = _request(port, "POST", "/tts", {"text": "hello.",
                                                   "spk_audio": prompt_wav().hex(),
                                                   "emotion": "happy", "emo_alpha": 0.7})
    assert status == 200, data
    status, body = _request(port, "GET", "/metrics")
    assert status == 200
    values = dict(line.split() for line in body.splitlines() if not line.startswith("#"))
    assert float(values["tts_requests_total"]) - before["tts_requests_total"] >= 2
    assert float(values["tts_batches_total"]) >= 2
    assert float(values["tts_audio_seconds_total"]) > 0
    assert values["tts_queue_depth"] == "0"
    assert "tts_replica_rebuilds_total" in values and "tts_requests_failed" in values


@pytest.fixture
def greedy_engines(jax_tiny, jax_port):
    """The shared tiny JAX engine and the port's converted from it, greedy."""
    jeng = _greedy(jax_tiny())
    return jeng, _greedy(jax_port(jeng))


def test_tts_matches_the_jax_service(greedy_engines, monkeypatch):
    """The same /tts bodies through the JAX service and the port's, on one
    tiny engine (the port's converted from the JAX one), greedy: the same
    statuses, and the round trip's WAV within 8 LSB of int16 with the JAX
    engine's CFM noise handed to the port."""
    jax = pytest.importorskip("jax")
    from voice_tts_tpu.serving.app import TTSService as JaxService

    jeng, peng = greedy_engines
    keys, chain = [], jeng._s2mel_chain

    def rec(*args, **kwargs):
        keys.append(args[9])
        return chain(*args, **kwargs)
    monkeypatch.setattr(jeng, "_s2mel_chain", rec)
    monkeypatch.setattr(peng, "_draw_noise", lambda shape: torch.from_numpy(
        np.array(jax.random.normal(keys.pop(0), tuple(shape)))))
    jsvc = JaxService()
    jsvc.engines.append(jeng)
    psvc = app.TTSService(peng)
    bodies = [json.dumps({"text": "hello world.", "spk_audio": prompt_wav().hex()}),
              json.dumps({"text": "x.", "spk_audio": prompt_wav().hex(), "emo_alpha": 2}),
              "{not json"]

    async def serve(svc):
        await svc.start_workers()
        handler = svc.server.routes[("POST", "/tts")]
        out = [await handler(Request("POST", "/tts", {}, b.encode())) for b in bodies]
        if svc is psvc:
            await svc.shutdown()
        return out
    ref = asyncio.run(serve(jsvc))
    out = asyncio.run(serve(psvc))
    assert [r.status for r in out] == [r.status for r in ref] == [200, 422, 400]
    wavs = [np.frombuffer(bytes.fromhex(r.payload["audio_hex"])[44:], np.int16).astype(np.int32)
            for r in (ref[0], out[0])]
    assert wavs[0].shape == wavs[1].shape and wavs[0].size > 0
    assert np.abs(wavs[0] - wavs[1]).max() <= 8


# ---------------------------------------------------------------------------
# queueing, watchdog, drain (fake engines: the queue's logic, not the model)
# ---------------------------------------------------------------------------

class FakeEngine:
    """Stands in for an engine: `infer_batch` records its groups and returns
    one short result a request, or raises `error`."""

    def __init__(self, error=None, delay: float = 0.0):
        self.cfg = tiny_config()
        self.device = "cpu"
        self.fused_pack = None
        self.error, self.delay = error, delay
        self.groups = []

    def infer_batch(self, reqs):
        self.groups.append(len(reqs))
        time.sleep(self.delay)
        if self.error is not None:
            raise self.error
        return [InferenceResult(np.ones(100, np.int16), 22050, {}) for _ in reqs]

    def infer(self, spk_audio_prompt, text, **kwargs):
        self.singles = getattr(self, "singles", 0) + 1
        return self.infer_batch([{"spk_audio_prompt": spk_audio_prompt, "text": text}])[0]


REQ = {"spk_audio_prompt": b"", "text": "hi."}


def test_concurrent_requests_coalesce_into_one_batch():
    """Requests queued together form one `infer_batch` of all of them (up
    to max_batch_size); the counters count one batch."""
    eng = FakeEngine()
    service = app.TTSService(eng)

    async def scenario():
        await service.start_workers()
        out = await asyncio.gather(*(service.submit(dict(REQ)) for _ in range(5)))
        await service.shutdown()
        return out
    out = asyncio.run(scenario())
    assert len(out) == 5 and eng.groups == [5]
    assert service.metrics["tts_batches_total"] == 1
    assert service.metrics["tts_batched_requests_total"] == 5
    assert service.batch_sizes == [5] and not getattr(eng, "singles", 0)


def test_a_lone_request_runs_infer():
    """A group of one runs `infer`, the single-request path, not
    `infer_batch`."""
    eng = FakeEngine()
    service = app.TTSService(eng)

    async def scenario():
        await service.start_workers()
        out = await service.submit(dict(REQ))
        await service.shutdown()
        return out
    assert asyncio.run(scenario()).wav.size > 0
    assert eng.singles == 1 and service.batch_sizes == [1]


def test_spy_on_a_real_engine_coalesces():
    """Three concurrent requests on a tiny engine: one `infer_batch` call
    of three requests (a spy), each result a WAV."""
    eng = _greedy(TTSEngine.tiny(device="cpu"), max_new=8)
    calls = []
    infer_batch = eng.infer_batch

    def spy(reqs):
        calls.append(len(reqs))
        return infer_batch(reqs)
    eng.infer_batch = spy
    service = app.TTSService(eng)

    async def scenario():
        await service.start_workers()
        reqs = [{"spk_audio_prompt": prompt_wav(220.0 + i), "text": t}
                for i, t in enumerate(("hi.", "one two.", "hello world."))]
        out = await asyncio.gather(*(service.submit(r) for r in reqs))
        await service.shutdown()
        return out
    out = asyncio.run(scenario())
    assert calls == [3] and all(r.wav.size > 0 for r in out)


@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["oom", "cuda_error"])
def test_watchdog_rebuilds_on_a_fatal_error(error):
    """A replica wedged by a fatal device error fails its batch, is rebuilt
    from the factory, and queued work then succeeds."""
    good = FakeEngine()
    service = app.TTSService(FakeEngine(error=error))
    rebuilt = []
    service._engine_factory = lambda i: rebuilt.append(i) or good
    assert app.is_fatal_engine_error(error)

    async def scenario():
        await service.start_workers()
        with pytest.raises(type(error)):
            await service.submit(dict(REQ), timeout=60)
        res = await asyncio.wait_for(service.submit(dict(REQ)), 60)
        await service.shutdown()
        return res
    assert asyncio.run(scenario()).wav.size > 0
    assert rebuilt == [0] and service.engines[0] is good
    assert service.metrics["tts_replica_rebuilds_total"] == 1


def test_consecutive_failures_trigger_rebuild():
    """A mundane error does not rebuild at once, but max_consecutive_failures
    in a row do."""
    flaky = FakeEngine(error=KeyError("mundane per-request bug"))
    flaky.cfg.server.max_consecutive_failures = 2
    good = FakeEngine()
    service = app.TTSService(flaky)
    rebuilt = []
    service._engine_factory = lambda i: rebuilt.append(i) or good
    assert not app.is_fatal_engine_error(flaky.error)

    async def scenario():
        await service.start_workers()
        with pytest.raises(KeyError):
            await service.submit(dict(REQ), timeout=60)
        assert rebuilt == []
        with pytest.raises(KeyError):
            await service.submit(dict(REQ), timeout=60)
        res = await asyncio.wait_for(service.submit(dict(REQ)), 60)
        await service.shutdown()
        return res
    assert asyncio.run(scenario()).wav.size > 0
    assert rebuilt == [0]


def test_offline_replica_retries_its_rebuild():
    """A rebuild that fails leaves an `_OfflineReplica` (reported offline);
    its next batch fails fatally and retries the rebuild, which succeeds."""
    good = FakeEngine()
    service = app.TTSService(FakeEngine(error=MemoryError("host OOM")))
    attempts = []

    def factory(i):
        attempts.append(i)
        if len(attempts) == 1:
            raise RuntimeError("rebuild failed")
        return good
    service._engine_factory = factory

    async def scenario():
        await service.start_workers()
        with pytest.raises(MemoryError):
            await service.submit(dict(REQ), timeout=60)
        for _ in range(500):                  # the rebuild runs off the loop
            if service.engines[0] is not None:
                break
            await asyncio.sleep(0.01)
        assert isinstance(service.engines[0], app._OfflineReplica)
        info = service._replica_info(0, service.engines[0])
        assert info["offline"] and info["device"] == "default"
        with pytest.raises(app.ReplicaOfflineError):
            await service.submit(dict(REQ), timeout=60)
        res = await asyncio.wait_for(service.submit(dict(REQ)), 60)
        await service.shutdown()
        return res
    assert asyncio.run(scenario()).wav.size > 0
    assert attempts == [0, 0] and service.engines[0] is good


def test_drain_waits_for_queued_work():
    """`drain` returns True once the queues are empty, and False when the
    budget runs out first; a request timeout answers 504."""
    service = app.TTSService(FakeEngine(delay=0.3))

    async def scenario():
        await service.start_workers()
        futs = [asyncio.ensure_future(service.submit(dict(REQ))) for _ in range(12)]
        await asyncio.sleep(0)
        assert not await service.drain(graceful_timeout=0.05)
        assert await service.drain(graceful_timeout=30.0)
        assert all(len(r.wav) for r in await asyncio.gather(*futs))
        assert await service.drain(graceful_timeout=0.5)
        await service.shutdown()
    asyncio.run(scenario())


def test_request_timeout_answers_504():
    eng = FakeEngine(delay=0.5)
    eng.cfg.server.request_timeout_s = 0.05
    service = app.TTSService(eng)
    body = json.dumps({"text": "hi.", "spk_audio": prompt_wav().hex()}).encode()

    async def scenario():
        await service.start_workers()
        resp = await service.server.routes[("POST", "/tts")](Request("POST", "/tts", {},
                                                                      body))
        await service.shutdown()
        return resp
    assert asyncio.run(scenario()).status == 504
    assert service.metrics["tts_requests_failed"] == 1


def test_fatal_error_names():
    fatal = [torch.cuda.OutOfMemoryError("x"), MemoryError(),
             RuntimeError("CUDA error: misaligned address"),
             RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx"),
             RuntimeError("device-side assert triggered"),
             RuntimeError("an illegal memory access was encountered"),
             RuntimeError("simulated device failure"), app.ReplicaOfflineError("x")]
    assert all(app.is_fatal_engine_error(e) for e in fatal)
    assert not any(app.is_fatal_engine_error(e) for e in
                   (ValueError("bad input"), KeyError("x"), RuntimeError("shape mismatch")))


# ---------------------------------------------------------------------------
# warm-up
# ---------------------------------------------------------------------------

def test_warm_texts_land_in_every_bucket():
    eng = TTSEngine.tiny(device="cpu")
    texts = app.TTSService._warm_texts(eng)
    buckets = eng.cfg.engine.text_buckets
    assert len(texts) == len(buckets)
    lo = 0
    for txt, tb in zip(texts, buckets):
        assert lo < len(eng.tokenizer.tokenize(txt)) <= tb
        lo = tb


class FakeBatcher:
    """Stands in for a ContinuousBatcher: records what it is sent and
    completes it at `run`."""

    def __init__(self):
        self.sent, self.runs = [], 0

    def submit(self, req, callback=None):
        self.sent.append(req)
        return [InferenceResult(np.ones(100, np.int16), 22050, {})], None

    def run(self):
        self.runs += 1


@pytest.mark.parametrize("continuous", [False, True], ids=["grouped", "continuous"])
def test_warmup_covers_the_batch_buckets(continuous):
    """"workload" warm-up: one request per text bucket, through `infer` in
    grouped mode and through the replica's batcher in continuous mode,
    then (grouped mode) `infer_batch` at every power-of-2 batch up to
    max_batch_size in every text bucket and the full-cap pass with the
    code-bucket estimate off, and in both modes the synthesis of every code
    bucket up to the cap at every batch; continuous mode runs no `infer`
    and no `infer_batch`."""
    eng = TTSEngine.tiny(device="cpu")
    eng.cfg.server.max_batch_size = 4
    eng.cfg.server.continuous_batching = continuous
    eng.cfg.engine.use_int8_decode = continuous
    if continuous:
        eng.fused_pack = object()
    calls, synth = [], []
    eng.infer = lambda wav, txt: calls.append(("infer", 1, txt, eng.cfg.engine.auto_code_bucket))
    eng.infer_batch = lambda reqs: calls.append(
        ("batch", len(reqs), reqs[0]["text"], eng.cfg.engine.auto_code_bucket))
    eng.cfg.generation.max_mel_tokens = 40
    eng._mel_jobs = lambda jobs, cbucket: synth.append(
        (len(jobs), cbucket, {j["code_len"] for j in jobs}))
    service = app.TTSService(eng)
    batcher = FakeBatcher()
    if continuous:
        service._batchers[0] = batcher
    service._warmup()
    # the synthesis of every code bucket up to the cap's (32, 64 for a
    # 40-code cap) at every batch
    assert sorted(synth) == sorted((b, c, {c}) for b in (1, 2, 4) for c in (32, 64))
    texts = app.TTSService._warm_texts(eng)
    singles = {(c[2], c[3]) for c in calls if c[0] == "infer"}
    batches = {(c[1], c[2]) for c in calls if c[0] == "batch" and c[3]}
    if continuous:
        assert calls == [] and batcher.runs == 1
        assert [r["text"] for r in batcher.sent] == texts
    else:
        assert {(t, True) for t in texts} <= singles
        assert batches == {(b, t) for b in (2, 4) for t in texts}
        assert (texts[-1], False) in {(c[2], c[3]) for c in calls}
        assert {c[1] for c in calls if not c[3] and c[0] == "batch"} == {2, 4}
    assert service.warmup_stats["mode"] == "workload"
    assert eng.cfg.engine.auto_code_bucket


def test_continuous_warmup_hands_its_batcher_to_the_worker():
    """Continuous warm-up on a tiny engine runs its requests through the
    replica's ContinuousBatcher (chunks run, nothing fails), and the worker
    then serves through that same batcher, so the chunk graph the warm-up
    captures on the card is the one traffic replays."""
    service = app.TTSService()
    service.load_engines(tiny=True, continuous=True, device="cpu")
    eng = _greedy(service.engines[0], max_new=8)
    eng.cfg.server.max_batch_size = 2
    service._warmup()
    batcher = service._batchers[0]
    assert batcher.stats["harvested"] == len(app.TTSService._warm_texts(eng))
    chunks = batcher.stats["chunks"]
    assert chunks > 0

    async def scenario():
        await service.start_workers()
        out = await service.submit({"spk_audio_prompt": prompt_wav(), "text": "hi."},
                                   timeout=120)
        await service.shutdown()
        return out
    assert asyncio.run(scenario()).wav.size > 0
    assert batcher.stats["chunks"] > chunks and service._modes == {0: "continuous"}


def test_replica_threads_take_their_card(monkeypatch):
    """Every thread that drives a replica makes the replica's device its
    current one before its first launch: the grouped executor, and the
    continuous batcher's scheduler and synthesis threads."""
    import threading

    from voice_tts_tpu_torch.engine import continuous as pcont
    from voice_tts_tpu_torch.engine import engine as peng

    seen = []

    def spy(device):
        seen.append((threading.current_thread().name, str(device)))
    monkeypatch.setattr(peng, "use_device", spy)
    monkeypatch.setattr(pcont, "use_device", spy)
    grouped = FakeEngine()
    grouped.device = "cuda:1"           # never launched: the fake runs on the host
    cont = app.TTSService()
    cont.load_engines(tiny=True, continuous=True, device="cpu")
    _greedy(cont.engines[0], max_new=8)
    for service in (app.TTSService(grouped), cont):
        async def scenario():
            await service.start_workers()
            await service.submit({"spk_audio_prompt": prompt_wav(), "text": "hi."},
                                 timeout=120)
            await service.shutdown()
        asyncio.run(scenario())
    assert ("tts-replica-0_0", "cuda:1") in seen
    assert ("continuous-scheduler", "cpu") in seen
    assert ("continuous-synthesis", "cpu") in seen


# ---------------------------------------------------------------------------
# continuous mode, the fallback, shutdown
# ---------------------------------------------------------------------------

def test_continuous_mode_serves_and_reports_itself():
    """`load_engines(continuous=True)` on a tiny engine: one replica on the
    CPU whatever `workers` asks, worker-info reports the continuous mode
    with its slots, and /tts answers through the batcher."""
    service = app.TTSService()
    service.load_engines(workers=4, tiny=True, continuous=True, device="cpu")
    assert len(service.engines) == 1
    _greedy(service.engines[0], max_new=8)
    srv = app.BackgroundServer(service)
    port = srv.start()
    try:
        info = _request(port, "GET", "/debug/worker-info")[1]["replicas"][0]
        assert info["mode"] == "continuous" and info["continuous_batching"] is True
        assert info["slots"] == min(service.engines[0].cfg.server.max_batch_size, 8)
        status, data = _request(port, "POST", "/tts", {"text": "hi there.",
                                                       "spk_audio": prompt_wav().hex()})
        assert status == 200, data
        assert bytes.fromhex(data["audio_hex"])[:4] == b"RIFF"
        assert service._batchers[0].stats["chunks"] > 0
    finally:
        srv.stop()


def test_continuous_chunk_failure_answers_500(monkeypatch):
    """A chunk that raises (a capture or launch failure on the card) fails
    the requests in flight with a 500, not a retry elsewhere; the batcher
    then serves the next request."""
    from voice_tts_tpu_torch.engine import continuous as pcont

    service = app.TTSService()
    service.load_engines(tiny=True, continuous=True, device="cpu")
    _greedy(service.engines[0], max_new=8)
    run_chunk, calls = pcont.run_chunk, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: operation failed due to a previous error "
                               "during capture")
        return run_chunk(*args, **kwargs)
    monkeypatch.setattr(pcont, "run_chunk", failing)
    body = json.dumps({"text": "hi.", "spk_audio": prompt_wav().hex()}).encode()

    async def scenario():
        await service.start_workers()
        handler = service.server.routes[("POST", "/tts")]
        out = [await handler(Request("POST", "/tts", {}, body)) for _ in range(2)]
        await service.shutdown()
        return out
    first, second = asyncio.run(scenario())
    assert first.status == 500 and "CUDA error" in first.payload["detail"]
    assert second.status == 200
    assert service.metrics["tts_requests_failed"] == 1


def test_beam_profile_falls_back_to_grouped():
    """Continuous batching asked of a beam-3 engine: the worker falls back
    to grouped `infer_batch`, and worker-info reports the grouped mode."""
    eng = TTSEngine.tiny(device="cpu", use_int8_decode=True, use_fused_decode=True)
    eng.cfg.generation.num_beams = 3
    eng.cfg.server.continuous_batching = True
    service = app.TTSService(eng)
    assert service._replica_info(0, eng)["mode"] == "grouped"

    async def scenario():
        await service.start_workers()
        await asyncio.sleep(0.05)
        info = service._replica_info(0, eng)
        await service.shutdown()
        return info
    info = asyncio.run(scenario())
    assert info["mode"] == "grouped" and info["continuous_batching"] is False
    assert service._modes == {0: "grouped"} and not service._batchers


def test_shutdown_leaves_nothing_pending(capfd):
    """Shutdown with requests in flight (continuous mode) and queued
    (grouped mode): every waiting request fails at once, no task is left
    pending, and nothing logs "Event loop is closed"."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = Keep()
    logging.getLogger("voice_tts_tpu_torch").addHandler(handler)
    try:
        cont = app.TTSService()
        cont.load_engines(tiny=True, continuous=True, device="cpu")
        _greedy(cont.engines[0], max_new=8)
        slow = app.TTSService(FakeEngine(delay=0.3))
        for service in (cont, slow):
            async def scenario():
                await service.start_workers()
                futs = [asyncio.ensure_future(service.submit(
                    {"spk_audio_prompt": prompt_wav(), "text": "hello world."}))
                    for _ in range(3)]
                await asyncio.sleep(0.1)
                await service.shutdown()
                done, pending = await asyncio.wait(futs, timeout=10)
                assert not pending
                others = [t for t in asyncio.all_tasks()
                          if t is not asyncio.current_task() and not t.done()]
                return done, others
            done, others = asyncio.run(scenario())
            assert others == []
            assert all(f.exception() is None or isinstance(f.exception(), RuntimeError)
                       for f in done)
        time.sleep(0.2)
    finally:
        logging.getLogger("voice_tts_tpu_torch").removeHandler(handler)
    out, err = capfd.readouterr()
    assert "Event loop is closed" not in out + err
    assert not any("Event loop is closed" in r for r in records)
