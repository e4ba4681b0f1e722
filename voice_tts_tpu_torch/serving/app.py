"""The TTS HTTP service on the PyTorch port, single request at a time
(`voice_tts_tpu/serving/app.py`).

Endpoints: `GET /`, `GET /health`, `GET /debug/worker-info`, `POST /tts`
with the JAX server's error taxonomy (400 invalid JSON / input, 422 schema
violation, 500 inference failure, 504 timeout).  One engine replica on one
device serves requests one at a time: each runs `engine.infer` in a
single-thread executor behind a lock.

The flagship engine serves the production profile by default, as the JAX
server does (`serving_config`: beam search with 3 beams through K3 with the
ancestor table, int8 KV, folded readout, bf16 conditioning); `--profile
bench` serves the bench decode configuration (`bench_config`: sampling,
num_beams = 1 through K1).  `--tiny` takes the tiny config whatever the
profile.  `/debug/worker-info` reports the profile, `num_beams` and the
served flags.

    python -m voice_tts_tpu_torch.serving.app --port 8020            # flagship
    python -m voice_tts_tpu_torch.serving.app --profile bench        # bench
    python -m voice_tts_tpu_torch.serving.app --tiny --device cpu    # demo
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import os
import threading
import time
from typing import Optional

from voice_tts_tpu_torch.logging import logger
from voice_tts_tpu_torch.serving.audio_input import ApiError, get_audio_data
from voice_tts_tpu_torch.serving.http import HttpServer, Request, Response
from voice_tts_tpu_torch.serving.schemas import (TTSRequest, TTSResponse,
                                                 ValidationError)
from voice_tts_tpu_torch.text.emotion import create_emotion_vector

# the engine flags that select the port's code paths
_SERVED_FLAGS = ("use_fp16", "use_int8_decode", "use_fused_decode",
                 "use_int4_decode", "use_fused_beam_decode", "fold_readout",
                 "use_int8_kv", "use_bf16_conditioning", "release_master_trees",
                 "spec_decode_k", "use_bf16_s2mel")
PROFILES = ("serving", "bench")


class TTSService:
    def __init__(self, engine=None, profile: Optional[str] = None):
        self.server = HttpServer()
        self.engine = engine
        self.profile = profile
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._lock = asyncio.Lock()
        self._register_routes()

    def close(self) -> None:
        self._executor.shutdown(wait=True)

    def _register_routes(self):
        s = self.server

        @s.route("GET", "/")
        async def root(req: Request) -> Response:
            return Response({"status": "running",
                             "model_loaded": self.engine is not None,
                             "service": "voice-tts-tpu API Server (PyTorch port)",
                             "version": "2.0"})

        @s.route("GET", "/health")
        async def health(req: Request) -> Response:
            if self.engine is None:
                return Response({"detail": "Model not loaded"}, 503)
            return Response({"status": "healthy", "model_loaded": True,
                             "deepspeed_enabled": False})

        @s.route("GET", "/debug/worker-info")
        async def worker_info(req: Request) -> Response:
            import torch

            e = self.engine
            return Response({
                "pid": os.getpid(),
                "backend": "torch",
                "torch": torch.__version__,
                "devices": [{"id": i, "platform": "gpu",
                             "kind": torch.cuda.get_device_name(i)}
                            for i in range(torch.cuda.device_count())],
                "model_info": {"loaded": e is not None, "replicas": int(e is not None)},
                "replicas": [] if e is None else [{
                    "replica": 0, "device": str(e.device),
                    "engine_flags": {k: getattr(e.cfg.engine, k)
                                     for k in _SERVED_FLAGS},
                    "num_beams": e.cfg.generation.num_beams,
                    "profile": self.profile,
                }],
            })

        @s.route("POST", "/tts")
        async def tts(req: Request) -> Response:
            if self.engine is None:
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
                spk_audio = await loop.run_in_executor(
                    None, get_audio_data, request.spk_audio)
                emo_audio = emo_vector = None
                if request.emo_audio:
                    emo_audio = await loop.run_in_executor(
                        None, get_audio_data, request.emo_audio)
                elif request.emotion is not None:
                    if isinstance(request.emotion, str):
                        emo_vector = create_emotion_vector(request.emotion,
                                                           request.emo_alpha)
                    else:
                        emo_vector = create_emotion_vector(request.emotion)
                timeout = self.engine.cfg.server.request_timeout_s
                start = time.time()
                async with self._lock:
                    fut = loop.run_in_executor(
                        self._executor, lambda: self.engine.infer(
                            spk_audio, request.text, emo_audio_prompt=emo_audio,
                            emo_alpha=request.emo_alpha if emo_audio else 1.0,
                            emo_vector=emo_vector))
                    try:
                        result = await asyncio.wait_for(asyncio.shield(fut), timeout)
                    except asyncio.TimeoutError:
                        return Response({"detail": "inference timed out"}, 504)
                inference_time = time.time() - start
                from voice_tts_tpu_torch.audio import encode_wav_int16

                wav_bytes = encode_wav_int16(result.wav, result.sample_rate)
                audio_length = len(result.wav) / result.sample_rate
                return Response(TTSResponse(
                    audio_hex=wav_bytes.hex(), audio_length=audio_length,
                    inference_time=inference_time,
                    rtf=inference_time / audio_length if audio_length else 0.0,
                    text=request.text).model_dump())
            except ApiError as e:
                return Response({"detail": e.detail}, e.status)
            except ValueError as e:
                return Response({"detail": str(e)}, 400)
            except Exception as e:  # noqa: BLE001 — request boundary
                logger.exception("TTS inference failed")
                return Response({"detail": f"TTS inference failed: {e}"}, 500)


class BackgroundServer:
    """Run a service's HTTP server on its own event loop in a thread
    (`start` returns once the port is bound; `stop` shuts it down)."""

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
                self._server = loop.run_until_complete(asyncio.start_server(
                    self.service.server._handle, self.host, self.port))
                self.port = self._server.sockets[0].getsockname()[1]
            except OSError as e:
                errors.append(e)
                ready.set()
                loop.close()
                return
            ready.set()
            try:
                loop.run_forever()
            finally:
                self._server.close()
                loop.run_until_complete(self._server.wait_closed())
                loop.close()

        self._thread = threading.Thread(target=run, name="tts-http", daemon=True)
        self._thread.start()
        if not ready.wait(timeout):
            raise TimeoutError("HTTP server did not start")
        if errors:
            raise errors[0]
        return self.port

    def stop(self, timeout: float = 30.0) -> None:
        if self._loop is not None and self._thread is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("HTTP server thread did not stop")


def build_engine(tiny: bool, device: str, seed: int = 0, profile: str = "serving"):
    """The served engine: random weights at the flagship widths in the
    production profile (`serving`, the default) or the bench configuration
    (`bench`), or the tiny configuration for demos."""
    from voice_tts_tpu_torch.engine.engine import (TTSEngine, bench_config,
                                                   serving_config)

    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r} (expected one of {PROFILES})")
    if tiny:
        return TTSEngine.tiny(device=device, seed=seed)
    cfg = serving_config() if profile == "serving" else bench_config()
    return TTSEngine.random(cfg, device=device, seed=seed)


async def amain(args):
    import signal

    profile = "tiny" if args.tiny else args.profile
    service = TTSService(build_engine(args.tiny, args.device, profile=args.profile),
                         profile)
    cfg = service.engine.cfg
    logger.info("serving on %s:%d (%s, profile %s, num_beams %d, flags %s)",
                args.host, args.port, service.engine.device, profile,
                cfg.generation.num_beams,
                {k: getattr(cfg.engine, k) for k in _SERVED_FLAGS})
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    serve_task = asyncio.create_task(service.server.serve(args.host, args.port))
    stop_task = asyncio.create_task(stop.wait())
    done, _ = await asyncio.wait({serve_task, stop_task},
                                 return_when=asyncio.FIRST_COMPLETED)
    serve_task.cancel()
    stop_task.cancel()
    service.close()
    for task in done:
        if task is serve_task and not task.cancelled():
            task.result()


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="voice-tts-tpu API server (PyTorch port)")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8020)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random-weight engine (demo / testing)")
    parser.add_argument("--profile", type=str, default="serving", choices=PROFILES,
                        help="'serving' (default): the production profile, "
                             "beam-3 with int8 KV; 'bench': sampling, one beam")
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
