"""Continuous batching: requests join a RUNNING decode batch mid-flight
(`voice_tts_tpu/engine/continuous.py`).

A group of `infer_batch` decodes to completion before the next admission,
so a request that arrives mid-group waits out the whole decode.  Slot
scheduling removes that barrier:

- a fixed pool of B <= MAX_ROWS decode slots shares one time-major KV cache
  (L, 2, B, Tmax, D) and steps through `ops.fused_decode_step_batch` (K3)
  with PER-ROW positions: each slot attends its own live [0, pos_b) prefix;
- `admit` prefills a new request's prompt straight into a free slot while
  the other slots keep their state;
- `run_chunk` advances all slots K steps, then the host reads one (4, B)
  status, harvests finished slots and refills them.  On a CUDA device the
  chunk is one replay of a CUDA graph (`engine.device_loop.run_graph`),
  captured at the key's first chunk, as the JAX `run_chunk` compiles at its
  first call: the slot state is bound once per key and `admit` writes into
  it in place between replays.

Completed segments drain into the engine's batched s2mel / vocoder stage
(`engine._mel_jobs`) on a synthesis thread of their own.  Greedy codes equal
`models.gpt.decode.decode` of the request alone with the fused pack and no
readout pack: the same kernels (K3 rows are independent, K1 is K3 at one
row), the prefill of each request alone over the same Tmax, and the readout
of each row alone (`UnifiedVoice.readout_rows`).  The JAX `run_chunk` reads
out through `UnifiedVoice.readout` and never the folded readout pack, and
so does this one.

Departures from the JAX package: a request whose conditioning fails (an
undecodable prompt) fails alone, not with every request in flight; `stop`
ends the synthesis thread and fails what is still in flight, so no caller
waits forever; `submit` takes an optional callback, called once the
request completes.  Both threads make the engine's card their current
device, so a replica on another card than the first launches there, and
run their device work under `device_loop.GATE.shared()`, so a capture of
either (the chunk's, the CFM solve's) never overlaps a CUDA call of the
other; the engine lock is taken before the gate, never inside it.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from voice_tts_tpu_torch.config import GenerationConfig, GPTConfig
from voice_tts_tpu_torch.engine import device_loop, post
from voice_tts_tpu_torch.engine.device_loop import GATE, DeviceLoops
from voice_tts_tpu_torch.engine.engine import InferenceResult, use_device
from voice_tts_tpu_torch.logging import logger
from voice_tts_tpu_torch.models.gpt.decode import generation_key, sample_token
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice, n_cond_latents
from voice_tts_tpu_torch.ops.fused_decode import (BLOCK_T, MAX_ROWS, Pack,
                                                  apply_kv_update_q_rows,
                                                  apply_kv_update_rows,
                                                  cache_to_time_major,
                                                  fused_decode_step_batch,
                                                  quantize_kv_cache_batch)


class SlotState(NamedTuple):
    """Device-resident decode state of B slots (kv_scales None: a float
    cache).  `pos` doubles as the occupancy marker: 0 is an idle slot
    (steps compute finite garbage there and `active` masks every state
    update)."""

    cache: torch.Tensor                # (L, 2, B, Tmax, D) float or int8
    kv_scales: Optional[torch.Tensor]  # (L, B, Tmax, 2) f32 with int8
    bias: torch.Tensor                 # (B, Tmax) f32 additive prompt mask
    pos: torch.Tensor                  # (B,) live prefix length
    steps: torch.Tensor                # (B,) codes emitted
    token: torch.Tensor                # (B,) last sampled code
    presence: torch.Tensor             # (B, V) repetition-penalty memory
    codes: torch.Tensor                # (B, max_new)
    active: torch.Tensor               # (B,) decoding now
    finished: torch.Tensor             # (B,) stop token or cap hit
    hit_limit: torch.Tensor            # (B,) stopped by the cap


def init_state(cfg: GPTConfig, slots: int, t_max: int, max_new: int,
               cache_dtype: torch.dtype, int8_kv: bool, device="cpu") -> SlotState:
    l, d = cfg.layers, cfg.model_dim
    with torch.device(device):
        if int8_kv:
            cache = torch.zeros((l, 2, slots, t_max, d), dtype=torch.int8)
            scales = torch.full((l, slots, t_max, 2), 1e-12)
        else:
            cache = torch.zeros((l, 2, slots, t_max, d), dtype=cache_dtype)
            scales = None
        return SlotState(
            cache=cache, kv_scales=scales, bias=torch.zeros((slots, t_max)),
            pos=torch.zeros((slots,), dtype=torch.long),
            steps=torch.zeros((slots,), dtype=torch.long),
            token=torch.zeros((slots,), dtype=torch.long),
            presence=torch.zeros((slots, cfg.number_mel_codes), dtype=torch.bool),
            codes=torch.full((slots, max_new), cfg.stop_mel_token, dtype=torch.long),
            active=torch.zeros((slots,), dtype=torch.bool),
            finished=torch.zeros((slots,), dtype=torch.bool),
            hit_limit=torch.zeros((slots,), dtype=torch.bool))


def bind_state(loops: Optional[DeviceLoops], key: tuple, state: SlotState) -> SlotState:
    """The slot state a chunk graph of `key` reads and writes: its static
    tensors on a capturing `loops` (allocated at the key's first use,
    reset to `state` after), else `state` itself."""
    tensors = {k: v for k, v in state._asdict().items() if v is not None}
    st = device_loop.bind(loops, key, tensors)
    return SlotState(**{f: st.get(f) for f in SlotState._fields})


def chunk_key(model: UnifiedVoice, fused_pack: Pack, gen: GenerationConfig,
              generator: Optional[torch.Generator], state: SlotState, k: int) -> tuple:
    """The device-loop key of a chunk: what its graph bakes in."""
    slots, t_max = state.bias.shape
    return ("continuous", id(model), id(fused_pack), id(generator), generation_key(gen),
            slots, t_max, state.codes.shape[1], state.kv_scales is not None, k)


@torch.no_grad()
def admit(model: UnifiedVoice, gen: GenerationConfig, state: SlotState, slot: int,
          cond: torch.Tensor, emo: torch.Tensor, text: torch.Tensor, tlen: torch.Tensor,
          generator: Optional[torch.Generator] = None) -> SlotState:
    """Prefill one request's prompt into slot `slot`, IN PLACE (the other
    slots keep their state).  text (1, bucket) right-padded.  The prefill
    runs over a (1, Tmax) cache, as `decode` alone runs it, and the first
    code is sampled as `decode()`'s prefill epilogue samples it."""
    cfg = model.cfg
    bl = text.shape[1]
    p = n_cond_latents(cfg) + 2 + bl + 2
    t_max = state.bias.shape[1]
    dev = text.device
    param_dtype = model.conditioning_encoder.after_norm.bias.dtype
    prompt, valid_p = model.build_prompt(cond.to(param_dtype), emo.to(param_dtype),
                                         text, tlen)
    cache = model.gpt.init_cache(1, t_max, prompt.dtype, dev)
    logits0 = model.prefill(prompt, valid_p, cache)
    tm = cache_to_time_major(cache)               # (L, 2, 1, Tmax, D)
    if state.kv_scales is not None:
        q, s = quantize_kv_cache_batch(tm)        # scales (L, 1, Tmax, 2)
        state.cache[:, :, slot] = q[:, :, 0]
        state.kv_scales[:, slot] = s[:, 0]
    else:
        state.cache[:, :, slot] = tm[:, :, 0].to(state.cache.dtype)
    valid = torch.cat([valid_p[0], torch.ones(t_max - p, dtype=torch.bool, device=dev)])
    state.bias[slot] = torch.where(valid, 0.0, -1e30)

    pres = torch.zeros((1, cfg.number_mel_codes), dtype=torch.bool, device=dev)
    pres[:, 1] = True                             # HF fake input ids
    pres[:, cfg.start_mel_token] = True
    tok0 = sample_token(logits0, pres, gen, generator)    # (1,)
    state.presence[slot:slot + 1] = pres.scatter(1, tok0[:, None], True)
    state.codes[slot] = cfg.stop_mel_token
    state.codes[slot:slot + 1, 0] = tok0
    fin0 = tok0 == cfg.stop_mel_token
    state.pos[slot] = p + 1
    state.steps[slot] = 1
    state.token[slot:slot + 1] = tok0
    state.active[slot:slot + 1] = ~fin0
    state.finished[slot:slot + 1] = fin0
    state.hit_limit[slot] = False
    return state


def _step(model: UnifiedVoice, fused_pack: Pack, gen: GenerationConfig,
          st: SlotState, generator: Optional[torch.Generator]) -> SlotState:
    """One decode step of every slot (the JAX `run_chunk` body)."""
    cfg = model.cfg
    stop = cfg.stop_mel_token
    max_new = st.codes.shape[1]
    emb = model.embed_decode_token_rows(st.token, st.steps - 1)
    hidden, kv_new, _ = fused_decode_step_batch(emb, fused_pack, st.cache, st.bias,
                                                st.pos, cfg.heads, kv_scales=st.kv_scales)
    if st.kv_scales is not None:
        apply_kv_update_q_rows(st.cache, st.kv_scales, kv_new, st.pos)
    else:
        apply_kv_update_rows(st.cache, kv_new, st.pos)
    logits = model.readout_rows(hidden)
    tok = sample_token(logits, st.presence, gen, generator)
    tok = torch.where(st.active, tok, stop)
    idx = st.steps.clamp(max=max_new - 1)[:, None]
    codes = st.codes.scatter(1, idx, torch.where(st.active[:, None], tok[:, None],
                                                 st.codes.gather(1, idx)))
    newly_stop = st.active & (tok == stop)
    adv = st.active.long()
    steps = st.steps + adv
    hit = st.active & ~newly_stop & (steps >= max_new)
    return st._replace(pos=st.pos + adv, steps=steps,
                       token=torch.where(st.active, tok, st.token),
                       presence=st.presence.scatter(1, tok[:, None], True), codes=codes,
                       active=st.active & ~newly_stop & ~hit,
                       finished=st.finished | newly_stop | hit,
                       hit_limit=st.hit_limit | hit)


def run_chunk(model: UnifiedVoice, fused_pack: Pack, gen: GenerationConfig,
              state: SlotState, generator: Optional[torch.Generator], k: int,
              loops: Optional[DeviceLoops] = None):
    """Advance every slot K decode steps, IN PLACE.  Idle and finished slots
    compute masked garbage (their pos / steps / codes never change; their
    cache writes land in their own row at a stale position, which the next
    admit overwrites).  Returns (state, status): status (4, B) int32 packs
    [active, finished, hit_limit, steps] for ONE host read a chunk.  On a
    capturing `loops` the state must be `bind_state(loops, chunk_key(...),
    ...)` and the chunk is one replay of the key's graph (the first call
    runs op by op and captures); `generator` is registered with it."""
    def chunk(st: SlotState):
        with torch.no_grad():
            for _ in range(k):
                st = _step(model, fused_pack, gen, st, generator)
            return st, torch.stack([st.active.int(), st.finished.int(),
                                    st.hit_limit.int(), st.steps.int()])
    key = chunk_key(model, fused_pack, gen, generator, state, k)
    return device_loop.run_graph(state, chunk, loops, key, generator)


class ContinuousBatcher:
    """Host-side slot scheduler over `admit` / `run_chunk`.

    Usage (one scheduler thread; `submit` is thread-safe):

        batcher = ContinuousBatcher(engine)
        holder, ev = batcher.submit({"spk_audio_prompt": ..., "text": ...})
        batcher.run()           # or batcher.start() / stop() around submits
        ev.wait(); result = holder[0]   # an InferenceResult or the exception
    """

    def __init__(self, engine, slots: Optional[int] = None, chunk_steps: int = 16,
                 generation_kwargs: Optional[dict] = None):
        if engine.fused_pack is None:
            raise ValueError("continuous batching requires the decode megakernel "
                             "pack (engine.use_fused_decode)")
        cfg = engine.cfg
        self.engine = engine
        self.gen = engine._generation_config(generation_kwargs or {})
        if self.gen.num_beams > 1:
            raise ValueError("continuous batching is the sampling path "
                             "(num_beams == 1); beams use infer_batch")
        self.slots = min(slots or cfg.server.max_batch_size, MAX_ROWS)
        self.chunk_steps = chunk_steps
        self.max_new = self.gen.max_mel_tokens
        p_max = n_cond_latents(cfg.gpt) + 2 + max(cfg.engine.text_buckets) + 2
        t_max = p_max + 1 + self.max_new
        self.t_max = t_max + (-t_max) % BLOCK_T
        model = engine.gpt_rt
        cache_dtype = model.conditioning_encoder.after_norm.bias.dtype
        self.generator = torch.Generator(device=engine.device).manual_seed(cfg.engine.seed)
        self.loops = engine.loops
        state = init_state(cfg.gpt, self.slots, self.t_max, self.max_new, cache_dtype,
                           cfg.engine.use_int8_kv, engine.device)
        self.key = chunk_key(model, engine.fused_pack, self.gen, self.generator, state,
                             chunk_steps)
        self.state = bind_state(self.loops, self.key, state)
        # chunks run, slots occupied over them, host reads (status / codes)
        self.stats = {"chunks": 0, "occupied": 0, "status_reads": 0, "codes_reads": 0,
                      "admitted": 0, "harvested": 0}

        self._lock = threading.Lock()
        self._pending: List[dict] = []       # raw requests awaiting prep
        self._seg_queue: List[dict] = []     # segment jobs awaiting a slot
        self._slot_job: List[Optional[dict]] = [None] * self.slots
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # synthesis runs OFF the scheduler thread so decode chunks keep
        # dispatching while finished segments vocode.  The engine's host
        # state (its generator, the conditioning caches) is not thread-safe,
        # so both engine touchpoints, `_prepare` on the scheduler thread and
        # `_mel_jobs` here, serialize on `_engine_lock`.  It is always taken
        # before `GATE.shared()`, never inside it: a synthesis that captures
        # waits in the gate holding the lock, so a thread in the gate must
        # not wait for the lock
        self._engine_lock = threading.Lock()
        self._synth_q: "queue_mod.Queue[Optional[List[dict]]]" = queue_mod.Queue()
        self._synth_thread = threading.Thread(target=self._synth_loop, daemon=True,
                                              name="continuous-synthesis")
        self._synth_thread.start()

    # ------------------------------------------------------------------
    # submission and completion
    # ------------------------------------------------------------------

    def submit(self, request: dict, callback: Optional[Callable[[list], None]] = None):
        """Queue one request (the `infer` keyword surface).  Returns (holder,
        event): on completion holder[0] is an InferenceResult or the
        exception that failed it, and `callback(holder)` is called."""
        holder: list = []
        ev = threading.Event()
        with self._lock:
            self._pending.append({"req": request, "holder": holder, "event": ev,
                                  "callback": callback, "t0": time.perf_counter()})
        return holder, ev

    def _complete(self, entry: dict, value) -> None:
        with self._lock:
            if entry["event"].is_set():
                return
            entry["holder"].append(value)
            entry["event"].set()
        if entry["callback"] is not None:
            entry["callback"](entry["holder"])

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def _prep_pending(self):
        """Turn raw requests into per-segment jobs (conditioning, tokenize).
        Runs on the scheduler thread; a request that fails here fails alone."""
        with self._lock:
            pending, self._pending = self._pending, []
        for entry in pending:
            req = entry["req"]
            try:
                if req.get("use_emo_text", False):
                    raise NotImplementedError("use_emo_text=True needs the Qwen emotion "
                                              "model, which is not ported")
                with self._engine_lock, GATE.shared():
                    spk, emovec, segments = self.engine._prepare(
                        req["spk_audio_prompt"], req.get("emo_audio_prompt"),
                        req.get("emo_alpha", 1.0), req.get("emo_vector"),
                        req.get("use_random", False), req["text"],
                        req.get("max_text_tokens_per_segment", 120))
            except Exception as e:  # noqa: BLE001 - this request only
                self._complete(entry, e)
                continue
            entry["segments_left"] = len(segments)
            entry["wavs"] = [None] * len(segments)
            for si, seg in enumerate(segments):
                ids = self.engine.tokenizer.convert_tokens_to_ids(seg)
                bucket = post.pick_bucket(len(ids), self.engine.cfg.engine.text_buckets)
                self._seg_queue.append({"entry": entry, "seg": si, "ids": ids,
                                        "bucket": bucket, "spk": spk, "emovec": emovec})

    def _admit_free_slots(self):
        dev = self.engine.device
        for slot in range(self.slots):
            if self._slot_job[slot] is not None or not self._seg_queue:
                continue
            job = self._seg_queue.pop(0)
            bucket = job["bucket"]
            ids = job["ids"][:bucket]
            text = torch.zeros((1, bucket), dtype=torch.long)
            text[0, :len(ids)] = torch.tensor(ids, dtype=torch.long)
            admit(self.engine.gpt_rt, self.gen, self.state, slot,
                  job["spk"]["cond_latents"], job["emovec"], text.to(dev),
                  torch.tensor([len(ids)], device=dev), self.generator)
            job["text_row"] = text[0]
            job["text_len"] = len(ids)
            self._slot_job[slot] = job
            self.stats["admitted"] += 1

    def _harvest(self, status: np.ndarray) -> List[dict]:
        done = []
        codes_np = None
        for slot in range(self.slots):
            job = self._slot_job[slot]
            if job is None or not status[1, slot]:
                continue
            if codes_np is None:
                codes_np = self.state.codes.cpu().numpy()
                self.stats["codes_reads"] += 1
            steps = int(status[3, slot])
            hit = bool(status[2, slot])
            code_len0 = max(steps - (0 if hit else 1), 1)
            row, row_len = post.remove_long_silence(
                codes_np[slot:slot + 1, :code_len0], np.asarray([code_len0]),
                self.engine.cfg.gpt.stop_mel_token, self.engine.cfg.engine.silent_token)
            job["codes"] = row[0]
            job["code_len"] = int(row_len[0])
            job["steps"], job["hit_limit"] = steps, hit
            job["cbucket"] = post.pick_bucket(job["code_len"],
                                              tuple(self.engine.cfg.engine.code_buckets))
            done.append(job)
            self._slot_job[slot] = None
            self.stats["harvested"] += 1
        return done

    def _synth_loop(self):
        use_device(self.engine.device)
        while True:
            jobs = self._synth_q.get()
            try:
                if jobs is None:
                    return
                self._do_synthesize(jobs)
            except Exception as e:  # noqa: BLE001 - fail those requests only
                logger.exception("continuous batching: synthesis failed")
                for job in jobs:
                    self._complete(job["entry"], e)
            finally:
                self._synth_q.task_done()

    def _do_synthesize(self, jobs: List[dict]):
        by_cbucket: Dict[int, List[dict]] = {}
        for job in jobs:
            by_cbucket.setdefault(job["cbucket"], []).append(job)
        with self._engine_lock, GATE.shared():
            for cbucket, group in by_cbucket.items():
                self.engine._mel_jobs(group, cbucket)
        for job in jobs:
            entry = job["entry"]
            entry["wavs"][job["seg"]] = job["wav"]
            entry["segments_left"] -= 1
            if entry["segments_left"] == 0:
                self._finish(entry)

    def _finish(self, entry: dict):
        cfg = self.engine.cfg
        full = post.insert_interval_silence(entry["wavs"], cfg.engine.sample_rate,
                                            entry["req"].get("interval_silence", 200))
        wav_len = len(full) / cfg.engine.sample_rate
        total = time.perf_counter() - entry["t0"]
        metrics = {"inference_time": total, "audio_length": wav_len,
                   "rtf": total / wav_len if wav_len > 0 else 0.0}
        self._complete(entry, InferenceResult(full.astype(np.int16),
                                              cfg.engine.sample_rate, metrics))

    def _idle(self) -> bool:
        with self._lock:
            no_pending = not self._pending
        return (no_pending and not self._seg_queue
                and all(j is None for j in self._slot_job)
                and self._synth_q.unfinished_tasks == 0)

    def step_once(self) -> bool:
        """One scheduler iteration.  Returns False when fully idle."""
        self._prep_pending()
        with GATE.shared():
            self._admit_free_slots()
        if all(j is None for j in self._slot_job):
            busy = not self._idle()
            if busy:            # only synthesis outstanding: don't busy-spin
                time.sleep(0.001)
            return busy
        with GATE.shared():
            _, status = run_chunk(self.engine.gpt_rt, self.engine.fused_pack, self.gen,
                                  self.state, self.generator, self.chunk_steps, self.loops)
            status_np = status.cpu().numpy()          # the chunk's one host read
            self.stats["chunks"] += 1
            self.stats["status_reads"] += 1
            self.stats["occupied"] += sum(j is not None for j in self._slot_job)
            done = self._harvest(status_np)
        if done:
            self._synth_q.put(done)
        return True

    def run(self):
        """Drain everything currently submitted (blocking)."""
        while self.step_once():
            pass
        self._synth_q.join()

    def _fail_all(self, err: Exception):
        """Complete every in-flight request with the error (holder[0] is the
        exception).  Keeps the scheduler thread alive for new submissions."""
        with self._lock:
            entries, self._pending = list(self._pending), []
        entries += [j["entry"] for j in self._seg_queue]
        self._seg_queue = []
        entries += [j["entry"] for j in self._slot_job if j is not None]
        self._slot_job = [None] * self.slots
        for entry in {id(e): e for e in entries}.values():
            self._complete(entry, err)

    def start(self):
        def loop():
            use_device(self.engine.device)
            while not self._stop.is_set():
                try:
                    busy = self.step_once()
                except Exception as e:  # noqa: BLE001 - fail requests, stay up
                    logger.exception("continuous batching: a chunk failed")
                    self._fail_all(e)
                    busy = False
                if not busy:
                    time.sleep(0.002)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="continuous-scheduler")
        self._thread.start()

    def stop(self):
        """Stop the scheduler and the synthesis thread; whatever is still in
        flight completes with an error."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._synth_thread.is_alive():
            self._synth_q.put(None)
            self._synth_thread.join()
        self._fail_all(RuntimeError("continuous batcher stopped"))
