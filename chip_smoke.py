"""Chip smoke test of the PyTorch + CUDA port (`voice_tts_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

(`--only k5 k8 ...` runs just those kernel checks and prints their JSON,
without the slices and without the result line; `--only vocoder` runs the
vocoder A/B alone on a flagship BigVGAN with random weights, `--only
batched` and `--only serving` those phases on engines of their own.)

Phases (any failure exits non-zero; no phase is caught and skipped):

1. device check: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from `voice_tts_tpu_torch/csrc` (one
   nvcc per source, in parallel);
3. kernels: each hand-written kernel against its plain PyTorch version at
   the flagship shapes of the paths, with the tolerance printed, both timed
   with CUDA events, beside its bound (the bytes it must move over 3.35
   TB/s, or its operations over the peak rate, whichever is larger): K5,
   K10 (below), K2 (first the snake's sin^2 against torch.sin in f64 over
   |x| <= 1e4, then rows of 1-13 samples, a tile boundary +- 1 and T % 4
   != 0, then every activation of a 448- and a 2656-frame vocode, host
   loop and device-only a shape; two calls bit-equal; its plans and ptxas
   registers), K4 (a layer's four products on the unfused decode
   step at 1, 3, 8 and 32 rows, each also device-only beside
   `torch._weight_int8pack_mm`, two calls bit-equal, the entry's times that
   set at 1 row; and a grid of 1 / 8 / 32 rows at D 1280),
   K1 (bf16 cache; int8 KV at pos 300 and 1500; device-only beside the host
   loop), K3 (beam-3 through an
   ancestor table with int8 KV and with a bf16 cache, pos 1500; eight rows
   at their own positions, one of them 0; each device-only beside the host
   loop, two calls bit-equal; then the split-prefix edge cases, pos 255 /
   256 / 257, a split wholly under the -1e30 bias and B 1 / 3 / 8 / 12
   through a table with either cache; one step of the first case under the
   profiler, its GEMV and attention spans; the ptxas registers and spills of
   the redesigned kernels; then the batched paths' row counts, `k3rows`:
   6 and 12 rows through a table that keeps each row in its request's
   three against those three alone, and 4 rows at one shared position
   against each row through K1, bit-equal or else within the step
   tolerance, and K3 device-only at 3, 4, 6 and 12 rows), K7 (the int4
   loader alone at the
   four GEMVs of a layer, beside `torch._weight_int4pack_mm`; the int4 K1
   chain at g128 and g640, pos 300; the int4 K3 chain at beam-3 through a
   table), K6 (the verify of K = 4 tokens at pos 300 and 1500);
4. micro-benchmark path: K12 (`micro_tile`, the int8 tile stream) and K13
   (`micro_int4`, the int4 stream with a carried row), every mode against
   its plain version at D 1280, 16 tiles (K12's dot8i with x past the int8
   range, K13 with scales at U(500, 2500)), then the entry points
   `voice_tts_tpu_torch.scripts.micro_tile` / `.micro_int4` at their
   defaults (D 1280, 288 tiles, 20 and 60 passes) with the counters from 0:
   one launch a pass, 160 a mode; then each plain version over 3 passes;
5. tiny engines: the tiny engine on the card against the same weights on
   the CPU, greedy, same CFM noise: one beam (K1), the production flags
   (beam-3 through K3, int8 KV, bf16 conditioning), spec decode with
   K = 4 (int4 drafts through K1 and K7, the verify through K6), the
   int4 decode pack (K1 with K7), K5 (below) and the vocoder flags;
6. production slice: the flagship engine (random weights) in the serving
   profile, the server default, behind the HTTP server in a background
   thread: GET /health, GET /debug/worker-info, three POST /tts, then one
   request under the CUDA profiler; the beam decode and the CFM solve run
   as replayed CUDA graphs (`engine/device_loop.py`), and the launch
   counters must show K3 once per beam step its device loop executed
   (chunks x CHUNK >= decode steps > chunks x CHUNK - decodes x CHUNK: at
   most CHUNK - 1 steps after a stop), the loops' host reads one before
   each decode's first chunk and one after each chunk, K1 never, K2 109
   times per vocode; then one request with the loops op by op
   (`DeviceLoops(capture=False)`) against the same request replayed, from
   one generator state and an empty cap memory (the 511-code cap hit, the
   1499 retry after `set_state`): every decode's codes, lengths, limit
   flag, steps and chunks, the CFM mel and the WAV bit-equal;
7. batched phase (`run_batched_slice`, the codes cut to a 512 cap; `--only
   batched` runs it alone on a production engine of its own): on the
   production engine `infer_batch` of four requests over two speakers in
   one text bucket (beam-3 sampling: one 12-row K3 decode through replayed
   graphs, K3 once a step it executed, K1 never) against the same requests
   one a decode (`beam_batch_rows = 3`, each on its own stream: codes and
   WAVs bit-equal) and against its loops op by op with the cap retry on
   reseeded streams; a 3-segment `infer` with `batch_segments` on and off
   (greedy: the same codes a segment); `infer(stream_return=True)` against
   `infer`'s WAV; four cold speakers conditioned in one group against
   each alone, on the production (bf16) and a fresh bench (f32) engine
   (each tensor's move, bounded by the bf16 rounding, and whether one
   request's codes from either entry agree); then the bench engine with
   `use_fused_batch_decode` (greedy): `infer_batch` of the four requests,
   K3 at 4 rows at one
   shared position, against each request alone through K1 (the same
   codes); each part's wall and `gpt_gen_time`, batched against
   sequential, and the peak device memory;
   Then the serving phase's grouped part (`run_grouped_serving`; `--only
   serving` runs both parts alone on engines of their own): the queued
   service (`TTSService` in a `BackgroundServer`) on the production engine
   at greedy beam-3, cap 512, after its `workload` warm-up: 8 concurrent
   POST /tts over two conditioned speakers in text buckets 32 and 64, all
   200 with a 22.05 kHz WAV, fewer than 8 batches in /metrics, no graph
   captured, each request's codes bit-equal to it served alone; p50 / p95
   latency, audio seconds per wall second, the group sizes;
8. bench slice: the same with `--profile bench` (sampling, one beam): K1
   once per executed step, K3 never, K2 109 times per vocode, the replayed
   request bit-equal to the uncaptured one; then the serving phase's
   continuous part (`run_continuous_serving`, 8 slots, 16 steps a chunk):
   a greedy `ContinuousBatcher` over 8 requests, one submitted a chunk,
   each request's codes, steps and limit flag bit-equal to `decode()`
   alone (K1, no readout pack), K3 chunks x 16 times and K1 never; a chunk
   key's first capture while a synthesis thread runs (every synthesis
   bit-equal to it alone); six sampled chunks replayed against the same
   chunks op by op, bit-equal; K3 at 8 slots, at the slots' per-row
   positions with no readout pack, against its plain version on the float
   cache and the same cache in int8, then device-only, and a replayed
   chunk timed; 8 requests one at a time through `infer`; then the
   service with `--continuous-batching`: its workload warm-up through the
   replica's batcher must capture the worker's chunk graph, then 16 POST
   /tts with Poisson arrivals at a quarter of a warm request's wall, all
   200, under the profiler: latency, throughput, occupied slots, host
   reads a request, idle share, graphs the traffic captured;
9. spec slice: the bench configuration with `spec_decode_k = 4` (int4
   drafts, one int8 verify a round), three POST /tts and one profiled: K6
   once per round, three int4 K1 chains (K1 and K7) per round, K3 never,
   K2 109 times per vocode; prints the acceptance rate, the codes per round
   and the stage times beside the bench slice's.
10. DiT slice: the bench configuration with `use_bf16_s2mel`, the K8 trunk
   (`fused_blocks`) and K9 attention (`fused_attention`): a 2.5 s prompt
   twice (T 704: K8 once per velocity evaluation, 25 a request, no K9) and
   a 5 s prompt (T 896 > 768: K9 in every block, 325, no K8), K1 once per
   executed decode step, K2 109 times per vocode, one more request
   profiled at each T; prints the stage timers beside the bench slice's;
   then the CFM graph at T 704 against the uncaptured solve, with K8 and
   without it (K9 in each block: one request captures, the next replays),
   bit-equal;
11. K11 engine: a second engine on the DiT slice's weights with
   `flash_attention` instead (K8 and K9 off): one request at the 5 s prompt,
   K11 325 times, then one profiled (the profiles of the DiT slice and this
   engine print the DiT attention kernels' device time a request).
12. K5 slice: the bench configuration with `GPTConfig.pallas_decode_attention`
    (the unfused decode step: K5 attention, K4 projections) and
    `use_fused_vocoder` (stages 2-5 through K10), three POST /tts and one
    profiled: per request K5 24 and K4 96 times a decode step, K1 and K3
    never, K10 4 and K2 37 times a vocode; prints the stage timers beside
    the bench slice's;
13. K5 beam request: a second engine on the K5 slice's models in the
    production profile with `pallas_decode_attention` and a 512-code cap,
    one request (beam-3 through the eager arm, 511 steps): K5 24 and K4 96
    times a beam step, K3 and K1 never;
14. vocoder A/B: the production slice's BigVGAN vocodes one mel at 448 and
    2656 frames through the module path, packed, shared-activation and
    fused variants, each timed, with its difference from the module path.

The kernel phase also holds K9 and K11 (bf16 on the tensor cores, f32 on
the CUDA cores; every row at T 65 and 130 with lens 0, 1, 63, 64, 65 and T
and a query row that matches no segment, and misaligned bf16 views must
raise; then T 896 and 3104, timed in a host loop and device-only behind a
`torch.cuda._sleep`) beside `F.scaled_dot_product_attention` with the same
boolean mask, timed alike, K8
(the 13-block trunk at B 2, T 704, lens 650 and at T 130, lens (1, 77):
the GEMM planner's tiles, checked against the C launch's; two calls
bit-equal; host loop and device-only; one evaluation profiled, with
attention, GEMM and adaRMS spans and no retired kernel, and again without
programmatic dependent launch, where the spans do not overlap),
K5 (bf16 and f32; B 1, Tmax 512, length 343 and B 3, Tmax 2048, length
1571, host loop and device-only at the planner's split and at every split
width, beside `F.scaled_dot_product_attention` on the live prefix; then
lengths 1, 31, 32, 33, a split under the -1e30 bias, length = Tmax, a
split boundary at B 3 and a fully masked row, two calls bit-equal), and
K10 (the four fused stages of the flagship BigVGAN at 448 and 2656
frames, host loop and device-only, two calls bit-equal, the prologue and
the MMA loop also timed alone, the bound as three TF32 passes and in f32,
`plan_fused_stage` checked against the C launch's plan, ptxas registers);
the tiny-engine phase
runs K9 and K11 whole requests, K8 on the s2mel stage with bf16 s2mel (D
256 DiT), `pallas_decode_attention` with one beam and with the production
flags (f32 GPT), the int8 + bf16 unfused step with K5 and with the einsum
attention (where the codes of card and CPU first differ), and each
vocoder flag.

The third-to-last stdout line repeats the card's name and power limit; the
second-to-last is the kernel JSON: under "kernels" every kernel, each with
its launch count from the path that runs it (K3 and K2 from the production
slice, K1 from the bench slice, K6 and K7 from the spec slice, K8 and K9
from the DiT slice, K11 from its engine, K5, K4 and K10 from the K5 slice,
K12 and K13 from the micro-benchmark path; `launches_by_path` has all
eleven paths, "batched" the batched phase's two warm `infer_batch` runs,
"grouped" the serving burst, "continuous" the greedy batcher's and the
Poisson run's chunks),
its largest error against the plain version, both times, its bound
and `library_ms` (null where no one PyTorch call computes the function: K1,
K2, K3, K6, K8, K10, K12, K13; the K12 and K13 entries time one mode a
pass, `dot1` and `cur`, with every mode under `modes`; K4's is
`torch._weight_int8pack_mm` where the build has it, K7's
`torch._weight_int4pack_mm` at the loader's GEMVs, K5's, K9's and K11's
`F.scaled_dot_product_attention`).  The last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_check():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        import voice_tts_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable (run from the repo root): {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return torch, card


def cuda_time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """CUDA-event time of `iters` calls that the host queued before the
    device reached them: a `torch.cuda._sleep` enqueued ahead of the start
    event holds the device while the host launches, so the calls run back
    to back and the time is the device's, not the host's launch rate.  The
    sleep grows until the start event is still pending when the host has
    queued the last call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_behind = start.query()
        torch.cuda.synchronize()
        if not host_behind:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail(f"device_time_ms: the host did not queue {iters} calls within the sleep")


def library_time_ms(torch, fn, iters: int, timer=cuda_time_ms):
    """CUDA-event time of one PyTorch library call that computes the same
    function as a kernel (a yardstick only: the port never calls it), by
    `timer` (the host loop, or `device_time_ms`), or None where this
    PyTorch build has no CUDA implementation of it."""
    try:
        return timer(torch, fn, iters)
    except (NotImplementedError, RuntimeError) as e:
        print(f"library call unavailable: {str(e).splitlines()[0][:200]}")
        return None


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# H100 SXM data sheet: device memory rate and dense peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}


def bound(n_bytes: float, n_ops: float, op_type: str = "bf16") -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate for their type, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[op_type]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def pack_bytes(pack) -> int:
    """Bytes of a trunk pack that one step reads: the weight tiles, an int4
    pack's group scales, and of the (L, 28, D) f32 consts only the rows the
    chain reads: the biases 12-19 and 23, LN1/LN2 24-27, and beside int8
    tiles their dequant scales 0-8 (fc2's one scale is row 8).  Rows 9-11
    and 20-22 repeat fc2's scale or hold zeros, and an int4 pack's rows 0-11
    are zeros, kept for the JAX row layout."""
    n_layers, _, d = pack.consts.shape
    gscales = getattr(pack, "gscales", None)
    rows_read = 13 if gscales is not None else 22
    return (nbytes(pack.w, gscales)
            + n_layers * rows_read * d * pack.consts.element_size())


def readout_bytes(ro, nrows: int) -> int:
    """Bytes of the folded readout for the VOCAB real columns (the padded
    columns up to 12 tiles carry no logit): their int8 rows, scale and bias,
    the final LN, and nrows f32 logits written."""
    d = ro.w.shape[1]
    return VOCAB * (d + 8) + nbytes(ro.lnf) + nrows * VOCAB * 4


def decode_step_bound(torch, pack, ro, cache, scales, bias, pos, src=None,
                      rows=None, verify=False):
    """Bound of one decode step (K1, K3, K6, int8 or int4 pack): the pack's
    bytes a step reads (`pack_bytes`) and the readout's once, the cached k|v
    rows the step reads (one sequence's prefix for the verify; each row's
    own prefix, or through an ancestor table the distinct (cache row,
    position) pairs it names), their int8 scales, the bias and table entries
    read, the inputs and outputs; operations 2 per weight's multiply-add per
    row plus attention."""
    n_layers, _, cb, _, d = cache.shape
    nrows = rows if rows is not None else cb
    pos_b = [int(p) for p in (pos.tolist() if isinstance(pos, torch.Tensor)
                              else [pos] * (1 if verify else cb))]
    if verify:
        cached = pos_b[0]
    elif src is not None:
        p = pos_b[0]
        head = src[:, :p].sort(dim=0).values
        cached = int(((head[1:] != head[:-1]).sum(dim=0) + 1).sum()) if p else 0
    else:
        cached = sum(pos_b)
    # one cached k or v row: D values, plus its f32 scale beside an int8 cache
    per_row = cache.element_size() * d + (4 if scales is not None else 0)
    kv_out = 4 if scales is not None else cache.element_size()
    n_bytes = (pack_bytes(pack) + (readout_bytes(ro, nrows) if ro is not None else 0)
               + n_layers * 2 * cached * per_row
               + 4 * (pos_b[0] if verify else sum(pos_b))        # bias
               + (4 * sum(pos_b) if src is not None else 0)      # table
               + nrows * d * 4 * 2                               # x, hidden
               + n_layers * 2 * nrows * d * kv_out)              # kv_new
    macs = n_layers * 12 * d * d + (VOCAB * d if ro is not None else 0)
    # q.k and p.v: 4 operations per value of each attended position
    attended = (nrows * pos_b[0] + nrows * (nrows + 1) // 2 if verify
                else sum(pos_b) + nrows)
    return bound(n_bytes, 2 * nrows * macs + 4 * n_layers * d * attended)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def random_trunk(torch, dev, seed: int):
    """A random int8 pack and readout at the flagship widths (L 24, D 1280,
    vocab 8194), scaled like a quantized GPT-2."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    L, D, V = 24, 1280, 8194
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    w = torch.randint(-127, 128, (L, 12, D, D), generator=g, device=dev,
                      dtype=torch.int8)
    consts = torch.zeros((L, 28, D), device=dev)
    consts[:, 0:12] = 0.02 * 3 / 127 * (1 + 0.1 * randn(L, 12, D)).abs()
    consts[:, 9:12] = consts[:, 8:9]             # one fc2 scale (pack_gpt)
    consts[:, 12:23] = randn(L, 11, D, std=0.02)
    consts[:, 20:23] = 0.0                       # fc2 partial biases
    consts[:, 24] = 1 + randn(L, D, std=0.05)
    consts[:, 25] = randn(L, D, std=0.02)
    consts[:, 26] = 1 + randn(L, D, std=0.05)
    consts[:, 27] = randn(L, D, std=0.02)
    state = {"mel_head.weight": randn(V, D, std=0.02),
             "mel_head.bias": randn(V, std=0.02),
             "final_norm.weight": 1 + randn(D, std=0.05),
             "final_norm.bias": randn(D, std=0.02)}
    return fd.FusedDecodePack(w, consts), fd.pack_readout(state), g


# f32 sums in another order flip single bf16 roundings of the activations;
# across 24 layers that stays within 1e-2 of the largest magnitude (the chip
# run records the actual error)
DECODE_TOL = 1e-2
VOCAB = 8194
# chained steps a device-only time queues behind the sleep: a step is 121
# launches, and the card's queue of pending launches holds about a thousand
CHAIN_ITERS = 4


def _compare_values(torch, tag, out, ref):
    """Hidden, kv_new and logits of a decode step against the plain version
    (tolerance DECODE_TOL * max|ref|); returns the errors."""
    errs = {}
    for name, a, b in (("hidden", out[0], ref[0]), ("kv_new", out[1], ref[1]),
                       ("logits", out[2][:, :VOCAB], ref[2][:, :VOCAB])):
        scale = float(b.float().abs().max())
        errs[name] = max_err(torch, a, b)
        print(f"{tag} {name}: max_abs_err {errs[name]:.4g} (max|ref| {scale:.4g}, "
              f"tol {DECODE_TOL} * max|ref|)")
        if not errs[name] <= DECODE_TOL * scale:
            fail(f"{tag} {name} disagrees with the plain version")
    return errs


def compare_step(torch, tag, out, ref):
    """Hidden, kv_new and logits of a decode step against the plain version
    (tolerance DECODE_TOL * max|ref|), and per row the logits' argmax: the
    plain argmax, or a token whose plain logit lies within the logits'
    tolerance of the plain maximum (a near-tie, which another f32 summation
    order may pick; such rows are printed).  Every row's plain top-2 gap is
    printed."""
    errs = _compare_values(torch, tag, out, ref)
    lo, lr = out[2][:, :VOCAB].float(), ref[2][:, :VOCAB].float()
    tol = DECODE_TOL * float(lr.abs().max())
    top2 = lr.topk(2, -1)
    am, am_p = lo.argmax(-1), top2.indices[:, 0]
    gaps = [round(float(v), 5) for v in top2.values[:, 0] - top2.values[:, 1]]
    under = top2.values[:, 0] - lr.gather(1, am[:, None])[:, 0]
    ties = (am != am_p).nonzero().flatten().tolist()
    print(f"{tag} argmax per row {am.tolist()} vs plain {am_p.tolist()} (plain top-2 "
          f"gap {gaps})" + (f"; near-tie rows {ties} pick a token "
                            f"{[round(float(under[r]), 5) for r in ties]} under the "
                            f"plain maximum (tolerance {tol:.4g})" if ties else ""))
    if not bool((under <= tol).all()):
        fail(f"{tag} logits argmax differs from the plain version beyond a near-tie")
    return max(errs.values())


def check_k1(torch, dev, results):
    """K1 at B = 1: the bf16 cache of the bench slice (pos 300, Tmax 512),
    and the int8-KV branch at pos 300 / Tmax 512 and pos 1500 / Tmax 1792;
    each at a 0-d device position, as the device loop passes it (every
    split of Tmax launched), timed, and bit-equal to the host int form."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    print(f"decode-step tolerance (K1, K3): {DECODE_TOL} * max|ref|, because f32 "
          f"sums in another order flip single bf16 roundings of the activations, "
          f"compounded over 24 layers")
    pack, ro, g = random_trunk(torch, dev, 1)
    L, _, _, D = pack.w.shape
    H = 20
    cases, worst = [], 0.0
    for int8_kv, t_max, pos in ((False, 512, 300), (True, 512, 300), (True, 1792, 1500)):
        cache = torch.randn(L, 2, 1, t_max, D, generator=g, device=dev).to(torch.bfloat16)
        scales = None
        if int8_kv:
            cache, scales = fd.quantize_kv_cache(cache)
        bias = torch.zeros((t_max, 1), device=dev)
        bias[70:82] = -1e30                      # invalid prompt pads
        x = torch.randn(1, D, generator=g, device=dev) * 0.5

        dpos = torch.tensor(pos, device=dev)

        def run(fn, p=dpos):
            return fn(x, pack, cache, bias, p, H, ro, scales)
        out = run(fd.fused_decode_step)
        torch.cuda.synchronize()
        tag = f"K1 {'int8' if int8_kv else 'bf16'}-KV pos={pos} Tmax={t_max}"
        if not all(torch.equal(u, v) for u, v in zip(out, run(fd.fused_decode_step, pos))):
            fail(f"{tag}: the device position's step differs from the host int's")
        worst = max(worst, compare_step(torch, tag, out, run(fd.fused_decode_step_plain)))
        ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step), 20)
        dev_ms = device_time_ms(torch, lambda: run(fd.fused_decode_step), CHAIN_ITERS)
        plain_ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step_plain), 3)
        b = decode_step_bound(torch, pack, ro, cache, scales, bias, pos)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), "
              f"{plain_ms:.4f} ms plain, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        cases.append({"kv": "int8" if int8_kv else "bf16", "pos": pos,
                      "t_max": t_max, "ms": ms, "device_ms": dev_ms,
                      "plain_ms": plain_ms, **b})
    results.append({
        "name": "fused_decode_step", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:555",
        "max_abs_err": worst, "ms": cases[0]["ms"], "device_ms": cases[0]["device_ms"],
        "plain_ms": cases[0]["plain_ms"],
        "bound_ms": cases[0]["bound_ms"], "bound_by": cases[0]["bound_by"],
        "library_ms": None,
        "ms_of": "one bf16-KV decode step at pos 300, Tmax 512", "cases": cases})


def k3_inputs(torch, dev, g, b, int8_kv, table, pos, pad=(50, 68), t_max=1792):
    """Random K3 inputs at the flagship widths: a (L, 2, B, Tmax, D) cache
    (int8 with its scales, or bf16), an ancestor table or None, a bias with
    the positions `pad` under -1e30 (invalid prompt pads), and x."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    cache = torch.randn(24, 2, b, t_max, 1280, generator=g, device=dev).to(torch.bfloat16)
    scales = src = None
    if int8_kv:
        cache, scales = fd.quantize_kv_cache_batch(cache)
    if table:
        src = torch.randint(0, b, (b, t_max), generator=g, device=dev, dtype=torch.int32)
    bias = torch.zeros((b, t_max), device=dev)
    bias[:, pad[0]:pad[1]] = -1e30
    x = torch.randn(b, 1280, generator=g, device=dev) * 0.5
    return cache, scales, src, bias, x


def profile_k3_step(torch, run):
    """One K3 step under the CUDA profiler: device time by kernel and the
    kernels launched.  Under programmatic dependent launch a kernel's span
    starts while the previous one drains, so the spans overlap and their
    sum exceeds the step's device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    by = {e.key[:60]: {"count": e.count, "device_ms": e.self_device_time_total / 1e3}
          for e in events}
    return {"kernels_a_step": sum(e.count for e in events),
            "gemv_span_ms": sum(v["device_ms"] for k, v in by.items() if "dq_gemv" in k),
            "attention_span_ms": sum(v["device_ms"] for k, v in by.items() if "attend" in k),
            "by_kernel": by}


def check_k3(torch, dev, results):
    """K3 at the flagship widths: (a) B = 3 through a random ancestor table
    with int8 KV, pos 1500, Tmax 1792 (the production beam step); (b) the
    same with a bf16 cache; (c) B = 8 at per-row positions, one of them 0,
    no table, bf16.  All with the folded readout, each timed in a host loop
    and device-only, two calls bit-equal.  Then the split-prefix edge cases
    (checked, not timed): pos 255 / 256 / 257 (one split, its edge, two),
    a split wholly under the -1e30 bias (positions 256-511 at pos 700), and
    B 1 / 3 / 8 / 12 through a table with either cache at pos 900; then one
    step of (a) under the profiler."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack, ro, g = random_trunk(torch, dev, 4)
    L, _, _, D = pack.w.shape
    H, T_MAX = 20, 1792
    rows8 = torch.tensor([0, 17, 300, 511, 800, 1024, 1400, 1500],
                         dtype=torch.int32, device=dev)
    cases, edges, worst, run_a = [], [], 0.0, None
    plan = [("a", 3, True, True, 1500, (50, 68)), ("b", 3, False, True, 1500, (50, 68)),
            ("c", 8, False, False, rows8, (50, 68)),
            ("pos 255", 3, True, True, 255, (50, 68)), ("pos 256", 3, True, True, 256, (50, 68)),
            ("pos 257", 3, False, True, 257, (50, 68)),
            ("split under the bias", 3, True, True, 700, (256, 512))]
    plan += [(f"B{b} {'int8' if q else 'bf16'}", b, q, True, 900, (50, 68))
             for b in (1, 3, 8, 12) for q in (True, False)]
    def step(x, cache, bias, pos, scales, src):
        return lambda fn: fn(x, pack, cache, bias, pos, H, scales, src, ro)

    for name, b, int8_kv, table, pos, pad in plan:
        cache, scales, src, bias, x = k3_inputs(torch, dev, g, b, int8_kv, table, pos, pad)
        if name in ("a", "b"):
            # the device loop's form: a 0-d position on the card, every
            # split of Tmax launched; bit-equal to the host int's
            dpos = torch.tensor(pos, device=dev)
            host = step(x, cache, bias, pos, scales, src)(fd.fused_decode_step_batch)
            run = step(x, cache, bias, dpos, scales, src)
            if not all(torch.equal(u, v) for u, v in
                       zip(run(fd.fused_decode_step_batch), host)):
                fail(f"K3 ({name}): the device position's step differs from the host int's")
        else:
            run = step(x, cache, bias, pos, scales, src)
        out, again = run(fd.fused_decode_step_batch), run(fd.fused_decode_step_batch)
        torch.cuda.synchronize()
        tag = (f"K3 ({name}) B={b} {'int8' if int8_kv else 'bf16'}-KV "
               f"{'table' if table else 'no table'} pos="
               f"{pos if isinstance(pos, int) else pos.tolist()} Tmax={T_MAX} "
               f"splits={fd.attend_splits(dpos if name in ('a', 'b') else pos, T_MAX)}")
        if not all(bool(torch.isfinite(t).all()) for t in out):
            fail(f"{tag}: non-finite output")
        if not all(torch.equal(u, v) for u, v in zip(out, again)):
            fail(f"{tag}: two calls differ")
        ref = run(fd.fused_decode_step_batch_plain)
        if name in ("a", "b", "c"):
            worst = max(worst, compare_step(torch, tag, out, ref))
        else:
            edges.append({"case": name, "max_abs_err": compare_step(torch, tag, out, ref)})
            continue
        ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step_batch), 20)
        dev_ms = device_time_ms(torch, lambda: run(fd.fused_decode_step_batch), CHAIN_ITERS)
        plain_ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step_batch_plain), 3)
        bnd = decode_step_bound(torch, pack, ro, cache, scales, bias, pos, src=src)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), "
              f"{plain_ms:.4f} ms plain, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
              f"two calls bit-equal")
        cases.append({"case": name, "rows": b, "kv": "int8" if int8_kv else "bf16",
                      "table": table, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      **bnd})
        if run_a is None:
            run_a = run
    prof = profile_k3_step(torch, lambda: run_a(fd.fused_decode_step_batch))
    print("K3 (a) one step profiled: " + json.dumps(
        {k: v for k, v in prof.items() if k != "by_kernel"}) + "; by kernel "
          + json.dumps(prof["by_kernel"]))
    print_ptxas(("int8_gemv_partial", "int8_gemv_reduce", "dq_gemv_kernel",
                 "attend_split_kernel", "dq_gemv4_kernel", "verify_split_kernel",
                 "gemm_wgmma_kernel", "decode_attention_split_kernel"))
    results.append({
        "name": "fused_decode_step_batch", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:1098",
        "max_abs_err": max([worst] + [e["max_abs_err"] for e in edges]),
        "ms": cases[0]["ms"], "device_ms": cases[0]["device_ms"],
        "plain_ms": cases[0]["plain_ms"],
        "bound_ms": cases[0]["bound_ms"], "bound_by": cases[0]["bound_by"],
        "library_ms": None,
        "ms_of": "one beam-3 step through the table, int8 KV, pos 1500, Tmax 1792",
        "profile": {k: v for k, v in prof.items() if k != "by_kernel"},
        "cases": cases, "edge_cases": edges})


def check_k3_rows(torch, dev, results):
    """K3 at the row counts of the batched paths, int8 KV and bf16 at pos
    1500, Tmax 1792, the folded readout, a 0-d device position: R = 2 and 4
    requests of beam-3 (6 and 12 rows) through a table in global row ids
    that keeps each row in its request's three, against the same three
    rows alone (K3 at 3 rows); and 4 rows at one shared position without
    a table (the batched sampling decode), against each row alone through
    K1.  A row's outputs bit-equal across the row counts means its sums
    keep their order (the GEMVs' accumulator count and columns a warp
    follow the rows, the attention does not); otherwise each row is held
    within the decode-step tolerance and the tie-aware argmax.  Then K3
    device-only at 3, 4, 6 and 12 rows beside its bound."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack, ro, g = random_trunk(torch, dev, 6)
    H, T_MAX, POS = 20, 1792, 1500
    dpos = torch.tensor(POS, device=dev)
    rows_cases, bit_equal = [], True

    def k3(x, cache, scales, src, bias):
        return fd.fused_decode_step_batch(x, pack, cache, bias, dpos, H, scales, src, ro)

    for r, int8_kv in ((2, True), (4, True), (4, False)):
        b = 3 * r
        cache, scales, _, bias, x = k3_inputs(torch, dev, g, b, int8_kv, False, POS)
        group = torch.arange(b, device=dev, dtype=torch.int32)[:, None] // 3 * 3
        src = group + torch.randint(0, 3, (b, T_MAX), generator=g, device=dev,
                                    dtype=torch.int32)
        out = k3(x, cache, scales, src, bias)
        for i in range(r):
            sl = slice(3 * i, 3 * i + 3)
            one = k3(x[sl], cache[:, :, sl].contiguous(),
                     None if scales is None else scales[:, sl].contiguous(),
                     (src[sl] - 3 * i).contiguous(), bias[sl].contiguous())
            part = (out[0][sl], out[1][:, :, sl], out[2][sl])
            same = all(torch.equal(u, v) for u, v in zip(part, one))
            bit_equal &= same
            tag = (f"K3 rows: request {i} of {r} ({b} rows, {'int8' if int8_kv else 'bf16'}"
                   f"-KV, table) against its 3 rows alone")
            print(f"{tag}: bit-equal {same}")
            if not same:
                compare_step(torch, tag, part, one)
    cache, _, _, bias, x = k3_inputs(torch, dev, g, 4, False, False, POS)
    out = k3(x, cache, None, None, bias)
    for i in range(4):
        one = fd.fused_decode_step(x[i:i + 1], pack, cache[:, :, i:i + 1].contiguous(),
                                   bias[i][:, None].contiguous(), dpos, H, ro)
        part = (out[0][i:i + 1], out[1][:, :, i], out[2][i:i + 1])
        same = all(torch.equal(u, v) for u, v in zip(part, one))
        bit_equal &= same
        tag = "K3 rows: row {} of 4 (bf16-KV, shared position) against K1 alone".format(i)
        print(f"{tag}: bit-equal {same}")
        if not same:
            compare_step(torch, tag, (part[0], part[1], part[2]), one)
    for b, int8_kv, table in ((3, True, True), (4, False, False), (6, True, True),
                              (12, True, True)):
        cache, scales, src, bias, x = k3_inputs(torch, dev, g, b, int8_kv, table, POS)
        dev_ms = device_time_ms(torch, lambda: k3(x, cache, scales, src, bias), CHAIN_ITERS)
        bnd = decode_step_bound(torch, pack, ro, cache, scales, bias, POS, src=src)
        print(f"K3 at {b} rows ({'int8' if int8_kv else 'bf16'}-KV, "
              f"{'table' if table else 'shared position, no table'}) pos {POS} Tmax "
              f"{T_MAX}: {dev_ms:.4f} ms device-only, {dev_ms / b:.4f} ms a row, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows_cases.append({"rows": b, "kv": "int8" if int8_kv else "bf16", "table": table,
                           "device_ms": dev_ms, **bnd})
    print(f"K3 rows: every row bit-equal across 1 / 3 / 4 / 6 / 12 rows: {bit_equal}")
    for r in results:
        if r["name"] == "fused_decode_step_batch":
            r["rows_cases"], r["rows_bit_equal"] = rows_cases, bit_equal


def random_trunk_int4(torch, dev, seed: int, group: int):
    """A random int4 pack at the flagship widths (L 24, D 1280) with scale
    groups of `group` contraction rows, scaled like `pack_gpt_int4` of a
    GPT-2 trunk, and the int8 readout of `random_trunk`."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack8, ro, g = random_trunk(torch, dev, seed)
    L, _, _, D = pack8.w.shape
    w = torch.randint(-128, 128, (L, 12, D, D // 2), generator=g, device=dev,
                      dtype=torch.int8)              # every byte: two nibbles
    gs = 0.02 * 3 / 7 * (1 + 0.1 * torch.randn(L, 12, D, D // group, generator=g,
                                                device=dev)).abs()
    consts = pack8.consts.clone()
    consts[:, 0:12] = 0.0                          # unused by the int4 pack
    return fd.FusedDecodePackInt4(w, consts, gs), ro, g


# one int4 GEMV alone: f32 sums of <= 5120 terms in another order (lanes,
# then a warp reduction) against the plain version's, with no bf16 rounding
# between them
GEMV4_TOL = 1e-4
# the same GEMV behind the LN prologue: the kernel's mean and variance (warp
# sums) and the plain version's (torch's reductions) are f32 sums in another
# order, which flip single bf16 roundings of the normalised activations; one
# flip moves a column by up to 2^-8 of an activation times 8 times its scale
GEMV4_LN_TOL = 1e-3
# the library product rounds the group scales and its output to bf16 (8
# significant bits each)
GEMV4_LIB_TOL = 1e-2


def int4_library_call(torch, w, gs, gsz: int):
    """`torch._weight_int4pack_mm` on the nibbles of w (n_kt, F, D/2) and the
    scales gs (n_kt, F, G), as a function of a bf16 row block: the library's
    unsigned nibbles u = q + 8 with its zero at 0 dequantize to q * scale (its
    scales in bf16).  None where this PyTorch build has no CUDA version."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    qs = [torch.cat(fd._unpack_int4(w[kt]), dim=1) for kt in range(w.shape[0])]
    u = (torch.cat(qs, dim=1) + 8).to(torch.int32)                # (F, K)
    scale = torch.cat(list(gs), dim=1).t()                        # (K/gsz, F)
    sz = torch.stack([scale, torch.zeros_like(scale)], -1).to(torch.bfloat16)
    try:
        try:                                  # (F, K/2) bytes, PyTorch >= 2.5
            packed = torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
        except RuntimeError:                  # (F, K) int32, earlier builds
            packed = torch._convert_weight_to_int4pack(u, 8)
    except (NotImplementedError, RuntimeError, AttributeError) as e:
        print(f"library call unavailable: {str(e).splitlines()[0][:200]}")
        return None
    sz = sz.contiguous()
    return lambda xb: torch._weight_int4pack_mm(xb, packed, gsz, sz)


def int4_gemv_cases(torch, dev, pack):
    """The K7 loader alone at the four int4 GEMVs of one layer of the int4
    chains (qkv 1280 -> 3840, proj 1280 -> 1280, fc 1280 -> 5120, fc2 5120
    -> 1280 as four contraction tiles) at 1 row (the K1 drafts) and 3 rows
    (the int4 K3 chain), each in two forms: the bare product (no LN, zero
    bias, no epilogue), beside `torch._weight_int4pack_mm` on the same
    nibbles and scales (checked against the plain version, GEMV4_LIB_TOL,
    and timed in a host loop and device-only); and the chain's form (the LN
    prologue on qkv and fc, GELU on fc, the residual on proj and fc2: the
    planner's two columns a warp on the LN GEMVs).  Each against the
    kernel's plain twin (`int4_gemv_plain`) and the plain version (`_dot4`
    a contraction tile), GEMV4_TOL, two calls bit-equal, timed in a host
    loop and device-only, with its bound."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    _, _, d, half = pack.w.shape
    n_groups = pack.gscales.shape[-1]
    gsz = d // n_groups
    g = torch.Generator(device=dev).manual_seed(9)
    cases = []
    for rows in (1, 3):
        for name, t0, n_tiles, n_kt, epi in (("qkv", 0, 3, 1, fd._EPI_NONE),
                                             ("proj", 3, 1, 1, fd._EPI_RESIDUAL),
                                             ("fc", 4, 4, 1, fd._EPI_GELU),
                                             ("fc2", 8, 4, 4, fd._EPI_RESIDUAL)):
            f, k = (d, n_kt * d) if n_kt > 1 else (n_tiles * d, d)
            w = pack.w[0, t0:t0 + n_tiles].reshape(n_kt, f, half)
            gs = pack.gscales[0, t0:t0 + n_tiles].reshape(n_kt, f, n_groups)
            x = torch.randn(rows, k, generator=g, device=dev) * 0.5
            for form in ("bare", "chain"):
                chain = form == "chain"
                bias = (torch.randn(f, generator=g, device=dev) * 0.02 if chain
                        else torch.zeros(f, device=dev))
                ln = ((1 + 0.05 * torch.randn(k, generator=g, device=dev),
                       0.02 * torch.randn(k, generator=g, device=dev))
                      if chain and name in ("qkv", "fc") else None)
                e = epi if chain else fd._EPI_NONE
                res = torch.randn(rows, f, generator=g, device=dev) if chain else None

                def kernel():
                    return fd.int4_gemv(x, w, gs, bias, ln, res, e)

                def twin():
                    return fd.int4_gemv_plain(x, w, gs, bias, ln, res, e)

                def plain():
                    xb = fd._ln(x, *ln) if ln is not None else x
                    y = bias
                    for kt in range(n_kt):
                        y = y + fd._dot4(xb[:, kt * d:(kt + 1) * d], w[kt], gs[kt], 0.0)
                    if e == fd._EPI_GELU:
                        return torch.nn.functional.gelu(y, approximate="tanh")
                    return res + y if e == fd._EPI_RESIDUAL else y
                y, y2 = kernel(), kernel()
                torch.cuda.synchronize()
                plan = fd.plan_int4_gemv(k, f, gsz, ln is not None)
                tag = (f"K7 int4 GEMV {name} ({form}) {rows}x{k}->{f} g{gsz}, {plan.blocks} "
                       f"blocks of {8 * plan.col_blocks} columns, {plan.warps} warps")
                if not torch.equal(y, y2):
                    fail(f"{tag}: two calls differ")
                ref = plain()
                err, err_twin = max_err(torch, y, ref), max_err(torch, y, twin())
                scale = float(ref.abs().max())
                tol = GEMV4_LN_TOL if ln is not None else GEMV4_TOL
                print(f"{tag}: max_abs_err {err:.4g} against the plain version, "
                      f"{err_twin:.4g} against the twin (max|ref| {scale:.4g}, tol "
                      f"{tol} * max|ref|), two calls bit-equal")
                if not max(err, err_twin) <= tol * scale:
                    fail(f"{tag} disagrees with the plain version")
                ms = cuda_time_ms(torch, kernel, 50)
                dev_ms = device_time_ms(torch, kernel, 50)
                plain_ms = cuda_time_ms(torch, plain, 20)
                lib_ms = lib_dev_ms = lib_err = None
                lib_fn = None if chain else int4_library_call(torch, w, gs, gsz)
                if lib_fn is not None:
                    xb = x.to(torch.bfloat16)
                    lib_err = max_err(torch, lib_fn(xb), ref)
                    print(f"{tag} torch._weight_int4pack_mm: max_abs_err {lib_err:.4g} "
                          f"(tol {GEMV4_LIB_TOL} * max|ref|)")
                    if lib_err <= GEMV4_LIB_TOL * scale:
                        lib_ms = library_time_ms(torch, lambda: lib_fn(xb), 50)
                        lib_dev_ms = library_time_ms(torch, lambda: lib_fn(xb), 50,
                                                     timer=device_time_ms)
                    else:
                        print(f"{tag}: the library call computes another function "
                              f"here; no library time")
                # the nibbles and their scales read once, x, the bias, the LN
                # constants and the residual read, the f32 output written;
                # 2 rows K F operations
                extra = (list(ln) if ln is not None else []) + ([res] if chain else [])
                bnd = bound(nbytes(w, gs, x, bias, y, *extra), 2 * rows * k * f)
                print(f"{tag}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), "
                      f"{plain_ms:.4f} ms plain, bound {bnd['bound_ms']:.4f} ms "
                      f"({bnd['bound_by']}), library {lib_ms} ms ({lib_dev_ms} device-only)")
                cases.append({"gemv": name, "form": form, "rows": rows, "k": k, "f": f,
                              "group": gsz, "blocks": plan.blocks,
                              "warps": plan.warps, "col_blocks": plan.col_blocks,
                              "ms": ms,
                              "device_ms": dev_ms, "plain_ms": plain_ms,
                              "max_abs_err": max(err, err_twin), "library_ms": lib_ms,
                              "library_device_ms": lib_dev_ms,
                              "library_max_abs_err": lib_err, **bnd})
    return cases


def check_k7(torch, dev, results):
    """K7, the int4 weight loader: alone at the four GEMVs of a layer of the
    int4 K1 chain (the entry's headline times, beside the library's int4
    product); then the int4 K1 chain (B = 1, bf16 cache, folded int8
    readout) at pos 300 / Tmax 512 with g128 and g640 scale groups, and the
    int4 K3 chain at B = 3 through an ancestor table with int8 KV at pos
    1500 / Tmax 1792."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    H, cases, gemvs, worst = 20, [], [], 0.0
    for name, group, b, t_max, pos in (("K1 g128", 128, 1, 512, 300),
                                       ("K1 g640", 640, 1, 512, 300),
                                       ("K3 g128", 128, 3, 1792, 1500)):
        pack, ro, g = random_trunk_int4(torch, dev, 7, group)
        L, _, D, _ = pack.w.shape
        if not gemvs and group == 128:
            gemvs = int4_gemv_cases(torch, dev, pack)
        cache = torch.randn(L, 2, b, t_max, D, generator=g, device=dev).to(torch.bfloat16)
        bias = torch.zeros((b, t_max), device=dev)
        bias[:, 70:82] = -1e30                   # invalid prompt pads
        x = torch.randn(b, D, generator=g, device=dev) * 0.5
        scales = src = None
        if b > 1:
            cache, scales = fd.quantize_kv_cache_batch(cache)
            src = torch.randint(0, b, (b, t_max), generator=g, device=dev,
                                dtype=torch.int32)
            kernel, plain = fd.fused_decode_step_batch, fd.fused_decode_step_batch_plain

            def run(fn):
                return fn(x, pack, cache, bias, pos, H, scales, src, ro)
        else:
            kernel, plain = fd.fused_decode_step, fd.fused_decode_step_plain
            bias = bias.reshape(t_max, 1)

            def run(fn):
                return fn(x, pack, cache, bias, pos, H, ro)
        out, again = run(kernel), run(kernel)
        torch.cuda.synchronize()
        tag = f"K7 int4 {name} B={b} pos={pos} Tmax={t_max}"
        if not all(torch.equal(u, v) for u, v in zip(out, again)):
            fail(f"{tag}: two calls differ")
        worst = max(worst, compare_step(torch, tag, out, run(plain)))
        ms = cuda_time_ms(torch, lambda: run(kernel), 20)
        dev_ms = device_time_ms(torch, lambda: run(kernel), CHAIN_ITERS)
        plain_ms = cuda_time_ms(torch, lambda: run(plain), 3)
        bnd = decode_step_bound(torch, pack, ro, cache, scales, bias, pos, src=src,
                                rows=b)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), "
              f"{plain_ms:.4f} ms plain, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}); two calls bit-equal")
        cases.append({"case": name, "group": group, "rows": b, "pos": pos,
                      "t_max": t_max, "ms": ms, "device_ms": dev_ms,
                      "plain_ms": plain_ms, **bnd})
    one_row = [c for c in gemvs if c["rows"] == 1 and c["form"] == "bare"]
    layer = bound(sum(c["bound_bytes"] for c in one_row),
                  sum(c["bound_ops"] for c in one_row))

    def total(key, cs):
        vals = [c[key] for c in cs]
        return None if None in vals else sum(vals)
    for rows in (1, 3):
        bare = [c for c in gemvs if c["rows"] == rows and c["form"] == "bare"]
        chained = [c for c in gemvs if c["rows"] == rows and c["form"] == "chain"]
        print(f"K7 a layer's four int4 GEMVs, {rows} row(s): bare {total('ms', bare):.4f} "
              f"ms kernel ({total('device_ms', bare):.4f} device-only), library "
              f"{total('library_ms', bare)} ms ({total('library_device_ms', bare)} "
              f"device-only); chain form {total('device_ms', chained):.4f} device-only; "
              f"bound {sum(c['bound_ms'] for c in bare):.4f} ms")
    three = [c for c in gemvs if c["rows"] == 3 and c["form"] == "bare"]
    results.append({
        "name": "fused_decode_int4", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:137",
        "max_abs_err": max([worst] + [c["max_abs_err"] for c in gemvs]),
        "ms": total("ms", one_row), "device_ms": total("device_ms", one_row),
        "plain_ms": total("plain_ms", one_row),
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "library_ms": total("library_ms", one_row),
        "library_device_ms": total("library_device_ms", one_row),
        "library_call": "torch._weight_int4pack_mm",
        "ms_of": "the int4 loader alone at the four bare GEMVs of one layer of "
                 "the int4 (g128) K1 chain (1 row), summed; launches count int4 "
                 "chains, 96 loader launches each; the 3-row and chain-form sets "
                 "under gemvs, the chains' times under cases",
        "three_row_device_ms": total("device_ms", three),
        "three_row_library_device_ms": total("library_device_ms", three),
        "gemvs": gemvs, "cases": cases})


def profile_spec_round(torch, dev):
    """One speculative round of kernels as `spec_decode` runs it, at pos 300
    / Tmax 512 and K = 4 (bf16 cache, random flagship trunks): three int4 K1
    drafts without readout, each writing its kv row into the cache, then the
    int8 verify of the four tokens and its span commit.  Profiled once warm:
    kernels a round, the int4 GEMV (K7) and verify-attention spans, and the
    device's busy time against the round's host wall time.  Under
    programmatic dependent launch the spans overlap."""
    from torch.profiler import ProfilerActivity, profile

    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack8, _, g = random_trunk(torch, dev, 8)
    pack4, _, _ = random_trunk_int4(torch, dev, 7, 128)
    L, _, _, D = pack8.w.shape
    H, K, t_max, pos = 20, 4, 512, 300
    cache = torch.randn(L, 2, 1, t_max, D, generator=g, device=dev).to(torch.bfloat16)
    bias = torch.zeros((t_max, 1), device=dev)
    bias[70:82] = -1e30
    xs = torch.randn(K, D, generator=g, device=dev) * 0.5

    def one_round():
        for i in range(K - 1):
            _, kv, _ = fd.fused_decode_step(xs[i:i + 1], pack4, cache, bias, pos + i, H)
            fd.apply_kv_update(cache, kv, pos + i)
        _, kv = fd.fused_decode_verify(xs, pack8, cache, bias, pos, H)
        fd.apply_kv_update_span(cache, kv, pos)
    one_round()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]

    def span(*names):
        return sum(e.self_device_time_total for e in events
                   if any(n in e.key for n in names)) / 1e3
    busy_ms = span("")
    out = {"kernels_a_round": sum(e.count for e in events),
           "int4_gemv_span_ms": span("dq_gemv4"),
           "int8_gemv_span_ms": span("dq_gemv_kernel"),
           "verify_attention_span_ms": span("verify_split"),
           "draft_attention_span_ms": span("attend_split"),
           "device_busy_ms": busy_ms, "wall_ms": wall_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "by_kernel": {e.key[:60]: {"count": e.count,
                                      "device_ms": e.self_device_time_total / 1e3}
                         for e in events}}
    print("spec round profiled (3 int4 K1 drafts + K6 verify, pos 300, K 4): "
          + json.dumps(out))
    return out


def check_k6(torch, dev, results):
    """K6, the speculative verify: K = 4 tokens of one sequence through the
    int8 trunk, bf16 cache, at pos 300 / Tmax 512 and pos 1500 / Tmax 1792,
    timed in a host loop and device-only; then the split edge cases
    (checked, not timed): an empty prefix (pos 0), a prefix ending on a
    split edge, K = 2 and K = 8, pos + K = Tmax, and a split wholly under
    the -1e30 bias.  Each finite, two calls bit-equal, hidden rows and the
    bf16 kv rows within DECODE_TOL of the plain version; then one spec round
    of kernels profiled."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack, _, g = random_trunk(torch, dev, 8)
    L, _, _, D = pack.w.shape
    H = 20
    # name: (K, Tmax, pos, prompt-pad span under -1e30)
    plan = [("pos 300", 4, 512, 300, (70, 82)), ("pos 1500", 4, 1792, 1500, (70, 82)),
            ("empty prefix", 4, 512, 0, (70, 82)),
            ("split edge", 4, 512, 320, (70, 82)),
            ("K 2", 2, 512, 300, (70, 82)), ("K 8", 8, 1792, 1500, (70, 82)),
            ("pos + K = Tmax", 4, 512, 508, (70, 82)),
            ("split under the bias", 4, 512, 300, (64, 96))]
    cases, edges, worst = [], [], 0.0
    for name, K, t_max, pos, (lo, hi) in plan:
        cache = torch.randn(L, 2, 1, t_max, D, generator=g, device=dev).to(torch.bfloat16)
        bias = torch.zeros((t_max, 1), device=dev)
        bias[lo:hi] = -1e30
        x = torch.randn(K, D, generator=g, device=dev) * 0.5

        def run(fn):
            return fn(x, pack, cache, bias, pos, H)
        out, again = run(fd.fused_decode_verify), run(fd.fused_decode_verify)
        torch.cuda.synchronize()
        ref = run(fd.fused_decode_verify_plain)
        split_t, splits = fd.verify_splits(pos, H, t_max)
        tag = (f"K6 verify ({name}) K={K} pos={pos} Tmax={t_max}, {splits} splits of "
               f"{split_t}")
        if not all(bool(torch.isfinite(v).all()) for v in out):
            fail(f"{tag}: non-finite output")
        if not all(torch.equal(u, v) for u, v in zip(out, again)):
            fail(f"{tag}: two calls differ")
        err_case = 0.0
        for part, a, r in (("hidden", out[0], ref[0]), ("kv_new", out[1], ref[1])):
            err, scale = max_err(torch, a, r), float(r.float().abs().max())
            print(f"{tag} {part}: max_abs_err {err:.4g} (max|ref| {scale:.4g}, "
                  f"tol {DECODE_TOL} * max|ref|); two calls bit-equal")
            if not err <= DECODE_TOL * scale:
                fail(f"{tag} {part} disagrees with the plain version")
            err_case = max(err_case, err)
        worst = max(worst, err_case)
        if name not in ("pos 300", "pos 1500"):
            edges.append({"case": name, "k": K, "pos": pos, "t_max": t_max,
                          "splits": splits, "split_t": split_t, "max_abs_err": err_case})
            continue
        ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_verify), 20)
        dev_ms = device_time_ms(torch, lambda: run(fd.fused_decode_verify), CHAIN_ITERS)
        plain_ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_verify_plain), 3)
        bnd = decode_step_bound(torch, pack, None, cache, None, bias, pos, rows=K,
                                verify=True)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), "
              f"{plain_ms:.4f} ms plain, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        cases.append({"k": K, "pos": pos, "t_max": t_max, "splits": splits,
                      "split_t": split_t, "ms": ms, "device_ms": dev_ms,
                      "plain_ms": plain_ms, **bnd})
    results.append({
        "name": "fused_decode_verify", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:1322",
        "max_abs_err": worst, "ms": cases[0]["ms"], "device_ms": cases[0]["device_ms"],
        "plain_ms": cases[0]["plain_ms"],
        "bound_ms": cases[0]["bound_ms"], "bound_by": cases[0]["bound_by"],
        "library_ms": None,
        "ms_of": "one K = 4 verify, bf16 KV, pos 300, Tmax 512", "cases": cases,
        "edge_cases": edges,
        "spec_round_profile": {k: v for k, v in profile_spec_round(torch, dev).items()
                               if k != "by_kernel"}})


# the (D, F) of a GPT layer's four int8 products on the unfused decode step
# (c_attn, attn c_proj, mlp c_fc, mlp c_proj at the flagship D 1280)
K4_LAYER_SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))


def check_k4(torch, dev, results):
    """K4 at the shapes the K5 slice gives it (a layer's four products, N 1;
    N 3 on the beam-3 request with K5; and N 8 / 32 at the same shapes), and
    a grid of N 1 / 8 / 32 rows at D 1280; two calls of each must be
    bit-equal.  The entry's times are one layer's set at N 1, summed: the
    host loop (which times the ctypes wrapper too) as `ms`, and device-only
    (`device_time_ms`) beside `torch._weight_int8pack_mm`'s."""
    from voice_tts_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(2)
    # bf16 output: sums in another order may round one bf16 ulp apart
    tol = 2 ** -7

    def one(n, d, f):
        x = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (d, f), generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(1, f, generator=g, device=dev) * 1e-3 + 1e-4
        y, y2 = im.int8_gemv(x, w, s), im.int8_gemv(x, w, s)
        torch.cuda.synchronize()
        if not torch.equal(y, y2):
            fail(f"K4 int8_gemv N={n} D={d} F={f}: two calls differ")
        y_p = im.int8_gemv_plain(x, w, s)
        err = max_err(torch, y, y_p)
        scale = float(y_p.float().abs().max())
        plan = im.plan_int8_gemv(n, d, f)
        print(f"K4 N={n} D={d} F={f}: max_abs_err {err:.4g} (max|ref| {scale:.4g}, "
              f"tol {tol:.4g} * max|ref|), two calls bit-equal; {plan.blocks} blocks "
              f"({plan.stripes} stripes x {plan.splits} splits of {plan.split_rows} "
              f"rows x {plan.slabs} slabs of {plan.slab})")
        if not err <= tol * scale:
            fail(f"K4 int8_gemv N={n} D={d} F={f} disagrees with the plain version")
        ms = cuda_time_ms(torch, lambda: im.int8_gemv(x, w, s), 50)
        dev_ms = device_time_ms(torch, lambda: im.int8_gemv(x, w, s), 50)
        plain_ms = cuda_time_ms(torch, lambda: im.int8_gemv_plain(x, w, s), 50)
        # the library's int8 weight-only product: the same function on the
        # same values, w as (F, D) and the scales in bf16
        w_t, s_b = w.t().contiguous(), s.reshape(-1).to(torch.bfloat16)

        def lib():
            return torch._weight_int8pack_mm(x, w_t, s_b)
        lib_ms = library_time_ms(torch, lib, 50)
        lib_dev_ms = library_time_ms(torch, lib, 50, timer=device_time_ms)
        # x and s read, w read, the bf16 output written; 2 N D F operations
        b = bound(nbytes(x, w, s) + n * f * 2, 2 * n * d * f)
        print(f"K4 N={n} D={d} F={f}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), "
              f"{plain_ms:.4f} ms plain, bound {b['bound_ms']:.4f} ms, library "
              f"{lib_ms} ms ({lib_dev_ms} device-only)")
        return {"n": n, "d": d, "f": f, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms, "max_abs_err": err,
                "blocks": plan.blocks, **b}

    def layer_set(cases):
        """One layer's four products summed: times, bound, library."""
        total = bound(sum(t["bound_bytes"] for t in cases),
                      sum(t["bound_ops"] for t in cases))
        out = {"bound_ms": total["bound_ms"], "bound_by": total["bound_by"]}
        for key in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms"):
            vals = [t[key] for t in cases]
            out[key] = None if None in vals else sum(vals)
        return out

    path = {n: [one(n, d, f) for d, f in K4_LAYER_SHAPES] for n in (1, 3, 8, 32)}
    grid = [one(n, 1280, f) for n in (1, 8, 32) for f in (1280, 3840, 5120)]
    sets = {n: layer_set(path[n]) for n in path}
    for n, tag in ((1, "N=1 (K5 slice)"), (3, "N=3 (K5 beam)"), (8, "N=8"), (32, "N=32")):
        t = sets[n]
        print(f"K4 a layer's four products, {tag}: {t['ms']:.4f} ms kernel, "
              f"{t['device_ms']:.4f} device-only, {t['plain_ms']:.4f} ms plain, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library {t['library_ms']} ms, "
              f"{t['library_device_ms']} device-only")
    results.append({
        "name": "int8_gemv", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/int8_gemv.cu",
        "replaces": "voice_tts_tpu/ops/int8_matmul.py:44",
        "max_abs_err": max(t["max_abs_err"] for n in path for t in path[n] + grid),
        **sets[1], "library_call": "torch._weight_int8pack_mm",
        "ms_of": "one layer's four products at N 1 (D, F) = "
                 + ", ".join(f"{d}x{f}" for d, f in K4_LAYER_SHAPES) + ", summed",
        "beam_layer_set": sets[3], "layer_set_n8": sets[8], "layer_set_n32": sets[32],
        "path_shapes": [t for n in path for t in path[n]], "grid_shapes": grid})


def vocoder_shapes(frames: int):
    """(C, T) of every BigVGAN activation for `frames` mel frames."""
    ch, t, shapes = 1536, frames, []
    for i, u in enumerate((4, 4, 2, 2, 2, 2)):
        ch, t = 1536 // 2 ** (i + 1), t * u
        shapes.append((ch, t))
    return shapes


def k2_case(torch, dev, g, aa, c: int, t: int):
    """One K2 shape: inputs from `g`, the kernel against its plain version
    (K2_TOL) and against itself (two calls bit-equal); returns (inputs,
    max_abs_err)."""
    x = torch.randn(1, c, t, generator=g, device=dev)
    alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=dev))
    br = 1.0 / (torch.exp(0.3 * torch.randn(c, generator=g, device=dev)) + 1e-9)
    y = aa.aa_snake_activation(x, alpha, br)
    y2 = aa.aa_snake_activation(x, alpha, br)
    torch.cuda.synchronize()
    y_p = aa.aa_snake_plain(x, alpha, br)
    err = max_err(torch, y, y_p)
    tol = K2_TOL * max(1.0, float(y_p.abs().max()))
    print(f"K2 C={c} T={t}: max_abs_err {err:.4g} (tol {tol:.4g})")
    if not err <= tol:
        fail(f"K2 aa_snake C={c} T={t} disagrees with the plain version")
    if not torch.equal(y, y2):
        fail(f"K2 aa_snake C={c} T={t}: two calls differ")
    return (x, alpha, br), err


# f32 FMA contraction vs separate multiply-add: a few ulp of the output
# magnitude, times max(1, max|ref|)
K2_TOL = 1e-5
# K2's edge shapes (8 rows each): every T of 1-13, a tile boundary +- 1 at
# 512, 1024 and 2048 samples and two tiles, and rows with T % 4 != 0
K2_EDGE_T = list(range(1, 14)) + [511, 512, 513, 1023, 1025, 2047, 2048, 2049, 4095,
                                  4096, 4097, 6146, 10001]


def k2_vocode(torch, dev, g, aa, frames: int):
    """K2 at every activation shape of one vocode of `frames` mel frames
    (18 activations a stage of 3 resblocks x 3 dilations x 2, and one more
    at the last stage's shape: 109): each against its plain version, two
    calls bit-equal, timed in a host loop and device-only (printed a shape,
    so the stage that sets the pace shows); the vocode's sums and bound."""
    shapes = vocoder_shapes(frames)
    per_vocode = [18] * len(shapes) + [1]
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    worst, by_shape = 0.0, []
    for (c, t), count in zip(shapes + [shapes[-1]], per_vocode):
        (x, alpha, br), err = k2_case(torch, dev, g, aa, c, t)
        worst = max(worst, err)
        ms = cuda_time_ms(torch, lambda: aa.aa_snake_activation(x, alpha, br), 20)
        dev_ms = device_time_ms(torch, lambda: aa.aa_snake_activation(x, alpha, br), 20)
        plain_ms = cuda_time_ms(torch, lambda: aa.aa_snake_plain(x, alpha, br),
                                20 if frames <= 448 else 2, warmup=1)
        # x read and y written in f32, alpha and beta read; per sample the
        # 12-tap upsampling (two outputs of 6 taps, 24), the snake of the two
        # (4 operations each) and the 12-tap downsampling (24): 56
        n_bytes, n_ops = 2 * nbytes(x) + nbytes(alpha, br), 56 * c * t
        b = bound(n_bytes, n_ops, "f32")
        print(f"K2 C={c} T={t}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only, "
              f"x{count} a vocode), {plain_ms:.4f} ms plain, bound {b['bound_ms']:.4f} ms")
        by_shape.append({"c": c, "t": t, "count": count, "device_ms": dev_ms,
                         "bound_ms": b["bound_ms"]})
        tot["ms"] += count * ms
        tot["device_ms"] += count * dev_ms
        tot["plain_ms"] += count * plain_ms
        tot["bytes"] += count * n_bytes
        tot["ops"] += count * n_ops
    b = bound(tot["bytes"], tot["ops"], "f32")
    print(f"K2 per vocode (109 activations, {frames} frames): {tot['ms']:.4f} ms kernel "
          f"({tot['device_ms']:.4f} device-only), {tot['plain_ms']:.4f} ms plain, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return worst, {"frames": frames, "ms": tot["ms"], "device_ms": tot["device_ms"],
                   "plain_ms": tot["plain_ms"], **b, "by_shape": by_shape}


def print_ptxas(families) -> None:
    """The ptxas registers and spills of every kernel whose symbol contains
    one of `families`, from the build's report; fails where none is there."""
    from voice_tts_tpu_torch.ops import build

    lib = build.kernels()
    for family in families:
        rows = build.ptxas_entries(lib.path, (family,))
        if not rows:
            fail(f"no kernel {family} in the build's ptxas report")
        spilled = [r[0] for r in rows if r[2]]
        print(f"ptxas {family}: {len(rows)} instances, {min(r[1] for r in rows)}-"
              f"{max(r[1] for r in rows)} registers a thread, "
              f"{sum(r[2] for r in rows)} bytes of spill stores"
              + (f" (in {spilled})" if spilled else ""))


# the kernels' sin^2 against sin^2 in f64: a few f32 ulp of 1 (the accurate
# sinf squared in f32 is within 1e-7)
SIN2_TOL = 4e-7


def check_sin2(torch, dev, g, sin2):
    """The sine of K2 and K10's snake (`sin_mod_pi` in csrc/aa_math.cuh,
    squared) against torch.sin in f64 on the same f32 arguments: 4M uniform
    in |x| <= 1e4, a dense grid on [-8, 8] and the f32 neighbours of k pi / 2
    for k up to 6000; beside it the error of torch.sin squared in f32."""
    x = torch.cat([(torch.rand(4_000_000, generator=g, device=dev) * 2 - 1) * 1e4,
                   torch.linspace(-8, 8, 1_000_001, device=dev)])
    half_pi = torch.arange(-6000, 6001, device=dev, dtype=torch.float64) * (torch.pi / 2)
    near = half_pi.float()
    x = torch.cat([x, near, torch.nextafter(near, near + 1), torch.nextafter(near, near - 1)])
    ref = torch.sin(x.double()) ** 2
    err = float((sin2(x).double() - ref).abs().max())
    lib_err = float((torch.sin(x) ** 2).double().sub(ref).abs().max())
    print(f"K2 / K10 sin^2 over {x.numel()} arguments, |x| <= 1e4: max_abs_err {err:.3g} "
          f"(tol {SIN2_TOL:.3g}; torch.sin squared in f32: {lib_err:.3g})")
    if not err <= SIN2_TOL:
        fail("the kernels' sin^2 disagrees with torch.sin in f64")


def check_k2(torch, dev, results):
    """K2 at its edge shapes (K2_EDGE_T), then at the activations of a
    448-frame vocode (~5 s, the bench slice's 256-code bucket; the entry's
    headline) and of a 2656-frame one (the production slice's mel bucket,
    the server default's size); the kernel's plan a shape where the tree
    has a planner; its ptxas registers and spills."""
    from voice_tts_tpu_torch.ops import aa_activation as aa

    g = torch.Generator(device=dev).manual_seed(3)
    sin2 = getattr(aa, "sin2_cuda", None)   # an older checkout has none
    if sin2 is not None:
        check_sin2(torch, dev, g, sin2)
    worst = 0.0
    for t in K2_EDGE_T:
        worst = max(worst, k2_case(torch, dev, g, aa, 8, t)[1])
    plan = getattr(aa, "plan_aa_snake", None)   # an older checkout has none
    if plan is not None:
        print("K2 plans (rows, T): " + json.dumps(
            {f"{c}x{t}": plan(c, t)._asdict()
             for c, t in sorted(set(vocoder_shapes(448) + vocoder_shapes(2656)
                                    + [(8, t) for t in K2_EDGE_T[:4]]))}))
    worst_b, bench = k2_vocode(torch, dev, g, aa, 448)
    worst_p, prod = k2_vocode(torch, dev, g, aa, 2656)
    print_ptxas(("aa_snake",))
    results.append({
        "name": "aa_snake_activation", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/aa_snake.cu",
        "replaces": "voice_tts_tpu/ops/aa_activation.py:210",
        "max_abs_err": max(worst, worst_b, worst_p), "ms": bench["ms"],
        "device_ms": bench["device_ms"], "plain_ms": bench["plain_ms"],
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"], "library_ms": None,
        "ms_of": "the 109 activations of one 448-frame vocode",
        "production_vocode": prod})


# f32 attention: sums of up to 3104 products in another order, and one
# rescaling a 64-key tile in the kernel's online softmax
ATT_F32_TOL = 1e-4
# bf16 attention: the kernel rounds the unnormalized probabilities to bf16
# (as jax's flash kernel), the plain K9 version the normalized ones, and the
# output rounds to bf16: a few bf16 ulps (2^-8) of the largest magnitude
ATT_BF16_TOL = 2 ** -6


def attention_case(torch, dev, g, kind: str, dtype, t: int, lens: list):
    """One K9 or K11 case at B 2, H 8, hd 64: kernel against its plain
    version (valid query rows), CUDA-event times (a host loop, and
    device-only behind a sleep), bound, and the times of
    `F.scaled_dot_product_attention` with the boolean mask that computes the
    same function on valid rows (checked against the plain version), timed
    alike."""
    import torch.nn.functional as F
    from voice_tts_tpu_torch.ops import cfm_attention as k9
    from voice_tts_tpu_torch.ops import flash_attention as k11

    b, h, hd = 2, 8, 64
    q, k, v = (torch.randn(b, h, t, hd, generator=g, device=dev).to(dtype)
               for _ in range(3))
    lens_t = torch.tensor(lens, device=dev, dtype=torch.int32)
    keep = torch.arange(t, device=dev)[None, :] < lens_t[:, None]       # (B, T)
    if kind == "K9":
        args = (q, k, v, lens_t, hd ** -0.5)
        kernel, plain = k9.cfm_attention, k9.cfm_attention_ref
        mask = keep[:, None, None, :]
        # keys a query row attends to: lens[b] for each of the T rows
        attended = sum(t * n for n in lens)
    else:
        seg = keep.to(torch.int32)
        args = (q, k, v, seg, seg, hd ** -0.5)
        kernel, plain = k11.flash_attention, k11.flash_attention_ref
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]
        # a row of segment 1 sees lens[b] keys, one of segment 0 T - lens[b]
        attended = sum(n * n + (t - n) * (t - n) for n in lens)
        lens_t = seg
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    tol = ATT_F32_TOL if dtype == torch.float32 else ATT_BF16_TOL
    tag = f"{kind} {str(dtype).split('.')[-1]} B={b} H={h} T={t} lens={lens}"
    err = max(max_err(torch, out[i, :, :n], ref[i, :, :n]) for i, n in enumerate(lens))
    scale = max(1.0, float(ref.float().abs().max()))
    print(f"{tag}: max_abs_err {err:.4g} on valid rows (tol {tol:.4g} * "
          f"max(1, max|ref|) = {tol * scale:.4g})")
    if not torch.isfinite(out.float()).all() or not err <= tol * scale:
        fail(f"{tag} disagrees with the plain version")
    ms = cuda_time_ms(torch, lambda: kernel(*args), 10)
    dev_ms = device_time_ms(torch, lambda: kernel(*args), 20)
    plain_ms = cuda_time_ms(torch, lambda: plain(*args), 3)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=hd ** -0.5)
    lib_ms = lib_dev_ms = None
    try:
        lib_err = max(max_err(torch, library()[i, :, :n], ref[i, :, :n])
                      for i, n in enumerate(lens))
    except (NotImplementedError, RuntimeError) as e:
        print(f"library call unavailable: {str(e).splitlines()[0][:200]}")
    else:
        print(f"{tag} F.scaled_dot_product_attention: max_abs_err {lib_err:.4g}")
        if lib_err <= 4 * tol * scale:
            lib_ms = library_time_ms(torch, library, 10)
            lib_dev_ms = device_time_ms(torch, library, 20)
    # q, k, v read, the output written, the mask's ints read; QK^T and PV
    # are 4 operations a (query, attended key, head dim)
    bnd = bound(nbytes(q, k, v, out, lens_t), 4 * h * hd * attended,
                "f32" if dtype == torch.float32 else "bf16")
    print(f"{tag}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), {plain_ms:.4f} ms "
          f"plain, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library "
          f"{lib_ms} ms ({lib_dev_ms} device-only)")
    return {"dtype": str(dtype).split(".")[-1], "t": t, "lens": lens, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "max_abs_err": err, **bnd}


def attention_edges(torch, dev, g):
    """K9 and K11 against their plain versions on EVERY query row at the
    edges the bf16 tensor-core tile leans on, bf16 and f32, H 8: T 65 and
    130 (a ragged last key tile); K9 at lens 0 (the uniform row over all T
    keys), 1, 63, 64, 65 and T (its key loop stops at ceil(lens / 64)
    tiles); K11 with the same key segments and one query row whose segment
    matches no key (the uniform row again).  A bf16 view off the kernel's
    16-byte grid must raise."""
    from voice_tts_tpu_torch.ops import cfm_attention as k9
    from voice_tts_tpu_torch.ops import flash_attention as k11

    h, hd = 8, 64
    for dtype in (torch.bfloat16, torch.float32):
        tol = ATT_F32_TOL if dtype == torch.float32 else ATT_BF16_TOL
        for t in (65, 130):
            lens = [0, 1, 63, 64, 65, t]
            q, k, v = (torch.randn(len(lens), h, t, hd, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            lens_t = torch.tensor(lens, device=dev, dtype=torch.int32)
            kv_seg = (torch.arange(t, device=dev)[None, :] < lens_t[:, None]).to(torch.int32)
            q_seg = kv_seg.clone()
            q_seg[:, t // 2] = 2                       # a row that matches no key
            for kind, kernel, plain, args in (
                    ("K9", k9.cfm_attention, k9.cfm_attention_ref,
                     (q, k, v, lens_t, hd ** -0.5)),
                    ("K11", k11.flash_attention, k11.flash_attention_ref,
                     (q, k, v, q_seg, kv_seg, hd ** -0.5))):
                out = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                err = max_err(torch, out, ref)
                scale = max(1.0, float(ref.float().abs().max()))
                tag = f"{kind} edge {str(dtype).split('.')[-1]} T={t} lens={lens}"
                print(f"{tag}: max_abs_err {err:.4g} on every row (tol {tol * scale:.4g})")
                if not torch.isfinite(out.float()).all() or not err <= tol * scale:
                    fail(f"{tag} disagrees with the plain version")
    b, t = 2, 130
    n = b * h * t * hd
    buf = torch.randn(b * h * t * 68 + 8, generator=g, device=dev).to(torch.bfloat16)
    good = buf[:n].view(b, h, t, hd)
    lens_t = torch.tensor([t, 65], device=dev, dtype=torch.int32)
    seg = (torch.arange(t, device=dev)[None, :] < lens_t[:, None]).to(torch.int32)
    for what, bad in (("base one element off", buf[1:n + 1].view(b, h, t, hd)),
                      ("time stride 68", buf.as_strided((b, h, t, hd), (h * t * 68, t * 68, 68, 1)))):
        for kind, call in (("K9", lambda x: k9.cfm_attention(x, good, good, lens_t, 0.125)),
                           ("K11", lambda x: k11.flash_attention(x, good, good, seg, seg, 0.125))):
            try:
                call(bad)
            except ValueError as e:
                print(f"{kind} bf16 q with {what} raises: {e}")
            else:
                fail(f"{kind}: a bf16 q with {what} did not raise")
    torch.cuda.synchronize()


def check_attention(torch, dev, results):
    """K9 and K11: the edge cases (`attention_edges`), then B 2, H 8, hd 64,
    bf16 and f32, T 896 (the DiT slice's 5 s prompt) and T 3104 (the
    production slice's mel bucket 2656 plus prompt bucket 448), lens below
    T; the entry's headline is bf16 at T 896, the shape the slice runs."""
    g = torch.Generator(device=dev).manual_seed(10)
    attention_edges(torch, dev, g)
    for kind, name, src in (("K9", "cfm_attention", "voice_tts_tpu/ops/attic/cfm_attention.py:64"),
                            ("K11", "flash_attention", "voice_tts_tpu/models/s2mel/dit.py:122")):
        print(f"{kind} tolerance: f32 {ATT_F32_TOL} (sums in another order), bf16 "
              f"{ATT_BF16_TOL} (probabilities rounded before the normalisation, "
              f"output rounded to bf16), times max(1, max|ref|)")
        cases = [attention_case(torch, dev, g, kind, dtype, t, lens)
                 for dtype in (torch.bfloat16, torch.float32)
                 for t, lens in ((896, [850, 600]), (3104, [3000, 2100]))]
        head = cases[0]
        results.append({
            "name": name, "route": "cuda", "source": "voice_tts_tpu_torch/csrc/dit_attention_mma.cuh",
            "replaces": src, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library_device_ms": head["library_device_ms"],
            "library_call": "torch.nn.functional.scaled_dot_product_attention (boolean mask)",
            "ms_of": "one call, bf16, B 2, H 8, T 896, lens (850, 600); f32 cases run "
                     "csrc/dit_attention.cuh", "cases": cases})


# K8 on the card against its plain version: the same bf16 rounding points,
# but GEMM sums in another order, expf against torch's sigmoid, and the
# attention's probabilities rounded before the normalisation flip single bf16
# roundings, compounded over 13 blocks
K8_TOL = 2e-2
# kernels a K8 call must not launch: the CUDA-core attention loop and the
# mma.sync GEMM tile, replaced by the tensor-core attention tile and the
# wgmma GEMM
K8_RETIRED = ("dit_attention_kernel", "gemm_bf16_kernel")
# K8 cases: (T, valid keys of each of the B 2 rows); the first is the DiT
# slice's T 704 and is timed, the second a ragged T with one valid key
K8_CASES = ((704, (650, 650)), (130, (1, 77)))
# chained trunk evaluations a device-only K8 time queues behind the sleep
# (a call is 92 launches)
K8_ITERS = 4


def profile_k8(torch, run):
    """One K8 evaluation under the CUDA profiler: device time by kernel and
    its spans (attention, the GEMMs, adaRMS).  Under programmatic dependent
    launch a span includes its wait for the previous launch, so the spans
    overlap."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]

    def span(name):
        return sum(e.self_device_time_total for e in events if name in e.key) / 1e3
    return {"kernels_a_call": sum(e.count for e in events),
            "attention_span_ms": span("dit_attention"), "gemm_span_ms": span("gemm"),
            "ada_rms_span_ms": span("ada_rms"), "device_busy_ms": span(""),
            "by_kernel": {e.key[:90]: {"count": e.count,
                                       "device_ms": e.self_device_time_total / 1e3}
                          for e in events}}


def k8_plans(torch, k8, b, t, d):
    """The tile of each of the chain's GEMMs at B, T: `plan_dit_gemm`'s,
    which must be the C launch's (`vtt_dit_gemm_plan`); printed."""
    import ctypes

    from voice_tts_tpu_torch.ops import build

    lib, plans = build.kernels().lib, {}
    for name, (m, n, k) in k8.dit_gemm_shapes(b, t, d).items():
        tile = k8.plan_dit_gemm(m, n, k)
        bm, bn = ctypes.c_int(), ctypes.c_int()
        if lib.vtt_dit_gemm_plan(m, n, k, ctypes.byref(bm), ctypes.byref(bn)) != 0:
            fail(f"vtt_dit_gemm_plan refused M {m}, N {n}, K {k}")
        if (bm.value, bn.value) != (tile.bm, tile.bn):
            fail(f"K8 {name} GEMM: the C launch plans {bm.value} x {bn.value}, "
                 f"plan_dit_gemm {tile.bm} x {tile.bn}")
        plans[name] = {"m": m, "n": n, "k": k, **tile._asdict()}
    print(f"K8 GEMM tiles at B {b}, T {t}: " + json.dumps(plans))
    return plans


def check_k8(torch, dev, results):
    """K8 at the flagship trunk (13 blocks, D 512, 8 heads) with random DiT
    weights, B 2 (CFG), at each of K8_CASES: against the plain version on
    valid rows, two calls bit-equal, the GEMM planner's tiles printed; the
    first case (T 704, lens 650) timed in a host loop and device-only, with
    one evaluation profiled."""
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.models.layers import init_weights
    from voice_tts_tpu_torch.models.s2mel.dit import DiT
    from voice_tts_tpu_torch.ops import dit_blocks as k8

    cfg = TTSConfig().s2mel
    g = torch.Generator(device=dev).manual_seed(11)
    with torch.device(dev):
        dit = init_weights(DiT(cfg.dit, cfg.wavenet), g).eval()
    d, heads, depth = cfg.dit.hidden_dim, cfg.dit.num_heads, cfg.dit.depth
    with torch.no_grad():
        tables = dit.step_tables(torch.tensor([0.36], device=dev))
        wb = k8.pack_dit_tables(dit, tables)[0]
        pack = k8.pack_dit_blocks(dit)
    print(f"K8 tolerance: {K8_TOL} * max|ref| of each row's valid positions (bf16 "
          f"roundings flipped by sums in another order, compounded over {depth} blocks)")
    errs, plans = [], {}
    for case, (t, lens) in enumerate(K8_CASES):
        b = len(lens)
        plans[t] = k8_plans(torch, k8, b, t, d)
        x = torch.randn(b, t, d, generator=g, device=dev)
        cos, sin = k8.rope_tables(t, d // heads, cfg.dit.rope_base, dev)
        lens_t = torch.tensor(lens, device=dev, dtype=torch.int32)

        def run(fn):
            return fn(x, pack, wb, cos, sin, lens_t, heads)
        out = run(k8.dit_block_chain)
        again = run(k8.dit_block_chain)
        torch.cuda.synchronize()
        ref = run(k8.dit_block_chain_ref)
        tag = f"K8 L={depth} D={d} H={heads} B={b} T={t} lens={lens}"
        for i, n in enumerate(lens):
            err, scale = max_err(torch, out[i, :n], ref[i, :n]), float(ref[i, :n].abs().max())
            print(f"{tag} row {i}: max_abs_err {err:.4g} on its {n} valid rows "
                  f"(max|ref| {scale:.4g})")
            if not torch.isfinite(out[i, :n]).all() or not err <= K8_TOL * scale:
                fail(f"{tag} row {i} disagrees with the plain version")
            errs.append(err)
        if not torch.equal(out, again):
            fail(f"{tag}: two calls differ")
        print(f"{tag}: two calls bit-equal")
        if case:
            continue
        ms = cuda_time_ms(torch, lambda: run(k8.dit_block_chain), 10)
        dev_ms = device_time_ms(torch, lambda: run(k8.dit_block_chain), K8_ITERS)
        plain_ms = cuda_time_ms(torch, lambda: run(k8.dit_block_chain_ref), 3)
        prof = profile_k8(torch, lambda: run(k8.dit_block_chain))
        print(f"{tag} profiled: " + json.dumps(prof))

        def run_serial():
            return k8.dit_block_chain_cuda(x, pack, wb, cos, sin, lens_t, heads, pdl=False)
        serial_ms = device_time_ms(torch, run_serial, K8_ITERS)
        serial = profile_k8(torch, run_serial)
        print(f"{tag} without programmatic dependent launch: {serial_ms:.4f} ms "
              f"device-only; profiled (spans do not overlap): " + json.dumps(serial))
        retired = [k for k in prof["by_kernel"] if any(r in k for r in K8_RETIRED)]
        # bytes: the bf16 weights once, x read and the output written in f32,
        # the tables; operations: 2 per multiply-add of the 13 D^2 weights a
        # row, and 4 a (query, valid key, head dim) of the attention, every layer
        n = lens[0]
        ops = depth * (2 * b * t * 13 * d * d + 4 * d * b * t * n)
        bnd = bound(nbytes(*pack, x, out, wb, cos, sin, lens_t), ops)
        print(f"K8: {ms:.4f} ms kernel chain ({dev_ms:.4f} device-only), {plain_ms:.4f} "
              f"ms plain, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        head = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "profile": prof,
                "serial_device_ms": serial_ms, "serial_profile": serial,
                **bnd}
        if retired:
            fail(f"K8 launched retired kernels: {retired}")
    results.append({
        "name": "dit_block_chain", "route": "cuda", "source": "voice_tts_tpu_torch/csrc/dit_blocks.cu",
        "replaces": "voice_tts_tpu/ops/attic/dit_blocks.py:243", "max_abs_err": max(errs),
        "ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None,
        "ms_of": "one trunk evaluation (13 blocks), B 2, T 704, lens 650",
        "bound_bytes": head["bound_bytes"], "bound_ops": head["bound_ops"],
        "spans_ms": {k: head["profile"][k] for k in
                     ("attention_span_ms", "gemm_span_ms", "ada_rms_span_ms",
                      "device_busy_ms")},
        "serial": {"device_ms": head["serial_device_ms"],
                   **{k: head["serial_profile"][k] for k in
                      ("attention_span_ms", "gemm_span_ms", "ada_rms_span_ms",
                       "device_busy_ms")}},
        "gemm_tiles": plans})


# K5 against its plain version: f32 sums in another order (and over other
# tiles of the online softmax); bf16 inputs keep f32 sums, the output rounds
# to bf16 (8 significant bits), so one flipped rounding is one ulp, which
# near the largest magnitude m is up to 2^-7 * m
K5_F32_TOL = 1e-5
K5_BF16_TOL = 2 ** -7
K5_WIDTHS = (32, 64, 128, 256, 512)     # the split widths the kernel takes
# K5's edges: (B, Tmax, length, each row's -1e30 positions [lo, hi) or
# None).  Lengths 1, 31, 32, 33 around the 32-position split; a split
# wholly under the bias at length 100 (splits of 32); length = Tmax; B 3
# one position past a split boundary (5 splits of 128); a row whose whole
# live prefix is masked (the uniform average over it)
K5_EDGES = ((1, 512, 1, [None]), (1, 512, 31, [None]), (1, 512, 32, [(8, 9)]),
            (1, 512, 33, [None]), (1, 512, 100, [(32, 64)]), (1, 512, 512, [(40, 52)]),
            (3, 2048, 513, [(40, 52), None, (256, 512)]),
            (3, 512, 40, [(0, 64), (3, 5), None]))


def k5_inputs(torch, dev, g, dtype, b, t_max, masked):
    h, hd = 20, 64
    q = torch.randn(b, h, hd, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, h, hd, t_max, generator=g, device=dev).to(dtype)
            for _ in range(2))
    bias = torch.zeros(b, t_max, device=dev)
    for i, span in enumerate(masked):
        if span is not None:
            bias[i, span[0]:span[1]] = -1e30
    return q, k, v, bias


def k5_edges(torch, dev, g):
    """K5 against its plain version at K5_EDGES, bf16 and f32, the
    planner's split printed; two calls bit-equal."""
    from voice_tts_tpu_torch.ops import decode_attention as k5

    for dtype in (torch.bfloat16, torch.float32):
        tol = K5_F32_TOL if dtype == torch.float32 else K5_BF16_TOL
        for b, t_max, length, masked in K5_EDGES:
            q, k, v, bias = k5_inputs(torch, dev, g, dtype, b, t_max, masked)
            out = k5.decode_attention(q, k, v, bias, length)
            again = k5.decode_attention(q, k, v, bias, length)
            torch.cuda.synchronize()
            ref = k5.decode_attention_plain(q, k, v, bias, length)
            err, scale = max_err(torch, out, ref), float(ref.float().abs().max())
            tag = (f"K5 edge {str(dtype).split('.')[-1]} B={b} Tmax={t_max} "
                   f"length={length} masked={masked} splits "
                   f"{k5.plan_decode_splits(b, 20, length)}")
            print(f"{tag}: max_abs_err {err:.4g} (max|ref| {scale:.4g})")
            if not torch.isfinite(out.float()).all() or not err <= tol * scale:
                fail(f"{tag} disagrees with the plain version")
            if not torch.equal(out, again):
                fail(f"{tag}: two calls differ")


def check_k5(torch, dev, results):
    """K5 at the flagged decode paths' shapes (GPT 20 heads of 64): B 1, Tmax
    512, length 343 (the bench configuration with the flag) and B 3, Tmax
    2048, length 1571 (beam-3 in the production profile with the flag), bf16
    and f32, timed in a host loop and device-only, beside
    `F.scaled_dot_product_attention` on the same live prefix with the bias
    as its additive mask; then the edges (`k5_edges`).  The headline is
    bf16 at B 1."""
    import torch.nn.functional as F
    from voice_tts_tpu_torch.ops import decode_attention as k5

    print(f"K5 tolerance: f32 {K5_F32_TOL} * max|ref| (sums in another order), bf16 "
          f"{K5_BF16_TOL} * max|ref| (the bf16 output rounding)")
    g = torch.Generator(device=dev).manual_seed(12)
    h, hd, cases = 20, 64, []
    for dtype in (torch.bfloat16, torch.float32):
        for b, t_max, length in ((1, 512, 343), (3, 2048, 1571)):
            q, k, v, bias = k5_inputs(torch, dev, g, dtype, b, t_max, [(40, 52)] * b)
            args = (q, k, v, bias, length)
            out = k5.decode_attention(*args)
            again = k5.decode_attention(*args)
            torch.cuda.synchronize()
            ref = k5.decode_attention_plain(*args)
            tol = K5_F32_TOL if dtype == torch.float32 else K5_BF16_TOL
            err, scale = max_err(torch, out, ref), float(ref.float().abs().max())
            split_t, splits = k5.plan_decode_splits(b, h, length)
            tag = (f"K5 {str(dtype).split('.')[-1]} B={b} H={h} Tmax={t_max} length={length} "
                   f"({splits} splits of {split_t})")
            print(f"{tag}: max_abs_err {err:.4g} (max|ref| {scale:.4g})")
            if not torch.isfinite(out.float()).all() or not err <= tol * scale:
                fail(f"{tag} disagrees with the plain version")
            if not torch.equal(out, again):
                fail(f"{tag}: two calls differ")
            ms = cuda_time_ms(torch, lambda: k5.decode_attention(*args), 50)
            dev_ms = device_time_ms(torch, lambda: k5.decode_attention(*args), 50)
            # every width the planner could choose, device-only: the planner's
            # choice against the others
            by_width = {w: device_time_ms(
                torch, lambda w=w: k5.decode_attention_cuda(*args, split_t=w), 50)
                for w in K5_WIDTHS}
            print(f"{tag}: device-only ms by split width " + json.dumps(by_width))
            plain_ms = cuda_time_ms(torch, lambda: k5.decode_attention_plain(*args), 20)
            kl = k[..., :length].transpose(-1, -2)  # (B, H, L, hd) views of the cache
            vl = v[..., :length].transpose(-1, -2)
            mask = bias[:, None, None, :length].to(dtype)

            def library():
                return F.scaled_dot_product_attention(q[:, :, None], kl, vl,
                                                      attn_mask=mask)[:, :, 0]
            lib_ms = lib_dev_ms = None
            lib_err = max_err(torch, library(), ref)
            print(f"{tag} F.scaled_dot_product_attention: max_abs_err {lib_err:.4g}")
            if lib_err <= 4 * tol * scale:
                lib_ms = library_time_ms(torch, library, 50)
                lib_dev_ms = library_time_ms(torch, library, 50, timer=device_time_ms)
            # the K and V prefix read once, q, the bias prefix, the output
            # written; 4 operations a (head, dim, attended position)
            el = q.element_size()
            bnd = bound(2 * b * h * hd * length * el + nbytes(q, out) + 4 * b * length,
                        4 * b * h * hd * length, "f32" if dtype == torch.float32 else "bf16")
            print(f"{tag}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only), {plain_ms:.4f} "
                  f"ms plain, bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), "
                  f"library {lib_ms} ms ({lib_dev_ms} device-only)")
            cases.append({"dtype": str(dtype).split(".")[-1], "b": b, "t_max": t_max,
                          "length": length, "split_t": split_t, "splits": splits,
                          "ms": ms, "device_ms": dev_ms, "device_ms_by_width": by_width,
                          "plain_ms": plain_ms, "library_ms": lib_ms,
                          "library_device_ms": lib_dev_ms, "max_abs_err": err, **bnd})
    k5_edges(torch, dev, g)
    head = cases[0]
    results.append({
        "name": "decode_attention", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "voice_tts_tpu/ops/decode_attention.py:104",
        "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": head["ms"],
        "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library_device_ms": head["library_device_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention (additive mask)",
        "ms_of": "one call, bf16, B 1, H 20, Tmax 512, length 343", "cases": cases})


# K10 against its plain version (cuDNN f32 convs with TF32 off): f32 sums in
# another order through 18 convs of up to 192 x 11 terms
K10_TOL = 1e-4
VOC_HALO = 78            # a stage's stencil halo (the module path's edges differ)


def flagship_vocoder(torch, dev, seed: int):
    """The flagship BigVGAN (`TTSConfig().vocoder`) with random weights, its
    snake parameters moved off zero so the activations bend."""
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.models.layers import init_weights
    from voice_tts_tpu_torch.models.vocoder.bigvgan import BigVGAN

    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        voc = init_weights(BigVGAN(TTSConfig().vocoder), g).eval().requires_grad_(False)
        for name, p in voc.named_parameters():
            if name.endswith(("alpha", "beta")):
                p.add_(0.1 * torch.randn(p.shape, generator=g, device=dev))
    return voc


def k10_plans(k10, cfg, frames_list) -> dict:
    """`plan_fused_stage`'s plan of every (stage, k, d) launch of the fused
    stages at `frames_list`, and at the kernel's largest halo, each checked
    against the C launch's (`vtt_fused_stage_plan`); printed."""
    import ctypes

    from voice_tts_tpu_torch.ops import build

    lib, plans = build.kernels().lib, {}
    shapes = sorted({s for f in frames_list for s in vocoder_shapes(f)[2:]})
    dils = sorted(set(cfg.resblock_dilation_sizes[0]) | {1})
    cases = [(c, t, k, d) for c, t in shapes for k in cfg.resblock_kernel_sizes
             for d in dils]
    cases += [(c, 4096, k10.MAX_TAPS, k10.MAX_HALO // ((k10.MAX_TAPS - 1) // 2))
              for c in (24, 192)] + [(c, 4096, 3, k10.MAX_HALO) for c in (24, 192)]
    for c, t, k, d in cases:
        plan = k10.plan_fused_stage(c, t, k, d)
        got = (ctypes.c_int * len(plan))()
        if lib.vtt_fused_stage_plan(c, t, k, d, got) != 0:
            fail(f"vtt_fused_stage_plan refused C {c}, T {t}, k {k}, d {d}")
        if tuple(got) != tuple(plan):
            fail(f"K10 C {c} T {t} k {k} d {d}: the C launch plans {tuple(got)}, "
                 f"plan_fused_stage {tuple(plan)}")
        if plan.smem > 232448:
            fail(f"K10 C {c} T {t} k {k} d {d}: {plan.smem} bytes of shared memory")
        plans[f"C{c} T{t} k{k} d{d}"] = plan._asdict()
    print("K10 plans: " + json.dumps(plans))
    return plans


# K10's measurement arms (`span`), each device-only: the prologue alone, the
# MMA loop alone, the MMA loop without its weight stream, and the skeleton
# (weight stream, barriers, epilogue and launches: no prologue, no MMA)
K10_SPANS = ("prologue", "mma", "mma_no_weights", "skeleton")


def k10_stages(torch, dev, g, k10, packs, dil, frames: int, sum_k: int, spans: bool):
    """K10 at the four fused stages of a `frames`-frame vocode: against the
    plain version (K10_TOL) and itself (two calls bit-equal), timed in a
    host loop and device-only, the plain version timed, with both bounds;
    with `spans`, each of K10_SPANS device-only."""
    n_iter = len(dil)
    iters, plain_iters = (5, 3) if frames <= 448 else (2, 1)
    cases = []
    for (c, t), (i, pack) in zip(vocoder_shapes(frames)[2:], sorted(packs.items())):
        x = torch.randn(1, c, t, generator=g, device=dev) * 0.3
        out = k10.fused_resblock_stage(x, pack, dil)
        out2 = k10.fused_resblock_stage(x, pack, dil)
        torch.cuda.synchronize()
        ref = k10.fused_resblock_stage_plain(x, pack, dil)
        err, scale = max_err(torch, out, ref), float(ref.abs().max())
        tag = f"K10 {frames} frames, stage {i} C={c} T={t}"
        print(f"{tag}: max_abs_err {err:.4g} (max|ref| {scale:.4g}, tol "
              f"{K10_TOL * scale:.4g})")
        if not torch.isfinite(out).all() or not err <= K10_TOL * scale:
            fail(f"{tag} disagrees with the plain version")
        if not torch.equal(out, out2):
            fail(f"{tag}: two calls differ")
        del out, out2, ref
        run = lambda: k10.fused_resblock_stage(x, pack, dil)  # noqa: E731
        ms = cuda_time_ms(torch, run, iters, warmup=1)
        dev_ms = device_time_ms(torch, run, iters, warmup=1)
        plain_ms = cuda_time_ms(torch, lambda: k10.fused_resblock_stage_plain(x, pack, dil),
                                plain_iters, warmup=1)
        # x read and the output written once, each block's own taps (2 n_iter
        # convs of k_j x C x C) with their biases and snake values; 2
        # operations a multiply-add of 2 C^2 T n_iter sum_j k_j: in f32 on
        # the CUDA cores, or as three TF32 products on the tensor cores
        n_bytes = 2 * nbytes(x) + 4 * (2 * n_iter * sum_k * c * c + 3 * pack.b.numel())
        n_ops = 2 * c * c * t * 2 * n_iter * sum_k
        b32, btf = bound(n_bytes, n_ops, "f32"), bound(n_bytes, 3 * n_ops, "tf32")
        case = {"stage": i, "c": c, "t": t, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "max_abs_err": err, **btf,
                "bound_f32_ms": b32["bound_ms"], "bound_f32_ops": n_ops}
        if spans:
            for span in K10_SPANS:
                case[f"{span}_ms"] = device_time_ms(
                    torch, lambda: k10.fused_resblock_stage_cuda(x, pack, dil, span=span),
                    iters, warmup=1)
        print(f"{tag}: {ms:.4f} ms kernel ({dev_ms:.4f} device-only"
              + ("; alone: " + ", ".join(f"{sp} {case[sp + '_ms']:.4f}" for sp in K10_SPANS)
                 if spans else "")
              + f"), {plain_ms:.4f} ms plain, bound {btf['bound_ms']:.4f} ms (3 TF32 "
              f"passes) / {b32['bound_ms']:.4f} ms (f32)")
        cases.append(case)
        del x
    tf32 = bound(sum(c["bound_bytes"] for c in cases), sum(c["bound_ops"] for c in cases),
                 "tf32")
    f32 = bound(sum(c["bound_bytes"] for c in cases),
                sum(c["bound_f32_ops"] for c in cases), "f32")
    tot = {k: sum(c[k] for c in cases) for k in ("ms", "device_ms", "plain_ms")}
    print(f"K10 per vocode ({frames} frames, the four fused stages): {tot['ms']:.4f} ms "
          f"kernel ({tot['device_ms']:.4f} device-only), {tot['plain_ms']:.4f} ms plain, "
          f"bound {tf32['bound_ms']:.4f} ms (3 TF32 passes) / {f32['bound_ms']:.4f} ms (f32)")
    return {"frames": frames, **tot, "bound_ms": tf32["bound_ms"],
            "bound_by": tf32["bound_by"], "bound_f32_ms": f32["bound_ms"],
            "max_abs_err": max(c["max_abs_err"] for c in cases), "cases": cases}


def check_k10(torch, dev, results):
    """K10 at the four fused stages of the flagship BigVGAN (C 192, 96, 48,
    24 at 32, 64, 128, 256 samples a frame), f32, random weights, for a
    448-frame mel (the entry's headline) and a 2656-frame one (the
    production mel bucket); the entry's times are the four summed (one
    vocode's fused stages).  Where the tree has the planner, its plans are
    checked against C's and the prologue and MMA loop are timed apart."""
    from voice_tts_tpu_torch.ops import fused_vocoder as k10

    # the plain reference's convs in full f32, as the engine runs them
    torch.backends.cudnn.allow_tf32 = False
    voc = flagship_vocoder(torch, dev, 13)
    cfg = voc.cfg
    packs = k10.pack_fused_stages(voc.state_dict(), cfg)
    del voc
    dil = tuple(cfg.resblock_dilation_sizes[0])
    sum_k = sum(cfg.resblock_kernel_sizes)
    redesigned = hasattr(k10, "plan_fused_stage")   # an older checkout has no plan
    if redesigned:
        k10_plans(k10, cfg, (448, 2656))
    g = torch.Generator(device=dev).manual_seed(14)
    print(f"K10 tolerance: {K10_TOL} * max|ref| (f32 sums in another order); "
          f"fused stages {sorted(packs)}")
    bench = k10_stages(torch, dev, g, k10, packs, dil, 448, sum_k, redesigned)
    prod = k10_stages(torch, dev, g, k10, packs, dil, 2656, sum_k, redesigned)
    print_ptxas(("stage_pair",))
    results.append({
        "name": "fused_resblock_stage", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_vocoder.cu",
        "replaces": "voice_tts_tpu/ops/attic/fused_vocoder.py:192",
        "max_abs_err": max(bench["max_abs_err"], prod["max_abs_err"]),
        "ms": bench["ms"], "device_ms": bench["device_ms"], "plain_ms": bench["plain_ms"],
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
        "bound_f32_ms": bench["bound_f32_ms"], "library_ms": None,
        "ms_of": "the four fused stages of one 448-frame vocode, summed; bound_ms: "
                 "three TF32 tensor-core passes, bound_f32_ms: f32 on the CUDA cores",
        "cases": bench["cases"], "production_vocode": prod})
    del packs


# ---------------------------------------------------------------------------
# the micro-benchmark path (K12, K13)
# ---------------------------------------------------------------------------

MICRO_CHECK_TILES = 16
# a benchmark run: the scripts' defaults (D 1280, 288 tiles, 20 and 60 passes)
MICRO_D, MICRO_TILES, MICRO_LO, MICRO_HI = 1280, 288, 20, 60
# the mode each entry's headline times: K12's one-row product (K4's case),
# K13's grouped int4 scheme (K7's)
MICRO_HEADLINE = {"micro_tile": "dot1", "micro_int4": "cur"}
MICRO_LIBRARY = ("no single PyTorch call streams int8 tiles through a per-tile "
                 "stage and sums the tiles' terms (or carries a row through "
                 "them): the function is a benchmark loop, not a library "
                 "operation")


def check_micro_tile(torch, dev):
    """K12's modes against the plain version at D 1280, 16 tiles (dot8i with
    x scaled past the int8 range, so the saturating cast shows).  Returns
    each mode's error."""
    from voice_tts_tpu_torch.ops import micro_tile as mt
    from voice_tts_tpu_torch.scripts import micro_tile as script

    n = MICRO_CHECK_TILES
    x, w = script.make_inputs(MICRO_D, n, dev)
    # the kernel adds its partials in another order: each of the n + 1
    # adds on either side rounds by at most 2^-24 of the absolute sum of the
    # terms; the dots' f32 sums of D products also run in another order
    # (4 standard deviations of that random walk, sqrt(D) 2^-24)
    c_int = 2 * (n + 1) * 2 ** -24
    c_dot = c_int + 4 * MICRO_D ** 0.5 * 2 ** -24
    errs = {}
    for mode in mt.MODES:
        xm = x * 100 if mode == "dot8i" else x
        out = mt.micro_tile(xm, w, mode)
        torch.cuda.synchronize()
        ref = mt.micro_tile_plain(xm, w, mode)
        if mode in ("dot1", "dot8"):
            terms = [mt.stage_plain(xm.abs(), w[t].abs(), mode) for t in range(n)]
        else:
            terms = [mt.stage_plain(xm, w[t], mode).abs() for t in range(n)]
        mag = float((xm.abs() + sum(terms)).max())
        tol = (c_dot if mode in ("dot1", "dot8") else c_int) * mag
        err = max_err(torch, out, ref)
        print(f"K12 {mode} D={MICRO_D} T={n}: max_abs_err {err:.4g} (tol {tol:.4g} = "
              f"{tol / mag:.3g} * {mag:.4g}, the largest absolute sum of the terms)")
        if not torch.isfinite(out).all() or not err <= tol:
            fail(f"K12 micro_tile {mode} disagrees with the plain version")
        errs[mode] = err
    return errs


def check_micro_int4(torch, dev):
    """K13's modes against the plain version at D 1280, scales at U(500,
    2500) so that the tile term moves the carried row: one tile from a
    bf16-exact x (the tile's arithmetic), then 16 tiles (the barriers and
    buffers that carry the row).  Returns each mode's larger error."""
    from voice_tts_tpu_torch.ops import micro_int4 as mi
    from voice_tts_tpu_torch.scripts import micro_int4 as script

    x, w, gs, per_half = script.make_inputs(MICRO_D, MICRO_CHECK_TILES, dev,
                                            gs_range=(500.0, 2500.0))
    x1 = x.to(torch.bfloat16).float()
    # dma: the same f32 operations in the same order.  One tile: the dots'
    # f32 sums in another order.  16 tiles: a carried value that differs in
    # its last bit may round to a neighbouring bf16 before the next tile's
    # product, and such flips compound from tile to tile (one bf16 step is
    # 2^-8 of a value; 2^-6 of max|row 0| bounds where the two land, while a
    # fault in a tile's arithmetic or in the carry moves row 0 by its size)
    tols = {1: 1e-5, MICRO_CHECK_TILES: 2 ** -6}
    errs = {}
    for mode in mi.MODES:
        errs[mode] = 0.0
        for n, xn in ((1, x1), (MICRO_CHECK_TILES, x)):
            out = mi.micro_int4(xn, w[:n].contiguous(), gs, mode, per_half)
            torch.cuda.synchronize()
            ref = mi.micro_int4_plain(xn, w[:n], gs, mode, per_half)
            scale = float(ref[0].abs().max())
            tol = 0.0 if mode == "dma" else tols[n] * scale
            err = max_err(torch, out, ref)
            moved = float((ref[0] - 0.5 ** n * xn[0]).abs().max())
            print(f"K13 {mode} D={MICRO_D} T={n}: max_abs_err {err:.4g} (tol {tol:.4g}; "
                  f"max|row 0| {scale:.4g}, moved by the tiles {moved:.4g}); rows 1-7 "
                  f"equal: {bool(torch.equal(out[1:], ref[1:]))}")
            if (not torch.isfinite(out).all() or not err <= tol
                    or not torch.equal(out[1:], ref[1:])):
                fail(f"K13 micro_int4 {mode} T={n} disagrees with the plain version")
            errs[mode] = max(errs[mode], err)
    return errs


def micro_bound(name: str, mode: str, x, w, gs=None) -> dict:
    """The weight stream (each byte read once), x and gs read, the (8, D)
    output written; the products' operations at their type's peak."""
    d = x.shape[1]
    rows = {"dot1": 1, "dot8": 8, "dot8i": 8}.get(mode, 0) if name == "micro_tile" \
        else (0 if mode == "dma" else 1)
    ops = 2 * rows * d * d * w.shape[0]
    return bound(nbytes(w, gs, x) + nbytes(x), ops, "int8" if mode == "dot8i" else "bf16")


def run_micro_path(torch, dev, counters, results):
    """The micro-benchmark path: both entry points at their defaults with
    the launch counters from 0 (one launch a pass: 2 (lo + hi) a mode),
    then each plain version's time over 3 passes at the same shapes."""
    from voice_tts_tpu_torch.ops import micro_int4 as mi
    from voice_tts_tpu_torch.ops import micro_tile as mt
    from voice_tts_tpu_torch.scripts import micro_int4 as int4_script
    from voice_tts_tpu_torch.scripts import micro_tile as tile_script

    torch.backends.cuda.matmul.allow_tf32 = False    # the plain versions' dots in f32
    errs = {"micro_tile": check_micro_tile(torch, dev),
            "micro_int4": check_micro_int4(torch, dev)}
    args = ["--dim", str(MICRO_D), "--tiles", str(MICRO_TILES),
            "--lo", str(MICRO_LO), "--hi", str(MICRO_HI)]
    counters.reset()
    timed = {"micro_tile": tile_script.main(args), "micro_int4": int4_script.main(args)}
    launches = counters.snapshot()
    per_mode = 2 * (MICRO_LO + MICRO_HI)
    for name, mods in (("micro_tile", mt.MODES), ("micro_int4", mi.MODES)):
        if launches[name] != per_mode * len(mods):
            fail(f"{name}: {launches[name]} launches on the micro-benchmark path, "
                 f"expected {per_mode * len(mods)} (one a pass)")
    others = {k: v for k, v in launches.items() if v and k not in timed}
    if others:
        fail(f"the micro-benchmark path launched other kernels: {others}")
    print(f"micro-benchmark path launches: micro_tile {launches['micro_tile']}, "
          f"micro_int4 {launches['micro_int4']} (one a pass, {per_mode} a mode)")

    x, w = tile_script.make_inputs(MICRO_D, MICRO_TILES, dev)
    x4, w4, gs, per_half = int4_script.make_inputs(MICRO_D, MICRO_TILES, dev)
    cases = {"micro_tile": ((x, w), mt.micro_tile_plain),
             "micro_int4": ((x4, w4, gs), lambda x, w, gs, mode:
                            mi.micro_int4_plain(x, w, gs, mode, per_half))}
    for name, (data, plain) in cases.items():
        modes = {}
        for r in timed[name]:
            mode = r["mode"]
            plain_ms = cuda_time_ms(torch, lambda: plain(*data, mode), 3, warmup=1)
            b = micro_bound(name, mode, *data)
            modes[mode] = {"ms": r["ms"], "event_ms": r["event_ms"],
                           "us_per_tile": r["us_per_tile"], "gb_per_s": r["gb_per_s"],
                           "plain_ms": plain_ms, "max_abs_err": errs[name][mode], **b}
            print(f"{name} {mode}: {r['ms']:.4f} ms a pass (events {r['event_ms']:.4f}), "
                  f"{r['gb_per_s']:.1f} GB/s, plain {plain_ms:.3f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        head = modes[MICRO_HEADLINE[name]]
        results.append({
            "name": name, "route": "cuda", "source": f"voice_tts_tpu_torch/csrc/{name}.cu",
            "replaces": {"micro_tile": "scripts/micro_tile.py:51",
                         "micro_int4": "scripts/micro_int4.py:119"}[name],
            "max_abs_err": max(errs[name].values()), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "library_note": MICRO_LIBRARY,
            "ms_of": f"a pass of mode {MICRO_HEADLINE[name]} at D {MICRO_D}, "
                     f"{MICRO_TILES} tiles ((t({MICRO_HI}) - t({MICRO_LO})) / "
                     f"{MICRO_HI - MICRO_LO}, as the script times); every mode under modes",
            "launches_per_pass": 1, "modes": modes})
    del x, w, x4, w4, gs, cases
    return launches


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def tone_prompt(seconds: float, sr: int) -> bytes:
    """A two-tone prompt WAV (as bench.py builds it)."""
    import numpy as np
    from voice_tts_tpu_torch.audio import encode_wav_int16

    t = np.arange(int(seconds * sr)) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    return encode_wav_int16(tone * 32767, sr)


def _shared_noise(torch, cpu, gpu, dev):
    """Hand both engines the same CFM noise, drawn on the CPU."""
    g = torch.Generator().manual_seed(5)
    noise = {}

    def draw(shape):
        if tuple(shape) not in noise:
            noise[tuple(shape)] = torch.randn(shape, generator=g)
        return noise[tuple(shape)]
    cpu._draw_noise = lambda shape: draw(shape)
    gpu._draw_noise = lambda shape: draw(shape).to(dev)


def _tiny_pair(torch, dev, dit=None, gpt=None, **flags):
    """The tiny engine with engine `flags` on the CPU (plain versions) and on
    the card (every kernel launched), with the same random weights.  With
    `dit` (DiTConfig fields to set) the DiT is widened to D 256, 4 heads:
    the DiT kernels' 64-wide heads, and `can_fuse_dit` holds.  `gpt` sets
    GPTConfig fields of the two engines (their runtime GPT is built from
    it)."""
    import copy

    from voice_tts_tpu_torch.engine.engine import TTSEngine, tiny_config

    def config(**engine_flags):
        cfg = tiny_config(**engine_flags)
        for k, v in (gpt or {}).items():
            setattr(cfg.gpt, k, v)
        if dit is not None:
            d = cfg.s2mel.dit
            d.hidden_dim, d.num_heads = 256, 4
            cfg.s2mel.wavenet.hidden_dim = d.hidden_dim
            for k, v in dit.items():
                setattr(d, k, v)
        return cfg
    base = TTSEngine.random(config(), device="cpu", seed=0)
    cfg = config(**flags)
    cpu = TTSEngine(cfg, copy.deepcopy(base.models), base.tokenizer, device="cpu")
    gpu = TTSEngine(cfg, copy.deepcopy(base.models), base.tokenizer, device=dev)
    _shared_noise(torch, cpu, gpu, dev)
    return cpu, gpu


def _compare_wavs(tag, ref, out, tol):
    import numpy as np

    if out.wav.shape != ref.wav.shape:
        fail(f"{tag}: card wav {out.wav.shape} vs CPU {ref.wav.shape}")
    diff = int(np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max())
    steps = (ref.metrics["decode_steps"], out.metrics["decode_steps"])
    print(f"{tag} card vs CPU: {len(out.wav)} samples, decode steps {steps}, "
          f"max |diff| {diff} LSB (tol {tol})")
    if steps[0] != steps[1] or diff > tol:
        fail(f"{tag} on the card disagrees with the CPU reference")


# same codes, then f32 s2mel / vocoder on two devices: the int16 samples may
# differ by float rounding only
WAV_TOL = 64
# the bench-like engine flags of the tiny checks: the int8 K1 decode
TINY_BENCH_FLAGS = dict(use_int8_decode=True, use_fused_decode=True,
                        fold_readout=True, use_fp16=True, fuse_pipeline=True)


def check_tiny_engine(torch, dev):
    """End-to-end reference on a small input, bench-like flags: the tiny
    engine on the card (K1, K2, K4 on its int8 prefill) against the same
    weights on the CPU (plain versions), greedy, same CFM noise."""
    cpu, gpu = _tiny_pair(torch, dev, **TINY_BENCH_FLAGS)
    prompt = tone_prompt(1.0, 16000)
    ref = cpu.infer(prompt, "hello world.", do_sample=False)
    out = gpu.infer(prompt, "hello world.", do_sample=False)
    torch.cuda.synchronize()
    _compare_wavs("tiny engine (num_beams 1)", ref, out, WAV_TOL)


# bf16 conditioning: cuBLAS and the CPU round the bf16 products at other
# points; one bf16 ulp is 2^-8 of a value, compounded over a few layers
COND_TOL = 3e-2


def check_tiny_engine_production(torch, dev, counters=None, gpt=None):
    """The tiny engine under the production flags (beam-3 through K3 with the
    ancestor table, int8 KV, folded readout, bf16 GPT and conditioning,
    masters released) on the card against the CPU, greedy, same weights and
    CFM noise.  The card's own bf16 conditioning is held against the CPU's
    (COND_TOL); the decode and synthesis then start from the CPU's
    conditioning on both, so that the comparison is of the beam kernels and
    the synthesis.  With `gpt` = {"pallas_decode_attention": True} the beam
    takes the eager arm with K5 instead of K3 (its launches are checked),
    with the f32 GPT (TINY_F32_GPT)."""
    flags = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                 use_fused_beam_decode=True, use_int8_kv=True, fold_readout=True,
                 use_bf16_conditioning=True, release_master_trees=True,
                 fuse_pipeline=True)
    if gpt:
        flags.update(TINY_F32_GPT)
    cpu, gpu = _tiny_pair(torch, dev, gpt=gpt, **flags)
    prompt = tone_prompt(1.0, 16000)
    key = cpu._content_key(prompt)
    spk_c, spk_g = cpu._speaker_conditioning(prompt), gpu._speaker_conditioning(prompt)
    for name in ("cond_latents", "spk_emovec", "style", "prompt_condition"):
        ref = spk_c[name].float()
        err = max_err(torch, spk_g[name].cpu(), ref)
        tol = COND_TOL * max(1.0, float(ref.abs().max()))
        print(f"tiny production conditioning {name}: max_abs_err {err:.4g} (tol {tol:.4g})")
        if not err <= tol:
            fail(f"tiny production conditioning {name}: card disagrees with the CPU")
    gpu._spk_cache[key] = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                           for k, v in spk_c.items()}
    gpu._emo_cache[key] = cpu._emotion_conditioning(prompt).to(dev)
    ref = cpu.infer(prompt, "hello world.", do_sample=False, num_beams=3)
    if counters is not None:
        counters.reset()
    out = gpu.infer(prompt, "hello world.", do_sample=False, num_beams=3)
    torch.cuda.synchronize()
    tag = "tiny engine (production, beam-3" + (", K5)" if gpt else ")")
    _compare_wavs(tag, ref, out, WAV_TOL)
    if gpt:
        _check_k5_launches(tag, counters.snapshot(), gpu, out.metrics["decode_steps"],
                           k4_per_step=0)


def _check_k5_launches(tag, got, engine, steps, k4_per_step):
    """K5 once per layer and decode step, K4 `k4_per_step` times per layer
    and step, K1 and K3 never."""
    layers = engine.cfg.gpt.layers
    print(f"{tag} launches: K5 {got['decode_attention']}, K4 {got['int8_gemv']} for "
          f"{steps} steps x {layers} layers; K1 {got['fused_decode_step']}, K3 "
          f"{got['fused_decode_step_batch']}")
    if (steps == 0 or got["decode_attention"] != layers * steps
            or got["int8_gemv"] != k4_per_step * layers * steps
            or got["fused_decode_step"] or got["fused_decode_step_batch"]):
        fail(f"{tag}: K5 not once per layer and step, K4 not {k4_per_step} times, "
             f"or K1 / K3 ran")


# the tiny K5 pairs decode with the f32 GPT: the int8 + bf16 runtime copy's
# unfused step rounds each op to bf16 at other points on the two devices
# (LayerNorm and tanh, K4's sums), and at random tiny weights one flipped
# rounding changes a greedy code within a few steps; the int8 path's
# kernels are held against their plain versions above, the flagship K5
# slice counts them, and `check_tiny_engine_k5_int8` holds the int8 + bf16
# pair with K5 against the same pair without it
TINY_F32_GPT = dict(use_fp16=False, use_int8_decode=False)


def check_tiny_engine_k5(torch, dev, counters):
    """`GPTConfig.pallas_decode_attention` in the tiny engine on the card
    against the CPU, f32 GPT (TINY_F32_GPT): one beam (the bench flags, the
    unfused step with K5 instead of K1) and the production flags (beam-3,
    the eager arm with K5, int8 KV dropped), greedy, same weights and CFM
    noise: the same decode and WAVs within WAV_TOL, K5 once per layer and
    step, K1, K3 and K4 never."""
    flag = {"pallas_decode_attention": True}
    cpu, gpu = _tiny_pair(torch, dev, gpt=flag, **{**TINY_BENCH_FLAGS, **TINY_F32_GPT})
    prompt = tone_prompt(1.0, 16000)
    ref = cpu.infer(prompt, "hello world.", do_sample=False)
    counters.reset()
    out = gpu.infer(prompt, "hello world.", do_sample=False)
    torch.cuda.synchronize()
    _compare_wavs("tiny engine (num_beams 1, K5)", ref, out, WAV_TOL)
    _check_k5_launches("tiny engine (num_beams 1, K5)", counters.snapshot(), gpu,
                       out.metrics["decode_steps"], k4_per_step=0)
    check_tiny_engine_production(torch, dev, counters, gpt=flag)


def _greedy_record(torch, engine, prompt, forced=None):
    """One greedy request on `engine` with the decode loop's choices
    recorded: the repetition-penalised logits each code is chosen from
    (the last decode of the request) and the codes.  With `forced` (the
    codes of another run) each step takes that run's code instead of its
    own argmax, so both runs decode from the same history."""
    from voice_tts_tpu_torch.models.gpt import decode as dec

    inner, logits, codes = dec.sample_token, [], []

    def choose(step_logits, presence, gen, generator):
        own = inner(step_logits, presence, gen, generator)
        logits.append(dec.apply_repetition_penalty(
            step_logits.float(), presence, gen.repetition_penalty)[0].cpu())
        code = own if forced is None else torch.full_like(own, forced[len(codes)])
        codes.append(int(code[0]))
        return code

    decode_sampled = engine._decode_sampled

    def decode(*args, **kwargs):
        logits.clear()
        codes.clear()
        return decode_sampled(*args, **kwargs)
    dec.sample_token, engine._decode_sampled = choose, decode
    try:
        out = engine.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
    finally:
        dec.sample_token = inner
        del engine._decode_sampled
    return out, torch.stack(logits), codes


# the int8 + bf16 pairs: the card's logits, decoded from the CPU's codes,
# may stray from the CPU's by bf16 roundings at other points; with K5 no
# more than K5_INT8_RATIO times as far as with the einsum attention
K5_INT8_RATIO = 4.0


def check_tiny_engine_k5_int8(torch, dev, counters):
    """The int8 + bf16 runtime copy's unfused step (the K5 slice's GPT
    flags) in the tiny engine on the card against the CPU, one beam,
    greedy, same weights and CFM noise, twice: with K5
    (`pallas_decode_attention`) and without it (the einsum attention,
    `use_fused_decode` off, so no pack).  Each pair decodes freely (where
    the codes first differ, the WAVs where they agree), then the card
    decodes again from the CPU's codes, and each step's logits are held
    against the CPU's.  Fails if K5 or K1 launch where they should not, if
    agreeing codes give WAVs beyond WAV_TOL, or if the logits stray further
    with K5 than K5_INT8_RATIO times as far as with the einsum attention."""
    import numpy as np

    prompt = tone_prompt(1.0, 16000)
    stray = {}
    for tag, gpt, flags in (
            ("K5", {"pallas_decode_attention": True}, TINY_BENCH_FLAGS),
            ("einsum", None, {**TINY_BENCH_FLAGS, "use_fused_decode": False})):
        cpu, gpu = _tiny_pair(torch, dev, gpt=gpt, **flags)
        ref, logits_c, codes_c = _greedy_record(torch, cpu, prompt)
        counters.reset()
        out, _, codes_g = _greedy_record(torch, gpu, prompt)
        got = counters.snapshot()
        _, logits_g, _ = _greedy_record(torch, gpu, prompt, forced=codes_c)
        first = next((i for i, (a, b) in enumerate(zip(codes_c, codes_g)) if a != b),
                     None if len(codes_c) == len(codes_g) else
                     min(len(codes_c), len(codes_g)))
        diff = None
        if out.wav.shape == ref.wav.shape:
            diff = int(np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max())
        err = (logits_g - logits_c).abs().amax(dim=-1)       # a step's largest
        top2 = logits_c.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        stray[tag] = float(err.max())
        at = "" if first is None or first >= len(err) else (
            f"; at code {first} the logits strayed {float(err[first]):.4g}, "
            f"the CPU's top-2 margin {float(margin[first]):.4g}")
        print(f"tiny engine int8 + bf16 unfused step ({tag}) card vs CPU: codes "
              f"{len(codes_g)} / {len(codes_c)}, first differing code {first}, wav "
              f"max |diff| {diff} LSB (tol {WAV_TOL} where the codes agree); from "
              f"the CPU's codes the card's logits stray at most {stray[tag]:.4g} "
              f"(max|logits| {float(logits_c.abs().max()):.4g}, smallest top-2 "
              f"margin {float(margin.min()):.4g}){at}; K5 launches "
              f"{got['decode_attention']}, K4 {got['int8_gemv']}, K1 "
              f"{got['fused_decode_step']}")
        if (got["decode_attention"] == 0) != (gpt is None) or got["fused_decode_step"]:
            fail(f"tiny int8 + bf16 pair ({tag}): K5 launched {got['decode_attention']} "
                 f"times, K1 {got['fused_decode_step']}")
        if first is None and (diff is None or diff > WAV_TOL):
            fail(f"tiny int8 + bf16 pair ({tag}): the codes agree but the WAVs do not")
    print(f"tiny int8 + bf16 pairs: the logits stray {stray['K5']:.4g} with K5, "
          f"{stray['einsum']:.4g} with the einsum attention (tol {K5_INT8_RATIO}x)")
    if not stray["K5"] <= K5_INT8_RATIO * stray["einsum"]:
        fail("tiny int8 + bf16 pair: the logits stray further with K5 than with "
             "the einsum attention")


def check_tiny_engine_vocoders(torch, dev, counters):
    """Each vocoder flag in the tiny engine (bench flags) on the card against
    the CPU, greedy, same weights and CFM noise: the same decode and WAVs
    within WAV_TOL (the packed and shared variants compute the module
    path's function, the fused one K10's on both devices); K10 once per
    fused stage on the card."""
    prompt = tone_prompt(1.0, 16000)
    for flag in ("use_packed_vocoder", "use_shared_act_vocoder", "use_fused_vocoder"):
        cpu, gpu = _tiny_pair(torch, dev, **{flag: True}, **TINY_BENCH_FLAGS)
        ref = cpu.infer(prompt, "hello world.", do_sample=False)
        counters.reset()
        out = gpu.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
        _compare_wavs(f"tiny engine ({flag}, {gpu.voc_variant})", ref, out, WAV_TOL)
        want = len(gpu.voc_pack) if gpu.voc_variant == "fused" else 0
        got = counters.snapshot()["fused_resblock_stage"]
        print(f"tiny engine ({flag}) K10 launches {got} (want {want})")
        if gpu.voc_variant == "module" or got != want:
            fail(f"tiny engine ({flag}): the variant was not taken, or K10 launches {got}")


def check_tiny_engine_spec(torch, dev):
    """The tiny engine with spec decode (K = 4: int4 drafts through K1 and
    K7, one verify a round through K6), and with the int4 decode pack (K1
    with K7), each on the card against the CPU, greedy, same weights and CFM
    noise: the same decode steps (and spec rounds) and WAVs within
    WAV_TOL."""
    base = dict(use_int8_decode=True, use_fused_decode=True, use_fp16=True,
                fuse_pipeline=True)
    prompt = tone_prompt(1.0, 16000)
    for tag, flags in (("spec_decode_k 4", dict(spec_decode_k=4)),
                       ("use_int4_decode", dict(use_int4_decode=True,
                                                fold_readout=True))):
        cpu, gpu = _tiny_pair(torch, dev, **base, **flags)
        ref = cpu.infer(prompt, "hello world.", do_sample=False)
        out = gpu.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
        _compare_wavs(f"tiny engine ({tag})", ref, out, WAV_TOL)
        rounds = [m.get("spec_rounds") for m in (ref.metrics, out.metrics)]
        accepted = [m.get("spec_accepted") for m in (ref.metrics, out.metrics)]
        print(f"tiny engine ({tag}) spec rounds {rounds}, accepted drafts {accepted}")
        if rounds[0] != rounds[1] or accepted[0] != accepted[1]:
            fail(f"tiny engine ({tag}): the card's speculative rounds differ from the CPU's")


# bf16 s2mel: cuBLAS and the CPU round the DiT's bf16 products at other
# points (as COND_TOL), and K8's bf16 storage flips a rounding here and there
S2MEL_BF16_TOL = 3e-2


def check_tiny_engine_dit(torch, dev, counters):
    """The DiT kernels in the tiny engine (D 256) on the card against the
    same weights on the CPU, same CFM noise: K9 (`fused_attention`) and K11
    (`flash_attention`) with f32 s2mel, whole requests, WAVs within WAV_TOL
    and one launch per block and Euler step; K8 (`fused_blocks` with
    `use_bf16_s2mel`, the DiT slice's flags) on the s2mel stage alone with
    the same random inputs, mels within S2MEL_BF16_TOL and one launch per
    Euler step."""
    import numpy as np

    prompt = tone_prompt(1.0, 16000)
    for tag, flag, name in (("K9", "fused_attention", "cfm_attention"),
                            ("K11", "flash_attention", "flash_attention")):
        cpu, gpu = _tiny_pair(torch, dev, dit={flag: True}, **TINY_BENCH_FLAGS)
        ref = cpu.infer(prompt, "hello world.", do_sample=False)
        counters.reset()
        out = gpu.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
        got = counters.snapshot()[name]
        want = gpu.cfg.engine.diffusion_steps * gpu.cfg.s2mel.dit.depth
        print(f"tiny engine ({tag}, {flag}) launches {got} (want {want})")
        if got != want:
            fail(f"tiny engine ({tag}): {name} was not launched once per block and step")
        _compare_wavs(f"tiny engine ({tag}, {flag})", ref, out, WAV_TOL)

    cpu, gpu = _tiny_pair(torch, dev, dit=dict(fused_blocks=True, fused_attention=True),
                          use_bf16_s2mel=True, **TINY_BENCH_FLAGS)
    rng = np.random.default_rng(3)
    c = gpu.cfg
    cb, pb = 32, 64
    mb = gpu._mel_bucket_for(cb)
    inputs = [rng.standard_normal((1, cb, c.gpt.model_dim)).astype(np.float32),
              rng.integers(0, c.semantic_codec.codebook_size, (1, cb)),
              np.asarray([cb - 2]),
              rng.standard_normal((1, pb, c.s2mel.length_regulator.channels)).astype(np.float32),
              np.asarray([pb - 7]),
              rng.standard_normal((1, c.mel.num_mels, pb)).astype(np.float32),
              rng.standard_normal((1, c.campplus.embedding_size)).astype(np.float32)]
    with torch.no_grad():
        ref, _ = cpu._s2mel(*[torch.from_numpy(a) for a in inputs], mb)
        counters.reset()
        out, _ = gpu._s2mel(*[torch.from_numpy(a).to(dev) for a in inputs], mb)
        torch.cuda.synchronize()
    got = counters.snapshot()
    err, scale = max_err(torch, out.cpu(), ref), float(ref.abs().max())
    print(f"tiny engine (K8, use_bf16_s2mel + fused_blocks) s2mel: max_abs_err "
          f"{err:.4g} (max|ref| {scale:.4g}, tol {S2MEL_BF16_TOL} * max|ref|); "
          f"launches K8 {got['dit_block_chain']}, K9 {got['cfm_attention']}")
    if not err <= S2MEL_BF16_TOL * scale:
        fail("tiny engine (K8): the card's s2mel disagrees with the CPU's")
    if got["dit_block_chain"] != c.engine.diffusion_steps or got["cfm_attention"] != 0:
        fail("tiny engine (K8): K8 was not launched once per Euler step")


def http(port: int, method: str, path: str, body: bytes = None, timeout=900):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def profile_request(torch, engine, prompt: bytes, text: str):
    """One more warm request under the CUDA profiler: device busy time
    (the union of the kernels' spans; their summed time beside it) against
    the host wall clock, top kernels, and the
    DiT attention kernels' device time (K9 / K11, where the request ran
    them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer(prompt, text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from voice_tts_tpu_torch.scripts.decode_host_time import busy_seconds

    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    # busy: the union of the kernels' spans (under programmatic dependent
    # launch neighbours overlap, and the sum of their times overcounts)
    busy = busy_seconds(prof)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    print("profile: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy,
        "kernel_sum_s": sum(e.self_device_time_total for e in events) / 1e6,
        "device_idle_share": 1.0 - busy / wall if wall else None,
        "metrics": engine.last_metrics,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_s": e.self_device_time_total / 1e6}
                        for e in top],
        "dit_attention": [{"name": e.key[:80], "count": e.count,
                           "device_s": e.self_device_time_total / 1e6}
                          for e in events if "dit_attention" in e.key]}))
    return {"wall_s": wall, "device_busy_s": busy, "metrics": dict(engine.last_metrics),
            "kernels": [(e.key, e.count, e.self_device_time_total / 1e6) for e in events]}


def serve_requests(torch, engine, profile: str, counters, prompts_s=(5.0, 5.0, 5.0)):
    """Serve `engine` over HTTP from a background thread: GET /health, GET
    /debug/worker-info, then one POST /tts per prompt length in `prompts_s`
    (seconds of the two-tone prompt), with the counters set to 0 just before
    the first and read after each.  Returns (launches over all requests,
    decode steps, AA activations per vocode, the first prompt, text, each
    request's metrics, each request's launches)."""
    import numpy as np
    from voice_tts_tpu_torch.audio import decode_audio_bytes
    from voice_tts_tpu_torch.serving.app import BackgroundServer, TTSService

    cfg = engine.cfg
    n_act = (len(cfg.vocoder.upsample_rates) * len(cfg.vocoder.resblock_kernel_sizes)
             * 2 * len(cfg.vocoder.resblock_dilation_sizes[0]) + 1)
    service = TTSService(engine, profile=profile)
    server = BackgroundServer(service)
    port = server.start()
    try:
        status, body = http(port, "GET", "/health")
        print(f"[{profile}] GET /health -> {status} {body.decode()}")
        if status != 200:
            fail("/health did not answer 200")
        status, body = http(port, "GET", "/debug/worker-info")
        info = json.loads(body)["replicas"][0]
        print(f"[{profile}] GET /debug/worker-info -> {status} "
              + json.dumps({k: info[k] for k in ("profile", "num_beams", "engine_flags")}))
        if status != 200 or info["profile"] != profile:
            fail("/debug/worker-info does not report the served profile")
        prompts = [tone_prompt(sec, 22050) for sec in prompts_s]
        text = "欢迎大家来体验这个语音合成系统谢谢大家."
        counters.reset()
        steps, metrics, per_request = 0, [], []
        before = counters.snapshot()
        for i, prompt in enumerate(prompts):
            t1 = time.perf_counter()
            status, body = http(port, "POST", "/tts", json.dumps(
                {"text": text, "spk_audio": prompt.hex()}).encode())
            wall = time.perf_counter() - t1
            if status != 200:
                fail(f"[{profile}] POST /tts #{i} -> {status}: {body[:500]!r}")
            after = counters.snapshot()
            per_request.append({k: after[k] - before[k] for k in after})
            before = after
            resp = json.loads(body)
            wav, sr = decode_audio_bytes(bytes.fromhex(resp["audio_hex"]))
            if sr != 22050 or wav.size == 0 or not np.all(np.isfinite(wav)):
                fail(f"[{profile}] POST /tts #{i}: bad WAV (sr {sr}, {wav.size} samples)")
            m = engine.last_metrics
            metrics.append(dict(m))
            steps += m["decode_steps"]
            print(f"[{profile}] POST /tts #{i} ({prompts_s[i]} s prompt): 200, "
                  f"{wav.size} samples ({resp['audio_length']:.3f} s), rtf "
                  f"{resp['rtf']:.4f} (server), wall {wall:.3f} s, timers "
                  + json.dumps({k: round(v, 4) for k, v in m.items()}))
        launches = counters.snapshot()
    finally:
        server.stop()
        service.close()
    print(f"[{profile}] launches over {len(prompts)} requests: {launches} (decode "
          f"steps {steps}, {n_act} AA activations per vocode)")
    return launches, steps, n_act, prompts[0], text, metrics, per_request


def check_decode_launches(tag, got, metrics, kernel: str):
    """The decode kernel `kernel` once a step its device loop executed: each
    decode runs its chunks of CHUNK steps, at most CHUNK - 1 of them after
    the stop, so executed = chunks x CHUNK >= decode steps > executed -
    decodes x CHUNK (summed over the requests of `metrics`)."""
    from voice_tts_tpu_torch.engine.device_loop import CHUNK

    steps = sum(m["decode_steps"] for m in metrics)
    chunks = sum(m["decode_chunks"] for m in metrics)
    runs = sum(m["decode_runs"] for m in metrics)
    executed = chunks * CHUNK
    print(f"[{tag}] {kernel}: {got[kernel]} launches = {chunks} chunks x {CHUNK} "
          f"steps (executed) over {runs} decodes of {steps} steps")
    if steps == 0 or got[kernel] != executed or not executed >= steps > executed - runs * CHUNK:
        fail(f"[{tag}] {kernel} was not launched once a step its device loop executed")


def check_served_through_graphs(tag, engine, before: dict, metrics):
    """The served requests' decodes and CFM solves replayed graphs, and the
    decode read the host once before each decode's first chunk and once
    after each chunk, nowhere else."""
    stats = engine.loops.stats
    chunks = sum(m["decode_chunks"] for m in metrics)
    runs = sum(m["decode_runs"] for m in metrics)
    delta = {k: stats[k] - before[k] for k in stats}
    print(f"[{tag}] device loops over the served requests: {json.dumps(delta)}; "
          f"{chunks} decode chunks in {runs} decodes; capture time a request "
          f"{[round(m.get('capture_time', 0.0), 4) for m in metrics]} s; graphs "
          f"{stats['graphs']}")
    if delta["replays"] == 0 or delta["host_reads"] != chunks + runs:
        fail(f"[{tag}] the decode did not run as replayed chunks with one host read "
             "a chunk")


def compare_with_uncaptured(torch, dev, engine, tag, prompt, text, runs=("graphs",),
                            retry=False, call=None):
    """The same request on `engine` with its loops op by op
    (`DeviceLoops(capture=False)`) and then as its graphs, from the same
    generator state (and, with `retry`, an empty cap memory, so that a beam
    decode hits the bucket's cap and retries at the full cap after
    `set_state`, or on the jobs' own streams): every decode's codes,
    lengths, limit flag, steps and chunks, the CFM mel and the WAV
    bit-equal.  `call` replaces `engine.infer(prompt, text)` (an
    `infer_batch`: every result's WAV).  Each name in `runs` is one more
    graph request; the last must capture nothing (a replay)."""
    import numpy as np
    from voice_tts_tpu_torch.engine import engine as eng_mod
    from voice_tts_tpu_torch.engine.device_loop import GATE, DeviceLoops

    graphs = engine.loops
    call = call or (lambda: engine.infer(prompt, text))
    state, hint = engine.generator.get_state(), dict(engine._cap_hint)
    names = ("uncaptured",) + tuple(runs)
    recs = {}
    for name in names:
        rec = {"decodes": [], "mels": []}
        originals = {f: getattr(eng_mod, f) for f in ("beam_decode", "gpt_decode",
                                                      "beam_decode_fused_batch")}

        def wrap(fn):
            def recorded(*a, **kw):
                res = fn(*a, **kw)
                rec["decodes"].append(tuple(res))
                return res
            return recorded
        for f, fn in originals.items():
            setattr(eng_mod, f, wrap(fn))
        s2mel = engine._s2mel

        def s2mel_recorded(*a, **kw):
            mel, target = s2mel(*a, **kw)
            rec["mels"].append(mel.clone())
            return mel, target
        engine._s2mel = s2mel_recorded
        engine.loops = graphs if name != "uncaptured" else DeviceLoops(dev, capture=False)
        engine.generator.set_state(state)
        engine._cap_hint = {} if retry else dict(hint)
        before = dict(graphs.stats)
        try:
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for f, fn in originals.items():
                setattr(eng_mod, f, fn)
            del engine._s2mel
            engine.loops = graphs
        recs[name] = (rec, out, wall, {k: graphs.stats[k] - before[k] for k in before})
    ref, ref_out = recs["uncaptured"][:2]
    for name in runs:
        rec, out, wall, delta = recs[name]
        same = (len(rec["decodes"]) == len(ref["decodes"]) and all(
            all((torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
                for a, b in zip(d, r)) for d, r in zip(rec["decodes"], ref["decodes"]))
            and len(rec["mels"]) == len(ref["mels"])
            and all(torch.equal(a, b) for a, b in zip(rec["mels"], ref["mels"]))
            and all(np.array_equal(a.wav, b.wav) for a, b in
                    zip(*(o if isinstance(o, list) else [o] for o in (out, ref_out)))))
        print(f"[{tag}] {name} against uncaptured: decodes (steps, chunks) "
              f"{[(d[3], d[4]) for d in rec['decodes']]} vs "
              f"{[(d[3], d[4]) for d in ref['decodes']]}, {len(rec['mels'])} CFM mel(s), "
              f"bit-equal {same}; wall {wall:.3f} s vs {recs['uncaptured'][2]:.3f}; "
              f"loops {json.dumps(delta)}")
        if not same:
            fail(f"[{tag}] the graphs' request differs from the uncaptured one")
    if recs[names[-1]][3]["graphs"] != 0 or recs[names[-1]][3]["replays"] == 0:
        fail(f"[{tag}] the compared graph request did not replay its graphs")
    engine._cap_hint = hint
    return {name: recs[name][2] for name in names}


def run_production_slice(torch, dev, counters):
    """The flagship engine in the production profile (the server default):
    beam-3 through K3 with the ancestor table, int8 KV."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, serving_config

    t0 = time.perf_counter()
    engine = TTSEngine.random(serving_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[serving] engine build (flagship widths, random weights): "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    before = dict(engine.loops.stats)
    launches, steps, n_act, prompt, text, metrics, _ = serve_requests(
        torch, engine, "serving", counters)
    check_decode_launches("serving", launches, metrics, "fused_decode_step_batch")
    check_served_through_graphs("serving", engine, before, metrics)
    if launches["fused_decode_step"] != 0:
        fail("K1 was launched on the beam path")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
    profile_request(torch, engine, prompt, text)
    print(f"[serving] peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # beam-3 int8 KV with the cap retry (511, then 1499 after set_state)
    compare_with_uncaptured(torch, dev, engine, "serving", prompt, text, retry=True)
    return launches, engine


# the batched phase's code cap: random weights never stop, so every decode
# runs to it (the production slice's 1500 would take a minute a part)
BATCH_CAP = 512
# four requests of one text bucket (32 in production, 48 in bench), texts of
# 20, 8, 11 and 13 tokens, over two speakers
BATCH_TEXTS = ("欢迎大家来体验这个语音合成系统谢谢大家.", "欢迎大家来体验.",
               "语音合成系统谢谢大家.", "这个语音合成系统欢迎大家.")
# three and two segments at 12 tokens a segment
SEGMENT_TEXT = "欢迎大家来体验. 这个语音合成系统. 谢谢大家."
STREAM_TEXT = "欢迎大家来体验. 这个语音合成系统."


def _batch_requests():
    prompts = (tone_prompt(5.0, 22050), tone_prompt(4.0, 22050))
    return [{"spk_audio_prompt": prompts[i % 2], "text": t}
            for i, t in enumerate(BATCH_TEXTS)], prompts


def _job_codes(engine):
    """Record the codes each segment was synthesized from, in segment order:
    the jobs of `_run_segment_jobs` (batched) and each decode of
    `_synthesize_segment` (one segment at a time); returns the list and the
    function that puts the engine back."""
    seen = []
    jobs_fn, beam, sampled = (engine._run_segment_jobs, engine._decode_beam,
                              engine._decode_sampled)

    def rec_jobs(jobs, *a, **kw):
        jobs_fn(jobs, *a, **kw)
        seen.extend(j["codes"][:j["code_len"]].tolist() for j in jobs)

    def rec_decode(fn):
        def run(*a, **kw):
            codes, code_len, cbucket = fn(*a, **kw)
            seen.append(codes[0, :int(code_len[0])].tolist())
            return codes, code_len, cbucket
        return run
    engine._run_segment_jobs = rec_jobs
    engine._decode_beam, engine._decode_sampled = rec_decode(beam), rec_decode(sampled)

    def restore():
        del engine._run_segment_jobs, engine._decode_beam, engine._decode_sampled
    return seen, restore


def _timed(torch, engine, call):
    """(result, wall s, the engine's last_metrics, the codes of its jobs)."""
    seen, restore = _job_codes(engine)
    try:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    return out, wall, dict(engine.last_metrics), seen


def _same_codes(tag, a, b):
    """Fail unless two runs synthesized the same codes, job by job."""
    lens = ([len(c) for c in a], [len(c) for c in b])
    same = a == b
    print(f"{tag}: codes a job {lens[0]} vs {lens[1]}, equal {same}")
    if not same:
        first = [next((t for t, (u, v) in enumerate(zip(x, y)) if u != v), min(len(x), len(y)))
                 for x, y in zip(a, b)]
        fail(f"{tag}: the codes differ (first differing code a job {first})")


# four speakers no earlier phase conditioned: prompt seconds of a cold group
COLD_PROMPT_S = (3.0, 3.5, 4.5, 6.0)


def _cold_entries(engine, prompts):
    """Each cold prompt's conditioning entry from one group forward
    (`_speaker_conditioning_batch`, 4 rows) and alone (`_speaker_
    conditioning`, 1 row); the engine's cache is left without them."""
    keys = [engine._content_key(p) for p in prompts]
    if any(k in engine._spk_cache for k in keys):
        fail("[batched] a cold-conditioning prompt was already cached")
    engine._speaker_conditioning_batch(prompts)
    grouped = [engine._spk_cache.pop(k) for k in keys]
    alone = []
    for p, k in zip(prompts, keys):
        engine._speaker_conditioning(p)
        alone.append(engine._spk_cache.pop(k))
    for g, a in zip(grouped, alone):
        if g["mel_frames"] != a["mel_frames"]:
            fail(f"[batched] cold conditioning: mel frames {g['mel_frames']} != "
                 f"{a['mel_frames']}")
    return keys, grouped, alone


def _entry_errs(entries, refs):
    """Each cached tensor's largest |entry - ref| / max(1, max|ref|) over
    the prompts."""
    errs = {}
    for e, r in zip(entries, refs):
        for name, ref in r.items():
            if name != "mel_frames":
                err = float((e[name].float() - ref.float()).abs().max())
                scale = max(1.0, float(ref.float().abs().max()))
                errs[name] = max(errs.get(name, 0.0), err / scale)
    return errs


def check_cold_conditioning(torch, engine, f32_engine, card):
    """Four cold speakers conditioned in one group against each alone, on
    the production engine (bf16 conditioning) and on `f32_engine` (f32
    conditioning, the same seed's weights): each cached tensor's largest
    difference, and whether one greedy request of the first speaker decodes
    the same codes from either production entry (random weights: any
    rounding can flip a near-tie, so that is reported, not required).  A
    group changes a row's rounding (cuBLAS and cuFFT pick their kernels by
    the row count; the log of a near-silent mel bin of a pure-tone prompt
    magnifies an FFT's rounding), so the check fails only where a mixed-up
    row would show: an f32 tensor moved by more than COND_TOL, or a bf16
    one moved by more than twice what bf16 rounding (its alone entry
    against the f32 one) or the f32 group moves it, or 1e-4."""
    prompts = [tone_prompt(sec, 22050) for sec in COLD_PROMPT_S]
    keys, grouped, alone = _cold_entries(engine, prompts)
    _, grouped32, alone32 = _cold_entries(f32_engine, prompts)
    group_bf16 = _entry_errs(grouped, alone)
    group_f32 = _entry_errs(grouped32, alone32)
    bf16_rounding = _entry_errs(alone, alone32)
    codes = []
    for entry in (grouped[0], alone[0]):
        engine._spk_cache[keys[0]] = entry
        codes.append(_timed(torch, engine, lambda: engine.infer(
            prompts[0], BATCH_TEXTS[0], do_sample=False))[3])
    del engine._spk_cache[keys[0]]
    print(f"[batched] cold speakers conditioned in a group of 4 against alone ({card}); "
          f"largest |difference| / max(1, max|alone|) a tensor: bf16 group "
          f"{json.dumps(group_bf16)}; f32 group {json.dumps(group_f32)}; bf16 alone "
          f"against f32 alone {json.dumps(bf16_rounding)}; greedy codes of one request "
          f"from the group's entry and the lone one equal {codes[0] == codes[1]} "
          f"(lengths {[len(c[0]) for c in codes]})")
    for name, r in bf16_rounding.items():
        bound = max(2 * max(r, group_f32[name]), 1e-4)
        if group_f32[name] > COND_TOL or group_bf16[name] > bound:
            fail(f"[batched] cold conditioning: a group of 4 moves {name} by "
                 f"{group_bf16[name]:.3e} in bf16 (bound {bound:.3e}) and "
                 f"{group_f32[name]:.3e} in f32 (bound {COND_TOL})")


def run_batched_slice(torch, dev, counters, engine, card):
    """The batched and long-form paths at the flagship widths, the codes cut
    to BATCH_CAP: (1) on the production engine `infer_batch` of 4 requests
    (two speakers, one text bucket), beam-3 sampling: one 12-row K3 decode
    through replayed graphs, K3 once a step it executed, K1 never, against
    the same requests at `beam_batch_rows = 3` (one request a decode, each
    on its own stream) and against its loops op by op (the cap retry after
    reseeding every stream); (2) a 3-segment
    `infer` with `batch_segments` on and off (greedy: the same codes a
    segment); (3) `infer(stream_return=True)` against `infer`'s WAV from the same generator state; (4) a bench
    engine with `use_fused_batch_decode`: `infer_batch` of the 4 requests,
    greedy, K3 at 4 rows and one shared position, K1 never, against each
    request alone through K1, after four cold speakers conditioned in one
    group against each alone on both engines (`check_cold_conditioning`).
    Returns the launches of (1) and (4) together."""
    import dataclasses

    import numpy as np
    from voice_tts_tpu_torch.engine.engine import TTSEngine, bench_config

    e, gen0 = engine.cfg.engine, engine.cfg.generation
    engine.cfg.generation = dataclasses.replace(gen0, max_mel_tokens=BATCH_CAP)
    reqs, prompts = _batch_requests()
    torch.cuda.reset_peak_memory_stats()
    launches, timing = {}, {}

    # (1) batched beam against one request a decode
    state = engine.generator.get_state()
    runs = {}
    for name, rows in (("batched cold", 12), ("batched", 12), ("sequential cold", 3),
                       ("sequential", 3)):
        e.beam_batch_rows = rows
        engine.generator.set_state(state)
        counters.reset()
        runs[name] = _timed(torch, engine, lambda: engine.infer_batch(reqs))
        if name == "batched":
            launches = counters.snapshot()
    e.beam_batch_rows = 12
    out_b, wall_b, m_b, codes_b = runs["batched"]
    out_s, wall_s, m_s, codes_s = runs["sequential"]
    print(f"[batched] production infer_batch of 4 requests, beam-3, cap {BATCH_CAP} "
          f"({card}): batched (one 12-row K3 decode) wall {wall_b:.4f} s, gpt_gen_time "
          f"{m_b['gpt_gen_time']:.4f} s, synthesis {m_b['synthesis_time']:.4f} s; "
          f"sequential (beam_batch_rows 3, 4 decodes) wall {wall_s:.4f} s, gpt_gen_time "
          f"{m_s['gpt_gen_time']:.4f} s; cold walls {runs['batched cold'][1]:.4f} / "
          f"{runs['sequential cold'][1]:.4f} s; decodes {m_b['decode_runs']} / "
          f"{m_s['decode_runs']}, steps {m_b['decode_steps']} / {m_s['decode_steps']}")
    timing["production"] = {"batched_wall_s": wall_b, "batched_gpt_gen_s": m_b["gpt_gen_time"],
                            "sequential_wall_s": wall_s,
                            "sequential_gpt_gen_s": m_s["gpt_gen_time"]}
    _same_codes("[batched] replayed batched run against the capturing one",
                runs["batched cold"][3], codes_b)
    _same_codes("[batched] 12-row batched beam against one request a decode", codes_b,
                codes_s)
    if not all(np.array_equal(a.wav, b.wav) for a, b in zip(out_b, out_s)):
        fail("[batched] the batched and sequential WAVs differ with the same codes")
    check_decode_launches("batched", launches, [m_b], "fused_decode_step_batch")
    if launches["fused_decode_step"] != 0 or m_b["decode_runs"] != 1:
        fail("[batched] the 4 requests did not decode as one K3 run")
    cptt = e.codes_per_text_token
    e.codes_per_text_token = 4.0        # a 256-code first cap: every row retries
    # the first graph run captures the 256-code key, the second replays
    compare_with_uncaptured(torch, dev, engine, "batched", None, None,
                            runs=("capture", "replay"), retry=True,
                            call=lambda: engine.infer_batch(reqs))
    e.codes_per_text_token = cptt
    print(f"[batched] peak device memory (production engine, 12-row decode): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # (2) multi-segment, greedy, batch_segments on and off
    seg = {}
    for on in (True, False):
        e.batch_segments = on
        engine.generator.set_state(state)
        seg[on] = _timed(torch, engine, lambda: engine.infer(
            prompts[0], SEGMENT_TEXT, max_text_tokens_per_segment=12, do_sample=False))
    e.batch_segments = True
    print(f"[batched] 3-segment infer, greedy beam-3 ({card}): batch_segments on wall "
          f"{seg[True][1]:.4f} s, gpt_gen_time {seg[True][2]['gpt_gen_time']:.4f} s; "
          f"off wall {seg[False][1]:.4f} s, gpt_gen_time "
          f"{seg[False][2]['gpt_gen_time']:.4f} s")
    timing["segments"] = {"batched_wall_s": seg[True][1],
                          "batched_gpt_gen_s": seg[True][2]["gpt_gen_time"],
                          "sequential_wall_s": seg[False][1],
                          "sequential_gpt_gen_s": seg[False][2]["gpt_gen_time"]}
    if len(seg[True][3]) != 3:
        fail(f"[batched] the segment text made {len(seg[True][3])} segments, not 3")
    _same_codes("[batched] segments batched against one after another", seg[True][3],
                seg[False][3])

    # (3) streaming against infer's WAV, from one generator state
    e.batch_segments = False
    engine.generator.set_state(state)
    hint = dict(engine._cap_hint)
    whole = engine.infer(prompts[0], STREAM_TEXT, max_text_tokens_per_segment=12,
                         do_sample=False)
    engine.generator.set_state(state)
    engine._cap_hint = hint
    t0 = time.perf_counter()
    chunks = list(engine.infer(prompts[0], STREAM_TEXT, max_text_tokens_per_segment=12,
                               do_sample=False, stream_return=True))
    wall_stream = time.perf_counter() - t0
    e.batch_segments = True
    joined = np.concatenate(chunks)
    print(f"[batched] streaming: {len(chunks)} chunks {[len(c) for c in chunks]} in "
          f"{wall_stream:.4f} s; joined equal to infer's WAV "
          f"{np.array_equal(joined, whole.wav)}")
    if len(chunks) != 3 or chunks[1].any() or not np.array_equal(joined, whole.wav):
        fail("[batched] the streamed chunks are not infer's segments and silence")
    # (4) the bench engine's batched sampling decode (greedy) against K1
    cfg = bench_config()
    cfg.engine.use_fused_batch_decode = True
    cfg.generation.do_sample = False
    bench = TTSEngine.random(cfg, device=dev, seed=0)
    check_cold_conditioning(torch, engine, bench, card)
    engine.cfg.generation = gen0
    bench.infer_batch(reqs)                        # captures the 4-row key
    counters.reset()
    out_b, wall_b, m_b, codes_b = _timed(torch, bench, lambda: bench.infer_batch(reqs))
    got = counters.snapshot()
    check_decode_launches("batched bench", got, [m_b], "fused_decode_step_batch")
    if got["fused_decode_step"] != 0 or m_b["decode_runs"] != 1:
        fail("[batched bench] the 4 requests did not decode as one K3 run")
    for r in reqs:                                 # captures the K1 key
        bench.infer(r["spk_audio_prompt"], r["text"])
    seq, wall_s, gen_s = [], 0.0, 0.0
    for r in reqs:
        _, wall, m, codes = _timed(torch, bench, lambda: bench.infer(
            r["spk_audio_prompt"], r["text"]))
        seq += codes
        wall_s, gen_s = wall_s + wall, gen_s + m["gpt_gen_time"]
    print(f"[batched] bench infer_batch of 4 requests, greedy, cap 256 ({card}): batched "
          f"(K3 at 4 rows) wall {wall_b:.4f} s, gpt_gen_time {m_b['gpt_gen_time']:.4f} s; "
          f"one at a time (K1) wall {wall_s:.4f} s, gpt_gen_time {gen_s:.4f} s")
    timing["bench"] = {"batched_wall_s": wall_b, "batched_gpt_gen_s": m_b["gpt_gen_time"],
                       "sequential_wall_s": wall_s, "sequential_gpt_gen_s": gen_s}
    _same_codes("[batched bench] K3 at 4 rows against each request through K1", codes_b,
                seq)
    print("[batched] timing: " + json.dumps(timing))
    del bench
    return {k: launches.get(k, 0) + got.get(k, 0) for k in set(launches) | set(got)}


# ---------------------------------------------------------------------------
# serving phase: the queued service, grouped and continuous
# ---------------------------------------------------------------------------

# the grouped part's code cap (random weights: every decode runs to it)
SERVE_CAP = 512
# four texts of text bucket 32 and four of bucket 64 (the hash tokenizer
# takes each character: 20, 13, 23, 26 and 33, 39, 41, 42 tokens); all
# eight lie in the bench configuration's one bucket, 48
SERVE_TEXTS = ("欢迎大家来体验这个语音合成系统谢谢大家.", "今天天气很好我们出去走走.",
               "这个系统可以把文字变成自然流畅的声音欢迎试用.",
               "语音合成系统正在为每一位用户生成清晰的声音谢谢大家.",
               "欢迎大家来体验这个语音合成系统谢谢大家今天天气很好我们出去走走吧.",
               "这个系统可以把文字变成自然流畅的声音欢迎试用语音合成系统正在为每一位用户生成.",
               "语音合成系统正在为每一位用户生成清晰的声音谢谢大家欢迎大家来体验这个语音合成系统.",
               "今天天气很好我们出去走走这个系统可以把文字变成自然流畅的声音欢迎试用谢谢大家来体验.")
# the continuous part: 8 slots, 16 steps a chunk, 8 texts of bucket 48
SLOTS, CHUNK_STEPS = 8, 16
POISSON_REQUESTS = 16


def speaker_prompt(f0: float, seconds: float = 2.0, sr: int = 22050) -> bytes:
    """A two-tone prompt at f0 and 2 f0: one speaker a frequency, 2 s (the
    warm-up prompt's length, so the same prompt bucket)."""
    import numpy as np
    from voice_tts_tpu_torch.audio import encode_wav_int16

    t = np.arange(int(seconds * sr)) / sr
    tone = (0.4 * np.sin(2 * np.pi * f0 * t)
            + 0.1 * np.sin(2 * np.pi * 2 * f0 * t)).astype(np.float32)
    return encode_wav_int16(tone * 32767, sr)


def _percentiles(xs):
    import numpy as np

    return {"p50_s": float(np.percentile(xs, 50)), "p95_s": float(np.percentile(xs, 95))}


def _post_tts(port, prompt: bytes, text: str, out: list, i: int, t_start=None):
    """POST /tts (after `t_start`, a perf_counter time, when given); stores
    (status, latency s, audio s, decoded WAV sample rate, samples) at out[i]."""
    import numpy as np
    from voice_tts_tpu_torch.audio import decode_audio_bytes

    if t_start is not None:
        time.sleep(max(0.0, t_start - time.perf_counter()))
    t0 = time.perf_counter()
    status, body = http(port, "POST", "/tts", json.dumps(
        {"text": text, "spk_audio": prompt.hex()}).encode())
    lat = time.perf_counter() - t0
    sr = n = 0
    audio = 0.0
    if status == 200:
        resp = json.loads(body)
        wav, sr = decode_audio_bytes(bytes.fromhex(resp["audio_hex"]))
        n = wav.size if np.all(np.isfinite(wav)) else 0
        audio = resp["audio_length"]
    out[i] = (status, lat, audio, sr, n, body[:300] if status != 200 else b"")


def _fire(port, reqs, starts=None):
    """Send the (prompt, text) requests from threads of their own, each at
    its start time (perf_counter) or all at once; returns their records in
    request order and the wall from the first send to the last answer."""
    import threading

    out = [None] * len(reqs)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_post_tts, args=(port, p, t, out, i,
                                                        None if starts is None else starts[i]))
               for i, (p, t) in enumerate(reqs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out, time.perf_counter() - t0


def _check_served(tag, out):
    for i, (status, lat, audio, sr, n, body) in enumerate(out):
        if status != 200 or sr != 22050 or n == 0:
            fail(f"[{tag}] request {i}: status {status}, sample rate {sr}, {n} finite "
                 f"samples: {body!r}")


def _metrics(port) -> dict:
    status, body = http(port, "GET", "/metrics")
    if status != 200:
        fail(f"/metrics answered {status}")
    return {k: float(v) for k, v in (line.split() for line in body.decode().splitlines()
                                     if not line.startswith("#"))}


def _record_mel_jobs(engine):
    """Record every job `_mel_jobs` synthesizes (its dict); returns the list
    and the function that puts the engine back."""
    seen, mel_jobs = [], engine._mel_jobs

    def rec(jobs, cbucket):
        seen.extend(jobs)
        return mel_jobs(jobs, cbucket)
    engine._mel_jobs = rec

    def restore():
        del engine._mel_jobs
    return seen, restore


def _codes_by_text(jobs) -> dict:
    """Each recorded job's codes, keyed by its text's token ids."""
    return {tuple(j["ids"]): [int(c) for c in j["codes"][:j["code_len"]]] for j in jobs}


def _key_text(key) -> str:
    """A device-loop key without its object ids (ints past 2^32)."""
    return repr(tuple(x for x in key if not (isinstance(x, int) and x >= 2 ** 32)))[:300]


def run_grouped_serving(torch, dev, counters, engine, card):
    """The queued service in grouped mode on the production engine (beam-3
    through K3 with the ancestor table, int8 KV), greedy so that a
    request's codes in a group and alone can be compared bit for bit, the
    codes cut to SERVE_CAP: `workload` warm-up (every text bucket at
    batches 1, 2, 4 and 8, then the full-cap pass), two speakers conditioned
    beforehand, 8 concurrent POST /tts (texts of buckets 32 and 64): all 200
    with a 22.05 kHz WAV, fewer than 8 batches in /metrics, no graph
    captured, then each request alone (a group of one: `infer`): the same
    codes.  Returns the burst's launches."""
    import dataclasses

    from voice_tts_tpu_torch.serving.app import BackgroundServer, TTSService

    gen0 = engine.cfg.generation
    engine.cfg.generation = dataclasses.replace(gen0, max_mel_tokens=SERVE_CAP,
                                                do_sample=False)
    engine.cfg.server.warmup_mode = "workload"
    service = TTSService(engine, profile="serving")
    service._warmup()
    warm = service.warmup_stats
    print(f"[grouped] workload warm-up ({card}): {warm['seconds']:.2f} s, "
          f"{warm['graphs']} graphs captured, {len(engine.loops._keys)} keys: "
          + "; ".join(_key_text(k) for k in engine.loops._keys))
    if warm["graphs"] == 0:
        fail("[grouped] the warm-up captured no graph")
    prompts = (speaker_prompt(180.0), speaker_prompt(260.0))
    for p in prompts:
        engine._speaker_conditioning(p)
    reqs = [(prompts[i % 2], text) for i, text in enumerate(SERVE_TEXTS)]
    from voice_tts_tpu_torch.engine import post

    buckets = sorted({post.pick_bucket(len(t), engine.cfg.engine.text_buckets)
                      for t in SERVE_TEXTS})
    seen, restore = _record_mel_jobs(engine)
    server = BackgroundServer(service)
    port = server.start()
    try:
        before = _metrics(port)
        stats0, keys0 = dict(engine.loops.stats), len(engine.loops._keys)
        counters.reset()
        out, wall = _fire(port, reqs)
        launches = counters.snapshot()
        _check_served("grouped", out)
        after = _metrics(port)
        batches = after["tts_batches_total"] - before["tts_batches_total"]
        grouped = after["tts_batched_requests_total"] - before["tts_batched_requests_total"]
        captured = engine.loops.stats["graphs"] - stats0["graphs"]
        lat = [o[1] for o in out]
        audio = sum(o[2] for o in out)
        print(f"[grouped] 8 concurrent POST /tts, beam-3 greedy, cap {SERVE_CAP}, text "
              f"buckets {buckets} ({card}): all 200; latency "
              f"{json.dumps(_percentiles(lat))}, wall {wall:.4f} s, audio "
              f"{audio:.3f} s, {audio / wall:.4f} audio s per wall s; group sizes "
              f"{service.batch_sizes}; /metrics: {batches:.0f} batches of {grouped:.0f} "
              f"requests; graphs captured {captured}, keys {keys0} -> "
              f"{len(engine.loops._keys)}; launches {json.dumps(launches)}")
        if grouped != 8 or not batches < 8:
            fail(f"[grouped] 8 requests went out in {batches:.0f} batches")
        if captured or len(engine.loops._keys) != keys0:
            fail("[grouped] the traffic captured a graph after the warm-up: "
                 + "; ".join(_key_text(k) for k in list(engine.loops._keys)[keys0:]))
        if launches["fused_decode_step_batch"] == 0 or launches["fused_decode_step"]:
            fail("[grouped] the beam decode did not run through K3 alone")
        burst = _codes_by_text(seen)
        # alone: a group of one runs `infer` (`_decode_beam`), one at a time
        seq, restore_seq = _job_codes(engine)
        alone_out = [None] * len(reqs)
        try:
            for i, (p, t) in enumerate(reqs):
                _post_tts(port, p, t, alone_out, i)
        finally:
            restore_seq()
        _check_served("grouped alone", alone_out)
        tok = engine.tokenizer
        alone = {tuple(tok.convert_tokens_to_ids(tok.tokenize(t))): c
                 for (_, t), c in zip(reqs, seq)}
        walls = [o[1] for o in alone_out]
        print(f"[grouped] the same 8 requests one at a time: latency "
              f"{json.dumps(_percentiles(walls))}, {sum(walls):.4f} s in all, "
              f"{audio / sum(walls):.4f} audio s per wall s; the burst "
              f"{sum(walls) / wall:.4f}x their throughput")
    finally:
        server.stop()
        restore()
        engine.cfg.generation = gen0
    keys = sorted(burst)
    _same_codes("[grouped] each request's codes in the burst against alone",
                [burst[k] for k in keys], [alone.get(k) for k in keys])
    if len(keys) != 8:
        fail(f"[grouped] {len(keys)} jobs synthesized, not 8")
    return launches


def _bench_requests(engine):
    """Eight requests over two speakers in text bucket 48 (the bench
    configuration's only bucket)."""
    prompts = (speaker_prompt(180.0), speaker_prompt(260.0))
    return [{"spk_audio_prompt": prompts[i % 2], "text": t}
            for i, t in enumerate(SERVE_TEXTS)]


def _continuous_against_alone(torch, engine, jobs, gen):
    """Each harvested job's steps, limit flag and codes against the port's
    `decode()` of its request alone (K1, the fused pack, no readout pack)."""
    import numpy as np
    from voice_tts_tpu_torch.engine import post
    from voice_tts_tpu_torch.models.gpt.decode import decode as gpt_decode

    dev, cfg = engine.device, engine.cfg
    got, ref = [], []
    for job in jobs:
        text = torch.zeros((1, job["bucket"]), dtype=torch.long)
        text[0, :job["text_len"]] = torch.tensor(job["ids"][:job["bucket"]])
        res = gpt_decode(engine.gpt_rt, gen, job["spk"]["cond_latents"], job["emovec"],
                         text.to(dev), torch.tensor([job["text_len"]], device=dev),
                         gen.max_mel_tokens, None, engine.fused_pack, None,
                         int8_kv=cfg.engine.use_int8_kv, loops=engine.loops)
        n, hit = int(res.lengths[0]), bool(res.hit_limit[0])
        code_len0 = max(n - (0 if hit else 1), 1)
        row, row_len = post.remove_long_silence(
            res.codes[:, :code_len0].cpu().numpy(), np.asarray([code_len0]),
            cfg.gpt.stop_mel_token, cfg.engine.silent_token)
        got.append([job["steps"], job["hit_limit"]]
                   + [int(c) for c in job["codes"][:job["code_len"]]])
        ref.append([n, hit] + row[0, :int(row_len[0])].tolist())
    return got, ref


def _chunk_state_run(torch, engine, loops, gen, reqs, seed, time_it=False):
    """Three requests admitted one chunk apart into 8 slots, 6 chunks, under
    `loops` (op by op, or graphs), the draws from a generator seeded
    `seed`: every state tensor and status after each chunk.  With
    `time_it`, then every slot filled: K3 at the slots' per-row positions
    with no readout pack, as the chunk calls it, held against its plain
    version (`compare_step`, the logits of each through the chunk's
    row-by-row readout) on the slot state and on the same cache quantized
    to int8 with its scales; then K3 alone device-only, and a replayed chunk
    (CUDA events)."""
    from voice_tts_tpu_torch.engine import continuous as cont
    from voice_tts_tpu_torch.models.gpt.unified_voice import n_cond_latents
    from voice_tts_tpu_torch.ops.fused_decode import BLOCK_T

    model, pack, dev, cfg = engine.gpt_rt, engine.fused_pack, engine.device, engine.cfg
    gen_t = torch.Generator(device=dev).manual_seed(seed)
    dtype = model.conditioning_encoder.after_norm.bias.dtype
    t_max = n_cond_latents(cfg.gpt) + 2 + max(cfg.engine.text_buckets) + 2 + 1
    t_max += gen.max_mel_tokens
    t_max += (-t_max) % BLOCK_T
    state = cont.init_state(cfg.gpt, SLOTS, t_max, gen.max_mel_tokens, dtype,
                            cfg.engine.use_int8_kv, dev)
    state = cont.bind_state(loops, cont.chunk_key(model, pack, gen, gen_t, state,
                                                  CHUNK_STEPS), state)
    statuses = []
    for c in range(6):
        if c < len(reqs):
            cond, emo, text, tlen = reqs[c]
            cont.admit(model, gen, state, c, cond, emo, text, tlen, gen_t)
        _, status = cont.run_chunk(model, pack, gen, state, gen_t, CHUNK_STEPS, loops)
        statuses.append(status.clone())
    torch.cuda.synchronize()
    out = [x.clone() for x in state if x is not None], statuses
    if time_it:
        from voice_tts_tpu_torch.ops.fused_decode import (fused_decode_step_batch,
                                                          fused_decode_step_batch_plain,
                                                          quantize_kv_cache_batch)

        for slot in range(len(reqs), SLOTS):
            cont.admit(model, gen, state, slot, *reqs[slot % len(reqs)], gen_t)
        x = model.embed_decode_token_rows(state.token, state.steps - 1)
        caches = [("int8" if state.kv_scales is not None else "float", state.cache,
                   state.kv_scales)]
        if state.kv_scales is None:
            caches.append(("int8", *quantize_kv_cache_batch(state.cache)))
        with torch.no_grad():
            for name, cache, scales in caches:
                def k3(fn):
                    hidden, kv_new, logits = fn(x, pack, cache, state.bias, state.pos,
                                                cfg.gpt.heads, kv_scales=scales)
                    if logits is not None:
                        fail("[continuous] K3 read out without a readout pack")
                    return hidden, kv_new, model.readout_rows(hidden)
                got, ref = k3(fused_decode_step_batch), k3(fused_decode_step_batch_plain)
                torch.cuda.synchronize()
                compare_step(torch, f"[continuous] K3 at {SLOTS} slots, {name} KV, per-row "
                             f"positions {state.pos.tolist()}, Tmax {t_max}, no readout "
                             f"pack", got, ref)
        k3 = device_time_ms(torch, lambda: fused_decode_step_batch(
            x, pack, state.cache, state.bias, state.pos, cfg.gpt.heads,
            kv_scales=state.kv_scales), CHAIN_ITERS)
        chunk = cuda_time_ms(torch, lambda: cont.run_chunk(
            model, pack, gen, state, gen_t, CHUNK_STEPS, loops), 5, warmup=1)
        print(f"[continuous] K3 at {SLOTS} slots, per-row positions "
              f"{state.pos.tolist()}, Tmax {t_max}: device-only {k3:.4f} ms a step; a "
              f"replayed chunk {chunk:.4f} ms, {chunk / CHUNK_STEPS:.4f} a step (K3, the "
              f"readout row by row, the sampling)")
    return out


def run_continuous_serving(torch, dev, counters, engine, card):
    """Continuous batching on the bench engine (sampling, one beam), 8
    slots, the 256 cap, 16 steps a chunk: (1) a greedy `ContinuousBatcher`
    over 8 requests, one submitted each chunk while the others decode:
    each request's codes against `decode()` alone, K3 chunks x 16 times;
    (2) a chunk key's first capture while a synthesis thread runs, its WAVs
    against the same synthesis alone; (3) chunks replayed against the same
    chunks op by op (sampling, staggered admissions): bit-equal, then K3 at
    the slots' positions against its plain version (`_chunk_state_run`);
    (4) the service with `--continuous-batching`: its workload warm-up
    (which must capture the worker's chunk graph), two requests, then 16
    requests with Poisson arrivals at a mean gap of a quarter of the second
    request's wall, under the profiler.  Returns the launches of (1) and
    (4) together."""
    import dataclasses
    import threading

    import numpy as np
    from voice_tts_tpu_torch.engine import continuous as cont
    from voice_tts_tpu_torch.engine.device_loop import GATE, DeviceLoops
    from voice_tts_tpu_torch.scripts.decode_host_time import busy_seconds
    from voice_tts_tpu_torch.serving.app import BackgroundServer, TTSService

    reqs = _bench_requests(engine)
    greedy = engine._generation_config({"do_sample": False})
    # (1) greedy batcher, staggered, against decode() alone
    seen, restore = _record_mel_jobs(engine)
    batcher = cont.ContinuousBatcher(engine, slots=SLOTS, chunk_steps=CHUNK_STEPS,
                                     generation_kwargs={"do_sample": False})
    counters.reset()
    t0 = time.perf_counter()
    pairs = []
    try:
        for r in reqs:
            pairs.append(batcher.submit(r))
            batcher.step_once()
        batcher.run()
    finally:
        batcher.stop()
        restore()
    wall = time.perf_counter() - t0
    launches = counters.snapshot()
    for holder, _ in pairs:
        if not holder or isinstance(holder[0], Exception):
            fail(f"[continuous] a batcher request failed: {holder}")
    st = batcher.stats
    print(f"[continuous] greedy batcher, 8 requests one a chunk, {SLOTS} slots, "
          f"{CHUNK_STEPS} steps a chunk, cap {batcher.max_new} ({card}): wall {wall:.4f} s, "
          f"{json.dumps(st)}, mean occupied slots a chunk "
          f"{st['occupied'] / st['chunks']:.3f}; K3 {launches['fused_decode_step_batch']} "
          f"launches, K1 {launches['fused_decode_step']}")
    if launches["fused_decode_step_batch"] != st["chunks"] * CHUNK_STEPS:
        fail("[continuous] K3 did not launch once a step of every chunk")
    if launches["fused_decode_step"] != 0 or st["harvested"] != 8:
        fail("[continuous] the batcher ran K1, or did not harvest 8 jobs")
    got, ref = _continuous_against_alone(torch, engine, seen, greedy)
    _same_codes("[continuous] steps, limit flag and codes a request against decode() "
                "alone (K1, no readout pack)", got, ref)

    # (2) a first capture while a synthesis thread runs
    group = [dict(j) for j in seen[:2]]
    fixed = {}
    draw = engine._draw_noise

    def noise(shape):
        if tuple(shape) not in fixed:
            fixed[tuple(shape)] = draw(shape)
        return fixed[tuple(shape)]
    engine._draw_noise = noise
    try:
        engine._mel_jobs(group, group[0]["cbucket"])
        ref_wavs = [j["wav"].copy() for j in group]
        spans, errors, stop = [], [], threading.Event()

        def synthesize():
            try:
                while not stop.is_set() or len(spans) < 3:
                    with sampled._engine_lock, GATE.shared():
                        s = time.perf_counter()
                        engine._mel_jobs(group, group[0]["cbucket"])
                        torch.cuda.synchronize()
                        spans.append((s, time.perf_counter(),
                                      all(np.array_equal(j["wav"], w)
                                          for j, w in zip(group, ref_wavs))))
                    time.sleep(0.005)         # let the scheduler take the lock
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
        synth = threading.Thread(target=synthesize)
        graphs0 = engine.loops.stats["graphs"]
        sampled = cont.ContinuousBatcher(engine, slots=SLOTS, chunk_steps=CHUNK_STEPS)
        synth.start()
        while len(spans) < 1 and synth.is_alive():
            time.sleep(0.01)
        t_cap = time.perf_counter()
        holder, ev = sampled.submit(reqs[0])
        sampled.step_once()                   # conditioning, admission, the capture
        t_done = time.perf_counter()
        sampled.start()
        ev.wait(300)
        sampled.stop()
        stop.set()
        synth.join()
    finally:
        engine._draw_noise = draw
    overlap = [s for s in spans if s[0] < t_done and s[1] > t_cap]
    print(f"[continuous] first capture of a chunk key ({t_done - t_cap:.4f} s from "
          f"submission, graphs +{engine.loops.stats['graphs'] - graphs0}) while "
          f"synthesis ran {len(spans)} times ({len(overlap)} overlapping the capture's "
          f"window); every synthesis bit-equal to the one alone "
          f"{all(s[2] for s in spans)}; the request "
          f"{'completed' if holder and not isinstance(holder[0], Exception) else holder}")
    if errors or not all(s[2] for s in spans):
        fail(f"[continuous] synthesis beside the capture failed or changed: {errors}")
    if not holder or isinstance(holder[0], Exception):
        fail(f"[continuous] the request whose chunk captured failed: {holder}")
    if engine.loops.stats["graphs"] == graphs0:
        fail("[continuous] the new chunk key captured no graph")

    # (3) replayed chunks against op by op, sampling, staggered admissions
    gen_s = engine.cfg.generation
    inputs = []
    for r in reqs[:3]:
        spk, emovec, segs = engine._prepare(r["spk_audio_prompt"], None, 1.0, None, False,
                                            r["text"], 120)
        ids = engine.tokenizer.convert_tokens_to_ids(segs[0])
        bucket = max(engine.cfg.engine.text_buckets)
        text = torch.zeros((1, bucket), dtype=torch.long)
        text[0, :len(ids)] = torch.tensor(ids)
        inputs.append((spk["cond_latents"], emovec, text.to(dev),
                       torch.tensor([len(ids)], device=dev)))
    runs = {name: _chunk_state_run(torch, engine, DeviceLoops(dev, capture=capture),
                                   gen_s, inputs, 1234, time_it=capture)
            for name, capture in (("op_by_op", False), ("graphs", True))}
    same = (all(torch.equal(a, b) for a, b in zip(runs["op_by_op"][0], runs["graphs"][0]))
            and all(torch.equal(a, b) for a, b in zip(runs["op_by_op"][1],
                                                       runs["graphs"][1])))
    steps = runs["graphs"][1][-1][3].tolist()
    print(f"[continuous] 6 sampled chunks, 3 staggered admissions: replayed against op "
          f"by op bit-equal {same} (steps a slot {steps})")
    if not same:
        fail("[continuous] a replayed chunk differs from the same chunk op by op")

    # (4) one at a time through K1 (`infer`), then the service, Poisson arrivals
    engine.infer(reqs[0]["spk_audio_prompt"], reqs[0]["text"])
    walls = []
    for r in reqs:
        t0 = time.perf_counter()
        engine.infer(r["spk_audio_prompt"], r["text"])
        walls.append(time.perf_counter() - t0)
    print(f"[continuous] 8 requests one at a time through `infer` (K1, sampling) ({card}): "
          f"wall {json.dumps(_percentiles(walls))}, {len(walls) / sum(walls):.4f} "
          f"requests/s")
    e = engine.cfg
    e.server.continuous_batching, e.server.chunk_steps = True, CHUNK_STEPS
    e.server.max_batch_size, e.server.warmup_mode = SLOTS, "workload"
    service = TTSService(engine, profile="bench")
    service._warmup()
    warm_up = service.warmup_stats
    key = service._batchers[0].key
    print(f"[continuous] workload warm-up through the replica's batcher ({card}): "
          f"{warm_up['seconds']:.2f} s, {warm_up['graphs']} graphs captured, the chunk "
          f"key's graph captured {engine.loops._keys[key].graph is not None}")
    if engine.loops._keys[key].graph is None:
        fail("[continuous] the warm-up did not capture the worker's chunk graph")
    server = BackgroundServer(service)
    port = server.start()
    try:
        info = json.loads(http(port, "GET", "/debug/worker-info")[1])["replicas"][0]
        if info["mode"] != "continuous":
            fail(f"[continuous] worker-info reports {info['mode']}")
        keys0 = list(engine.loops._keys)
        graphs0 = engine.loops.stats["graphs"]
        r0 = [(reqs[0]["spk_audio_prompt"], reqs[0]["text"])]
        cold, cold_wall = _fire(port, r0)
        warm, warm_wall = _fire(port, r0)
        _check_served("continuous warm-up", cold + warm)
        gap = warm_wall / 4
        rng = np.random.default_rng(7)
        arrivals = np.cumsum(rng.exponential(gap, POISSON_REQUESTS))
        batcher = service._batchers[0]
        stats0 = dict(batcher.stats)
        traffic = [(reqs[i % len(reqs)]["spk_audio_prompt"], reqs[i % len(reqs)]["text"])
                   for i in range(POISSON_REQUESTS)]
        from torch.profiler import ProfilerActivity, profile

        counters.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out, wall = _fire(port, traffic, list(t0 + arrivals))
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        got = counters.snapshot()
        _check_served("continuous", out)
        d = {k: batcher.stats[k] - stats0[k] for k in stats0}
        busy = busy_seconds(prof)
        lat = [o[1] for o in out]
        audio = sum(o[2] for o in out)
        print(f"[continuous] {POISSON_REQUESTS} POST /tts, Poisson arrivals at a mean gap "
              f"of {gap:.4f} s (a quarter of the second request's {warm_wall:.4f} s; the first "
              f"{cold_wall:.4f} s) ({card}): all 200; latency {json.dumps(_percentiles(lat))}, "
              f"wall {span:.4f} s, {POISSON_REQUESTS / span:.4f} requests/s, "
              f"{audio / span:.4f} audio s per wall s; chunks {d['chunks']}, mean occupied "
              f"slots a chunk {d['occupied'] / max(d['chunks'], 1):.3f}; host reads a "
              f"request {(d['status_reads'] + d['codes_reads']) / POISSON_REQUESTS:.3f} "
              f"(status {d['status_reads']}, codes {d['codes_reads']}); device busy "
              f"{busy:.4f} s, idle share {1 - busy / span:.4f} (profiled); K3 "
              f"{got['fused_decode_step_batch']} launches, K1 {got['fused_decode_step']}")
        new_keys = [k for k in engine.loops._keys if k not in keys0]
        print(f"[continuous] the traffic after the warm-up captured "
              f"{engine.loops.stats['graphs'] - graphs0} graphs: "
              + "; ".join(_key_text(k) for k in new_keys))
        if got["fused_decode_step_batch"] != d["chunks"] * CHUNK_STEPS or got["fused_decode_step"]:
            fail("[continuous] the served chunks did not run K3 once a step, or K1 ran")
    finally:
        server.stop()
        e.server.continuous_batching = False
    return {k: launches.get(k, 0) + got.get(k, 0) for k in set(launches) | set(got)}


def _on_card_spy(engine, i, seen, names=("infer", "infer_batch", "_prepare", "_mel_jobs")):
    """Record (replica i, the calling thread's current device) at each call
    of the engine's entry points."""
    import torch

    for name in names:
        fn = getattr(engine, name)

        def spy(*a, _fn=fn, **k):
            seen.append((i, torch.cuda.current_device()))
            return _fn(*a, **k)
        setattr(engine, name, spy)
    return engine


def run_workers(torch, counters, card):
    """`--workers N` over every card of the machine (two or more; `--only
    workers`): tiny engines with the int8 trunk and the fused decode pack,
    replica i on cuda:i, so their kernels (K4 / K1 / K3, K2) launch on card
    i.
    Grouped mode, then continuous: 2N concurrent POST /tts, all 200, every
    replica serving, each engine entry point called on a thread whose
    current device is the replica's card.  Grouped mode then fails the last
    replica once with a fatal error: the watchdog rebuilds it on its card,
    and the next 2N requests are all 200 again."""
    from voice_tts_tpu_torch.serving.app import BackgroundServer, TTSService

    n = torch.cuda.device_count()
    if n < 2:
        fail(f"[workers] needs two cards or more; found {n}")
    prompts = [speaker_prompt(180.0 + 40 * i) for i in range(2 * n)]
    reqs = [(p, SERVE_TEXTS[i % len(SERVE_TEXTS)][:12]) for i, p in enumerate(prompts)]
    for mode in ("grouped", "continuous"):
        service = TTSService()
        service.load_engines(workers=n, tiny=True, continuous=True, device="cuda")
        devices = [str(e.device) for e in service.engines]
        if devices != [f"cuda:{i}" for i in range(n)]:
            fail(f"[workers] replicas on {devices}")
        seen = []
        for i, e in enumerate(service.engines):
            e.cfg.server.continuous_batching = mode == "continuous"
            e.cfg.generation.do_sample, e.cfg.generation.max_mel_tokens = False, 32
            _on_card_spy(e, i, seen)
        factory = service._engine_factory

        def rebuilt(i, factory=factory, seen=seen):
            e = factory(i)
            e.cfg.generation.do_sample, e.cfg.generation.max_mel_tokens = False, 32
            return _on_card_spy(e, i, seen)
        service._engine_factory = rebuilt
        server = BackgroundServer(service)
        port = server.start()
        try:
            info = json.loads(http(port, "GET", "/debug/worker-info")[1])["replicas"]
            if [r["mode"] for r in info] != [mode] * n:
                fail(f"[workers] worker-info modes {[r['mode'] for r in info]}")
            counters.reset()
            out, wall = _fire(port, reqs)
            launches = counters.snapshot()
            _check_served(f"workers {mode}", out)
            served = sorted({i for i, _ in seen})
            strays = sorted({(i, d) for i, d in seen if d != i})
            print(f"[workers] {mode}: {n} replicas on {devices} ({card}), {2 * n} concurrent "
                  f"POST /tts all 200 in {wall:.4f} s; replicas called {served}; calls off "
                  f"their card {strays}; launches {json.dumps(launches)}")
            if served != list(range(n)) or strays:
                fail(f"[workers] {mode}: a replica served nothing, or ran off its card")
            # a group of 2+ decodes eagerly through K4, a lone request
            # through K1, a continuous chunk through K3
            decode = (launches["fused_decode_step"] + launches["fused_decode_step_batch"]
                      + launches["int8_gemv"])
            if not decode or not launches["aa_snake_activation"]:
                fail(f"[workers] {mode}: the decode or the vocoder kernels did not launch")
            if mode == "grouped":
                last = service.engines[-1]

                def fatal(*a, **k):
                    raise RuntimeError("CUDA error: simulated device failure")
                last.infer = last.infer_batch = fatal
                failed, _ = _fire(port, reqs[:n])
                deadline = time.time() + 120
                while (_metrics(port)["tts_replica_rebuilds_total"] < 1
                       and time.time() < deadline):
                    time.sleep(0.2)
                new = service.engines[-1]
                seen.clear()
                again, _ = _fire(port, reqs)
                _check_served("workers rebuilt", again)
                strays = sorted({(i, d) for i, d in seen if d != i})
                print(f"[workers] grouped: a fatal error on replica {n - 1}: statuses "
                      f"{[o[0] for o in failed]}; rebuilt {new is not last} on "
                      f"{new.device}; then {2 * n} requests all 200, replicas called "
                      f"{sorted({i for i, _ in seen})}, calls off their card {strays}")
                if (new is last or str(new.device) != f"cuda:{n - 1}" or strays
                        or sorted(o[0] for o in failed) != [200] * (n - 1) + [500]):
                    fail("[workers] the watchdog did not rebuild the replica on its card")
        finally:
            server.stop()
        del service
        torch.cuda.empty_cache()


def run_bench_slice(torch, dev, counters):
    """The flagship engine in the bench configuration (`--profile bench`):
    sampling, one beam through K1."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, bench_config

    t0 = time.perf_counter()
    engine = TTSEngine.random(bench_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[bench] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    before = dict(engine.loops.stats)
    launches, steps, n_act, prompt, text, metrics, _ = serve_requests(
        torch, engine, "bench", counters)
    check_decode_launches("bench", launches, metrics, "fused_decode_step")
    check_served_through_graphs("bench", engine, before, metrics)
    compare_with_uncaptured(torch, dev, engine, "bench", prompt, text)
    if launches["fused_decode_step_batch"] != 0:
        fail("K3 was launched on the one-beam path")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
    return launches, metrics, engine


def run_spec_slice(torch, dev, counters, bench_metrics):
    """The bench configuration with self-speculative decode, K = 4: each
    round three int4 draft steps (K1 chains with the int4 loader, K7), one
    int8 verify of the four tokens (K6), then the acceptance step."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, bench_config

    cfg = bench_config()
    cfg.engine.spec_decode_k = 4
    t0 = time.perf_counter()
    engine = TTSEngine.random(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[spec] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches, steps, n_act, prompt, text, metrics, _ = serve_requests(torch, engine,
                                                                      "spec", counters)
    rounds = sum(m["spec_rounds"] for m in metrics)
    accepted = sum(m["spec_accepted"] for m in metrics)
    if rounds == 0 or launches["fused_decode_verify"] != rounds:
        fail("K6 was not launched once per speculative round")
    if (launches["fused_decode_int4"] != 3 * rounds
            or launches["fused_decode_step"] != 3 * rounds):
        fail("the int4 K1 chain (K1 with K7) was not launched three times a round")
    if launches["fused_decode_step_batch"] != 0:
        fail("K3 was launched on the speculative path")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
    print("[spec] " + json.dumps({
        "rounds": rounds, "accepted_drafts": accepted,
        "acceptance_rate": accepted / (3 * rounds),
        "codes_per_round": steps / rounds,
        "gpt_gen_time": [m["gpt_gen_time"] for m in metrics],
        "rtf": [m["rtf"] for m in metrics],
        "decode_steps": [m["decode_steps"] for m in metrics],
        "bench_gpt_gen_time": [m["gpt_gen_time"] for m in bench_metrics],
        "bench_rtf": [m["rtf"] for m in bench_metrics],
        "bench_decode_steps": [m["decode_steps"] for m in bench_metrics]}))
    prof = profile_request(torch, engine, prompt, text)
    n = prof["metrics"]["spec_rounds"]

    chain = ("dq_gemv", "attend_split", "verify_split")

    def span_s(*names):
        return sum(t for key, _, t in prof["kernels"] if any(k in key for k in names))
    print("[spec] profiled request a round: " + json.dumps({
        "rounds": n,
        "chain_kernels": sum(c for key, c, _ in prof["kernels"]
                             if any(k in key for k in chain)) / n,
        "int4_gemv_span_ms": 1e3 * span_s("dq_gemv4") / n,
        "verify_attention_span_ms": 1e3 * span_s("verify_split") / n,
        "chain_kernels_busy_ms": 1e3 * span_s(*chain) / n,
        "gpt_gen_time_ms": 1e3 * prof["metrics"]["gpt_gen_time"] / n}))
    return launches


def dit_config():
    """The DiT slice: `bench_config()` with bf16 s2mel, the K8 trunk and K9
    attention (the JAX engine's flags; no server profile has them)."""
    from voice_tts_tpu_torch.engine.engine import bench_config

    cfg = bench_config()
    cfg.engine.use_bf16_s2mel = True
    cfg.s2mel.dit.fused_blocks = True
    cfg.s2mel.dit.fused_attention = True
    return cfg


def run_dit_slice(torch, dev, counters, bench_metrics):
    """The DiT slice at the flagship widths: three POST /tts, a 2.5 s prompt
    twice (prompt bucket 256 + mel bucket 448 = T 704: the K8 trunk, once per
    velocity evaluation) and a 5 s prompt (bucket 448, T 896 > 768: K9 in
    every block), then one profiled request at each prompt length.  Returns
    (launches, the engine)."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine

    t0 = time.perf_counter()
    engine = TTSEngine.random(dit_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[dit] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches, _, n_act, prompt, text, metrics, per_request = serve_requests(
        torch, engine, "dit", counters, prompts_s=(2.5, 2.5, 5.0))
    prompt_t896 = tone_prompt(5.0, 22050)
    cfg = engine.cfg
    evals = cfg.engine.diffusion_steps
    for i, (m, got) in enumerate(zip(metrics, per_request)):
        k8, k9 = got["dit_block_chain"], got["cfm_attention"]
        want = (evals, 0) if i < 2 else (0, evals * cfg.s2mel.dit.depth)
        print(f"[dit] request #{i}: K8 {k8}, K9 {k9} (want {want}), K1 "
              f"{got['fused_decode_step']} for {m['decode_steps']} steps, K2 "
              f"{got['aa_snake_activation']}")
        if (k8, k9) != want:
            fail(f"[dit] request #{i}: K8 / K9 launches {(k8, k9)}, want {want}")
        check_decode_launches(f"dit #{i}", got, [m], "fused_decode_step")
        if got["aa_snake_activation"] != n_act or got["flash_attention"] != 0:
            fail(f"[dit] request #{i}: K2 not once per activation, or K11 launched")
    keys = ("s2mel_time", "gpt_gen_time", "gpt_forward_time", "bigvgan_time", "rtf")
    print("[dit] stage timers " + json.dumps({
        "dit": {k: [m[k] for m in metrics] for k in keys},
        "bench": {k: [m[k] for m in bench_metrics] for k in keys},
        "dit_prompts_s": [2.5, 2.5, 5.0], "bench_prompts_s": [5.0, 5.0, 5.0]}))
    print("[dit] profiled request at T 704 (K8):")
    profile_request(torch, engine, prompt, text)
    print("[dit] profiled request at T 896 (K9):")
    profile_request(torch, engine, prompt_t896, text)
    # the CFM graph at T 704 with K8, then without it (K9 in every block:
    # its first graph request captures, the second replays)
    compare_with_uncaptured(torch, dev, engine, "dit K8", prompt, text)
    dit_pack, engine.dit_pack = engine.dit_pack, None
    try:
        compare_with_uncaptured(torch, dev, engine, "dit without K8", prompt, text,
                                runs=("graphs (capture)", "graphs"))
    finally:
        engine.dit_pack = dit_pack
    return launches, engine


def run_flash_engine(torch, dev, counters, dit_engine):
    """K11: a second engine on the DiT slice engine's weights with
    `flash_attention` on and `fused_attention` / `fused_blocks` off, one
    request at the 5 s prompt (T 896): K11 in every block and Euler step,
    then one profiled request."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine
    from voice_tts_tpu_torch.models.s2mel.s2mel import S2Mel

    cfg = dit_config()
    cfg.s2mel.dit.fused_blocks = cfg.s2mel.dit.fused_attention = False
    cfg.s2mel.dit.flash_attention = True
    extras = {"w2v_mean": dit_engine.w2v_mean.cpu().numpy(),
              "w2v_std": dit_engine.w2v_std.cpu().numpy(),
              "emo_matrix": dit_engine.emo_matrix, "spk_matrix": dit_engine.spk_matrix}
    # the s2mel module carries its DiT flags: a new one with this
    # configuration, holding the DiT slice's weights; the other models shared
    with torch.device(dev):
        s2mel = S2Mel(cfg.s2mel, cfg.semantic_codec.hidden_size)
    s2mel.load_state_dict(dit_engine.models["s2mel"].state_dict())
    engine = TTSEngine(cfg, {**dit_engine.models, "s2mel": s2mel},
                       dit_engine.tokenizer, extras, dev)
    launches, _, n_act, prompt, text, metrics, _ = serve_requests(
        torch, engine, "flash", counters, prompts_s=(5.0,))
    want = cfg.engine.diffusion_steps * cfg.s2mel.dit.depth
    print(f"[flash] K11 {launches['flash_attention']} (want {want}), K8 "
          f"{launches['dit_block_chain']}, K9 {launches['cfm_attention']}; s2mel_time "
          f"{metrics[0]['s2mel_time']:.4f} s")
    if (launches["flash_attention"] != want or launches["dit_block_chain"]
            or launches["cfm_attention"]):
        fail("[flash] K11 was not launched once per block and Euler step")
    if launches["aa_snake_activation"] != n_act:
        fail("[flash] K2 was not launched on every vocoder activation")
    print("[flash] profiled request at T 896 (K11):")
    profile_request(torch, engine, prompt, text)
    return launches


def k5_config():
    """The K5 slice: `bench_config()` with `GPTConfig.pallas_decode_attention`
    (the unfused decode step, K5 attention, K4 projections) and
    `use_fused_vocoder` (stages 2-5 through K10); no server profile has
    them, as in the JAX package."""
    from voice_tts_tpu_torch.engine.engine import bench_config

    cfg = bench_config()
    cfg.gpt.pallas_decode_attention = True
    cfg.engine.use_fused_vocoder = True
    return cfg


def run_k5_slice(torch, dev, counters, bench_metrics):
    """The K5 slice at the flagship widths: three POST /tts (5 s prompts),
    each launching K5 24 times and K4 96 times a decode step, K1 and K3
    never, K10 once per fused stage (4) and K2 on the other stages' and the
    post activations (37) a vocode; then one profiled request.  Returns
    (launches, the engine)."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine
    from voice_tts_tpu_torch.ops.fused_vocoder import fused_stage_plan

    t0 = time.perf_counter()
    engine = TTSEngine.random(k5_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[k5] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cfg = engine.cfg
    layers, vc = cfg.gpt.layers, cfg.vocoder
    print(f"[k5] K4 a decode step: 4 int8 projections (attn_c_attn, attn_c_proj, "
          f"mlp_c_fc, mlp_c_proj) x {layers} layers = {4 * layers}: each has B*S = 1 "
          f"<= 32 rows on a step; the prefill (84 rows) and the teacher-forced forward "
          f"take the dequantized matmul instead")
    plan = fused_stage_plan(vc)
    n_k10 = sum(plan)
    n_k2 = (plan.count(False) * len(vc.resblock_kernel_sizes) * 2
            * len(vc.resblock_dilation_sizes[0]) + 1)
    launches, _, _, prompt, text, metrics, per_request = serve_requests(
        torch, engine, "k5", counters)
    for i, (m, got) in enumerate(zip(metrics, per_request)):
        steps = m["decode_steps"]
        tag = f"[k5] request #{i}"
        _check_k5_launches(tag, got, engine, steps, k4_per_step=4)
        print(f"{tag}: K10 {got['fused_resblock_stage']} (want {n_k10}), K2 "
              f"{got['aa_snake_activation']} (want {n_k2})")
        if got["fused_resblock_stage"] != n_k10 or got["aa_snake_activation"] != n_k2:
            fail(f"{tag}: K10 not once per fused stage or K2 not on the other activations")
    keys = ("gpt_gen_time", "decode_steps", "s2mel_time", "gpt_forward_time",
            "bigvgan_time", "rtf")
    print("[k5] stage timers " + json.dumps({
        "k5": {k: [m[k] for m in metrics] for k in keys},
        "bench": {k: [m[k] for m in bench_metrics] for k in keys}}))
    profile_request(torch, engine, prompt, text)
    return launches, engine


# the K5 beam request's code cap: random weights never stop, and the
# profile's 1500 would decode 511 + 1499 eager beam steps (115 s of the
# run's time limit in one measured run, 55.7 ms a step); 512 decodes 511
K5_BEAM_MAX_CODES = 512


def run_k5_beam(torch, dev, counters, k5_engine):
    """One beam-3 request with K5: a second engine in the production profile
    with `pallas_decode_attention`, on the K5 slice engine's models (the
    int8 runtime GPT is built from its f32 master), its code cap cut to
    K5_BEAM_MAX_CODES.  Random weights decode to the cap (511 steps), each a
    K5 launch per layer and K4 four; K3 and K1 never."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, serving_config

    cfg = serving_config()
    cfg.gpt.pallas_decode_attention = True
    cfg.generation.max_mel_tokens = K5_BEAM_MAX_CODES
    extras = {"w2v_mean": k5_engine.w2v_mean.cpu().numpy(),
              "w2v_std": k5_engine.w2v_std.cpu().numpy(),
              "emo_matrix": k5_engine.emo_matrix, "spk_matrix": k5_engine.spk_matrix}
    engine = TTSEngine(cfg, dict(k5_engine.models), k5_engine.tokenizer, extras, dev)
    launches, steps, _, _, _, metrics, _ = serve_requests(torch, engine, "k5_beam",
                                                          counters, prompts_s=(5.0,))
    m = metrics[0]
    _check_k5_launches("[k5_beam] request #0", launches, engine, steps, k4_per_step=4)
    print(f"[k5_beam] {steps} beam steps, gpt_gen_time {m['gpt_gen_time']:.4f} s "
          f"({1e3 * m['gpt_gen_time'] / steps:.3f} ms a step), rtf {m['rtf']:.4f}")
    return launches


# the vocoder variants against the module path on the same weights and mel:
# the same function (packed, shared), or K10's (fused) beyond the edge halos;
# f32 sums in another order through six stages, relative to the largest
# output magnitude (random weights leave the waveform far below 1, so an
# absolute bound would say nothing)
VOC_AB_TOL = 1e-4


def vocoder_ab(torch, dev, vocoder):
    """The production slice's flagship BigVGAN vocodes one random mel at 448
    and 2656 frames four ways, each timed with CUDA events over 5 runs after
    one warm-up: the module path (K2 109 a vocode), packed (grouped convs),
    shared activations, and fused (stages 2-5 through K10).  Prints each
    time and the largest difference from the module path over the module
    path's largest magnitude; the fused one's in the interior (beyond 4
    stage halos at stage 2's rate, 8 samples of output a sample there) and
    at the edges."""
    from voice_tts_tpu_torch.models.vocoder import packed
    from voice_tts_tpu_torch.ops import fused_vocoder

    torch.backends.cudnn.allow_tf32 = False
    cfg = vocoder.cfg
    state = vocoder.state_dict()
    trees = {"packed": packed.pack_bigvgan(state, cfg),
             "shared_act": packed.pack_bigvgan_shared(state, cfg),
             "fused": fused_vocoder.pack_fused_stages(state, cfg)}
    ways = {"module": lambda mel: vocoder(mel),
            "packed": lambda mel: packed.bigvgan_packed_apply(trees["packed"], mel, cfg),
            "shared_act": lambda mel: packed.bigvgan_shared_act_apply(trees["shared_act"],
                                                                      mel, cfg),
            "fused": lambda mel: fused_vocoder.bigvgan_fused_apply(vocoder, trees["fused"],
                                                                   mel)}
    edge = 4 * VOC_HALO * 8
    g = torch.Generator(device=dev).manual_seed(15)
    report = []
    with torch.no_grad():
        for frames in (448, 2656):
            mel = torch.randn(1, cfg.num_mels, frames, generator=g, device=dev) - 4.0
            row, ref = {"frames": frames, "samples": frames * 256}, None
            for name, fn in ways.items():
                out = fn(mel)
                torch.cuda.synchronize()
                ms = cuda_time_ms(torch, lambda: fn(mel), 5, warmup=1)
                entry = {"ms": ms}
                if ref is None:
                    ref, scale = out, float(out.abs().max())
                    entry["max_abs"] = scale
                elif name == "fused":
                    d = (out - ref).abs()[0, 0] / scale
                    entry["rel_diff_interior"] = float(d[edge:-edge].max())
                    entry["rel_diff_edges"] = float(torch.cat([d[:edge], d[-edge:]]).max())
                    entry["interior_from"] = edge
                else:
                    entry["rel_diff"] = max_err(torch, out, ref) / scale
                row[name] = entry
            print("[vocoder A/B] " + json.dumps(row))
            if not scale > 0:
                fail(f"[vocoder A/B] the module path's waveform is zero at {frames} frames")
            for name in ("packed", "shared_act"):
                if not row[name]["rel_diff"] <= VOC_AB_TOL:
                    fail(f"[vocoder A/B] {name} differs from the module path at {frames} frames")
            if not row["fused"]["rel_diff_interior"] <= VOC_AB_TOL:
                fail(f"[vocoder A/B] fused differs from the module path inside at {frames} frames")
            report.append(row)
    return report


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNEL_CHECKS = {"k2": check_k2, "k4": check_k4, "k1": check_k1, "k3": check_k3,
                 "k3rows": check_k3_rows, "k7": check_k7, "k6": check_k6, "attention": check_attention,
                 "k8": check_k8, "k5": check_k5, "k10": check_k10}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+",
                    choices=list(KERNEL_CHECKS) + ["vocoder", "batched", "serving",
                                                   "workers"],
                    help="run only these kernel checks, in this order, and print "
                         "their JSON (no slice runs, no result line); `vocoder` runs "
                         "the vocoder A/B on a flagship BigVGAN with random weights, "
                         "`batched` the batched phase on a production engine of its own, "
                         "`serving` the serving phase on a production and a bench engine "
                         "of its own, `workers` the server's replicas over every card "
                         "(two or more)")
    args = ap.parse_args()

    torch, card = device_check()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    from voice_tts_tpu_torch.ops import build, counters

    t0 = time.perf_counter()
    lib = build.kernels(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.path.name})")

    results = []
    if args.only:
        for name in args.only:
            if name == "vocoder":
                vocoder_ab(torch, dev, flagship_vocoder(torch, dev, 13))
            elif name == "batched":
                from voice_tts_tpu_torch.engine.engine import TTSEngine, serving_config
                run_batched_slice(torch, dev, counters, TTSEngine.random(
                    serving_config(), device=dev, seed=0), card)
            elif name == "serving":
                from voice_tts_tpu_torch.engine.engine import (TTSEngine, bench_config,
                                                               serving_config)
                run_continuous_serving(torch, dev, counters, TTSEngine.random(
                    bench_config(), device=dev, seed=0), card)
                torch.cuda.empty_cache()
                run_grouped_serving(torch, dev, counters, TTSEngine.random(
                    serving_config(), device=dev, seed=0), card)
            elif name == "workers":
                run_workers(torch, counters, card)
            else:
                KERNEL_CHECKS[name](torch, dev, results)
        print(card)
        print(json.dumps({"kernels": results}))
        return
    for check in KERNEL_CHECKS.values():
        check(torch, dev, results)
    torch.cuda.empty_cache()
    by_path = {"micro": run_micro_path(torch, dev, counters, results)}
    torch.cuda.empty_cache()
    check_tiny_engine(torch, dev)
    check_tiny_engine_production(torch, dev)
    check_tiny_engine_spec(torch, dev)
    check_tiny_engine_dit(torch, dev, counters)
    check_tiny_engine_k5(torch, dev, counters)
    check_tiny_engine_k5_int8(torch, dev, counters)
    check_tiny_engine_vocoders(torch, dev, counters)
    by_path["serving"], engine = run_production_slice(torch, dev, counters)
    by_path["batched"] = run_batched_slice(torch, dev, counters, engine, card)
    by_path["grouped"] = run_grouped_serving(torch, dev, counters, engine, card)
    vocoder = engine.vocoder
    del engine
    torch.cuda.empty_cache()
    by_path["bench"], bench_metrics, bench = run_bench_slice(torch, dev, counters)
    by_path["continuous"] = run_continuous_serving(torch, dev, counters, bench, card)
    del bench
    torch.cuda.empty_cache()
    by_path["spec"] = run_spec_slice(torch, dev, counters, bench_metrics)
    torch.cuda.empty_cache()
    by_path["dit"], dit_engine = run_dit_slice(torch, dev, counters, bench_metrics)
    by_path["flash"] = run_flash_engine(torch, dev, counters, dit_engine)
    del dit_engine
    torch.cuda.empty_cache()
    by_path["k5"], k5_engine = run_k5_slice(torch, dev, counters, bench_metrics)
    by_path["k5_beam"] = run_k5_beam(torch, dev, counters, k5_engine)
    del k5_engine
    torch.cuda.empty_cache()
    vocoder_ab(torch, dev, vocoder)
    # each kernel's launches come from the path that runs it: K3 and K2 from
    # the production slice, K1 from the bench slice, K6 and K7 from the spec
    # slice, K8 and K9 from the DiT slice, K11 from its engine, K5, K4 and
    # K10 from the K5 slice
    owner = {"fused_decode_step": "bench", "fused_decode_verify": "spec",
             "fused_decode_int4": "spec", "dit_block_chain": "dit",
             "cfm_attention": "dit", "flash_attention": "flash",
             "decode_attention": "k5", "int8_gemv": "k5", "fused_resblock_stage": "k5",
             "micro_tile": "micro", "micro_int4": "micro"}
    for r in results:
        r["launches"] = by_path[owner.get(r["name"], "serving")][r["name"]]
        r["launches_by_path"] = {p: by_path[p][r["name"]] for p in by_path}
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
