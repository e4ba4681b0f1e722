"""The decode loops that ran on the host now run as device loops
(`voice_tts_tpu_torch/engine/device_loop.py`): the unfused step of
`decode` (the einsum attention, K5 with its length on the device, the int8
`QuantKVCache`), the eager beam arm (its cache reordered by parents carried
in the state) and `spec_decode` (K6 at a device position, JAX's masked
window merge), a chunk of N steps or rounds between host reads.

On the CPU, against the JAX package at tiny widths, numpy-seeded inputs
(the models and packs built as `tests/test_torch_decode_attention.py`,
`tests/test_torch_spec.py` build theirs): K5's plain version at a 0-d
tensor length, and its split twin at the plan fixed for the cache, against
JAX's `decode_attention` in interpret mode at lengths 1, a split edge and
Tmax; K6's plain verify and its split twin at a tensor position against
JAX's interpret-mode `fused_decode_verify` at pos 0 and 77; the unfused
`decode` (einsum, K5, int8 KV), the eager beam (the search ending on the
limit, and `done` inside a chunk) and greedy `spec_decode` against JAX's
loops at N 1 / 3 / 16; sampled spec and sampled eager beam chunked against
one step a chunk on one generator; the host reads, one before the first
chunk and one after each; the unfused step's writes at a device position
bit-equal to the int form's, and taken back after the stop.

The `cuda` cases (skipped without a card) hold each new loop's CUDA graphs
against the same chunks run op by op on the card, bit for bit, and K5 at a
device length and K6 at a device position against their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine import device_loop
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.engine.engine import TTSEngine, tiny_config
from voice_tts_tpu_torch.models.gpt import beam as pbeam
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.ops import decode_attention as k5
from voice_tts_tpu_torch.ops import fused_decode as pfd

import test_torch_decode_attention as tda   # noqa: E402 - imports JAX only if it is there

try:
    import jax
    import jax.numpy as jnp

    import test_torch_spec as tsp
    from tests.test_gpt import TINY
    from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
    from voice_tts_tpu.models.gpt import beam as jbeam
    from voice_tts_tpu.models.gpt import decode as jdecode
    from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
    from voice_tts_tpu.ops import fused_decode as jfd
    from voice_tts_tpu.ops.decode_attention import \
        decode_attention as jax_decode_attention
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

pytest_plugins = ("port_fixtures",)

CHUNKS = [1, 3, 16]
GREEDY = GenerationConfig(do_sample=False, repetition_penalty=2.0, num_beams=1)
BEAM3 = dataclasses.replace(GREEDY, num_beams=3)
SAMPLE = GenerationConfig(top_k=30, top_p=0.8, temperature=0.8, repetition_penalty=2.0,
                          num_beams=1)
# the unfused arms: (pallas_decode_attention, int8_kv)
ARMS = {"einsum": (False, False), "k5": (True, False), "int8_kv": (False, True)}
# the greedy decodes at max_new 10 run 9 steps to the limit; greedy beam-3
# at max_new 30 is `done` after 29 steps (inside a chunk at N 3 / 16), at
# 13 it ends on the limit after 12
DECODE_NEW, BEAM_DONE_NEW, BEAM_LIMIT_NEW = 10, 30, 13


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_gen(gen: GenerationConfig):
    return JaxGenerationConfig(**dataclasses.asdict(gen))


def _same(out, ref):
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.hit_limit.numpy(), np.asarray(ref.hit_limit))


@pytest.fixture(scope="module")
def tiny():
    """`tests/test_torch_decode_attention.py`'s tiny GPT: the JAX f32
    parameters, the port's f32 modules with K5 on and off, the int8
    runtime copies, and the inputs."""
    return tda.make_tiny_gpt()


@pytest.fixture(scope="module")
def spec_gpts():
    """`tests/test_torch_spec.py`'s tiny int8 GPT with its int8 and int4
    packs, both sides."""
    return tsp.make_gpts()


def _port_args(inputs):
    cond, emo, text, tlen = inputs
    return t(cond), t(emo), t(text).long(), t(tlen).long()


# ---------------------------------------------------------------------------
# the kernels' plain versions at a device position
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 33, 1024], ids=["one", "split_edge", "t_max"])
def test_k5_plain_at_a_device_length_matches_jax(length):
    """K5's plain version at a 0-d tensor length (the positions past it
    masked, no slice) and its split twin at the fixed plan of the cache (32
    positions a split at B 2, H 4, Tmax 1024; 33 is one past a split edge)
    against JAX's kernel in interpret mode at the same traced length, within
    the tolerances of `tests/test_torch_decode_attention.py`."""
    q, k, v, bias = tda.attention_inputs(0)
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.asarray(length, jnp.int32), interpret=True))
    dev_len = torch.tensor(length)
    assert k5._split_plan(2, 4, 1024, dev_len) == (32, 32)
    for out in (k5.decode_attention(t(q), t(k), t(v), t(bias), dev_len),
                k5.decode_attention_split_plain(t(q), t(k), t(v), t(bias), dev_len)):
        np.testing.assert_allclose(out.numpy(), ref, atol=tda.F32_ATOL, rtol=tda.F32_RTOL)


@pytest.mark.parametrize("pos", [0, 77], ids=["empty_prefix", "pos77"])
def test_k6_plain_at_a_device_position_matches_jax(pos):
    """K6's plain verify and its split twin (at `verify_plan`'s plan fixed
    for the cache: 8 splits of 32 at Tmax 256, K 4) at a 0-d tensor
    position against JAX's `fused_decode_verify` in interpret mode, within
    `tests/test_torch_spec.py`'s tolerance; the commit at the tensor
    position writes the int form's rows."""
    jpack, ppack = tsp.make_trunk()
    cache, bias, x = tsp._verify_inputs(1, pos)
    jy, jkv = jfd.fused_decode_verify(jnp.asarray(x), jpack,
                                      jnp.asarray(cache, jnp.bfloat16),
                                      jnp.asarray(bias), pos, tsp.H, interpret=True)
    dev_pos = torch.tensor(pos)
    assert pfd.verify_plan(dev_pos, tsp.H, tsp.T_MAX, tsp.K) == (32, 8)
    pcache = t(cache).to(torch.bfloat16)
    for fn in (pfd.fused_decode_verify, pfd.fused_decode_verify_split_plain):
        py, pkv = fn(t(x), ppack, pcache, t(bias), dev_pos, tsp.H)
        tsp._close(py, jy)
        tsp._close(pkv, jkv)
    ref = pfd.apply_kv_update_span(pcache.clone(), pkv, pos)
    assert torch.equal(pfd.apply_kv_update_span(pcache.clone(), pkv, dev_pos), ref)
    kept = pfd.apply_kv_update_span(pcache.clone(), pkv, dev_pos, torch.tensor(False))
    assert torch.equal(kept, pcache)


def test_k5_workspace_is_kept_per_shape():
    """K5's scratch and arrival counters: one pair per (device, B, H, hd,
    splits), the same tensors on every later call (a graph that captured a
    launch keeps reading them), the counters zero."""
    dev = torch.device("cpu")
    a = k5.split_workspace(dev, 3, 4, 64, 7)
    assert k5.split_workspace(dev, 3, 4, 64, 7)[0] is a[0]
    assert k5.split_workspace(dev, 3, 4, 64, 8)[0] is not a[0]
    assert a[0].numel() == 3 * 4 * 7 * 66 and not a[1].any()


# ---------------------------------------------------------------------------
# the unfused step at a device position
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", list(ARMS))
def test_unfused_step_at_a_device_position(tiny, arm):
    """`UnifiedVoice.decode_step` at a 0-d tensor step and cache position
    writes what the int form writes and gives its logits (bit for bit with
    the einsum and the int8 cache; with K5 within 1e-5, as its masked
    prefix sums the same terms in another grouping and the layers after
    the first see that); `held_step` with `active` false leaves the cache
    as it was."""
    _, ports, _, _, inputs = tiny
    flag, int8_kv = ARMS[arm]
    model = ports[flag]
    t_max, pos, b = 512, 45, 1
    rng = np.random.default_rng(4)
    if int8_kv:
        cache = model.gpt.init_quant_cache(b, t_max, "cpu")
        cache.kv[..., :pos] = t(rng.integers(-127, 128, cache.kv[..., :pos].shape)
                                .astype(np.int8))
        cache.scales[..., :pos] = t(rng.uniform(1e-3, 1e-2, cache.scales[..., :pos].shape)
                                    .astype(np.float32))
    else:
        cache = model.gpt.init_cache(b, t_max, torch.float32, "cpu")
        cache[..., :pos] = t(rng.standard_normal(cache[..., :pos].shape).astype(np.float32))
    valid = torch.ones((b, t_max), dtype=torch.bool)
    token = torch.tensor([7])

    def fresh():
        return (type(cache)(cache.kv.clone(), cache.scales.clone()) if int8_kv
                else cache.clone())
    c_int, c_dev = fresh(), fresh()
    ref = model.decode_step(token, 3, pos, valid, c_int)
    out = model.decode_step(token, torch.tensor(3), torch.tensor(pos), valid, c_dev)
    pairs = list(zip(pdecode.kv_tensors(c_dev), pdecode.kv_tensors(c_int))) + [(out, ref)]
    for a, r in pairs:
        if flag:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, r)
    kept = fresh()
    pdecode.held_step(kept, torch.tensor(pos), torch.tensor(False), lambda: model.decode_step(
        token, torch.tensor(3), torch.tensor(pos), valid, kept))
    for a, r in zip(pdecode.kv_tensors(kept), pdecode.kv_tensors(cache)):
        assert torch.equal(a, r)


# ---------------------------------------------------------------------------
# whole loops against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_unfused(tiny):
    """JAX's greedy unfused `decode` of each arm at max_new 10."""
    params, _, _, _, inputs = tiny
    out = {}
    for arm, (flag, int8_kv) in ARMS.items():
        model = JUV(dataclasses.replace(TINY, pallas_decode_attention=flag))
        out[arm] = jdecode.decode(params, model, jax_gen(GREEDY),
                                  *map(jnp.asarray, inputs), jax.random.PRNGKey(1),
                                  max_new=DECODE_NEW, int8_kv=int8_kv)
    return out


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("arm", list(ARMS))
def test_unfused_decode_matches_jax(tiny, jax_unfused, arm, chunk):
    """The unfused arm (f32: the einsum step, K5's plain version over a
    cache padded to 512, or an int8 `QuantKVCache`) as a device loop of N
    steps a chunk against JAX's `while_loop`: equal codes, lengths and
    limit flag; 9 steps to the limit, inside the last chunk at N 3 / 16."""
    _, ports, _, _, inputs = tiny
    flag, int8_kv = ARMS[arm]
    out = pdecode.decode(ports[flag], GREEDY, *_port_args(inputs), DECODE_NEW,
                         int8_kv=int8_kv, chunk=chunk)
    _same(out, jax_unfused[arm])
    assert out.steps == DECODE_NEW - 1 and out.chunks == -(-out.steps // chunk)


@pytest.fixture(scope="module")
def jax_beams(tiny):
    """JAX's greedy beam-3 on the XLA path (no pack), keyed by max_new."""
    params, _, _, _, inputs = tiny
    return {n: jbeam.beam_decode(params, JUV(TINY), jax_gen(BEAM3),
                                 *map(jnp.asarray, inputs), jax.random.PRNGKey(0),
                                 max_new=n)
            for n in (BEAM_LIMIT_NEW, BEAM_DONE_NEW)}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("max_new", [BEAM_LIMIT_NEW, BEAM_DONE_NEW], ids=["limit", "done"])
def test_eager_beam_matches_jax(tiny, jax_beams, max_new, chunk):
    """The eager beam arm (f32, no pack: the cache reordered by the parents
    in the state through a scratch, every step) as a device loop of N steps
    a chunk against JAX's beam search: equal codes, lengths and limit flag.
    At max_new 30 the search is `done` after 29 steps, inside a chunk at N
    3 / 16: the steps after it leave the state and the cache as they were;
    at 13 the limit ends it after 12."""
    _, ports, _, _, inputs = tiny
    out = pbeam.beam_decode(ports[False], BEAM3, *_port_args(inputs), max_new, chunk=chunk)
    _same(out, jax_beams[max_new])
    steps = 29 if max_new == BEAM_DONE_NEW else 12
    assert out.steps == steps and out.chunks == -(-steps // chunk)
    assert bool(out.hit_limit[0]) == (max_new == BEAM_LIMIT_NEW)


@pytest.fixture(scope="module")
def jax_spec(spec_gpts):
    g = spec_gpts
    return jdecode.spec_decode(g["jrt"], g["model"], jax_gen(tsp.GREEDY),
                               *map(jnp.asarray, g["inputs"]), jax.random.PRNGKey(0),
                               max_new=10, pack_target=g["jpack"],
                               pack_draft=g["jpack4"], k_spec=tsp.K)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_greedy_spec_decode_matches_jax(spec_gpts, jax_spec, chunk):
    """Greedy spec decode (int4 drafts through K1's plain version at a
    device position, the verify through K6's at a device position, the
    emission merged on the device) as a device loop of N rounds a chunk
    against JAX's `spec_decode`: equal codes, lengths and limit flag."""
    g = spec_gpts
    out = pdecode.spec_decode(g["prt"], tsp.GREEDY, *tsp._port_args(g), 10, None,
                              g["pack"], g["pack4"], tsp.K, chunk=chunk)
    _same(out, jax_spec)
    assert out.rounds >= 2 and out.chunks == -(-out.rounds // chunk)
    assert out.steps == int(out.lengths[0]) - 1


@pytest.mark.parametrize("chunk", [3, 16])
def test_sampled_spec_chunks_match_one_round_a_chunk(spec_gpts, chunk):
    """Sampled spec decode (the stop token pushed down, so the rounds run
    to the cap): N rounds a chunk give the codes, lengths, rounds and
    accepted drafts of one round a chunk on the same generator seed: every
    round draws a fixed number of times, and the rounds after the stop
    draw on without changing the result."""
    g = spec_gpts
    bias = g["prt"].mel_head.bias
    saved = bias.detach().clone()
    try:
        with torch.no_grad():
            bias[tsp.CFG.gpt.stop_mel_token] -= 10.0
        runs = [pdecode.spec_decode(g["prt"], SAMPLE, *tsp._port_args(g), 20,
                                    torch.Generator().manual_seed(3), g["pack"],
                                    g["pack4"], tsp.K, chunk=n) for n in (1, chunk)]
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    ref, out = runs
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert (out.steps, out.rounds, out.accepted) == (ref.steps, ref.rounds, ref.accepted)
    assert out.steps == 19 and ref.chunks == ref.rounds >= 5
    codes = out.codes[0]
    assert bool(((codes >= 0) & (codes < tsp.CFG.gpt.number_mel_codes)).all())


@pytest.mark.parametrize("chunk", [3, 16])
def test_sampled_eager_beam_chunks_match_one_step_a_chunk(tiny, chunk):
    """Beam sampling on the eager arm: N steps a chunk give the codes,
    lengths, limit flag and steps of one step a chunk on the same generator
    seed."""
    _, ports, _, _, inputs = tiny
    gen = dataclasses.replace(SAMPLE, num_beams=3)
    ref, out = (pbeam.beam_decode(ports[False], gen, *_port_args(inputs), 20,
                                  torch.Generator().manual_seed(11), chunk=n)
                for n in (1, chunk))
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert out.steps == ref.steps == ref.chunks > 0


def test_host_reads_once_a_chunk(tiny, spec_gpts, monkeypatch):
    """The unfused decode, the eager beam and spec decode read the device
    once before their first chunk and once after each, nowhere else; a
    spec chunk defaults to CHUNK // K rounds."""
    _, ports, _, _, inputs = tiny
    reads = []
    real = device_loop.read_flag

    def counted(flag):
        reads.append(flag.shape)
        return real(flag)
    monkeypatch.setattr(device_loop, "read_flag", counted)
    out = pdecode.decode(ports[True], GREEDY, *_port_args(inputs), DECODE_NEW, chunk=4)
    assert out.chunks == 3 and len(reads) == out.chunks + 1
    reads.clear()
    out = pbeam.beam_decode(ports[False], BEAM3, *_port_args(inputs), BEAM_DONE_NEW, chunk=4)
    assert out.chunks == 8 and len(reads) == out.chunks + 1
    reads.clear()
    g = spec_gpts
    out = pdecode.spec_decode(g["prt"], tsp.GREEDY, *tsp._port_args(g), 10, None,
                              g["pack"], g["pack4"], tsp.K)
    assert out.chunks == -(-out.rounds // (device_loop.CHUNK // tsp.K))
    assert len(reads) == out.chunks + 1 and all(s == () for s in reads)


# ---------------------------------------------------------------------------
# on the card: the graphs against the same chunks run op by op
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _card_inputs(engine):
    c = engine.cfg.gpt
    dev = engine.device
    g = torch.Generator(device=dev).manual_seed(5)
    cond = torch.randn((1, c.condition_num_latent, c.model_dim), generator=g, device=dev) * 0.5
    emo = torch.randn((1, c.model_dim), generator=g, device=dev) * 0.5
    text = torch.randint(3, c.number_text_tokens, (1, 16), generator=g, device=dev)
    return cond, emo, text, torch.tensor([11], device=dev)


def _card_run(engine, loop: str, loops):
    """One sampled decode of the tiny engine's runtime GPT from a fixed
    generator state on `loop`: the unfused step with K5, the eager beam-3
    with K5, or spec decode (int4 drafts, K6)."""
    args = _card_inputs(engine)
    engine.generator.manual_seed(17)
    gen = SAMPLE if loop != "eager_beam" else dataclasses.replace(SAMPLE, num_beams=3)
    if loop == "spec":
        return pdecode.spec_decode(engine.gpt_rt, gen, *args, 24, engine.generator,
                                   engine.fused_pack, engine.spec_draft_pack, 4,
                                   loops=loops)
    if loop == "eager_beam":
        return pbeam.beam_decode(engine.gpt_rt, gen, *args, 24, engine.generator,
                                 loops=loops)
    return pdecode.decode(engine.gpt_rt, gen, *args, 24, engine.generator, loops=loops)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["unfused_k5", "eager_beam", "spec"])
def test_graph_replay_matches_uncaptured_on_card(cuda_device, loop):
    """Each new loop captured (a first call that captures, then two that
    replay) against the same chunks op by op on the card: codes, lengths,
    limit flag, steps and chunks bit-equal, and the generator left where
    the op-by-op run leaves it."""
    spec = loop == "spec"
    cfg = tiny_config(use_fp16=True, use_int8_decode=True, use_fused_decode=spec,
                      **(dict(spec_decode_k=4) if spec else {}))
    cfg.gpt.pallas_decode_attention = not spec
    engine = TTSEngine.random(cfg, device=str(cuda_device), seed=0)
    ref = _card_run(engine, loop, DeviceLoops(cuda_device, capture=False))
    ref_state = engine.generator.get_state()
    loops = DeviceLoops(cuda_device)
    for _ in range(3):
        out = _card_run(engine, loop, loops)
        for a, b in zip(out[:3], ref[:3]):
            assert torch.equal(a, b)
        assert (out.steps, out.chunks) == (ref.steps, ref.chunks)
        assert torch.equal(engine.generator.get_state(), ref_state)
    assert loops.stats["graphs"] == 1 and loops.stats["replays"] == 3 * ref.chunks - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("length", [1, 33, 1024])
def test_k5_at_a_device_length_on_card(cuda_device, dtype, length):
    """K5 with its length in device memory (the fixed plan of the cache)
    against its plain version, and bit-equal to the host-int form at the
    same split width: the splits past the length only arrive."""
    q, k, v, bias = (t(a).to(cuda_device) for a in tda.attention_inputs(2))
    q, k, v = (a.to(dtype) for a in (q, k, v))
    dev_len = torch.tensor(length, device=cuda_device)
    out = k5.decode_attention(q, k, v, bias, dev_len)
    width, _ = k5._split_plan(2, 4, 1024, dev_len)
    same_width = k5.decode_attention_cuda(q, k, v, bias, length, split_t=width)
    ref = k5.decode_attention_plain(q, k, v, bias, dev_len)
    torch.cuda.synchronize()
    assert torch.equal(out, same_width)
    tol = 1e-5 if dtype == torch.float32 else tda.BF16_TOL
    assert float((out.float() - ref.float()).abs().max()) <= tol * float(ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("pos", [0, 77, 252])
def test_k6_at_a_device_position_on_card(cuda_device, int4, pos):
    """K6 (int8, and its int4 branch) with its position in device memory
    (the plan fixed for the cache) against its plain verify at the same
    position, within the bound of `tests/test_torch_spec.py`'s card case;
    pos 252 is Tmax - K."""
    from voice_tts_tpu_torch.utils.convert import flatten_params
    from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

    dev = cuda_device
    tree = flatten_params(_trunk_tree())
    pack = pfd.pack_gpt_int4(tree, 2) if int4 else pfd.pack_gpt(quantize_gpt_state(tree), 2)
    pack = type(pack)(*(a.to(dev) for a in pack))
    rng = np.random.default_rng(1)
    cache = t((rng.standard_normal((2, 2, 1, 256, 256)) * 0.5).astype(np.float32))
    cache[:, :, :, pos:] = 0.0
    bias = torch.zeros((256, 1))
    bias[20:26] = -1e30
    x = t((rng.standard_normal((4, 256)) * 0.5).astype(np.float32))
    args = (x.to(dev), pack, cache.to(dev, torch.bfloat16), bias.to(dev))
    out = pfd.fused_decode_verify(*args, torch.tensor(pos, device=dev), 4)
    ref = pfd.fused_decode_verify_split_plain(*args, torch.tensor(pos, device=dev), 4)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= 1e-3 * scale


def _trunk_tree(seed=0):
    """An L 2, D 256 trunk as `tests/test_torch_spec.py` draws it (that
    module imports JAX, which the machine with the card has not)."""
    rng = np.random.default_rng(seed)
    d = 256

    def n(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return {"params": {"gpt": {f"h_{i}": {
        "attn_c_attn": {"weight": n(d, 3 * d), "bias": n(3 * d)},
        "attn_c_proj": {"weight": n(d, d), "bias": n(d)},
        "mlp_c_fc": {"weight": n(d, 4 * d), "bias": n(4 * d)},
        "mlp_c_proj": {"weight": n(4 * d, d), "bias": n(d)},
        "ln_1": {"weight": 1 + n(d, std=0.1), "bias": n(d)},
        "ln_2": {"weight": 1 + n(d, std=0.1), "bias": n(d)},
    } for i in range(2)}}}
