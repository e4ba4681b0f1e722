"""The device-resident loops of the port (`voice_tts_tpu_torch/engine/device_loop.py`):
the K1 arm of `models/gpt/decode.py` and the K3 arm of `models/gpt/beam.py`
run as the JAX `while_loop`s, a chunk of N steps between host reads, with
the position and the stop test on the device.

On the CPU (no capture) against the JAX package at tiny widths, numpy-seeded
inputs, one tiny GPT for both: the chunked greedy `decode` (float and int8
KV) against JAX `decode` with its fused pack (Pallas in interpret mode) at
N 1 / 3 / 4 / 16 with `max_new` 9 (8 steps: the limit on a chunk boundary
at N 1 / 4, inside a chunk at N 3 / 16); the chunked greedy `beam_decode`
(int8 KV, ancestor table) against JAX's fused beam, the search `done`
after 25 steps (inside a chunk at N 3 / 4 / 16) and the limit at 12 steps
(a boundary at N 3 / 4); the sampled beam with injected uniforms against
the port's own reorder arm (the K3 step with a physical reorder) at one
step a chunk; the cache
writers, `embed_decode_token` and the K1 / K3 plain steps with a device
position bit-equal to the int form; and the host reads counted, one before
the first chunk and one after each.

The `cuda` cases (skipped without a card) hold the captured graphs against
the same chunked code run op by op on the card (`DeviceLoops(capture=False)`),
bit-equal, for the tiny engine's sampling decode, beam-3 and CFM solve.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine import device_loop
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.engine.engine import TTSEngine, build_models, tiny_config
from voice_tts_tpu_torch.models.gpt import beam as pbeam
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.utils.convert import convert, flatten_params, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

try:
    import jax
    import jax.numpy as jnp

    from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
    from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
    from voice_tts_tpu.models.gpt import beam as jbeam
    from voice_tts_tpu.models.gpt import decode as jdecode
    from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
    from voice_tts_tpu.ops.fused_decode import pack_gpt as jax_pack_gpt
    from voice_tts_tpu.ops.fused_decode import pack_readout as jax_pack_readout
    from voice_tts_tpu.utils.quantize import quantize_gpt_params
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

CFG = tiny_config()
CHUNKS = [1, 3, 4, 16]
SAMPLE = GenerationConfig(num_beams=3)                   # reference defaults
BEAM_GREEDY = dataclasses.replace(SAMPLE, do_sample=False)
GREEDY = dataclasses.replace(SAMPLE, do_sample=False, num_beams=1)
# a stop-token bias that ends the greedy beam-3 search (`done`) after 25 steps
STOP_BUMP = 0.85
# the decode-step cases' trunk: layers, width, heads, Tmax, vocabulary
L, D, H, T_MAX, V = 2, 256, 4, 256, 300


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def jax_gen(gen: GenerationConfig):
    return JaxGenerationConfig(**dataclasses.asdict(gen))


def _gpt_tree(seed=0):
    """A numpy UnifiedVoice sub-tree holding what the decode packs read."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)
    layers = {f"h_{i}": {
        "attn_c_attn": {"weight": n(D, 3 * D), "bias": n(3 * D)},
        "attn_c_proj": {"weight": n(D, D), "bias": n(D)},
        "mlp_c_fc": {"weight": n(D, 4 * D), "bias": n(4 * D)},
        "mlp_c_proj": {"weight": n(4 * D, D), "bias": n(D)},
        "ln_1": {"weight": 1 + n(D, std=0.1), "bias": n(D)},
        "ln_2": {"weight": 1 + n(D, std=0.1), "bias": n(D)}} for i in range(L)}
    return {"params": {"gpt": layers, "mel_head": {"weight": n(V, D), "bias": n(V)},
                       "final_norm": {"weight": 1 + n(D, std=0.1), "bias": n(D)}}}


def _port_gpt(params):
    """The port's int8 runtime UnifiedVoice and its K1 / K3 packs from JAX
    f32 parameters."""
    master = load_family(build_models(CFG)["gpt"], convert("gpt", params))
    state = quantize_gpt_state(master.state_dict())
    prt = UnifiedVoice(CFG.gpt, int8=True)
    TTSEngine._cast_like(prt, state)
    prt.load_state_dict(state)
    return prt.eval(), pfd.pack_gpt(state, CFG.gpt.layers), pfd.pack_readout(state)


@pytest.fixture(scope="module")
def gpts():
    return make_gpts()


def make_gpts():
    """One tiny GPT two ways: as initialised (its greedy one-beam decode
    runs to the limit) and with the stop token's bias raised by STOP_BUMP
    (its greedy beam-3 search ends); for each the JAX int8 runtime tree
    with its packs and the port's module with its packs; and the inputs
    (the JAX module first).  `tests/test_torch_host_loops.py` builds its
    own from here."""
    c = CFG.gpt
    model = JUV(JaxTTSConfig.from_dict(CFG.to_dict()).gpt)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(3))
    bumped = jax.tree.map(lambda x: x, params)
    head = bumped["params"]["mel_head"]
    head["bias"] = head["bias"].at[c.stop_mel_token].add(STOP_BUMP)
    out = {}
    for name, p in (("plain", params), ("stop", bumped)):
        jrt = quantize_gpt_params(p)
        out[name] = (jrt, jax_pack_gpt(jrt, c.layers), jax_pack_readout(jrt), *_port_gpt(p))
    rng = np.random.default_rng(51)
    inputs = ((rng.standard_normal((1, c.condition_num_latent, c.model_dim)) * 0.5
               ).astype(np.float32),
              (rng.standard_normal((1, c.model_dim)) * 0.5).astype(np.float32),
              rng.integers(3, c.number_text_tokens, (1, 16)).astype(np.int32),
              np.asarray([11], np.int32))
    return model, out, inputs


def _same(out, ref):
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.hit_limit.numpy(), np.asarray(ref.hit_limit))


@pytest.fixture(scope="module")
def jax_decodes(gpts):
    """JAX `decode` (greedy, fused pack, folded readout) at max_new 9 with a
    float and an int8 cache, keyed by `int8_kv`."""
    model, trees, inputs = gpts
    jrt, jpack, jro = trees["plain"][:3]
    return {kv: jdecode.decode(jrt, model, jax_gen(GREEDY), *map(jnp.asarray, inputs),
                               jax.random.PRNGKey(0), max_new=9, fused_pack=jpack,
                               int8_kv=kv, readout_pack=jro)
            for kv in (False, True)}


@pytest.fixture(scope="module")
def jax_beams(gpts):
    """JAX's fused greedy beam-3 (int8 KV, folded readout) at max_new 13
    and 30, keyed by max_new."""
    model, trees, inputs = gpts
    jrt, jpack, jro = trees["stop"][:3]
    return {n: jbeam.beam_decode(jrt, model, jax_gen(BEAM_GREEDY),
                                 *map(jnp.asarray, inputs), jax.random.PRNGKey(0),
                                 max_new=n, fused_pack=jpack, int8_kv=True,
                                 readout_pack=jro)
            for n in (13, 30)}


def _port_args(inputs):
    cond, emo, text, tlen = inputs
    return t(cond), t(emo), t(text).long(), t(tlen).long()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16_kv", "int8_kv"])
def test_chunked_decode_matches_jax(gpts, jax_decodes, int8_kv, chunk):
    """The K1 arm, a chunk of `chunk` steps between host reads, against the
    JAX `while_loop`: equal codes, lengths and `hit_limit`; 8 steps to the
    limit, the last chunk running `chunk` steps, those past the limit
    leaving the state as it was."""
    _, trees, inputs = gpts
    prt, pack, ro = trees["plain"][3:]
    ref = jax_decodes[int8_kv]
    out = pdecode.decode(prt, GREEDY, *_port_args(inputs), 9, fused_pack=pack,
                         readout_pack=ro, int8_kv=int8_kv, chunk=chunk)
    _same(out, ref)
    assert bool(out.hit_limit[0]) and out.steps == 8
    assert out.chunks == -(-8 // chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("max_new", [13, 30], ids=["limit", "done"])
def test_chunked_beam_matches_jax(gpts, jax_beams, max_new, chunk):
    """The K3 arm (int8 KV, ancestor table, folded readout), a chunk of
    `chunk` beam steps between host reads, against JAX's fused beam: equal
    codes, lengths and `hit_limit`.  At max_new 30 the search is `done`
    after 25 steps, inside a chunk at N 3 / 4 / 16: the steps after it
    leave the pool, the beams and the cache as they were.  At max_new 13
    the limit ends it after 12 steps."""
    _, trees, inputs = gpts
    prt, pack, ro = trees["stop"][3:]
    ref = jax_beams[max_new]
    out = pbeam.beam_decode(prt, BEAM_GREEDY, *_port_args(inputs), max_new,
                            fused_pack=pack, readout_pack=ro, int8_kv=True, chunk=chunk)
    _same(out, ref)
    steps = 25 if max_new == 30 else 12
    assert out.steps == steps and out.chunks == -(-steps // chunk)
    assert bool(out.hit_limit[0]) == (max_new == 13)


class JaxUniforms:
    """The uniforms JAX's beam draws from PRNGKey(0), one split a step."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, shape):
        self.key, sub = jax.random.split(self.key)
        return t(jax.random.uniform(sub, shape, minval=1e-20, maxval=1.0))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_sampled_beam_matches_host_loop(gpts, chunk):
    """Beam sampling with injected uniforms (JAX's draws): the chunked K3
    arm at each N gives the codes, lengths, limit flag and steps of the K3
    step with a physical cache reorder one step a chunk (the reorder arm's
    device loop at N 1, one host read a step, which replaced its host
    loop), the uniforms drawn in the same order.  (Held against the port's
    reorder arm: the port's candidates equal JAX's bit for bit on the same
    logits, but the trunk's sums in another order move the logits enough
    for this seed's sampled path to leave JAX's at the fourth code, in the
    port before the device loops too.)"""
    _, trees, inputs = gpts
    prt, pack, ro = trees["stop"][3:]
    kw = dict(fused_pack=pack, readout_pack=ro, int8_kv=True)
    ref = pbeam.beam_decode(prt, SAMPLE, *_port_args(inputs), 20,
                            uniform=JaxUniforms(), ancestor_table=False, chunk=1, **kw)
    out = pbeam.beam_decode(prt, SAMPLE, *_port_args(inputs), 20,
                            uniform=JaxUniforms(), chunk=chunk, **kw)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert out.steps == ref.steps == 19 and ref.chunks == 19
    assert out.chunks == -(-19 // chunk)


def test_host_reads_once_a_chunk(gpts, monkeypatch):
    """The K1 loop reads the device once before its first chunk and once
    after each chunk, and nowhere else (`read_flag` counted), and the K3
    loop likewise."""
    _, trees, inputs = gpts
    reads = []
    real = device_loop.read_flag

    def counted(flag):
        reads.append(flag.shape)
        return real(flag)
    monkeypatch.setattr(device_loop, "read_flag", counted)
    prt, pack, ro = trees["plain"][3:]
    out = pdecode.decode(prt, GREEDY, *_port_args(inputs), 9, fused_pack=pack,
                         readout_pack=ro, chunk=3)
    assert out.chunks == 3 and len(reads) == out.chunks + 1
    assert all(s == () for s in reads)
    reads.clear()
    prt, pack, ro = trees["stop"][3:]
    out = pbeam.beam_decode(prt, BEAM_GREEDY, *_port_args(inputs), 30, fused_pack=pack,
                            readout_pack=ro, int8_kv=True, chunk=4)
    assert out.chunks == 7 and len(reads) == out.chunks + 1


# ---------------------------------------------------------------------------
# the pieces with a device position
# ---------------------------------------------------------------------------



@pytest.mark.parametrize("writer", ["kv", "kv_q", "batch", "q_batch"])
def test_kv_writers_at_a_device_position(writer):
    """`apply_kv_update*` at a 0-d tensor position write what the int form
    writes, bit for bit, and with `active` false leave the cache and its
    scales as they were."""
    rng = np.random.default_rng(7)
    t_max, pos, b = T_MAX, 37, 3
    rows = (1,) if writer in ("kv", "kv_q") else (b,)
    cache_f = t(rng.standard_normal((L, 2, rows[0], t_max, D)).astype(np.float32))
    new = t(rng.standard_normal((L, 2, rows[0], D)).astype(np.float32))
    if writer == "kv":
        cache = cache_f.to(torch.bfloat16)

        def write(c, s, p, a=None):
            return pfd.apply_kv_update(c, new[:, :, 0], p, a), None
    elif writer == "batch":
        cache = cache_f.to(torch.bfloat16)

        def write(c, s, p, a=None):
            return pfd.apply_kv_update_batch(c, new, p, a), None
    elif writer == "kv_q":
        cache, scales = pfd.quantize_kv_cache(cache_f)

        def write(c, s, p, a=None):
            return pfd.apply_kv_update_q(c, s, new[:, :, 0], p, a)
    else:
        cache, scales = pfd.quantize_kv_cache_batch(cache_f)

        def write(c, s, p, a=None):
            return pfd.apply_kv_update_q_batch(c, s, new, p, a)
    scales = scales if writer in ("kv_q", "q_batch") else None

    def fresh():
        return cache.clone(), None if scales is None else scales.clone()
    ref = write(*fresh(), pos)
    dev_pos = torch.tensor(pos)
    for active in (None, torch.tensor(True)):
        out = write(*fresh(), dev_pos, active)
        for a, r in zip(out, ref):
            assert (a is None and r is None) or torch.equal(a, r)
    kept = write(*fresh(), dev_pos, torch.tensor(False))
    for a, r in zip(kept, fresh()):
        assert (a is None and r is None) or torch.equal(a, r)
    assert not torch.equal(ref[0], cache)


def test_embed_decode_token_at_a_device_step(gpts):
    _, trees, _ = gpts
    prt = trees["plain"][3]
    token = torch.tensor([5, 9, 60])
    for step in (0, 7, 23):
        assert torch.equal(prt.embed_decode_token(token, torch.tensor(step)),
                           prt.embed_decode_token(token, step))


def test_attend_splits_at_a_device_position():
    """A device position (shared or per row) plans every split of Tmax; a
    host int only those of its live prefix."""
    assert pfd.attend_splits(torch.tensor(300), 1792) == 7
    assert pfd.attend_splits(torch.tensor([300, 10, 0]), 1792) == 7
    assert pfd.attend_splits(300, 1792) == 2
    assert pfd.attend_splits(0, 512) == 1


@pytest.mark.parametrize("rows", [1, 3])
def test_plain_step_at_a_device_position(rows):
    """The K1 (one row) and K3 (three rows through an ancestor table, int8
    KV) plain steps at a 0-d tensor position give the int form's hidden
    rows, k/v rows and logits bit for bit; so does K3's split-prefix twin."""
    rng = np.random.default_rng(9)
    t_max, pos = T_MAX, 70
    state = quantize_gpt_state(flatten_params(_gpt_tree()))
    pack, ro = pfd.pack_gpt(state, L), pfd.pack_readout(state)
    x = t(rng.standard_normal((rows, D)).astype(np.float32))
    cache = t(rng.standard_normal((L, 2, rows, t_max, D)).astype(np.float32)).to(torch.bfloat16)
    if rows == 1:
        bias = torch.zeros((t_max, 1))
        calls = [lambda p: pfd.fused_decode_step(x, pack, cache, bias, p, H, ro)]
    else:
        q, scales = pfd.quantize_kv_cache_batch(cache)
        src = t(rng.integers(0, rows, (rows, t_max)).astype(np.int32))
        bias = torch.zeros((rows, t_max))
        calls = [lambda p, f=f: f(x, pack, q, bias, p, H, scales, src, ro)
                 for f in (pfd.fused_decode_step_batch,
                           pfd.fused_decode_step_batch_split_plain)]
    for call in calls:
        for a, b in zip(call(torch.tensor(pos)), call(pos)):
            assert torch.equal(a, b)


def test_loop_pieces():
    """`select` keeps a None field; `DeviceLoops` refuses the CPU; the
    device loops run op by op there (`loops_for`)."""
    st = pdecode._LoopState(torch.tensor(1), torch.tensor([4]), None, None, None, None)
    new = st._replace(step=torch.tensor(2), token=torch.tensor([7]))
    kept = device_loop.select(torch.tensor(False), new, st)
    assert int(kept.step) == 1 and kept.presence is None
    assert int(device_loop.select(torch.tensor(True), new, st).token[0]) == 7
    with pytest.raises(ValueError, match="CUDA"):
        DeviceLoops("cpu")
    assert device_loop.loops_for(torch.device("cpu"), None) is None


# ---------------------------------------------------------------------------
# on the card: the graphs against the same chunks run op by op
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _card_engine(dev, **flags):
    return TTSEngine.tiny(device=str(dev), use_fp16=True, use_int8_decode=True,
                          use_fused_decode=True, fold_readout=True, **flags)


def _card_decode(engine, beams: int, max_new: int, loops):
    """One decode of the tiny engine's runtime GPT from a fixed generator
    state: beam-3 through K3 (int8 KV, table) or sampling through K1."""
    c = engine.cfg.gpt
    dev = engine.device
    g = torch.Generator(device=dev).manual_seed(5)
    cond = torch.randn((1, c.condition_num_latent, c.model_dim), generator=g, device=dev) * 0.5
    emo = torch.randn((1, c.model_dim), generator=g, device=dev) * 0.5
    text = torch.randint(3, c.number_text_tokens, (1, 16), generator=g, device=dev)
    tlen = torch.tensor([11], device=dev)
    engine.generator.manual_seed(17)
    gen = dataclasses.replace(SAMPLE, num_beams=beams)
    if beams > 1:
        return pbeam.beam_decode(engine.gpt_rt, gen, cond, emo, text, tlen, max_new,
                                 engine.generator, fused_pack=engine.fused_pack,
                                 int8_kv=True, readout_pack=engine.readout_pack,
                                 loops=loops)
    return pdecode.decode(engine.gpt_rt, gen, cond, emo, text, tlen, max_new,
                          engine.generator, engine.fused_pack, engine.readout_pack,
                          loops=loops)


@pytest.mark.cuda
@pytest.mark.parametrize("beams", [1, 3], ids=["sampling_k1", "beam3_k3"])
def test_graph_replay_matches_uncaptured_on_card(cuda_device, beams):
    """The captured decode (a first request that captures, then two that
    replay) against the same chunks op by op on the card: codes, lengths,
    limit flag, steps and chunks bit-equal, and the generator left where
    the op-by-op run leaves it."""
    engine = _card_engine(cuda_device, use_fused_beam_decode=True, use_int8_kv=True)
    ref = _card_decode(engine, beams, 24, DeviceLoops(cuda_device, capture=False))
    ref_state = engine.generator.get_state()
    loops = DeviceLoops(cuda_device)
    for _ in range(3):
        out = _card_decode(engine, beams, 24, loops)
        for a, b in zip(out[:3], ref[:3]):
            assert torch.equal(a, b)
        assert (out.steps, out.chunks) == (ref.steps, ref.chunks)
        assert torch.equal(engine.generator.get_state(), ref_state)
    assert loops.stats["graphs"] == 1 and loops.stats["replays"] == 3 * ref.chunks - 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3])
def test_kernel_step_at_a_device_position_on_card(cuda_device, rows):
    """K1 (one row) and K3 (three rows through a table, int8 KV) at a 0-d
    device position: every split of Tmax launched, the splits past the
    prefix adding nothing, so the outputs equal the int position's (its
    live splits only) bit for bit."""
    dev = cuda_device
    rng = np.random.default_rng(9)
    t_max, pos = 4 * T_MAX, 300
    state = quantize_gpt_state(flatten_params(_gpt_tree()))
    pack = pfd.FusedDecodePack(*(a.to(dev) for a in pfd.pack_gpt(state, L)))
    ro = pfd.ReadoutPack(*(a.to(dev) for a in pfd.pack_readout(state)))
    x = t(rng.standard_normal((rows, D)).astype(np.float32)).to(dev)
    cache = t(rng.standard_normal((L, 2, rows, t_max, D)).astype(np.float32)).to(
        dev, torch.bfloat16)
    if rows == 1:
        bias = torch.zeros((t_max, 1), device=dev)

        def call(p):
            return pfd.fused_decode_step(x, pack, cache, bias, p, H, ro)
    else:
        q, scales = pfd.quantize_kv_cache_batch(cache)
        src = t(rng.integers(0, rows, (rows, t_max)).astype(np.int32)).to(dev)
        bias = torch.zeros((rows, t_max), device=dev)

        def call(p):
            return pfd.fused_decode_step_batch(x, pack, q, bias, p, H, scales, src, ro)
    assert pfd.attend_splits(torch.tensor(pos), t_max) > pfd.attend_splits(pos, t_max)
    for a, b in zip(call(torch.tensor(pos, device=dev)), call(pos)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cfm_graph_matches_uncaptured_on_card(cuda_device):
    """The tiny engine's whole request with the CFM solve as one graph
    against the same engine with its loops op by op: the WAV bit-equal."""
    engine = _card_engine(cuda_device)
    prompt = (0.3 * np.sin(np.arange(16000) * 0.05)).astype(np.float32)
    outs, graphs = [], DeviceLoops(cuda_device)
    for loops in (DeviceLoops(cuda_device, capture=False), graphs, graphs):
        engine.loops = loops
        engine.generator.manual_seed(3)
        outs.append(engine.infer((prompt, 16000), "hello there").wav)
    assert graphs.stats["graphs"] >= 2 and graphs.stats["replays"] > 0
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
