"""K6, the speculative verify step, and the self-speculative decode of the
port against the JAX package: the plain verify against JAX's
`fused_decode_verify` (Pallas in interpret mode) and against K1 steps one
after another; greedy `spec_decode` against JAX's on a tiny int8 GPT with
an int4 draft; greedy spec decode with draft == target against the port's
greedy `decode`, with its cap and stop; the acceptance step's output
distribution; the tiny engine with `spec_decode_k = 4` against the JAX
engine; and (on a card only) the verify chain against its plain version."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu.engine.engine import TTSEngine as JaxEngine
from voice_tts_tpu.models.gpt import decode as jdecode
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu.ops import fused_decode as jfd
from voice_tts_tpu.utils.quantize import quantize_gpt_params
from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine.engine import TTSEngine, build_models, tiny_config
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.utils.convert import convert, flatten_params, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

L, D, H, T_MAX = 2, 256, 4, 256
K = 4
GREEDY = GenerationConfig(do_sample=False, num_beams=1, repetition_penalty=10.0)


def t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def jax_gen(gen: GenerationConfig) -> JaxGenerationConfig:
    """The JAX package's GenerationConfig with the same fields (one object
    per port config, so the jitted JAX functions compile once for it)."""
    return JaxGenerationConfig(**dataclasses.asdict(gen))


def _close(out, ref, tol=1e-3):
    """max |out - ref| <= tol * max|ref|: both sides round each activation
    to bf16 before the int8 products and keep the causal tail in f32; they
    differ in f32 summation order and the rare bf16 rounding it flips."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# K6 at L=2, D=256, H=4
# ---------------------------------------------------------------------------

def _trunk_tree(seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return {"params": {"gpt": {f"h_{i}": {
        "attn_c_attn": {"weight": n(D, 3 * D), "bias": n(3 * D)},
        "attn_c_proj": {"weight": n(D, D), "bias": n(D)},
        "mlp_c_fc": {"weight": n(D, 4 * D), "bias": n(4 * D)},
        "mlp_c_proj": {"weight": n(4 * D, D), "bias": n(D)},
        "ln_1": {"weight": 1 + n(D, std=0.1), "bias": n(D)},
        "ln_2": {"weight": 1 + n(D, std=0.1), "bias": n(D)},
    } for i in range(L)}}}


@pytest.fixture(scope="module")
def trunk():
    return make_trunk()


def make_trunk():
    """The JAX and the port's int8 packs of one L 2, D 256 trunk (also
    built by `tests/test_torch_host_loops.py`)."""
    tree = _trunk_tree()
    jpack = jfd.pack_gpt(quantize_gpt_params(jax.tree.map(jnp.asarray, tree)), L)
    return jpack, pfd.pack_gpt(quantize_gpt_state(flatten_params(tree)), L)


def _verify_inputs(seed, pos):
    rng = np.random.default_rng(seed)
    cache = (rng.standard_normal((L, 2, 1, T_MAX, D)) * 0.5).astype(np.float32)
    cache[:, :, :, pos:] = 0.0                   # nothing committed past pos
    bias = np.zeros((T_MAX, 1), np.float32)
    bias[20:26] = -1e30                          # invalid prompt pads
    x = (rng.standard_normal((K, D)) * 0.5).astype(np.float32)
    return cache, bias, x


@pytest.mark.parametrize("pos", [0, 77], ids=["empty_prefix", "pos77"])
def test_verify_plain_matches_jax(trunk, pos):
    """K6 plain against JAX's `fused_decode_verify` (interpret mode) at
    K = 4: hidden rows and the bf16 kv rows; an empty prefix attends the
    causal tail alone."""
    jpack, ppack = trunk
    cache, bias, x = _verify_inputs(1, pos)
    jy, jkv = jfd.fused_decode_verify(jnp.asarray(x), jpack,
                                      jnp.asarray(cache, jnp.bfloat16),
                                      jnp.asarray(bias), pos, H, interpret=True)
    py, pkv = pfd.fused_decode_verify(t(x), ppack, t(cache).to(torch.bfloat16),
                                      t(bias), pos, H)
    assert py.shape == (K, D) and pkv.shape == (L, 2, K, D)
    assert pkv.dtype == torch.bfloat16
    _close(py, jy)
    _close(pkv, jkv)


def test_verify_matches_chained_k1_steps(trunk):
    """One K = 4 verify reproduces 4 K1 steps one after another (each
    writing its kv row before the next).  Bounds as the JAX package's own
    test of the same identity (hidden 0.05 * max|ref|; kv rows 0.05 abs +
    0.05 rel): the steps read earlier rows back from the cache rounded to
    bf16, the verify keeps them in f32."""
    _, ppack = trunk
    pos = 60
    cache, bias, x = _verify_inputs(2, pos)
    pcache = t(cache).to(torch.bfloat16)
    vy, vkv = pfd.fused_decode_verify(t(x), ppack, pcache.clone(), t(bias), pos, H)
    seq = pcache.clone()
    hs = []
    for i in range(K):
        y, kv, _ = pfd.fused_decode_step(t(x[i:i + 1]), ppack, seq, t(bias), pos + i, H)
        pfd.apply_kv_update(seq, kv, pos + i)
        hs.append(y)
    hs = torch.cat(hs)
    assert float((vy - hs).abs().max()) <= 0.05 * float(hs.abs().max())
    committed = pfd.apply_kv_update_span(pcache.clone(), vkv, pos)
    np.testing.assert_allclose(committed[:, :, 0, pos:pos + K].float().numpy(),
                               seq[:, :, 0, pos:pos + K].float().numpy(),
                               rtol=0.05, atol=0.05)


def test_apply_kv_update_span_matches_jax():
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((L, 2, 1, 64, 8)).astype(np.float32)
    new = rng.standard_normal((L, 2, K, 8)).astype(np.float32)
    ref = jfd.apply_kv_update_span(jnp.asarray(cache), jnp.asarray(new), 9)
    out = pfd.apply_kv_update_span(t(cache.copy()), t(new), 9)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_verify_refuses_what_it_does_not_take(trunk):
    _, ppack = trunk
    cache, bias, x = _verify_inputs(4, 10)
    with pytest.raises(ValueError, match="2 <= K <= 8"):
        pfd.fused_decode_verify(t(x[:1]), ppack, t(cache), t(bias), 10, H)
    # an int4 pack is taken; int4_expand=True is refused at the engine's
    # config check, the one place the scheme is chosen
    p4 = pfd.pack_gpt_int4(flatten_params(_trunk_tree()), L)
    y4, kv4 = pfd.fused_decode_verify(t(x), p4, t(cache).to(torch.bfloat16), t(bias), 10, H)
    assert y4.shape == (K, D) and kv4.shape == (L, 2, K, D)
    with pytest.raises(ValueError, match="TPU-only"):
        pfd.check_int4_expand(True)
    with pytest.raises(TypeError, match="trunk pack"):
        pfd.fused_decode_verify(t(x), p4.w, t(cache), t(bias), 10, H)
    with pytest.raises(ValueError, match="unsupported device"):
        pfd.fused_decode_verify(torch.empty(K, D, device="meta"), ppack,
                                t(cache), t(bias), 10, H)


# ---------------------------------------------------------------------------
# the acceptance step
# ---------------------------------------------------------------------------

def test_acceptance_keeps_the_target_distribution():
    """Speculative sampling's guarantee on a 6-token vocab: with d ~ p and
    the step's accept / residual draw, the first emitted token is
    distributed as q, not p.  N = 40000 trials from fixed seeds; total
    variation bound 0.02, about 6 standard errors of the empirical TV at
    this N and vocab (TV(p, q) here is 0.45)."""
    q = np.asarray([0.40, 0.25, 0.15, 0.10, 0.07, 0.03])
    p = np.asarray([0.05, 0.10, 0.15, 0.20, 0.20, 0.30])
    lp_t = torch.log(torch.tensor(np.stack([q, q[::-1]]), dtype=torch.float32))
    lp_d = torch.log(torch.tensor(p[None], dtype=torch.float32))
    rng = np.random.default_rng(17)
    n = 40000
    drafts = rng.choice(6, size=n, p=p)
    us = rng.random(n)
    counts = np.zeros(6)
    for d, u in zip(drafts, us):
        n_acc, next_lp = pdecode.speculative_accept(
            lp_t, lp_d, torch.tensor([d]), torch.tensor([u], dtype=torch.float32))
        if int(n_acc) == 1:
            first = d
        else:
            w = torch.softmax(next_lp, -1).double().numpy()
            first = rng.choice(6, p=w / w.sum())
        counts[first] += 1
    tv = 0.5 * np.abs(counts / n - q).sum()
    assert tv < 0.02, tv
    assert 0.5 * np.abs(p - q).sum() > 0.4


@pytest.mark.parametrize("case", ["all_accepted", "second_rejected", "greedy"])
def test_acceptance_step_with_chosen_numbers(case):
    """Accepts while u < q(d) / p(d); the next token's distribution is the
    bonus row after K - 1 accepts, the normalised residual max(q - p, 0) at
    the first rejection, and the target row there under greedy."""
    q = torch.tensor([[0.5, 0.3, 0.2], [0.2, 0.2, 0.6], [0.1, 0.1, 0.8]])
    p = torch.tensor([[0.25, 0.5, 0.25], [0.1, 0.8, 0.1]])
    drafts = torch.tensor([0, 1])        # q/p: 2.0 (always), then 0.25
    lp_t, lp_d = torch.log(q), torch.log(p)
    if case == "all_accepted":
        n_acc, nxt = pdecode.speculative_accept(lp_t, lp_d, drafts,
                                                torch.tensor([0.9, 0.2]))
        assert int(n_acc) == 2 and torch.equal(nxt, lp_t[2])
    elif case == "second_rejected":
        n_acc, nxt = pdecode.speculative_accept(lp_t, lp_d, drafts,
                                                torch.tensor([0.9, 0.3]))
        assert int(n_acc) == 1
        resid = torch.softmax(nxt, -1)
        np.testing.assert_allclose(resid.numpy(), [0.1 / 0.6, 0.0, 0.5 / 0.6],
                                   atol=1e-6)
    else:
        n_acc, nxt = pdecode.speculative_accept(lp_t, lp_d, drafts, None)
        assert int(n_acc) == 1 and torch.equal(nxt, lp_t[1])   # argmax q[1] is 2


def test_warped_logprobs_scatter_minus_inf_and_match_jax_sampling_warp():
    """Warped log-probs: -inf outside the top-k / top-p support (a zero
    probability, as rejection sampling needs), and inside it the log-softmax
    of the same warped logits JAX's `sample_token` pipeline keeps."""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((1, 68)) * 3).astype(np.float32)
    presence = np.zeros((1, 68), bool)
    presence[0, [1, 7, 30]] = True
    gen = GenerationConfig(top_k=10, top_p=0.8, temperature=0.8,
                           repetition_penalty=10.0)
    out = pdecode.warped_logprobs(t(logits), t(presence), gen)[0].numpy()
    ref = jax.nn.log_softmax(jdecode.process_logits(
        jnp.asarray(logits), jnp.asarray(presence), jax_gen(gen)), axis=-1)[0]
    support = np.isfinite(out)
    assert 1 <= support.sum() <= 10
    np.testing.assert_array_equal(support, np.asarray(ref) > -1e30)
    np.testing.assert_allclose(out[support], np.asarray(ref)[support], atol=1e-5)


# ---------------------------------------------------------------------------
# whole decodes on a tiny GPT
# ---------------------------------------------------------------------------

CFG = tiny_config()
JAX_CFG = JaxTTSConfig.from_dict(CFG.to_dict())


@pytest.fixture(scope="module")
def gpts():
    return make_gpts()


def make_gpts():
    """One tiny GPT: the JAX int8 runtime tree, its int8 pack and the int4
    pack of its f32 master; the port's int8 runtime module and packs made
    from the same f32 weights; numpy inputs (also built by
    `tests/test_torch_host_loops.py`)."""
    c = CFG.gpt
    model = JUV(JAX_CFG.gpt)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(7))
    jrt = quantize_gpt_params(params)
    master = load_family(build_models(CFG)["gpt"], convert("gpt", params))
    state = quantize_gpt_state(master.state_dict())
    prt = UnifiedVoice(c, int8=True)
    TTSEngine._cast_like(prt, state)
    prt.load_state_dict(state)
    prt.eval()
    rng = np.random.default_rng(8)
    inputs = ((rng.standard_normal((1, c.condition_num_latent, c.model_dim)) * 0.3
               ).astype(np.float32),
              (rng.standard_normal((1, c.model_dim)) * 0.1).astype(np.float32),
              rng.integers(3, c.number_text_tokens, (1, 16)).astype(np.int32),
              np.asarray([12], np.int32))
    return dict(model=model, jrt=jrt, jpack=jfd.pack_gpt(jrt, c.layers),
                jpack4=jfd.pack_gpt_int4(params, c.layers), prt=prt,
                pack=pfd.pack_gpt(state, c.layers),
                pack4=pfd.pack_gpt_int4(master.state_dict(), c.layers),
                inputs=inputs)


def _port_args(g):
    cond, emo, text, tlen = g["inputs"]
    return t(cond), t(emo), t(text).long(), t(tlen).long()


def test_greedy_spec_decode_matches_jax(gpts):
    """Greedy spec decode with the int4 draft and the int8 target: the
    port's codes, lengths and limit flag equal JAX's (its K1 int4 steps and
    K6 verify in interpret mode)."""
    g = gpts
    max_new = 10
    ref = jdecode.spec_decode(g["jrt"], g["model"], jax_gen(GREEDY),
                              *map(jnp.asarray, g["inputs"]), jax.random.PRNGKey(0),
                              max_new=max_new, pack_target=g["jpack"],
                              pack_draft=g["jpack4"], k_spec=K)
    out = pdecode.spec_decode(g["prt"], GREEDY, *_port_args(g), max_new, None,
                              g["pack"], g["pack4"], K)
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.hit_limit.numpy(), np.asarray(ref.hit_limit))
    assert out.rounds >= 1 and out.steps == int(out.lengths[0]) - 1


def _greedy_pair(g, max_new, stop_logit_shift):
    """The port's greedy `decode` (fused step, readout through the model)
    and its greedy spec decode with draft == target (both the int8 pack),
    with `stop_logit_shift` added to the stop token's logit bias."""
    prt, stop = g["prt"], CFG.gpt.stop_mel_token
    bias = prt.mel_head.bias
    saved = bias.detach().clone()
    try:
        with torch.no_grad():
            bias[stop] += stop_logit_shift
        ref = pdecode.decode(prt, GREEDY, *_port_args(g), max_new,
                             fused_pack=g["pack"])
        out = pdecode.spec_decode(prt, GREEDY, *_port_args(g), max_new, None,
                                  g["pack"], g["pack"], K)
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    return ref, out


@pytest.mark.parametrize("max_new", [9, 10, 11, 12], ids=lambda n: f"cap{n}")
def test_greedy_spec_with_draft_equal_to_target_is_greedy_decode(gpts, max_new):
    """Draft == target: every draft is the target's argmax and accepted, so
    spec decode emits the greedy stream of `decode`.  The stop token is
    pushed down (-10) so that the caps end the decode, at each offset of a
    4-token round.  Codes, lengths and the limit flag equal."""
    ref, out = _greedy_pair(gpts, max_new, -10.0)
    assert bool(ref.hit_limit[0]) and int(ref.lengths[0]) == max_new
    assert torch.equal(out.codes, ref.codes)
    assert torch.equal(out.lengths, ref.lengths)
    assert torch.equal(out.hit_limit, ref.hit_limit)
    assert out.accepted == (K - 1) * out.rounds


@pytest.mark.parametrize("shift,length", [(1.0, 6), (2.0, 3)],
                         ids=["second_round", "first_round"])
def test_spec_decode_stops_at_the_stop_token(gpts, shift, length):
    """A stop token inside a round's emission ends the decode there, the
    drafts after it dropped: with the stop token's logit raised, greedy
    `decode` stops at code `length` (in the second round, or inside the
    first one's drafts), and spec decode with draft == target stops with
    it, reporting no limit."""
    ref, out = _greedy_pair(gpts, 20, shift)
    n = int(ref.lengths[0])
    assert not bool(ref.hit_limit[0]) and n == length
    assert int(ref.codes[0, n - 1]) == CFG.gpt.stop_mel_token
    assert torch.equal(out.codes, ref.codes) and torch.equal(out.lengths, ref.lengths)
    assert not bool(out.hit_limit[0]) and out.steps == n - 1


def test_sampling_spec_decode_emits_valid_codes(gpts):
    """Sampling with the int4 draft: a valid stream within the cap, the
    rounds' accepted drafts counted, and the same stream again from the
    same generator state."""
    g = gpts
    gen = GenerationConfig(top_k=30, top_p=0.8, temperature=0.8,
                           repetition_penalty=10.0)
    outs = [pdecode.spec_decode(g["prt"], gen, *_port_args(g), 12,
                                torch.Generator().manual_seed(3), g["pack"],
                                g["pack4"], K) for _ in range(2)]
    out = outs[0]
    n = int(out.lengths[0])
    assert 1 <= n <= 12 and 0 <= out.accepted <= (K - 1) * out.rounds
    codes = out.codes[0, :n]
    assert bool(((codes >= 0) & (codes < CFG.gpt.number_mel_codes)).all())
    assert torch.equal(outs[1].codes, out.codes)


# ---------------------------------------------------------------------------
# the slice: the tiny engine with spec_decode_k = 4
# ---------------------------------------------------------------------------

FLAGS = dict(use_int8_decode=True, use_fused_decode=True, fuse_pipeline=True,
             use_fp16=True, spec_decode_k=K)
TEXT = "hello world."


def prompt_wav() -> bytes:
    """1 s at 16 kHz: a tone plus white noise (as `test_torch_engine.py`)."""
    from voice_tts_tpu_torch.audio import encode_wav_int16

    sr = 16000
    x = np.arange(sr) / sr
    noise = np.random.default_rng(0).standard_normal(sr)
    y = 0.3 * np.sin(2 * np.pi * 220 * x) + 0.05 * noise
    return encode_wav_int16((y * 32767).astype(np.float32), sr)


def test_tiny_engine_spec_decode_matches_jax():
    """The whole segment with spec decode (int4 drafts, int8 verify),
    greedy, the JAX engine's CFM noise handed to the port: WAVs within 8
    LSB of int16, the bound of `test_torch_engine.py` (identical codes;
    the f32 s2mel / vocoder and the bf16 teacher-forced GPT round at other
    points in the two frameworks).  The port counts its rounds."""
    jeng = JaxEngine.tiny(**FLAGS)
    params = jax.tree.map(np.asarray, jeng.params)
    extras = {"w2v_mean": np.asarray(jeng.w2v_mean),
              "w2v_std": np.asarray(jeng.w2v_std),
              "emo_matrix": [np.asarray(m) for m in jeng.emo_matrix],
              "spk_matrix": [np.asarray(m) for m in jeng.spk_matrix]}
    peng = TTSEngine.from_jax_params(jeng.cfg, params, jeng.tokenizer, extras,
                                     device="cpu")
    assert isinstance(peng.spec_draft_pack, pfd.FusedDecodePackInt4)
    wav = prompt_wav()
    rng0 = jeng._rng
    ref = jeng.infer(wav, TEXT, do_sample=False)
    r1, _ = jax.random.split(rng0)
    _, sub_s = jax.random.split(r1)
    peng._draw_noise = lambda shape: torch.from_numpy(
        np.array(jax.random.normal(sub_s, tuple(shape))))
    out = peng.infer(wav, TEXT, do_sample=False)
    assert out.wav.shape == ref.wav.shape and out.wav.size > 0
    diff = np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max()
    assert diff <= 8, diff
    m = out.metrics
    assert m["spec_rounds"] >= 1
    assert 0 <= m["spec_accepted"] <= (K - 1) * m["spec_rounds"]


# ---------------------------------------------------------------------------
# on a card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_verify_kernel_matches_plain_on_card(trunk, cuda_device):
    """The K6 chain against its plain version on the same card inputs
    (tolerance as on the CPU)."""
    _, ppack = trunk
    dev = cuda_device
    pack = pfd.FusedDecodePack(*(x.to(dev) for x in ppack))
    cache, bias, x = _verify_inputs(6, 90)
    args = (t(x).to(dev), pack, t(cache).to(dev, torch.bfloat16), t(bias).to(dev), 90, H)
    out = pfd.fused_decode_verify(*args)
    ref = pfd.fused_decode_verify_plain(*args)
    for a, r in zip(out, ref):
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= 1e-3 * scale
