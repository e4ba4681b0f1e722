"""The port's model families against the JAX modules at the tiny config,
f32, same weights (converted with `utils.convert`) and the same numpy
inputs.  Tolerances are the JAX package's own parity ceilings (PARITY.md
§2.3), applied as max |port - jax| <= tol * max(1, max |jax|): both sides
compute in f32, and the differences are summation order and fusion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu.models.conditioning.campplus import CAMPPlus as JCAMPPlus
from voice_tts_tpu.models.conditioning.repcodec import RepCodec as JRepCodec
from voice_tts_tpu.models.conditioning.repcodec import \
    repcodec_vq2emb as jax_vq2emb
from voice_tts_tpu.models.conditioning.w2v_bert import Wav2Vec2Bert as JW2V
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu.models.s2mel.cfm import cfm_inference as jax_cfm
from voice_tts_tpu.models.s2mel.s2mel import S2Mel as JS2Mel
from voice_tts_tpu.models.vocoder.bigvgan import BigVGAN as JBigVGAN
from voice_tts_tpu_torch.engine.engine import build_models, tiny_config
from voice_tts_tpu_torch.models.conditioning.repcodec import repcodec_vq2emb
from voice_tts_tpu_torch.models.s2mel.cfm import cfm_inference
from voice_tts_tpu_torch.models.s2mel.dit import DiT
from voice_tts_tpu_torch.utils.convert import convert, load_family

pytest_plugins = ("port_fixtures",)

CFG = tiny_config()
JAX_CFG = JaxTTSConfig.from_dict(CFG.to_dict())   # the same widths


def close(out, ref, tol):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def ports():
    return build_models(CFG)


def port_with(ports, family, params):
    return load_family(ports[family], convert(family, params)).eval()


@pytest.fixture(scope="module")
def gpt(ports):
    c = CFG.gpt
    model = JUV(JAX_CFG.gpt)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(0))
    return model, params, port_with(ports, "gpt", params)


def test_gpt_conditioning(gpt):
    model, params, port = gpt
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((1, 20, CFG.gpt.condition_module.input_size)).astype(np.float32)
    lens = np.asarray([17])
    ref_c = model.apply(params, jnp.asarray(feats), jnp.asarray(lens),
                        method=JUV.get_conditioning)
    ref_e = model.apply(params, jnp.asarray(feats), jnp.asarray(lens),
                        method=JUV.get_emovec)
    with torch.no_grad():
        close(port.get_conditioning(t(feats), t(lens)), ref_c, 2e-4)
        close(port.get_emovec(t(feats), t(lens)), ref_e, 2e-4)


def test_gpt_conditioning_bf16_runtime(gpt):
    """The int8 runtime GPT's bf16 conformer-perceiver, as the bf16
    conditioning path runs it on bf16 w2v features: the f32 position table
    promotes the conformer's attention, and from there the rest, to f32 in
    both packages (same dtypes); values within bf16 rounding, 1e-2 of
    max(1, max|ref|)."""
    from voice_tts_tpu.utils.quantize import quantize_gpt_params
    from voice_tts_tpu_torch.engine.engine import TTSEngine
    from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
    from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

    model, params, port = gpt
    jrt = quantize_gpt_params(params)
    state = quantize_gpt_state(port.state_dict())
    prt = UnifiedVoice(CFG.gpt, int8=True)
    TTSEngine._cast_like(prt, state)
    prt.load_state_dict(state)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((1, 20, CFG.gpt.condition_module.input_size)).astype(np.float32)
    lens = np.asarray([17])
    jf = jnp.asarray(feats, jnp.bfloat16)
    ref_c = model.apply(jrt, jf, jnp.asarray(lens), method=JUV.get_conditioning)
    ref_e = model.apply(jrt, jf, jnp.asarray(lens), method=JUV.get_emovec)
    with torch.no_grad():
        pf = t(feats).to(torch.bfloat16)
        out_c = prt.get_conditioning(pf, t(lens))
        out_e = prt.get_emovec(pf, t(lens))
    for out, ref in ((out_c, ref_c), (out_e, ref_e)):
        assert str(out.dtype).split(".")[-1] == str(ref.dtype)
        close(out, ref, 1e-2)


def test_gpt_latent_and_prefill_logits(gpt):
    model, params, port = gpt
    c = CFG.gpt
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((1, c.condition_num_latent, c.model_dim)).astype(np.float32)
    emo = rng.standard_normal((1, c.model_dim)).astype(np.float32)
    text = rng.integers(3, c.number_text_tokens, (1, 16)).astype(np.int32)
    tlen = np.asarray([11], np.int32)
    codes = rng.integers(0, c.number_mel_codes - 2, (1, 12)).astype(np.int32)
    clen = np.asarray([9], np.int32)
    ref = model.apply(params, *map(jnp.asarray, (cond, emo, text, tlen, codes, clen)))
    with torch.no_grad():
        out = port(*(t(v).long() if v.dtype == np.int32 else t(v)
                     for v in (cond, emo, text, tlen, codes, clen)))
    close(out, ref, 5e-4)

    prompt, valid = model.apply(params, *map(jnp.asarray, (cond, emo, text, tlen)),
                                method=JUV.build_prompt)
    p = prompt.shape[1]
    hd = c.model_dim // c.heads
    cache0 = jnp.zeros((c.layers, 2, 1, c.heads, hd, p + 8), jnp.float32)
    ref_logits, ref_cache = model.apply(params, prompt, valid, cache0,
                                        method=JUV.prefill)
    with torch.no_grad():
        pp, pv = port.build_prompt(t(cond), t(emo), t(text).long(), t(tlen).long())
        close(pp, prompt, 5e-4)
        assert np.array_equal(pv.numpy(), np.asarray(valid))
        cache = torch.zeros(tuple(cache0.shape))
        logits = port.prefill(pp, pv, cache)
    close(logits, ref_logits, 5e-4)
    close(cache, ref_cache, 5e-4)


def test_s2mel_regulator_and_cfm_solve(ports):
    c = CFG.s2mel
    d = c.dit
    model = JS2Mel(JAX_CFG.s2mel)
    sem = CFG.semantic_codec.hidden_size
    params = jax.jit(model.init, static_argnums=4)(
        jax.random.PRNGKey(1), jnp.zeros((1, 6, sem)), jnp.asarray([6]),
        jnp.asarray([8]), 8, jnp.zeros((1, d.in_channels, 8)),
        jnp.zeros((1, d.in_channels, 8)), jnp.asarray([8]), jnp.zeros((1,)),
        jnp.zeros((1, d.style_dim)), jnp.zeros((1, 4, c.gpt_dim)))
    port = port_with(ports, "s2mel", params)
    rng = np.random.default_rng(2)
    s = rng.standard_normal((1, 10, sem)).astype(np.float32)
    ref_reg = model.apply(params, jnp.asarray(s), jnp.asarray([9]), jnp.asarray([15]),
                          24, method=JS2Mel.regulate)
    with torch.no_grad():
        close(port.regulate(t(s), torch.tensor([9]), torch.tensor([15]), 24),
              ref_reg, 1e-5)

    total, n_steps = 24, 4
    mu = rng.standard_normal((1, total, d.content_dim)).astype(np.float32)
    prompt = rng.standard_normal((1, d.in_channels, total)).astype(np.float32)
    prompt[:, :, 6:] = 0.0
    style = rng.standard_normal((1, d.style_dim)).astype(np.float32)
    noise = rng.standard_normal((1, d.in_channels, total)).astype(np.float32)
    x_len, p_len = np.asarray([20]), np.asarray([6])
    t_mids = jnp.linspace(0.0, 1.0, n_steps + 1)[:n_steps]
    tables = model.apply(params, t_mids, method=JS2Mel.step_tables)

    def dit_apply(p, x, px, lens, tt, sv, m, tab):
        return model.apply(p, x, px, lens, tt, sv, m, tables=tab,
                           method=JS2Mel.velocity)
    ref = jax_cfm(dit_apply, params, jnp.asarray(mu), jnp.asarray(x_len),
                  jnp.asarray(prompt), jnp.asarray(p_len), jnp.asarray(style),
                  None, n_steps, 0.7, noise=jnp.asarray(noise), tables=tables)
    est = port.estimator
    with torch.no_grad():
        ptab = est.step_tables(torch.linspace(0.0, 1.0, n_steps + 1)[:n_steps])
        out = cfm_inference(
            lambda x, px, lens, tt, sv, m, tab: est(x, px, lens, tt, sv, m, tables=tab),
            t(mu), t(x_len), t(prompt), t(p_len), t(style), n_steps, 0.7,
            noise=t(noise), tables=lambda i: DiT.table_step(ptab, i))
    close(out, ref, 2e-4)


def test_bigvgan(ports):
    model = JBigVGAN(JAX_CFG.vocoder)
    params = jax.jit(model.init)(jax.random.PRNGKey(2),
                                 jnp.zeros((1, CFG.vocoder.num_mels, 8)))
    port = port_with(ports, "vocoder", params)
    mel = np.random.default_rng(3).standard_normal(
        (1, CFG.vocoder.num_mels, 12)).astype(np.float32)
    ref = jax.jit(model.apply)(params, jnp.asarray(mel))
    with torch.no_grad():
        close(port(t(mel)), ref, 2e-5)


def test_w2v_bert(ports):
    c = CFG.w2v_bert
    model = JW2V(JAX_CFG.w2v_bert)
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 8, c.feature_projection_input_dim)))
    port = port_with(ports, "w2v", params)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((1, 30, c.feature_projection_input_dim)).astype(np.float32)
    mask = (np.arange(30) < 24).astype(np.int32)[None]
    ref = jax.jit(model.apply)(params, jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        close(port(t(feats), t(mask)), ref, 2e-5)


def test_repcodec_codes_exact(ports):
    c = CFG.semantic_codec
    model = JRepCodec(JAX_CFG.semantic_codec)
    params = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.zeros((1, 8, c.hidden_size)))
    port = port_with(ports, "repcodec", params)
    x = np.random.default_rng(5).standard_normal((1, 40, c.hidden_size)).astype(np.float32)
    ref_idx, ref_q = jax.jit(model.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        idx, zq = port(t(x))
        assert np.array_equal(idx.numpy(), np.asarray(ref_idx))
        close(zq, ref_q, 2e-5)
        codes = np.asarray(ref_idx).astype(np.int32)
        codes[0, -3:] = c.codebook_size + 1          # out-of-range pad, clipped
        close(repcodec_vq2emb(port, t(codes).long()),
              jax_vq2emb(params, jnp.asarray(codes)), 2e-5)


def test_campplus(ports):
    c = CFG.campplus
    model = JCAMPPlus(JAX_CFG.campplus)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 16, c.feat_dim)))
    port = port_with(ports, "campplus", params)
    fb = np.random.default_rng(6).standard_normal((1, 50, c.feat_dim)).astype(np.float32)
    ref = jax.jit(model.apply)(params, jnp.asarray(fb), jnp.asarray([41]))
    with torch.no_grad():
        close(port(t(fb), torch.tensor([41])), ref, 2e-4)
