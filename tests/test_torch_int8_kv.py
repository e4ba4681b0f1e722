"""int8 KV on the unfused one-beam decode of the port
(`voice_tts_tpu_torch/models/gpt/gpt2.py` `QuantKVCache`,
`models/gpt/decode.py`) against the JAX package's `QuantKVCache` decode on
the CPU: a tiny f32 GPT (tests/test_gpt.py's TINY widths) decodes greedily
through the JAX `decode(..., int8_kv=True)` without a pack and through the
port's `decode` on the converted weights; the step logits are compared
teacher-forced, and `int8_kv=False` is shown to keep a float cache.  Inputs
come from numpy with a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_gpt import TINY
from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
from voice_tts_tpu.models.gpt import decode as jdecode
from voice_tts_tpu.models.gpt.gpt2 import QuantKVCache as JaxQuantKVCache
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.config import TTSConfig as PortTTSConfig
from voice_tts_tpu_torch.engine.device_loop import CHUNK
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.gpt2 import QuantKVCache, _quantize_kv
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.utils.convert import convert, load_family

GREEDY = GenerationConfig(do_sample=False, repetition_penalty=2.0, num_beams=1)
MAX_NEW = 12
# relative to max|logits|: the same f32 arithmetic in both frameworks, sums
# in another order (measured at most 5.3e-7 here); the int8 cache itself
# moves the logits by about 1e-3 of that against a float cache, and the
# test checks that this shows (over 10 * LOGIT_TOL)
LOGIT_TOL = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def tiny():
    """JAX f32 parameters of a TINY UnifiedVoice, the port's module on the
    converted weights, and numpy decode inputs (a text of 28 tokens)."""
    c = TINY
    model = JUV(c)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    pc = PortTTSConfig.from_dict({"gpt": dataclasses.asdict(c)}).gpt
    port = load_family(UnifiedVoice(pc), convert("gpt", params)).eval()
    rng = np.random.default_rng(11)
    inputs = ((rng.standard_normal((1, c.condition_num_latent, c.model_dim)) * 0.1
               ).astype(np.float32),
              (rng.standard_normal((1, c.model_dim)) * 0.1).astype(np.float32),
              rng.integers(2, 30, size=(1, 28)).astype(np.int32),
              np.asarray([25], np.int32))
    return model, params, port, inputs


def port_decode(port, inputs, **kw):
    cond, emo, text, tlen = inputs
    return pdecode.decode(port, GREEDY, t(cond), t(emo), t(text).long(),
                          t(tlen).long(), MAX_NEW, **kw)


def jax_teacher_forced(model, params, inputs, codes, n_steps):
    """The JAX prefill and `n_steps` decode steps over a `QuantKVCache`
    (jitted, as `decode` is), fed `codes`: the logits of each step."""
    p_len = TINY.condition_num_latent + 2 + inputs[2].shape[1] + 2
    t_max = p_len + 1 + MAX_NEW
    hd = TINY.model_dim // TINY.heads

    @jax.jit
    def prefill(params, cond, emo, text, tlen):
        prompt, valid_p = model.apply(params, cond, emo, text, tlen,
                                      method=JUV.build_prompt)
        shape = (TINY.layers, 2, 1, TINY.heads, hd, t_max)
        cache0 = JaxQuantKVCache(jnp.zeros(shape, jnp.int8),
                                 jnp.full(shape[:4] + (t_max,), 1e-12, jnp.float32))
        logits, cache = model.apply(params, prompt, valid_p, cache0,
                                    method=JUV.prefill)
        valid = jnp.concatenate(
            [valid_p, jnp.ones((1, t_max - p_len), bool)], axis=1)
        return logits, cache, valid

    @jax.jit
    def step(params, token, i, valid, cache):
        return model.apply(params, token, i, p_len + i + 1, valid, cache,
                           method=JUV.decode_step)

    logits, cache, valid = prefill(params, *map(jnp.asarray, inputs))
    out = [np.asarray(logits)]
    for i in range(n_steps):
        logits, cache = step(params, jnp.asarray(codes[:, i], jnp.int32),
                             jnp.asarray(i), valid, cache)
        out.append(np.asarray(logits))
    return out, cache


def test_int8_kv_greedy_codes_match_jax(tiny):
    """Greedy decode with `int8_kv` and no pack: the port's codes equal the
    JAX `decode`'s (its `int8_kv_xla` case), and the run is long enough to
    read many quantized positions."""
    model, params, port, inputs = tiny
    ref = jdecode.decode(params, model, JaxGenerationConfig(**dataclasses.asdict(GREEDY)),
                         *map(jnp.asarray, inputs), jax.random.PRNGKey(1),
                         max_new=MAX_NEW, int8_kv=True)
    out = port_decode(port, inputs, int8_kv=True)
    n = int(np.asarray(ref.lengths)[0])
    assert n >= 8
    assert int(out.lengths[0]) == n
    np.testing.assert_array_equal(out.codes.numpy()[0, :n], np.asarray(ref.codes)[0, :n])


def test_int8_kv_step_logits_match_jax(tiny):
    """Teacher-forced on the same codes, the prefill's and every step's
    logits over the int8 cache agree with the JAX `QuantKVCache` steps
    within LOGIT_TOL of max|logits|, and the two caches hold the same int8
    codes and scales (the unwritten positions' scales stay 1e-12).  The
    same steps over a float cache stray from them by far more, so the
    comparison sees the quantization."""
    model, params, port, inputs = tiny
    codes = port_decode(port, inputs, int8_kv=True).codes.numpy()
    n_steps = 8
    ref, jcache = jax_teacher_forced(model, params, inputs, codes, n_steps)
    cond, emo, text, tlen = inputs
    with torch.no_grad():
        prompt, valid_p = port.build_prompt(t(cond), t(emo), t(text).long(),
                                            t(tlen).long())
        p_len = prompt.shape[1]
        t_max = p_len + 1 + MAX_NEW
        valid = torch.cat([valid_p, torch.ones((1, t_max - p_len), dtype=torch.bool)], 1)
        caches = {"int8": port.gpt.init_quant_cache(1, t_max, "cpu"),
                  "float": port.gpt.init_cache(1, t_max, torch.float32, "cpu")}
        runs = {}
        for kind, cache in caches.items():
            got = [port.prefill(prompt, valid_p, cache)]
            for i in range(n_steps):
                got.append(port.decode_step(torch.from_numpy(codes[:, i]), i,
                                            p_len + i + 1, valid, cache))
            runs[kind] = got
    for i, r in enumerate(ref):
        scale = max(1.0, np.abs(r).max())
        err = np.abs(runs["int8"][i].numpy() - r).max()
        assert err <= LOGIT_TOL * scale, (i, err)
        assert np.abs(runs["float"][i].numpy() - r).max() > 10 * LOGIT_TOL * scale
    cache = caches["int8"]
    assert cache.kv.dtype == torch.int8 and cache.scales.dtype == torch.float32
    np.testing.assert_array_equal(cache.kv.numpy(), np.asarray(jcache.kv))
    np.testing.assert_allclose(cache.scales.numpy(), np.asarray(jcache.scales),
                               rtol=1e-6)
    written = p_len + 1 + n_steps
    assert (cache.scales[..., written:] == 1e-12).all()
    assert (cache.scales[..., :written] > 1e-12).all()


@pytest.mark.parametrize("int8_kv", [True, False])
def test_int8_kv_flag_selects_cache(tiny, monkeypatch, int8_kv):
    """Without a pack, `int8_kv=True` decodes every step over a
    `QuantKVCache` and `int8_kv=False` over a float cache of the model's
    dtype, so the new branch is not always taken: each step its device
    loop executes (CHUNK a chunk, at most CHUNK - 1 of them after the
    stop)."""
    _, _, port, inputs = tiny
    seen = []
    step = port.decode_step

    def spy(token, i, index, valid, cache):
        seen.append(cache)
        return step(token, i, index, valid, cache)
    monkeypatch.setattr(port, "decode_step", spy)
    res = port_decode(port, inputs, int8_kv=int8_kv)
    executed = res.chunks * CHUNK
    assert len(seen) == executed and executed >= res.steps > executed - CHUNK
    assert res.steps >= 5
    if int8_kv:
        assert all(isinstance(c, QuantKVCache) and c.kv.dtype == torch.int8
                   for c in seen)
    else:
        assert all(isinstance(c, torch.Tensor) and c.dtype == torch.float32
                   for c in seen)


def test_quantize_kv_matches_jax():
    """`_quantize_kv` against the JAX `_quantize_kv` under jit on rows with
    exact ties (x.5 steps), zeros and a wide range: equal int8 codes, scales
    equal to f32 rounding."""
    from voice_tts_tpu.models.gpt.gpt2 import _quantize_kv as jax_quantize_kv

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, 16, 7)) * np.logspace(-3, 2, 7)).astype(np.float32)
    x[0, 0, :, 0] = 0.0
    x[1, 2, :, 3] = np.arange(16, dtype=np.float32) - 7.5
    q_ref, s_ref = jax.jit(jax_quantize_kv)(jnp.asarray(x))
    q, s = _quantize_kv(t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-7)
