"""The text-emotion model of the port (`models/qwen.py`,
`engine/qwen_emotion.py`, `utils/checkpoint.convert_qwen`) against the JAX
package and Hugging Face `transformers` at tiny Qwen2 / Qwen3 widths (the
configs built in code; nothing downloads): the logits, the greedy decode
(the device loop at several chunk sizes, a stop inside a chunk), the
converter bit-equal to `flatten_params` of JAX's tree, the response parser,
and `QwenEmotion.inference` with one stub tokenizer on both sides."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voice_tts_tpu.config import QwenEmoConfig as JaxQwenEmoConfig
from voice_tts_tpu.engine import qwen_emotion as jqe
from voice_tts_tpu.models import qwen as jqwen
from voice_tts_tpu.utils.checkpoint import convert_qwen as jax_convert_qwen
from voice_tts_tpu_torch.config import QwenEmoConfig
from voice_tts_tpu_torch.engine import device_loop
from voice_tts_tpu_torch.engine import qwen_emotion as pqe
from voice_tts_tpu_torch.models import qwen as pqwen
from voice_tts_tpu_torch.utils.checkpoint import convert_qwen
from voice_tts_tpu_torch.utils.convert import flatten_params

VOCAB, EOS = 120, 119
# f32 on both sides, summed in other orders: as the JAX package's own test
LOGIT_ATOL, LOGIT_RTOL = 3e-4, 1e-3


def _tiny_hf(model_type):
    """A tiny random HF Qwen2 / Qwen3 (seed 0), tied embeddings.  The
    weights are redrawn wider than HF's init (std 0.02 makes the model echo
    its last token) and the norms off 1, so the greedy ids vary."""
    common = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
                  max_position_embeddings=512, rope_theta=10000.0,
                  tie_word_embeddings=True)
    torch.manual_seed(0)
    if model_type == "qwen2":
        from transformers import Qwen2Config, Qwen2ForCausalLM
        cfg = Qwen2Config(**common)
        model = Qwen2ForCausalLM(cfg)
    else:
        from transformers import Qwen3Config, Qwen3ForCausalLM
        cfg = Qwen3Config(head_dim=8, **common)
        model = Qwen3ForCausalLM(cfg)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            p.copy_(1 + 0.2 * noise if "norm" in name else 0.3 * noise)
    return model.eval(), cfg


def _arch(cls, hf_cfg, model_type):
    return cls(vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
               num_layers=hf_cfg.num_hidden_layers,
               num_heads=hf_cfg.num_attention_heads,
               num_kv_heads=hf_cfg.num_key_value_heads, head_dim=8,
               intermediate_size=hf_cfg.intermediate_size,
               rope_theta=hf_cfg.rope_theta, rms_eps=hf_cfg.rms_norm_eps,
               qkv_bias=model_type == "qwen2", qk_norm=model_type == "qwen3",
               tie_embeddings=True)


def tiny_models(model_type):
    """(HF model, JAX QwenLM, JAX params, port QwenLM, the HF state as
    numpy) of one tiny Qwen."""
    hf, hf_cfg = _tiny_hf(model_type)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jmodel = jqwen.QwenLM(_arch(jqwen.QwenArch, hf_cfg, model_type))
    pmodel = pqwen.load_qwen_state(pqwen.QwenLM(_arch(pqwen.QwenArch, hf_cfg, model_type)),
                                   convert_qwen({k: torch.from_numpy(v) for k, v in sd.items()}))
    return hf, jmodel, jax_convert_qwen(sd), pmodel.eval(), sd


@pytest.fixture(scope="module", params=["qwen2", "qwen3"])
def models(request):
    return tiny_models(request.param)


def test_convert_qwen_matches_jax_tree(models):
    """`convert_qwen` gives `flatten_params` of JAX's `convert_qwen` tree,
    key for key and bit for bit (the tied head's copy included)."""
    _, _, jparams, _, sd = models
    ours = convert_qwen({k: torch.from_numpy(v) for k, v in sd.items()})
    ref = flatten_params(jax.tree.map(np.asarray, jparams))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


def test_logits_match_jax_and_hf(models):
    """Prefill logits of two rows (no cache) and, through a left-padded
    cache, the last row's: the port against JAX's `QwenLM` and HF."""
    hf, jmodel, jparams, pmodel, _ = models
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 9)).astype(np.int64)
    with torch.no_grad():
        ours, _ = pmodel(torch.from_numpy(tokens))
        ref_hf = hf(torch.from_numpy(tokens)).logits.numpy()
    ref_jax, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32))
    for ref in (ref_hf, np.asarray(ref_jax)):
        np.testing.assert_allclose(ours.numpy(), ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    # left padding of 3 into a 16-row cache: the masked pads take no weight
    pad = np.concatenate([np.full((1, 3), EOS), tokens[:1]], axis=1)
    valid = np.concatenate([np.arange(12)[None] >= 3, np.ones((1, 4), bool)], axis=1)
    cache = pmodel.init_cache(1, 16, "cpu")
    with torch.no_grad():
        ours, _ = pmodel(torch.from_numpy(pad), cache, 0, torch.from_numpy(valid))
    jcache = jnp.zeros(tuple(cache.shape), jnp.float32)
    ref, _ = jmodel.apply(jparams, jnp.asarray(pad, jnp.int32), jcache, 0,
                          jnp.asarray(valid))
    np.testing.assert_allclose(ours[:, -1].numpy(), np.asarray(ref)[:, -1],
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def _left_padded(prompt, bucket):
    toks = np.full((1, bucket), EOS, np.int64)
    toks[0, bucket - len(prompt):] = prompt
    return toks


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_greedy_decode_matches_jax_and_hf(models, chunk):
    """`qwen_greedy_decode` (the device loop, `chunk` steps a chunk) gives
    JAX's ids exactly and HF generate's greedy continuation, with one host
    read before the first chunk and one after each."""
    hf, jmodel, jparams, pmodel, _ = models
    prompt = [5, 17, 33, 2, 98]
    toks = _left_padded(prompt, 8)
    res = pqwen.qwen_greedy_decode(pmodel, torch.from_numpy(toks), 5, 10, EOS, chunk=chunk)
    ref = np.asarray(jqwen.qwen_greedy_decode(jparams, jmodel, jnp.asarray(toks, jnp.int32),
                                              jnp.asarray([5]), 10, eos_id=EOS))
    np.testing.assert_array_equal(res.ids.numpy(), ref)
    with torch.no_grad():
        hf_out = hf.generate(torch.tensor([prompt]), max_new_tokens=10, do_sample=False,
                             eos_token_id=None, pad_token_id=0)
    np.testing.assert_array_equal(res.ids[0].numpy(), hf_out[0, len(prompt):].numpy())
    assert res.steps == 9 and res.chunks == -(-9 // chunk)


def test_greedy_decode_stops_inside_a_chunk(models, monkeypatch):
    """With the eos id set to the first greedy id after the first that did
    not come before, the loop stops there: the rest is eos-padded as JAX's,
    the steps after the stop inside the chunk leave the state as it was
    (one chunk of 16)."""
    _, jmodel, jparams, pmodel, _ = models
    toks = _left_padded([5, 17, 33, 2, 98], 8)
    free = pqwen.qwen_greedy_decode(pmodel, torch.from_numpy(toks), 5, 10, EOS).ids[0]
    stop_at = next(j for j in range(1, 10) if int(free[j]) not in free[:j].tolist())
    eos = int(free[stop_at])
    reads = []
    monkeypatch.setattr(device_loop, "read_flag", lambda f: reads.append(1) or bool(f))
    res = pqwen.qwen_greedy_decode(pmodel, torch.from_numpy(toks), 5, 10, eos)
    ref = np.asarray(jqwen.qwen_greedy_decode(jparams, jmodel, jnp.asarray(toks, jnp.int32),
                                              jnp.asarray([5]), 10, eos_id=eos))
    np.testing.assert_array_equal(res.ids.numpy(), ref)
    assert res.ids[0, :stop_at + 1].tolist() == free[:stop_at + 1].tolist()
    assert (res.ids[0, stop_at:] == eos).all()
    assert res.steps == stop_at and res.chunks == 1
    assert len(reads) == 2


@pytest.mark.parametrize("content,text", [
    ('{"高兴": 0.9, "愤怒": 0.2}', "some text"),        # JSON
    ('高兴: 0.5, 自然: 0.4 junk', "text"),                # regex fallback
    ('{"高兴": 5.0, "恐惧": 0.3}', "t"),                  # clamp to 1.2
    ('{}', "t"),                                          # calm fallback
    ('{"悲伤": 0.8, "低落": 0.1}', "feeling depressed today"),  # swap
    ('nothing to read', "gloomy"),                        # swap of nothing, calm
])
def test_parse_emotion_response_matches_jax(content, text):
    out = pqe.parse_emotion_response(content, text)
    assert out == jqe.parse_emotion_response(content, text)
    assert list(out) == [pqe.CN_KEY_TO_EN[k] for k in pqe.DESIRED_ORDER]


def test_parse_emotion_response_cases():
    assert pqe.parse_emotion_response('{"高兴": 5.0}', "t")["happy"] == 1.2
    assert pqe.parse_emotion_response('{}', "t")["calm"] == 1.0
    out = pqe.parse_emotion_response('{"悲伤": 0.8}', "feeling depressed today")
    assert out["melancholic"] == 0.8 and out["sad"] == 0.0
    assert pqe.parse_emotion_response('高兴: 0.5, 自然: 0.4', "t")["calm"] == 0.4


class StubTokenizer:
    """A byte-level stand-in for a Hugging Face tokenizer: a chat template
    without `enable_thinking` (the retry path), ids from the UTF-8 bytes,
    and a decode that writes a JSON score dict from the ids (so the parsed
    emotion depends on every generated id)."""

    eos_token_id = EOS

    def apply_chat_template(self, messages, tokenize, add_generation_prompt):
        assert not tokenize and add_generation_prompt
        return "".join(f"<{m['role']}>{m['content']}" for m in messages) + "<assistant>"

    def __call__(self, text):
        return {"input_ids": [3 + b % 100 for b in text.encode()]}

    def decode(self, ids, skip_special_tokens=True):
        keys = ["高兴", "愤怒", "悲伤", "恐惧", "反感", "低落", "惊讶", "自然"]
        scores = {keys[i % 8]: round((i * 7 + sum(ids)) % 13 / 10.0, 1)
                  for i in ids[:4]}
        return "<think>x</think>" + json.dumps(scores, ensure_ascii=False)


def emotion_pair(models_tuple, max_new=12):
    """The JAX and the port's `QwenEmotion` on the same weights and stub
    tokenizer."""
    _, jmodel, jparams, pmodel, _ = models_tuple
    jq = jqe.QwenEmotion(JaxQwenEmoConfig(max_new_tokens=max_new), jmodel, jparams,
                         StubTokenizer())
    pq = pqe.QwenEmotion(dataclasses.replace(QwenEmoConfig(), max_new_tokens=max_new),
                         pmodel, StubTokenizer())
    return jq, pq


def port_emotion(max_new=8):
    """A port `QwenEmotion` on the tiny Qwen3 and the stub tokenizer."""
    return pqe.QwenEmotion(dataclasses.replace(QwenEmoConfig(), max_new_tokens=max_new),
                           tiny_models("qwen3")[3], StubTokenizer())


def test_emotion_inference_matches_jax(models):
    """`QwenEmotion.inference` on a sentence whose chat prompt fits the
    128 bucket and on one that needs 256: the same emotion dict as JAX's,
    from the same greedy ids."""
    jq, pq = emotion_pair(models)
    for text in ("今天真开心", "a long sentence, " * 9):
        assert len(pq._chat_tokens(text)) <= 128 or "long" in text
        assert pq.inference(text) == jq.inference(text)
