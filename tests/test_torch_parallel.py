"""The port's tensor parallelism (`voice_tts_tpu_torch/parallel/`) against
the JAX package on the CPU.

The port's meshes repeat the CPU (`[cpu] * n`, the stand-in for conftest's
8 virtual JAX devices); the JAX side stays unsharded (the JAX package's
own tests assert that its sharded runs equal its unsharded ones), at
tests/test_parallel.py's GPT widths, the same weights converted with
`utils.convert`, the same numpy inputs.  Tolerances: the teacher-forced
latent and the loss as tests/test_torch_models.py holds the GPT (2e-4 of
max(1, max |ref|)); the gradients 2e-5 of max(1e-3, each leaf's max |jax
grad|) (f32 summation order: about 2e-6 seen); decodes equal codes
(greedy f32, exact up to summation order, which the tiny model's logit
gaps absorb); a WAV within 2 LSB (JAX's own contract,
tests/test_parallel.py:74-100).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voice_tts_tpu.config import ConformerConfig, GPTConfig
from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu.models.gpt import decode as jdecode
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu.parallel import make_mesh as jax_make_mesh
from voice_tts_tpu.parallel.mesh import sharding_tree
from voice_tts_tpu.parallel.training import gpt_loss as jax_gpt_loss
from voice_tts_tpu.parallel.training import make_train_step as jax_make_train_step
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.config import TTSConfig as PortTTSConfig
from voice_tts_tpu_torch.engine import engine as pengine
from voice_tts_tpu_torch.engine.device_loop import CHUNK
from voice_tts_tpu_torch.engine.engine import TTSEngine
from voice_tts_tpu_torch.models.gpt import beam as pbeam
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops import decode_attention as k5
from voice_tts_tpu_torch.parallel import (gathered_state, gpt_loss, make_mesh,
                                          make_train_step, shard_gpt, sharding_plan)
from voice_tts_tpu_torch.parallel.mesh import sharded_leaves
from voice_tts_tpu_torch.parallel.tp import ShardedKV, TPStack, shard_devices
from voice_tts_tpu_torch.utils.convert import convert, load_family

pytest_plugins = ("port_fixtures",)

TINY = GPTConfig(
    layers=2, model_dim=64, heads=4, max_text_tokens=32, max_mel_tokens=48,
    number_text_tokens=40, number_mel_codes=68, start_mel_token=66,
    stop_mel_token=67, condition_num_latent=4, emo_dim=1024,
    condition_module=ConformerConfig(
        input_size=24, output_size=32, attention_heads=2, linear_units=48,
        num_blocks=2, input_layer="conv2d2", perceiver_mult=2),
    emo_condition_module=ConformerConfig(
        input_size=24, output_size=32, attention_heads=2, linear_units=48,
        num_blocks=1, input_layer="conv2d2", perceiver_mult=2),
)
CPU = torch.device("cpu")
GREEDY = GenerationConfig(do_sample=False, repetition_penalty=1.0, num_beams=1)
BEAM3 = GenerationConfig(do_sample=False, repetition_penalty=1.0, num_beams=3)
LATENT_TOL = 2e-4
GRAD_TOL = 2e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(out, ref, tol):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def port_cfg(jax_cfg, **changes):
    cfg = PortTTSConfig.from_dict({"gpt": dataclasses.asdict(jax_cfg)}).gpt
    return dataclasses.replace(cfg, **changes)


def cpu_mesh(n, axes=("tp",)):
    return make_mesh(axes, devices=[CPU] * n)


def jax_init(model, c, run=jax.jit):
    """`model.init_all` at `c`'s widths through `run` (jit, or eval_shape
    for the shapes alone)."""
    def init(key):
        return model.init(
            key, jnp.zeros((1, 6, c.condition_module.input_size)),
            jnp.zeros((1, 6, c.emo_condition_module.input_size)),
            jnp.zeros((1, 7), jnp.int32), jnp.asarray([7]),
            jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]), method=JUV.init_all)
    return run(init)(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tiny():
    """The JAX f32 parameters at TINY, the port's module on them (with and
    without `pallas_decode_attention`), and the decode inputs of
    tests/test_parallel.py."""
    model = JUV(TINY)
    params = jax.tree.map(np.asarray, jax_init(model, TINY))
    ports = {flag: load_family(UnifiedVoice(port_cfg(TINY, pallas_decode_attention=flag)),
                               convert("gpt", params)).eval().requires_grad_(False)
             for flag in (False, True)}
    rng = np.random.default_rng(5)
    text = rng.integers(2, 30, size=(1, 7)).astype(np.int32)
    inputs = ((rng.normal(size=(1, 4, TINY.model_dim)) * 0.1).astype(np.float32),
              (rng.normal(size=(1, TINY.model_dim)) * 0.1).astype(np.float32),
              text, np.asarray([7], np.int32))
    return model, params, ports, inputs


def port_decode(model, inputs, max_new, gen=GREEDY, fn=pdecode.decode, **kw):
    cond, emo, text, tlen = inputs
    return fn(model, gen, t(cond), t(emo), t(text).long(), t(tlen).long(), max_new, **kw)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def jax_plan(params, tp):
    """{path: spec} of the leaves JAX's `sharding_tree` splits over "tp"."""
    mesh = jax_make_mesh(("tp",), devices=jax.devices()[:tp])
    tree = sharding_tree(params, mesh)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not s.is_fully_replicated:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[key.removeprefix("params/")] = tuple(s.spec)
    return out


def port_plan(module, tp):
    plan = sharded_leaves(sharding_plan(module.state_dict(), cpu_mesh(tp)))
    return {k.replace(".", "/"): v for k, v in plan.items()}


@pytest.mark.parametrize("tp", [2, 4])
def test_plan_matches_jax_tiny(tiny, tp):
    """`sharding_plan` splits the leaves JAX's `sharding_tree` splits, with
    the same specs; the mel vocabulary of 68 splits at tp 4, the text
    vocabulary of 41 replicates."""
    _, params, ports, _ = tiny
    plan = port_plan(ports[False], tp)
    assert plan == jax_plan(params, tp)
    assert "mel_embedding/weight" in plan and "text_embedding/weight" not in plan
    assert plan["gpt/h_0/attn_c_attn/weight"] == (None, "tp")


def test_plan_matches_jax_flagship():
    """The same at the flagship widths, on shapes alone (`jax.eval_shape`,
    the port's module on the meta device): the mel vocabulary of 8194
    splits at tp 2 and replicates at tp 4; the text vocabulary replicates
    at both."""
    jcfg = JaxTTSConfig().gpt
    shapes = jax_init(JUV(jcfg), jcfg, lambda f: lambda key: jax.eval_shape(f, key))
    with torch.device("meta"):
        port = UnifiedVoice(PortTTSConfig().gpt)
    for tp in (2, 4):
        plan = port_plan(port, tp)
        assert plan == jax_plan(shapes, tp)
        assert ("mel_head/weight" in plan) == (tp == 2)
        assert ("mel_embedding/weight" in plan) == (tp == 2)
        assert "text_embedding/weight" not in plan and "text_head/weight" not in plan


# ---------------------------------------------------------------------------
# the sharded runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_shards_hold_the_weights(tiny, tp):
    """`shard_gpt` leaves the source as it was, gathers back to it bit for
    bit, holds each split leaf as tp tensors of their own, and its caches
    split over heads."""
    _, _, ports, _ = tiny
    src = ports[False]
    before = {k: v.clone() for k, v in src.state_dict().items()}
    sharded = shard_gpt(src, cpu_mesh(tp))
    assert isinstance(sharded.gpt, TPStack)
    full = gathered_state(sharded)
    assert full.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(full[k], v) and torch.equal(src.state_dict()[k], v), k
    blk = sharded.gpt.h_0
    ptrs = {p.data_ptr() for p in blk.qkv_w_shards}
    assert len(ptrs) == tp and all(len(d) == tp for d in shard_devices(sharded).values())
    cache = sharded.gpt.init_cache(3, 20, torch.float32)
    assert isinstance(cache, ShardedKV) and len(cache.shards) == tp
    assert cache.shape == src.gpt.init_cache(3, 20, torch.float32, CPU).shape
    assert cache.shards[0].shape[3] == TINY.heads // tp


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_decode_matches_jax(tiny, tp):
    """Greedy f32 decode of 8 steps through the sharded port equals JAX's
    unsharded `decode` (codes and lengths); the teacher-forced latent of
    the same text and codes is JAX's within LATENT_TOL."""
    model, params, ports, inputs = tiny
    ref = jdecode.decode(params, model,
                         JaxGenerationConfig(**dataclasses.asdict(GREEDY)),
                         *map(jnp.asarray, inputs), jax.random.PRNGKey(1), max_new=8)
    sharded = shard_gpt(ports[False], cpu_mesh(tp))
    out = port_decode(sharded, inputs, 8)
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    cond, emo, text, tlen = inputs
    codes = np.asarray(ref.codes)
    clen = np.asarray(ref.lengths)
    latent = model.apply(params, *map(jnp.asarray, (cond, emo, text, tlen, codes, clen)))
    with torch.no_grad():
        close(sharded(t(cond), t(emo), t(text).long(), t(tlen).long(), t(codes).long(),
                      t(clen).long()), latent, LATENT_TOL)


def test_sharded_prefill_rows(tiny):
    """`prefill_rows` (each row's prefill alone, written into a batch cache
    by index) on a tp-4 runtime: the unsharded module's logits, and its
    cache once the shards' heads are put side by side."""
    _, _, ports, inputs = tiny
    src = ports[False]
    sharded = shard_gpt(src, cpu_mesh(4))
    cond, emo, text, tlen = (t(np.repeat(x, 2, axis=0)) for x in inputs)
    text, tlen = text.long(), tlen.long() - torch.tensor([0, 2])
    out = {}
    with torch.no_grad():
        for name, m in (("src", src), ("tp", sharded)):
            prompt, valid = m.build_prompt(cond, emo, text, tlen)
            out[name] = pdecode.prefill_rows(m, prompt, valid, prompt.shape[1] + 4)
    close(out["tp"][0], out["src"][0].numpy(), LATENT_TOL)
    whole = torch.cat(out["tp"][1].shards, dim=3)
    close(whole, out["src"][1].numpy(), LATENT_TOL)


@pytest.mark.parametrize("arm", ["beam3", "int8_kv", "k5"])
def test_sharded_arms_match_unsharded(tiny, arm, monkeypatch):
    """The other unfused arms on a tp-4 runtime against the port's
    unsharded module: beam-3 (the eager arm, its cache reordered a shard
    at a time), the int8 `QuantKVCache` decode (each shard's heads
    quantized), and `pallas_decode_attention` (K5 on each shard's heads:
    tp launches a layer and step its device loop executes, as the JAX
    engine runs K5 under TP); equal codes and lengths."""
    _, _, ports, inputs = tiny
    flag = arm == "k5"
    src = ports[flag]
    sharded = shard_gpt(src, cpu_mesh(4))
    if arm == "beam3":
        ref = port_decode(src, inputs, 10, BEAM3, pbeam.beam_decode)
        out = port_decode(sharded, inputs, 10, BEAM3, pbeam.beam_decode)
    else:
        kw = {"int8_kv": True} if arm == "int8_kv" else {}
        ref = port_decode(src, inputs, 10, **kw)
        calls = []
        plain = k5.decode_attention_plain
        monkeypatch.setattr(k5, "decode_attention_plain",
                            lambda q, *a: calls.append(q.shape) or plain(q, *a))
        out = port_decode(sharded, inputs, 10, **kw)
        if flag:
            executed = out.chunks * CHUNK
            assert executed >= out.steps > executed - CHUNK
            assert len(calls) == 4 * TINY.layers * executed > 0
            assert all(s[1] == TINY.heads // 4 for s in calls)
    assert out.steps == ref.steps
    assert torch.equal(out.codes, ref.codes) and torch.equal(out.lengths, ref.lengths)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def tone() -> bytes:
    s = np.arange(16000) / 16000
    return encode_wav_int16((0.4 * np.sin(2 * np.pi * 440 * s)).astype(np.float32), 16000)


def test_engine_tensor_parallel_matches_single():
    """The tiny engine with `tensor_parallel=4` (fused and int8 decode off,
    as JAX's test builds it) serves the tp-1 engine's WAV within 2 LSB;
    `to_device` is a no-op under TP."""
    flags = dict(use_fused_decode=False, use_int8_decode=False)
    eng_tp = TTSEngine.tiny(device="cpu", tensor_parallel=4, **flags)
    assert eng_tp.tp_mesh.shape == {"tp": 4} and isinstance(eng_tp.gpt_rt.gpt, TPStack)
    res_tp = eng_tp.infer(tone(), "你好世界")
    res = TTSEngine.tiny(device="cpu", **flags).infer(tone(), "你好世界")
    assert res_tp.wav.shape == res.wav.shape
    diff = np.abs(res_tp.wav.astype(np.int32) - res.wav.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    rt = eng_tp.gpt_rt
    assert eng_tp.to_device("cpu") is eng_tp and eng_tp.gpt_rt is rt


def test_engine_conditioning_reads_the_master():
    """Under TP the conditioning reads the unsharded f32 master even with
    `use_bf16_conditioning`, and `release_master_trees` keeps it (JAX
    `engine.py:253-255`); the runtime copy is the sharded bf16 one, and
    the production arms serve: beam-3 with int8 KV, and `infer_batch`."""
    flags = dict(use_fp16=True, use_int8_kv=True, use_bf16_conditioning=True,
                 release_master_trees=True)
    eng = TTSEngine.tiny(device="cpu", tensor_parallel=2, **flags)
    assert eng.cond_gpt is eng.gpt is eng.models["gpt"]
    assert eng.cond_gpt.final_norm.weight.dtype == torch.float32
    assert not isinstance(eng.cond_gpt.gpt, TPStack)
    assert eng.gpt_rt.param_dtype == torch.bfloat16 and isinstance(eng.gpt_rt.gpt, TPStack)
    assert eng.fused_pack is None and eng.readout_pack is None
    eng.cfg.generation.num_beams = 3
    res = eng.infer(tone(), "你好世界", do_sample=False)
    assert res.wav.size > 0 and eng.last_metrics["decode_steps"] > 0
    out = eng.infer_batch([{"spk_audio_prompt": tone(), "text": "你好"},
                           {"spk_audio_prompt": tone(), "text": "世界你好啊"}])
    assert [r.wav.size > 0 for r in out] == [True, True]


def test_tensor_parallel_refuses_too_few_cards(monkeypatch):
    """`tensor_parallel` above the cards from the engine's on raises, as the
    JAX engine does (`engine.py:148-150`); the CPU takes any count."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="tensor_parallel=4 but only 2 devices"):
        pengine.tp_devices(torch.device("cuda", 0), 4)
    with pytest.raises(ValueError, match="tensor_parallel=2 but only 1 devices"):
        pengine.tp_devices(torch.device("cuda", 1), 2)
    assert pengine.tp_devices(torch.device("cuda", 0), 2) == [torch.device("cuda", 0),
                                                              torch.device("cuda", 1)]
    assert pengine.tp_devices(CPU, 4) == [CPU] * 4


@pytest.mark.cuda
def test_engine_refuses_more_tp_than_cards():
    """On a machine with cards: an engine asking for one more than there
    are raises ValueError before building anything on them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"tensor_parallel={n + 1} but only {n} devices"):
        TTSEngine.tiny(device="cuda:0", tensor_parallel=n + 1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_batch(seed=3, b=4, l=9, m=12):
    """A numpy batch at TINY: conditioning features, right-padded text and
    codes with their lengths."""
    rng = np.random.default_rng(seed)
    c = TINY.condition_module.input_size
    return {"spk_cond": rng.standard_normal((b, 20, c)).astype(np.float32),
            "emo_cond": rng.standard_normal((b, 16, c)).astype(np.float32),
            "text": rng.integers(2, 38, size=(b, l)).astype(np.int32),
            "text_len": rng.integers(3, l + 1, size=(b,)).astype(np.int32),
            "codes": rng.integers(0, 64, size=(b, m)).astype(np.int32),
            "code_len": rng.integers(4, m + 1, size=(b,)).astype(np.int32)}


def port_batch(batch):
    return {k: t(v).long() if v.dtype == np.int32 else t(v) for k, v in batch.items()}


def grads_close(grads, ref_tree):
    ref = {k: v.numpy() for k, v in convert("gpt", ref_tree).items()}
    assert grads.keys() == ref.keys()
    for k, g in ref.items():
        err = np.abs(grads[k].numpy() - g).max()
        assert err <= GRAD_TOL * max(1e-3, np.abs(g).max()), (k, err, np.abs(g).max())


@pytest.fixture(scope="module")
def trained(tiny):
    """JAX's loss and gradients at TINY on `train_batch`, and its weights
    after one `optax.adamw(1e-4)` step of `make_train_step` (a 1 x 1 mesh:
    the unsharded step)."""
    model, params, _, _ = tiny
    jb = {k: jnp.asarray(v) for k, v in train_batch().items()}
    mesh = jax_make_mesh(("dp", "tp"), shape=(1, 1), devices=jax.devices()[:1])
    init_state, step = jax_make_train_step(model, optax.adamw(1e-4), mesh)

    @jax.jit      # one compile: the gradients and the jitted step inlined
    def both(state):
        loss, grads = jax.value_and_grad(
            lambda p: jax_gpt_loss(model, {"params": p}, jb))(state["params"]["params"])
        return loss, grads, step(state, jb)
    loss, grads, (state, step_loss) = both(init_state(params))
    return (float(loss), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, state["params"]), float(step_loss))


def adamw(ps):
    """optax.adamw(1e-4)'s settings (b1 0.9, b2 0.999, eps 1e-8, weight
    decay 1e-4: torch's default decay is 1e-2)."""
    return torch.optim.AdamW(ps, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@pytest.mark.parametrize("tp", [1, 4])
def test_gpt_loss_and_grads_match_jax(tiny, trained, tp):
    """`gpt_loss` on the unsharded module and on a tp-4 copy (the
    conditioning's FF leaves split too) equals JAX's `gpt_loss` within
    LATENT_TOL, and its gradients, gathered, `jax.grad`'s within GRAD_TOL."""
    _, _, ports, _ = tiny
    ref_loss, ref_grads, _, _ = trained
    model = shard_gpt(ports[False], cpu_mesh(tp)).requires_grad_(True)
    if tp > 1:
        assert type(model.conditioning_encoder.layer_0.ff_w1).__name__ == "ShardedLinear"
    loss = gpt_loss(model, port_batch(train_batch()))
    close(loss, ref_loss, LATENT_TOL)
    loss.backward()
    grads_close(gathered_state(model, grad=True), ref_grads)


def test_train_step_dp2_tp4(tiny, trained):
    """One `train_step` on a dp 2 x tp 4 mesh of [cpu] * 8: the loss of the
    unsharded step (dp 1 x tp 1) and JAX's, the two dp replicas equal
    after the step, and the new weights those of the unsharded step and of
    JAX's `optax.adamw(1e-4)` step.  Adam's first step moves an entry by
    about lr * sign(g); where |g| is within 1e-6 of zero the direction
    rests on rounding, so there the bound is the step's own size."""
    _, params, ports, _ = tiny
    _, ref_grads, ref_params, ref_loss = trained
    src = ports[False]
    batch = port_batch(train_batch())
    states, losses = {}, {}
    for name, mesh in (("dp2tp4", cpu_mesh(8, ("dp", "tp"))),
                       ("single", cpu_mesh(1, ("dp", "tp")))):
        init_state, step = make_train_step(src, adamw, mesh)
        states[name], losses[name] = step(init_state(), batch)
    assert cpu_mesh(8, ("dp", "tp")).shape == {"dp": 2, "tp": 4}
    close(losses["dp2tp4"], float(losses["single"]), LATENT_TOL)
    close(losses["dp2tp4"], ref_loss, LATENT_TOL)
    reps = [gathered_state(r) for r in states["dp2tp4"]["replicas"]]
    assert all(torch.equal(reps[0][k], reps[1][k]) for k in reps[0])
    single = gathered_state(states["single"]["replicas"][0])
    ref = {k: v.numpy() for k, v in convert("gpt", ref_params).items()}
    g = {k: np.abs(v.numpy()) for k, v in convert("gpt", ref_grads).items()}
    lr = 1e-4
    for k, new in reps[0].items():
        steady = g[k] > 1e-6
        for other in (single[k].numpy(), ref[k]):
            err = np.abs(new.numpy() - other)
            assert err[steady].max(initial=0) <= 1e-3 * lr + 1e-7, k
            assert err.max() <= 2.1 * lr, k
    # the step moved the weights (lr * sign(g) where g is not tiny)
    moved = np.abs(reps[0]["mel_head.weight"].numpy()
                   - src.state_dict()["mel_head.weight"].numpy())
    assert np.median(moved) > 0.5 * lr


def test_train_step_leaves_source_and_loads_params(tiny):
    """`init_state` copies: the source module is untouched by a step, and
    `init_state(params)` starts from the state dict given."""
    _, _, ports, _ = tiny
    src = ports[False]
    before = copy.deepcopy(src.state_dict())
    init_state, step = make_train_step(src, adamw, cpu_mesh(2, ("dp", "tp")))
    assert make_mesh(("dp", "tp"), devices=[CPU] * 2).shape == {"dp": 1, "tp": 2}
    state, loss = step(init_state(), port_batch(train_batch(b=2)))
    assert np.isfinite(float(loss))
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in before.items())
    zeroed = {k: torch.zeros_like(v) for k, v in before.items()}
    fresh = init_state(zeroed)
    assert all(float(v.abs().max()) == 0 for v in gathered_state(fresh["replicas"][0]).values())
