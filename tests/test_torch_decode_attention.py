"""K5, the bounded-read decode attention of the port
(`voice_tts_tpu_torch/ops/decode_attention.py`), and the decode paths that
`GPTConfig.pallas_decode_attention` sends through it, against the JAX
package on the CPU: the plain K5 against the Pallas kernel in interpret mode;
greedy decode and beam-3 with the flag against the JAX loops with the flag;
the flag on against off; the gating (K5 once per layer and step, no fused
step, K4 on the int8 runtime copy's projections, spec decode untouched),
counted with spies.  Inputs come from numpy with a seed.  The `cuda` case
holds the kernel against its plain version on the card."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.config import TTSConfig as PortTTSConfig
from voice_tts_tpu_torch.engine.device_loop import CHUNK
from voice_tts_tpu_torch.engine.engine import TTSEngine
from voice_tts_tpu_torch.models.gpt import beam as pbeam
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops import decode_attention as k5
from voice_tts_tpu_torch.ops import int8_matmul
from voice_tts_tpu_torch.ops.fused_decode import pack_gpt, pack_gpt_int4, pack_readout
from voice_tts_tpu_torch.utils.convert import convert, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

try:
    import jax
    import jax.numpy as jnp

    from tests.test_gpt import TINY
    from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
    from voice_tts_tpu.models.gpt import beam as jbeam
    from voice_tts_tpu.models.gpt import decode as jdecode
    from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
    from voice_tts_tpu.ops.decode_attention import \
        decode_attention as jax_decode_attention
    from voice_tts_tpu.utils.quantize import quantize_gpt_params
except ImportError:     # the machine with the card has no JAX: the `cuda` case runs there
    jax = None

pytest_plugins = ("port_fixtures",)

GREEDY = GenerationConfig(do_sample=False, repetition_penalty=2.0, num_beams=1)
BEAM3 = dataclasses.replace(GREEDY, num_beams=3)


def t(x):
    return torch.from_numpy(np.asarray(x))


def attention_inputs(seed, b=2, h=4, hd=64, t_max=1024):
    """q (B, H, hd), k / v (B, H, hd, Tmax) and a (B, Tmax) bias whose row 0
    has three padded prompt positions (-1e30)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, h, hd, t_max)).astype(np.float32)
    v = rng.standard_normal((b, h, hd, t_max)).astype(np.float32)
    bias = np.zeros((b, t_max), np.float32)
    bias[0, :3] = -1e30
    return q, k, v, bias


# f32: the same f32 arithmetic, sums in another order and over other tiles
# (the JAX package's own tolerance for its kernel, tests/test_decode_attention.py)
F32_ATOL, F32_RTOL = 2e-5, 1e-4
# bf16: scores and sums stay f32, the output rounds to bf16 (8 significant
# bits); a sum in another order that flips that rounding moves an output by
# one bf16 ulp, which near the largest magnitude m is up to 2^-7 * m
BF16_TOL = 2 ** -7


@pytest.mark.parametrize("length", [5, 512, 549, 1023])
def test_plain_matches_jax_kernel(length):
    q, k, v, bias = attention_inputs(0)
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.asarray(length, jnp.int32), interpret=True))
    out = k5.decode_attention(t(q), t(k), t(v), t(bias), length)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL, rtol=F32_RTOL)


def test_plain_matches_jax_kernel_bf16():
    q, k, v, bias = attention_inputs(1, b=1, t_max=512)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_decode_attention(qj, kj, vj, jnp.asarray(bias),
                                          jnp.asarray(100, jnp.int32),
                                          interpret=True).astype(jnp.float32))
    qt, kt, vt = (t(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (qj, kj, vj))
    out = k5.decode_attention(qt, kt, vt, t(bias), 100)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= BF16_TOL * np.abs(ref).max(), err


# ---------------------------------------------------------------------------
# the decode loops with the flag
# ---------------------------------------------------------------------------

def port_gpt_config(jax_cfg, **changes):
    """The port's GPTConfig with the JAX config's fields."""
    cfg = PortTTSConfig.from_dict({"gpt": dataclasses.asdict(jax_cfg)}).gpt
    return dataclasses.replace(cfg, **changes)


@pytest.fixture(scope="module")
def tiny_gpt():
    return make_tiny_gpt()


def init_params(c, seed: int = 0):
    """The JAX f32 parameters of a UnifiedVoice of config `c`, as numpy."""
    model = JUV(c)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def make_tiny_gpt(params=None):
    """The JAX f32 parameters of a UnifiedVoice at tests/test_gpt.py's TINY
    widths, the port's f32 and int8-runtime modules with the flag on and
    off (the same weights), and numpy decode inputs; the text fills 28 of
    TINY's 32 text positions, so the prefill (37 rows) is not a K4 product.
    `params` replaces the seeded ones (`tests/test_torch_host_loops.py`)."""
    c = TINY
    if params is None:
        params = init_params(c)
    ports = {}
    for flag in (False, True):
        pc = port_gpt_config(c, pallas_decode_attention=flag)
        ports[flag] = load_family(UnifiedVoice(pc), convert("gpt", params)).eval()
    state = quantize_gpt_state(ports[False].state_dict())
    int8 = {}
    for flag in (False, True):
        rt = UnifiedVoice(ports[flag].cfg, int8=True)
        TTSEngine._cast_like(rt, state)
        rt.load_state_dict(state)
        int8[flag] = rt.eval()
    rng = np.random.default_rng(9)
    inputs = ((rng.standard_normal((1, c.condition_num_latent, c.model_dim)) * 0.1
               ).astype(np.float32),
              (rng.standard_normal((1, c.model_dim)) * 0.1).astype(np.float32),
              rng.integers(2, 30, size=(1, 28)).astype(np.int32),
              np.asarray([25], np.int32))
    return params, ports, int8, state, inputs


def port_decode(model, inputs, max_new, gen=GREEDY, **kw):
    cond, emo, text, tlen = inputs
    return pdecode.decode(model, gen, t(cond), t(emo), t(text).long(),
                          t(tlen).long(), max_new, **kw)


def same_codes(out, ref):
    n = int(np.asarray(ref.lengths)[0])
    assert int(out.lengths[0]) == n
    np.testing.assert_array_equal(out.codes.numpy()[0, :n], np.asarray(ref.codes)[0, :n])


def test_decode_with_flag_matches_jax(tiny_gpt):
    """Greedy decode, f32, with `pallas_decode_attention` on both sides (K5
    in interpret mode in JAX, its plain version here): equal codes."""
    params, ports, _, _, inputs = tiny_gpt
    model = JUV(dataclasses.replace(TINY, pallas_decode_attention=True))
    ref = jdecode.decode(params, model, JaxGenerationConfig(**dataclasses.asdict(GREEDY)),
                         *map(jnp.asarray, inputs), jax.random.PRNGKey(1), max_new=8)
    same_codes(port_decode(ports[True], inputs, 8), ref)


@pytest.mark.parametrize("max_new", [8, 24])
def test_flag_on_matches_off(tiny_gpt, max_new):
    """The port's greedy decode with K5 (cache padded to 512) against the
    einsum step: equal codes and lengths."""
    _, ports, _, _, inputs = tiny_gpt
    on = port_decode(ports[True], inputs, max_new)
    off = port_decode(ports[False], inputs, max_new)
    assert on.steps == off.steps >= 5
    assert torch.equal(on.codes, off.codes) and torch.equal(on.lengths, off.lengths)


def test_beam3_with_flag_matches_jax(tiny_gpt, monkeypatch):
    """Greedy beam-3 with the flag: the port's eager arm (K5 plain) against
    the JAX `beam_decode` with the flag (K5 and K4 in interpret mode), on the
    int8 runtime trees; equal codes; both caches are a multiple of 512
    positions long."""
    params, _, int8, _, inputs = tiny_gpt
    seen_jax, seen_port = [], []
    import voice_tts_tpu.ops.decode_attention as jk5
    jax_k5 = jk5.decode_attention

    def jax_spy(q, k_cache, *a, **kw):
        seen_jax.append(k_cache.shape[3])
        return jax_k5(q, k_cache, *a, **kw)
    monkeypatch.setattr(jk5, "decode_attention", jax_spy)
    port_k5 = k5.decode_attention_plain

    def port_spy(q, k_cache, *a):
        seen_port.append(k_cache.shape[3])
        return port_k5(q, k_cache, *a)
    monkeypatch.setattr(k5, "decode_attention_plain", port_spy)

    model = JUV(dataclasses.replace(TINY, pallas_decode_attention=True))
    ref = jbeam.beam_decode(quantize_gpt_params(params), model,
                            JaxGenerationConfig(**dataclasses.asdict(BEAM3)),
                            *map(jnp.asarray, inputs), jax.random.PRNGKey(0), max_new=11)
    cond, emo, text, tlen = inputs
    out = pbeam.beam_decode(int8[True], BEAM3, t(cond), t(emo), t(text).long(),
                            t(tlen).long(), 11)
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    assert seen_jax and seen_port
    assert all(n % 512 == 0 for n in seen_jax + seen_port), (seen_jax, seen_port)


def counting(monkeypatch, module, name):
    """Replace module.name by a spy; returns its call list."""
    calls = []
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(a)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_gating_counts(tiny_gpt, monkeypatch):
    """The int8 runtime copy with the flag and a fused pack, folded readout
    and int8 KV passed, as the engine passes them: no fused step runs, K5
    runs once per layer and step over a float cache, and each of a layer's
    four projections is one K4 product a step; without the flag the fused
    step runs once a step its device loop executes (CHUNK a chunk, at most
    CHUNK - 1 of them after the stop)."""
    _, _, int8, state, inputs = tiny_gpt
    layers = TINY.layers
    k5_calls = counting(monkeypatch, k5, "decode_attention_plain")
    k4_calls = counting(monkeypatch, int8_matmul, "int8_gemv_plain")
    fused_calls = counting(monkeypatch, pdecode, "fused_decode_step")
    res = port_decode(int8[True], inputs, 12, fused_pack=pack_gpt(state, layers),
                      readout_pack=pack_readout(state), int8_kv=True)
    assert res.steps >= 5
    assert not fused_calls
    executed = res.chunks * CHUNK
    assert executed >= res.steps > executed - CHUNK
    assert len(k5_calls) == layers * executed
    assert all(a[1].dtype == torch.bfloat16 and a[1].shape[-1] % 512 == 0
               for a in k5_calls)
    assert len(k4_calls) == 4 * layers * executed
    # without the flag the same call takes the fused step and no K5
    k5_calls.clear()
    res = port_decode(int8[False], inputs, 12, fused_pack=pack_gpt(state, layers),
                      readout_pack=pack_readout(state))
    executed = res.chunks * CHUNK
    assert len(fused_calls) == executed and not k5_calls
    assert executed >= res.steps > executed - CHUNK


def test_spec_decode_ignores_flag(tiny_gpt, monkeypatch):
    """The JAX `spec_decode` does not read `pallas_decode_attention`, and
    neither does the port's: with the flag on, spec decode runs its packs
    (no K5) and emits the codes it emits with the flag off."""
    assert "pallas_decode_attention" not in inspect.getsource(jdecode.spec_decode)
    _, ports, int8, state, inputs = tiny_gpt
    k5_calls = counting(monkeypatch, k5, "decode_attention_plain")
    cond, emo, text, tlen = inputs
    master = ports[False].state_dict()
    runs = [pdecode.spec_decode(int8[flag], GREEDY, t(cond), t(emo), t(text).long(),
                                t(tlen).long(), 12, None, pack_gpt(state, TINY.layers),
                                pack_gpt_int4(master, TINY.layers, group=32), 4)
            for flag in (True, False)]
    assert not k5_calls
    assert torch.equal(runs[0].codes, runs[1].codes) and runs[0].rounds == runs[1].rounds


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("length", [5, 343, 1023])
def test_kernel_matches_plain_on_card(cuda_device, dtype, length):
    q, k, v, bias = (t(a).to(cuda_device) for a in attention_inputs(2))
    q, k, v = (a.to(dtype) for a in (q, k, v))
    out = k5.decode_attention(q, k, v, bias, length)
    torch.cuda.synchronize()
    ref = k5.decode_attention_plain(q, k, v, bias, length)
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = 1e-5 if dtype == torch.float32 else BF16_TOL
    assert err <= tol * scale, (err, scale)
