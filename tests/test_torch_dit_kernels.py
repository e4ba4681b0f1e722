"""The s2mel DiT kernel path of the port against the JAX package, on the CPU:
K9 (`ops/cfm_attention.py`), K11 (`ops/flash_attention.py`) and K8
(`ops/dit_blocks.py`), each plain version against the JAX kernel (K9 and K8
in interpret mode, K11 as jax's own flash kernel under
`force_tpu_interpret_mode`); the port's DiT with each flag against the JAX
DiT on the same parameters; a tiny engine with `use_bf16_s2mel` and
`fused_blocks` against the JAX tiny engine with the same flags, weights and
CFM noise.  Inputs come from numpy with a seed.  The `cuda` cases hold each
kernel against its plain version on the card and skip without one."""

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import DiTConfig, WaveNetConfig
from voice_tts_tpu_torch.engine.engine import TTSEngine, tiny_config
from voice_tts_tpu_torch.models.layers import init_weights
from voice_tts_tpu_torch.models.s2mel.dit import DiT
from voice_tts_tpu_torch.ops import cfm_attention as k9
from voice_tts_tpu_torch.ops import dit_blocks as k8
from voice_tts_tpu_torch.ops import flash_attention as k11
from voice_tts_tpu_torch.utils.convert import flatten_params, load_family

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import (BlockSizes,
                                                                 SegmentIds)
    from jax.experimental.pallas.ops.tpu.flash_attention import \
        flash_attention as jax_flash

    from voice_tts_tpu.config import DiTConfig as JDiTConfig
    from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
    from voice_tts_tpu.config import WaveNetConfig as JWaveNetConfig
    from voice_tts_tpu.engine.engine import TTSEngine as JaxEngine
    from voice_tts_tpu.models.s2mel.dit import DiT as JDiT
    from voice_tts_tpu.ops.attic import dit_blocks as jdb
    from voice_tts_tpu.ops.attic.cfm_attention import \
        cfm_attention as jax_cfm_attention
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

HD = 64
# f32: the same f32 arithmetic, sums in another order (as
# tests/test_cfm_attention.py holds the JAX kernel to its einsum)
F32_TOL = 2e-5
# bf16 inputs: scores and sums stay f32, but the probabilities and the
# output round to bf16 (8 significant bits); a sum in another order that
# flips one rounding moves an output by at most one bf16 ulp, 2^-8 of the
# largest magnitude (2^-10 seen)
BF16_TOL = 2 ** -8

# D 256, 4 heads of 64: the smallest width where `can_fuse_dit` holds
DCFG = dict(hidden_dim=256, depth=2, num_heads=4, in_channels=8, style_dim=12,
            content_dim=16)
WCFG = dict(hidden_dim=32, num_layers=2, kernel_size=3)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def qkv_inputs(b, h, tl, dtype, seed):
    """q, k, v (B, H, T, 64) from numpy, as JAX arrays and torch tensors of
    the same values in `dtype` ("f32" or "bf16")."""
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal((b, h, tl, HD)),
                        jnp.float32 if dtype == "f32" else jnp.bfloat16) for _ in range(3)]
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return arrs, [t(np.asarray(a, np.float32)).to(tdt) for a in arrs]


def assert_valid_rows_close(out, ref, lens, tol):
    """(B, H, T, hd) outputs agree at query rows < lens[b] within tol *
    max(1, max|ref|)."""
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    for i, n in enumerate(lens):
        err = np.abs(out[i, :, :n] - ref[i, :, :n]).max()
        scale = max(1.0, np.abs(ref[i, :, :n]).max())
        assert err <= tol * scale, (i, err, scale)


# ---------------------------------------------------------------------------
# K9 and K11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tl,lens", [(160, (160, 96)), (128, (50, 128)), (130, (1, 0)),
                                     (130, (65, 130)), (128, (0, 1))])
def test_cfm_attention_ref_matches_jax_kernel(tl, lens, dtype):
    """Every query row (K9 masks keys only), also at a T off the 64-key
    tile, one valid key, a tile edge, and lens 0: the uniform row.  The JAX
    kernel pads T to a multiple of 128 with zero keys that its lens mask
    covers too, so its lens-0 row averages the padded length (v's zero rows
    included); the port's averages the T keys, the JAX row times tp / T."""
    (qj, kj, vj), (q, k, v) = qkv_inputs(2, 4, tl, dtype, 0)
    ref = np.array(jax_cfm_attention(qj, kj, vj, jnp.asarray(lens, jnp.int32), HD ** -0.5,
                                     interpret=True).astype(jnp.float32))
    tp = -(-tl // 128) * 128
    for i, n in enumerate(lens):
        if n == 0:
            ref[i] *= tp / tl
    out = k9.cfm_attention(q, k, v, torch.tensor(lens), HD ** -0.5)
    assert out.dtype == q.dtype
    assert torch.isfinite(out.float()).all()
    assert_valid_rows_close(out, ref, (tl, tl), F32_TOL if dtype == "f32" else BF16_TOL)


def jax_flash_dit(q, k, v, lens):
    """jax's flash_attention as the DiT calls it (`dit.py:131-148`): T padded
    to a multiple of 128, key validity as segment ids, interpret mode."""
    b, h, tl, hd = q.shape
    pad = (-tl) % 128
    zq = ((0, 0), (0, 0), (0, pad), (0, 0))
    q, k, v = (jnp.pad(a, zq) for a in (q, k, v))
    valid = jnp.arange(tl)[None, :] < jnp.asarray(lens)[:, None]
    seg = jnp.pad(valid.astype(jnp.int32), ((0, 0), (0, pad)))
    tp = tl + pad
    blk = next(bs for bs in (512, 256, 128) if tp % bs == 0)
    sizes = BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1)
    with pltpu.force_tpu_interpret_mode():
        out = jax_flash(q, k, v, segment_ids=SegmentIds(seg, seg),
                        sm_scale=1.0 / np.sqrt(hd), block_sizes=sizes)
    return out[:, :, :tl]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tl,lens", [(160, (160, 96)), (256, (200, 256)), (130, (1, 65))])
def test_flash_attention_ref_matches_jax_flash(tl, lens, dtype):
    (qj, kj, vj), (q, k, v) = qkv_inputs(2, 2, tl, dtype, 1)
    ref = jax_flash_dit(qj, kj, vj, lens)
    seg = (torch.arange(tl)[None, :] < torch.tensor(lens)[:, None]).to(torch.int32)
    out = k11.flash_attention(q, k, v, seg, seg, HD ** -0.5)
    assert out.dtype == q.dtype
    assert_valid_rows_close(out, ref.astype(jnp.float32), lens,
                            F32_TOL if dtype == "f32" else BF16_TOL)


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dit_pair():
    """The JAX DiT and the port's (same parameters) at D 256, depth 2."""
    jdit = JDiT(JDiTConfig(**DCFG), JWaveNetConfig(**WCFG))
    b, tl = 2, 128
    params = jax.jit(jdit.init)(
        jax.random.PRNGKey(4), jnp.zeros((b, DCFG["in_channels"], tl)),
        jnp.zeros((b, DCFG["in_channels"], tl)), jnp.asarray([tl, 96]),
        jnp.full((b,), 0.3), jnp.zeros((b, DCFG["style_dim"])),
        jnp.zeros((b, tl, DCFG["content_dim"])))
    params = jax.tree.map(np.asarray, params)
    port = DiT(DiTConfig(**DCFG), WaveNetConfig(**WCFG))
    load_family(port, flatten_params(params)).eval()
    return jdit, params, port


def test_packs_match_jax(dit_pair):
    """pack_dit_blocks holds the JAX (depth, 5, 3, D, D) tiles' values
    (bit-equal: both round the same f32 weights to bf16), pack_dit_tables
    the JAX folded tables (bit-equal on the same step tables), rope_tables
    the JAX cos / sin (bit-equal)."""
    jdit, params, port = dit_pair
    d = DCFG["hidden_dim"]
    tiles = np.asarray(jdb.pack_dit_blocks(params, DCFG["depth"]).astype(jnp.float32))
    pack = k8.pack_dit_blocks(port)

    def tile(w):                      # a port (out, in) slice -> a JAX tile
        return w.float().t().numpy()
    for layer in range(DCFG["depth"]):
        w13 = pack.w13[layer].reshape(3 * d, 2, d)
        for j in range(3):
            cols = slice(j * d, (j + 1) * d)
            np.testing.assert_array_equal(tiles[layer, 0, j], tile(pack.wqkv[layer][cols]))
            np.testing.assert_array_equal(tiles[layer, 2 + j, 0], tile(w13[cols, 0]))
            np.testing.assert_array_equal(tiles[layer, 2 + j, 1], tile(w13[cols, 1]))
            np.testing.assert_array_equal(tiles[layer, 2 + j, 2],
                                          tile(pack.w2[layer][:, cols]))
        np.testing.assert_array_equal(tiles[layer, 1, 0], tile(pack.wo[layer]))

    t_span = jnp.asarray([0.12, 0.77])
    jtables = jdit.apply(params, t_span, method=JDiT.step_tables)
    ptables = {"blocks": tuple(tuple(t(a) for a in pair) for pair in jtables["blocks"])}
    np.testing.assert_array_equal(
        k8.pack_dit_tables(port, ptables).numpy(),
        np.asarray(jdb.pack_dit_tables(params, jtables, DCFG["depth"])))

    cos, sin, _ = jdb.rope_tables(704, HD, 10000.0)
    pcos, psin = k8.rope_tables(704, HD, 10000.0)
    np.testing.assert_array_equal(pcos.numpy(), np.asarray(cos))
    np.testing.assert_array_equal(psin.numpy(), np.asarray(sin))


# K8 against the interpret-mode JAX kernel: the same bf16 rounding points
# except RoPE, whose sin term the JAX kernel takes from bf16-rounded q and
# bf16 tables (the port rotates in f32 with f32 tables); the flipped bf16
# roundings of q and k that this causes move the two-layer trunk's output
# by about 4e-4 of its largest magnitude
K8_TOL = 2e-3


def test_block_chain_ref_matches_jax_kernel(dit_pair):
    jdit, params, port = dit_pair
    b, tl, d, heads = 2, 128, DCFG["hidden_dim"], DCFG["num_heads"]
    lens = (128, 96)
    rng = np.random.default_rng(7)
    h0 = (0.7 * rng.standard_normal((b, tl, d))).astype(np.float32)
    t_span = jnp.asarray([0.12, 0.77])
    jtables = jdit.apply(params, t_span, method=JDiT.step_tables)
    wb_all = jdb.pack_dit_tables(params, jtables, DCFG["depth"])
    tiles = jdb.pack_dit_blocks(params, DCFG["depth"])
    cos, sin, perm = jdb.rope_tables(tl, HD, 10000.0)
    pack = k8.pack_dit_blocks(port)
    pcos, psin = k8.rope_tables(tl, HD, 10000.0)
    for s in range(len(t_span)):
        ref = np.asarray(jdb.dit_block_chain(
            jnp.asarray(h0), tiles, wb_all[s], cos, sin, perm,
            jnp.asarray(lens, jnp.int32), heads, interpret=True))
        out = k8.dit_block_chain(t(h0), pack, t(wb_all[s]), pcos, psin,
                                 torch.tensor(lens), heads)
        assert out.dtype == torch.float32
        for i, n in enumerate(lens):
            err = np.abs(out[i, :n].numpy() - ref[i, :n]).max()
            assert err <= K8_TOL * np.abs(ref[i, :n]).max(), (s, i, err)


# ---------------------------------------------------------------------------
# the DiT with each flag, and the engine
# ---------------------------------------------------------------------------

# the einsum (JAX on the CPU) against K9 / K11's plain versions: f32 both,
# sums in another order through two blocks and the WaveNet head (1.3e-6 of
# the largest magnitude seen)
DIT_F32_TOL = 2e-5


@pytest.mark.parametrize("flag", ["fused_attention", "flash_attention", "fused_blocks"])
def test_dit_with_flag_matches_jax(dit_pair, flag):
    """The port's DiT with `flag` against the JAX DiT with the same flag and
    parameters, one step's tables: on the CPU the JAX DiT takes the einsum
    for K9 and K11 and runs K8 in interpret mode (`fused_w`)."""
    _, params, base = dit_pair
    b, tl, lens = 2, 128, (128, 96)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((b, DCFG["in_channels"], tl)).astype(np.float32)
    prompt = 0.2 * rng.standard_normal((b, DCFG["in_channels"], tl)).astype(np.float32)
    style = rng.standard_normal((b, DCFG["style_dim"])).astype(np.float32)
    cond = rng.standard_normal((b, tl, DCFG["content_dim"])).astype(np.float32)
    tt = np.full((b,), 0.4, np.float32)

    jdit = JDiT(JDiTConfig(**DCFG, **{flag: True}), JWaveNetConfig(**WCFG))
    jt = jdit.apply(params, jnp.asarray([0.4]), method=JDiT.step_tables)
    port = DiT(DiTConfig(**DCFG, **{flag: True}), WaveNetConfig(**WCFG))
    port.load_state_dict(base.state_dict())
    port.eval()
    pt = port.step_tables(torch.tensor([0.4]))
    jw = pw = None
    if flag == "fused_blocks":
        jt["fused_wb"] = jdb.pack_dit_tables(params, jt, DCFG["depth"])
        jw = jdb.pack_dit_blocks(params, DCFG["depth"])
        pt["fused_wb"] = k8.pack_dit_tables(port, pt)
        pw = k8.pack_dit_blocks(port)
    ref = np.asarray(jdit.apply(params, *map(jnp.asarray, (x, prompt, lens, tt, style, cond)),
                                tables=jax.tree.map(lambda a: a[0], jt), fused_w=jw))
    with torch.no_grad():
        out = port(t(x), t(prompt), torch.tensor(lens), t(tt), t(style), t(cond),
                   tables=DiT.table_step(pt, 0), fused_w=pw).numpy()
    tol = K8_TOL if flag == "fused_blocks" else DIT_F32_TOL
    for i, n in enumerate(lens):
        err = np.abs(out[i, :, :n] - ref[i, :, :n]).max()
        assert err <= tol * max(1.0, np.abs(ref[i, :, :n]).max()), (i, err)


def tiny_dit_config(**flags):
    """The tiny engine with its DiT widened to D 256, 4 heads (so that
    `can_fuse_dit` holds), bf16 s2mel and the K8 / K9 flags."""
    cfg = tiny_config(use_bf16_s2mel=True, **flags)
    d = cfg.s2mel.dit
    d.hidden_dim, d.num_heads = 256, 4
    d.fused_blocks = d.fused_attention = True
    cfg.s2mel.wavenet.hidden_dim = d.hidden_dim
    return cfg


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine.random(JaxTTSConfig.from_dict(tiny_dit_config().to_dict()), seed=0)
    params = jax.tree.map(np.asarray, jeng.params)
    peng = TTSEngine.from_jax_params(jeng.cfg, params, jeng.tokenizer, device="cpu")
    return jeng, peng


def s2mel_inputs(eng, seed, code_bucket=32, prompt_bucket=64):
    """Random s2mel-stage inputs at the tiny widths: GPT latent, codes and
    their length, prompt condition and mel, style."""
    cfg = eng.cfg
    rng = np.random.default_rng(seed)
    return dict(
        latent=rng.standard_normal((1, code_bucket, cfg.gpt.model_dim)).astype(np.float32),
        codes=rng.integers(0, cfg.semantic_codec.codebook_size, (1, code_bucket)),
        code_len=np.asarray([code_bucket - 2]),
        prompt_condition=rng.standard_normal(
            (1, prompt_bucket, cfg.s2mel.length_regulator.channels)).astype(np.float32),
        prompt_len=np.asarray([prompt_bucket - 7]),
        ref_mel=rng.standard_normal((1, cfg.mel.num_mels, prompt_bucket)).astype(np.float32),
        style=rng.standard_normal((1, cfg.campplus.embedding_size)).astype(np.float32))


# bf16 s2mel in both engines: XLA and PyTorch round the bf16 products and
# elementwise ops of the DiT, regulator and WaveNet head at other points, a
# bf16 ulp (2^-8) here and there over 4 Euler steps (1.3e-3 of the largest
# mel magnitude seen)
ENGINE_TOL = 1e-2


def test_engine_bf16_s2mel_fused_blocks_matches_jax(engines):
    """The s2mel stage of the tiny engine with `use_bf16_s2mel` and
    `fused_blocks` (K8 in the port, K8 in interpret mode in JAX) against the
    JAX engine's, same weights, inputs and CFM noise."""
    jeng, peng = engines
    inp = s2mel_inputs(peng, 3)
    cb = inp["codes"].shape[1]
    mb = peng._mel_bucket_for(cb)
    total = inp["prompt_condition"].shape[1] + mb
    assert peng.use_fused_dit(1, total)
    rng = jax.random.PRNGKey(11)
    ref, ref_len = jeng._s2mel_chain(
        jeng.params_s2mel_rt, jeng.params["repcodec"], jnp.asarray(inp["latent"]),
        jnp.asarray(inp["codes"], jnp.int32), jnp.asarray(inp["code_len"], jnp.int32),
        jnp.asarray(inp["prompt_condition"]), jnp.asarray(inp["prompt_len"], jnp.int32),
        jnp.asarray(inp["ref_mel"]), jnp.asarray(inp["style"]), rng, cb, mb)
    peng._draw_noise = lambda shape: t(jax.random.normal(rng, tuple(shape)))
    with torch.no_grad():
        out, out_len = peng._s2mel(
            t(inp["latent"]), torch.from_numpy(inp["codes"]),
            torch.from_numpy(inp["code_len"]), t(inp["prompt_condition"]),
            torch.from_numpy(inp["prompt_len"]), t(inp["ref_mel"]), t(inp["style"]), mb)
    assert int(out_len[0]) == int(ref_len[0])
    ref = np.asarray(ref, np.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = np.abs(out.numpy() - ref).max()
    assert err <= ENGINE_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_engine_picks_k8_or_k9(engines, monkeypatch):
    """The port's gate, as the JAX engine's: K8 runs the trunk once per
    velocity evaluation at batch 1 and prompt + mel buckets <= 768 frames;
    past 768 each block's attention runs K9.  On the CPU the wrappers take
    their plain versions (and count no launch), so the calls are counted
    here, at the functions the DiT calls."""
    _, peng = engines
    calls = {"k8": 0, "k9": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(k8, "dit_block_chain", spy("k8", k8.dit_block_chain))
    monkeypatch.setattr(k9, "cfm_attention", spy("k9", k9.cfm_attention))
    steps, depth = peng.cfg.engine.diffusion_steps, peng.cfg.s2mel.dit.depth
    inp = s2mel_inputs(peng, 4)
    args = (t(inp["latent"]), torch.from_numpy(inp["codes"]),
            torch.from_numpy(inp["code_len"]), t(inp["prompt_condition"]),
            torch.from_numpy(inp["prompt_len"]), t(inp["ref_mel"]), t(inp["style"]))
    for mel_bucket, want in ((64, {"k8": steps, "k9": 0}),
                             (720, {"k8": 0, "k9": steps * depth})):
        calls.update(k8=0, k9=0)
        assert peng.use_fused_dit(1, 64 + mel_bucket) == (want["k8"] > 0)
        with torch.no_grad():
            mel, _ = peng._s2mel(*args, mel_bucket)
        assert calls == want, (mel_bucket, calls)
        assert torch.isfinite(mel).all()
    assert not peng.use_fused_dit(2, 128)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cfm_attention", "flash_attention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tl,lens", [(200, (200, 77)), (65, (0, 1, 63, 64, 65, 65)),
                                     (130, (0, 1, 63, 64, 65, 130))])
def test_attention_kernel_matches_plain_on_card(cuda_device, kernel, dtype, tl, lens):
    """Every query row, also at the tile's edges: a ragged last key tile; K9
    at lens 0 (the uniform row), 1, 63, 64, 65 and T (the key loop stops at
    ceil(lens / 64) tiles); K11 on the same key segments with one query row
    whose segment matches no key (the uniform row)."""
    rng = np.random.default_rng(5)
    q, k, v = (t(rng.standard_normal((len(lens), 4, tl, HD))).to(cuda_device, dtype)
               for _ in range(3))
    lens_t = torch.tensor(lens, device=cuda_device)
    if kernel == "cfm_attention":
        args = (q, k, v, lens_t, HD ** -0.5)
        out, ref = k9.cfm_attention(*args), k9.cfm_attention_ref(*args)
    else:
        kv_seg = (torch.arange(tl, device=cuda_device)[None, :] < lens_t[:, None]).int()
        q_seg = kv_seg.clone()
        q_seg[:, tl // 2] = 2
        args = (q, k, v, q_seg, kv_seg, HD ** -0.5)
        out, ref = k11.flash_attention(*args), k11.flash_attention_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    # the kernel rounds the unnormalized probabilities, the plain K9 version
    # the normalized ones: one more bf16 ulp than against the JAX kernel
    assert_valid_rows_close(out.cpu(), ref.float().cpu().numpy(), [tl] * len(lens),
                            F32_TOL if dtype == torch.float32 else 2 * BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cfm_attention", "flash_attention"])
@pytest.mark.parametrize("bad", ["offset", "stride"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kernel_rejects_misaligned_bf16_on_card(cuda_device, kernel, bad, dtype):
    """Both tensor-core tiles copy 16-byte chunks: a view one element off, or
    with a time stride off the 16-byte grid (68 bf16, 66 f32 elements),
    raises instead of launching."""
    b, h, tl = 2, 4, 130
    n = b * h * tl * HD
    st = 68 if dtype == torch.bfloat16 else 66
    buf = torch.randn(b * h * tl * st + 8, device=cuda_device).to(dtype)
    good = buf[:n].view(b, h, tl, HD)
    q = (buf[1:n + 1].view(b, h, tl, HD) if bad == "offset"
         else buf.as_strided((b, h, tl, HD), (h * tl * st, tl * st, st, 1)))
    lens = torch.tensor([tl, 65], device=cuda_device)
    seg = (torch.arange(tl, device=cuda_device)[None, :] < lens[:, None]).int()
    with pytest.raises(ValueError, match="16-byte"):
        if kernel == "cfm_attention":
            k9.cfm_attention(q, good, good, lens, HD ** -0.5)
        else:
            k11.flash_attention(q, good, good, seg, seg, HD ** -0.5)


@pytest.mark.cuda
def test_block_chain_kernel_matches_plain_on_card(cuda_device):
    b, tl, d = 2, 150, DCFG["hidden_dim"]
    with torch.device(cuda_device):
        port = init_weights(DiT(DiTConfig(**DCFG), WaveNetConfig(**WCFG)),
                            torch.Generator(cuda_device).manual_seed(0)).eval()
    rng = np.random.default_rng(8)
    h0 = t(0.7 * rng.standard_normal((b, tl, d))).to(cuda_device)
    with torch.no_grad():
        pt = port.step_tables(torch.tensor([0.3], device=cuda_device))
        wb = k8.pack_dit_tables(port, pt)[0]
        pack = k8.pack_dit_blocks(port)
    cos, sin = k8.rope_tables(tl, HD, 10000.0, cuda_device)
    lens = torch.tensor([150, 101], device=cuda_device)
    out = k8.dit_block_chain(h0, pack, wb, cos, sin, lens, DCFG["num_heads"])
    torch.cuda.synchronize()
    ref = k8.dit_block_chain_ref(h0, pack, wb, cos, sin, lens, DCFG["num_heads"])
    for i, n in enumerate((150, 101)):
        err = float((out[i, :n] - ref[i, :n]).abs().max())
        assert err <= K8_TOL * float(ref[i, :n].abs().max()), (i, err)
