"""The f32 DiT attention tile's arithmetic on the CPU: K9's and K11's split
plain versions (`cfm_attention_split_plain`, `flash_attention_split_plain`:
three-pass split-TF32 products through `ops/tf32.py`, an online softmax over
64-key tiles, K9's key loop stopping at ceil(lens / 64) tiles) against the
JAX kernel in interpret mode and jax's flash kernel under
`force_tpu_interpret_mode`, at the cases `test_torch_dit_kernels.py` holds
the plain versions to, f32, F32_TOL; then against the plain versions on
every row at the tile's edges the card tests use, and one TF32 pass
against three.  Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.ops import cfm_attention as k9
from voice_tts_tpu_torch.ops import flash_attention as k11
from voice_tts_tpu_torch.ops import tf32

import test_torch_dit_kernels as tdk   # noqa: E402 - imports JAX only if it is there

pytest_plugins = ("port_fixtures",)

if tdk.jax is not None:
    import jax.numpy as jnp
    from voice_tts_tpu.ops.attic.cfm_attention import \
        cfm_attention as jax_cfm_attention

HD = tdk.HD
F32_TOL = tdk.F32_TOL


@pytest.mark.parametrize("tl,lens", [(160, (160, 96)), (128, (50, 128)), (130, (1, 0)),
                                     (130, (65, 130)), (128, (0, 1))])
def test_cfm_attention_split_plain_matches_jax_kernel(tl, lens):
    """Every query row, as `test_cfm_attention_ref_matches_jax_kernel`: the
    JAX kernel's lens-0 row averages its T padded to 128, the port's the T
    keys (the JAX row times tp / T)."""
    (qj, kj, vj), (q, k, v) = tdk.qkv_inputs(2, 4, tl, "f32", 0)
    ref = np.array(jax_cfm_attention(qj, kj, vj, jnp.asarray(lens, jnp.int32), HD ** -0.5,
                                     interpret=True))
    tp = -(-tl // 128) * 128
    for i, n in enumerate(lens):
        if n == 0:
            ref[i] *= tp / tl
    out = k9.cfm_attention_split_plain(q, k, v, torch.tensor(lens), HD ** -0.5)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    tdk.assert_valid_rows_close(out, ref, (tl, tl), F32_TOL)


@pytest.mark.parametrize("tl,lens", [(160, (160, 96)), (256, (200, 256)), (130, (1, 65))])
def test_flash_attention_split_plain_matches_jax_flash(tl, lens):
    (qj, kj, vj), (q, k, v) = tdk.qkv_inputs(2, 2, tl, "f32", 1)
    ref = tdk.jax_flash_dit(qj, kj, vj, lens)
    seg = (torch.arange(tl)[None, :] < torch.tensor(lens)[:, None]).to(torch.int32)
    out = k11.flash_attention_split_plain(q, k, v, seg, seg, HD ** -0.5)
    assert out.dtype == torch.float32
    tdk.assert_valid_rows_close(out, np.asarray(ref), lens, F32_TOL)


def edge_inputs(tl, lens, seed=5):
    """The card tests' edge case: q, k, v (len(lens), 4, T, 64) and K11's
    segment ids (keys < lens[b] in segment 1, one query row in segment 2,
    matching no key)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((len(lens), 4, tl, HD)).astype(np.float32))
               for _ in range(3))
    kv_seg = (torch.arange(tl)[None, :] < torch.tensor(lens)[:, None]).to(torch.int32)
    q_seg = kv_seg.clone()
    q_seg[:, tl // 2] = 2
    return q, k, v, q_seg, kv_seg


@pytest.mark.parametrize("tl", [65, 130])
def test_split_plain_matches_plain_at_tile_edges(tl):
    """Every row at a ragged last key tile: K9 at lens 0 (the uniform row),
    1, 63, 64, 65 and T (the loop stops at ceil(lens / 64) tiles); K11 on
    the same key segments with a query row that matches no key."""
    lens = (0, 1, 63, 64, 65, tl)
    q, k, v, q_seg, kv_seg = edge_inputs(tl, lens)
    lens_t = torch.tensor(lens)
    for out, ref in ((k9.cfm_attention_split_plain(q, k, v, lens_t, HD ** -0.5),
                      k9.cfm_attention_ref(q, k, v, lens_t, HD ** -0.5)),
                     (k11.flash_attention_split_plain(q, k, v, q_seg, kv_seg, HD ** -0.5),
                      k11.flash_attention_ref(q, k, v, q_seg, kv_seg, HD ** -0.5))):
        assert torch.isfinite(out).all()
        tdk.assert_valid_rows_close(out, ref.numpy(), [tl] * len(lens), F32_TOL)


def test_trunc_split():
    """The tile's split: hi and lo have TF32's bits only, hi is v truncated
    (within 2^-10 of |v|), and hi + lo is v within 2^-20 of |v|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(20000).astype(np.float32))
    x[:3] = torch.tensor([0.0, 1.0 + 2 ** -11, -(3.0 + 2 ** -9)])
    hi, lo = tf32.split_tf32_trunc(x)
    for part in (hi, lo):
        assert torch.equal(part.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    assert hi[0] == 0 and lo[0] == 0 and hi[1] == 1.0 and lo[1] == 2 ** -11 and hi[2] == x[2]
    assert bool(((hi.abs() <= x.abs()) & (hi * x >= 0)).all())
    assert float(((x - hi).abs() / x.abs().clamp_min(1e-30)).max()) <= 2 ** -10
    err = (x.double() - hi.double() - lo.double()).abs() / x.abs().double().clamp_min(1e-30)
    assert float(err.max()) <= 2 ** -20


def test_key_tiles():
    assert k9.key_tiles(130, [0, 1, 63, 64, 65, 130, -3]) == [3, 1, 1, 1, 2, 3, 3]
    assert k9.key_tiles(64, [64, 200]) == [1, 1]


def test_one_tf32_pass_misses_f32_tol(monkeypatch):
    """Why the tile takes three passes: with q, k, p and v rounded to TF32
    once (hi.hi alone) the same tiles miss F32_TOL; the split holds it."""
    tl, lens = 160, (160, 96)
    q, k, v, _, _ = edge_inputs(tl, lens, seed=2)
    q, k = 4 * q, 4 * k                       # scores of a few units, as a trained DiT's
    lens_t = torch.tensor(lens)
    ref = k9.cfm_attention_ref(q, k, v, lens_t, HD ** -0.5).numpy()
    tdk.assert_valid_rows_close(k9.cfm_attention_split_plain(q, k, v, lens_t, HD ** -0.5),
                                ref, lens, F32_TOL)
    monkeypatch.setattr(k9, "split_matmul",
                        lambda a, b: tf32.tf32_round(a) @ tf32.tf32_round(b))
    with pytest.raises(AssertionError):
        tdk.assert_valid_rows_close(k9.cfm_attention_split_plain(q, k, v, lens_t, HD ** -0.5),
                                    ref, lens, F32_TOL)
