"""K2 anti-aliased snake activation: the port's plain PyTorch version
against the JAX package's `_aa_snake_jnp` and its Pallas kernel in
interpret mode (`_aa_snake_pallas(interpret=True)`, small-tile path).

Tolerance 1e-5 absolute at O(1) magnitudes: the same f32 arithmetic in
the same tap order, so differences are a few f32 ulp from sin and from
how the two backends fuse multiply-adds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voice_tts_tpu.ops import aa_activation as jax_aa
from voice_tts_tpu_torch.ops import aa_activation as port_aa

pytest_plugins = ("port_fixtures",)

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _inputs(b, c, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, t)).astype(np.float32)
    alpha = np.exp(0.3 * rng.standard_normal(c)).astype(np.float32)
    beta_recip = (1.0 / (np.exp(0.3 * rng.standard_normal(c)) + 1e-9)).astype(np.float32)
    return x, alpha, beta_recip


def _port(x, alpha, beta_recip):
    return port_aa.aa_snake_activation(torch.from_numpy(x), torch.from_numpy(alpha),
                                       torch.from_numpy(beta_recip)).numpy()


def test_filter_matches_jax():
    np.testing.assert_array_equal(port_aa._FILTER12, jax_aa._FILTER12)


@pytest.mark.parametrize("t", [1, 3, 7, 8, 64, 301])
def test_plain_matches_jax_jnp(t):
    x, a, br = _inputs(2, 5, t, seed=t)
    ref = np.asarray(jax_aa._aa_snake_jnp(jnp.asarray(x), jnp.asarray(a),
                                          jnp.asarray(br)))
    out = _port(x, a, br)
    assert out.shape == ref.shape == x.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    # the edge samples, where the phase-edge replication rule applies
    np.testing.assert_allclose(out[..., :4], ref[..., :4], atol=TOL, rtol=0)
    np.testing.assert_allclose(out[..., -4:], ref[..., -4:], atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [5, 40])
def test_plain_matches_pallas_interpret(t):
    x, a, br = _inputs(1, 10, t, seed=100 + t)
    ref = np.asarray(jax_aa._aa_snake_pallas(jnp.asarray(x), jnp.asarray(a),
                                             jnp.asarray(br), interpret=True))
    np.testing.assert_allclose(_port(x, a, br), ref, atol=TOL, rtol=0)


def test_dtype_round_trip():
    """bf16 input computes in f32 and returns bf16 (as the JAX entry)."""
    x, a, br = _inputs(1, 3, 20, seed=7)
    out = port_aa.aa_snake_activation(torch.from_numpy(x).to(torch.bfloat16),
                                      torch.from_numpy(a), torch.from_numpy(br))
    assert out.dtype == torch.bfloat16


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    x, a, br = _inputs(1, 24, 5000, seed=3)
    xs = [torch.from_numpy(v).to(cuda_device) for v in (x, a, br)]
    out = port_aa.aa_snake_cuda(*xs).cpu().numpy()
    np.testing.assert_allclose(out, port_aa.aa_snake_plain(*xs).cpu().numpy(),
                               atol=TOL, rtol=0)
