"""Card-only tests: the forward-backward kernels as Triton compiles them for
a CUDA device, against the scan path on the same card.

Marked `gpu`: without a CUDA device they skip (the `cuda_device` fixture).
chip_smoke.py runs them on the card; the interpreter twins of these checks
run on the CPU in tests/test_pallas.py and tests/test_fb_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu import messages
from pysvihmm_tpu.messages.pallas_fb import pallas_forward_backward_batched
from pysvihmm_tpu.utils.precision import f32_matmuls

pytestmark = pytest.mark.gpu


def _problem(B, T, K, seed):
    r = np.random.default_rng(seed)
    return (
        jnp.asarray(np.log(r.dirichlet(np.ones(K))), jnp.float32),
        jnp.asarray(np.log(r.dirichlet(np.ones(K), size=K)), jnp.float32),
        jnp.asarray(r.normal(scale=3.0, size=(B, T, K)), jnp.float32),
        jnp.asarray((r.random((B, T)) > 0.3).astype(np.float32)),
    )


@pytest.mark.parametrize(
    "B,T,K,block_b",
    [(1024, 1000, 64, 16), (19, 17, 5, 16), (40, 70, 128, 32), (3, 1, 2, 16)],
)
def test_compiled_kernel_matches_scan(cuda_device, B, T, K, block_b):
    """Real widths and the padded corners (K below 16 and not a power of
    two, B not a multiple of the block, K=128, T=1) compile and agree with
    the scan path on the card."""
    log_pi, log_A, ll, w = _problem(B, T, K, seed=B + T + K)
    with jax.default_device(cuda_device):
        fb = pallas_forward_backward_batched(log_pi, log_A, ll, w, block_b=block_b)
        ref = jax.jit(f32_matmuls(lambda a, b, c, d: messages.e_step_batched(
            a, b, c, weights=d, method="scan")))(log_pi, log_A, ll, w)
    np.testing.assert_allclose(np.asarray(fb.gamma), np.asarray(ref.gamma), atol=1e-5)
    np.testing.assert_allclose(np.asarray(fb.log_z), np.asarray(ref.log_z), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(fb.trans_stats), np.asarray(ref.trans_stats),
        rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(ref.trans_stats)).max()),
    )
    np.testing.assert_allclose(np.asarray(fb.init_stats), np.asarray(ref.init_stats), atol=1e-5)


def test_auto_is_compiled_kernel(cuda_device):
    """On the card "auto" is the kernel, compiled (a Triton call in the
    optimized HLO), not the interpreter."""
    assert messages.resolve_method("auto") == "pallas"
    log_pi, log_A, ll, _ = _problem(16, 8, 16, seed=0)
    fn = jax.jit(lambda a, b, c: messages.e_step_batched(a, b, c).log_z)
    hlo = fn.lower(log_pi, log_A, ll).compile().as_text()
    assert "triton" in hlo.lower()
