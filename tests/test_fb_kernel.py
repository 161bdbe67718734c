"""The forward-backward kernel (messages/pallas_fb.py) against the float64
oracle, in the Pallas interpreter on the CPU: every shape corner the
Triton route pads (K below 16 or not a power of two, B not a multiple of
the 16-row block, T of 1 and 2), SVI kept-masks, underflow, padded rows,
the method switch, and the lowering for CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu import messages
from pysvihmm_tpu.messages.pallas_fb import pallas_forward_backward_batched
from pysvihmm_tpu.oracle import numpy_ref as oracle


def _oracle(log_pi, log_A, ll, w=None):
    """float64 reference for a batch: gamma (B,T,K), summed pair-gated xi,
    log_z (B,), init_stats (B,K)."""
    A = np.exp(log_A)
    gams, xi, zs = [], 0.0, []
    for b in range(ll.shape[0]):
        alpha, beta, gamma, xi_sum, log_z = oracle.forward_backward(log_pi, log_A, ll[b])
        gams.append(gamma)
        zs.append(log_z)
        if w is None:
            xi = xi + xi_sum
            continue
        lik = np.exp(ll[b] - ll[b].max(axis=1, keepdims=True))
        x = alpha[:-1, :, None] * A * (lik[1:] * beta[1:])[:, None, :]
        x /= x.sum(axis=(1, 2), keepdims=True)
        xi = xi + np.einsum("t,tij->ij", w[b, :-1] * w[b, 1:], x)
    gamma = np.stack(gams)
    init = gamma[:, 0] if w is None else gamma[:, 0] * w[:, :1]
    return gamma, np.asarray(xi), np.array(zs), init


def _problem(B, T, K, seed, scale=2.0):
    r = np.random.default_rng(seed)
    log_pi = np.log(r.dirichlet(np.ones(K)))
    log_A = np.log(r.dirichlet(np.ones(K), size=K))
    ll = r.normal(scale=scale, size=(B, T, K))
    w = (r.random((B, T)) > 0.3).astype(np.float64)
    return log_pi, log_A, ll, w


def _run(log_pi, log_A, ll, w=None, **kw):
    f32 = lambda x: None if x is None else jnp.asarray(x, jnp.float32)
    return pallas_forward_backward_batched(
        f32(log_pi), f32(log_A), f32(ll), f32(w), interpret=True, **kw
    )


def _assert_matches(fb, ref, log_z_rtol=1e-5):
    gamma, xi, log_z, init = ref
    np.testing.assert_allclose(np.asarray(fb.log_z), log_z, rtol=log_z_rtol, atol=1e-4)
    assert np.abs(np.asarray(fb.gamma, np.float64) - gamma).max() <= 1e-4
    scale = max(np.abs(xi).max(), 1.0)
    assert np.abs(np.asarray(fb.trans_stats, np.float64) - xi).max() / scale <= 1e-4
    assert np.abs(np.asarray(fb.init_stats, np.float64) - init).max() <= 1e-4
    np.testing.assert_allclose(
        np.asarray(fb.log_c, np.float64).sum(-1), log_z, rtol=log_z_rtol, atol=1e-4
    )


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("T", [1, 2, 17, 1000])
@pytest.mark.parametrize("K", [2, 3, 5, 8, 16, 64])
def test_kernel_matches_f64_oracle(K, T, weighted):
    """B=19 is not a multiple of the 16-row block: the last block is
    mostly padding, which must not leak into any statistic."""
    log_pi, log_A, ll, w = _problem(19, T, K, seed=K * 1000 + T)
    w = w if weighted else None
    _assert_matches(_run(log_pi, log_A, ll, w), _oracle(log_pi, log_A, ll, w))


@pytest.mark.parametrize("case", ["huge_loglik", "near_zero_transitions", "one_hot_lik"])
def test_underflow_cases(case):
    """Per-step scales far outside f32's range stay finite and exact: the
    max shift absorbs huge log-likelihoods, and the per-sequence renorm
    every step absorbs transition mass of e^-60 per step."""
    B, T, K = 5, 300, 8
    log_pi, log_A, ll, _ = _problem(B, T, K, seed=3)
    if case == "huge_loglik":
        ll = ll * 400.0
    elif case == "near_zero_transitions":
        off = ~np.eye(K, dtype=bool)
        log_A = np.where(off, -60.0, 0.0)
        log_A = log_A - np.log(np.exp(log_A).sum(1, keepdims=True))
    else:  # each step's evidence names one state, the rest sit 80 nats below
        r = np.random.default_rng(4)
        ll = np.full((B, T, K), -80.0)
        ll[np.arange(B)[:, None], np.arange(T)[None, :], r.integers(0, K, (B, T))] = 0.0
    fb = _run(log_pi, log_A, ll)
    for leaf in jax.tree.leaves(fb):
        assert np.isfinite(np.asarray(leaf)).all(), case
    _assert_matches(fb, _oracle(log_pi, log_A, ll))


@pytest.mark.parametrize("B", [1, 15, 17, 33])
def test_padded_rows_give_zero_stats(B):
    """Rows added to fill the last block, and rows whose kept-mask is all
    zero, add nothing to the summed statistics."""
    log_pi, log_A, ll, _ = _problem(B, 12, 5, seed=B)
    fb = _run(log_pi, log_A, ll)
    _, xi, _, init = _oracle(log_pi, log_A, ll)
    np.testing.assert_allclose(np.asarray(fb.trans_stats), xi, rtol=1e-5, atol=1e-5)
    assert fb.gamma.shape == (B, 12, 5) and fb.log_c.shape == (B, 12)
    # the same rows plus B all-masked rows: identical sums, zero init rows
    w = np.concatenate([np.ones((B, 12)), np.zeros((B, 12))])
    ll2 = np.concatenate([ll, ll[::-1]])
    fb2 = _run(log_pi, log_A, ll2, w)
    np.testing.assert_allclose(np.asarray(fb2.trans_stats), xi, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(fb2.init_stats[B:]), 0.0)


@pytest.mark.parametrize(
    "cuda,method,expect",
    [(False, "auto", "scan"), (True, "auto", "pallas"), (False, "pallas", "pallas"),
     (True, "scan", "scan"), (True, "blocked", "blocked"), (False, "assoc", "assoc")],
)
def test_resolve_method(monkeypatch, cuda, method, expect):
    """"auto" is the kernel exactly when computations run on CUDA; an
    explicit method passes through on any backend."""
    monkeypatch.setattr(messages, "on_cuda", lambda: cuda)
    assert messages.resolve_method(method) == expect


def test_on_cuda_false_on_cpu():
    assert messages.on_cuda() is False
    assert messages.resolve_method("auto") == "scan"


@pytest.mark.parametrize("method", ["fused", "mosaic"])
@pytest.mark.parametrize("cuda", [False, True])
def test_unknown_method_raises(monkeypatch, cuda, method):
    """A method outside messages.METHODS (the removed fully-fused route
    among them) raises on every backend instead of falling back."""
    monkeypatch.setattr(messages, "on_cuda", lambda: cuda)
    with pytest.raises(ValueError, match="unknown E-step method"):
        messages.resolve_method(method)


@pytest.mark.parametrize("entry", ["e_step_batched", "batch_local_step", "kernel"])
def test_kernel_without_interpret_raises_on_cpu(entry):
    """No silent interpreter: off CUDA the kernel runs only when the caller
    asks for the interpreter."""
    log_pi, log_A, ll, _ = _problem(4, 8, 4, seed=0)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    if entry == "e_step_batched":
        call = lambda: messages.e_step_batched(f32(log_pi), f32(log_A), f32(ll), method="pallas")
    elif entry == "kernel":
        call = lambda: pallas_forward_backward_batched(f32(log_pi), f32(log_A), f32(ll))
    else:
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines.base import batch_local_step
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), 3, 2, 2, 8)
        prior = make_prior(3, GaussianNIW, obs_dim=2)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        call = lambda: batch_local_step(params, GaussianNIW, obs, "pallas")
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("B,T,K", [(1024, 1000, 64), (19, 17, 5), (5, 1, 128)])
def test_kernel_lowers_for_cuda(B, T, K):
    """The Triton lowering (run here, without a card) accepts every
    primitive the kernels use at these shapes; ptxas itself runs only on
    the card (tests/test_gpu_kernels.py)."""
    args = (jnp.zeros(K), jnp.zeros((K, K)), jnp.zeros((B, T, K)), jnp.ones((B, T)))
    lowered = jax.jit(pallas_forward_backward_batched).trace(*args).lower(
        lowering_platforms=("cuda",)
    )
    assert "triton" in lowered.as_text()
