"""The port's CTC lattice (haloop_tpu_torch.ops.ctc, and ops.ctc_cuda on
CPU tensors) against the JAX package's plain trellis and its Pallas
kernel (K3, interpret mode), on the same numpy inputs.

Tolerance: fp32 lattices that sum exp/log terms in another order,
rel 1e-5 and abs 1e-4 on the per-item NLL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haloop_tpu.ops import ctc as jctc
from haloop_tpu.ops.ctc_pallas import ctc_loss_pallas
from haloop_tpu_torch.ops import ctc, ctc_cuda

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _case(seed, T=24, N=5, C=11, U=6):
    """Feasible items of unequal lengths: item 0 has an empty target,
    item 1 one label repeated U times."""
    rng = np.random.default_rng(seed)
    log_probs = _log_softmax(rng.normal(size=(T, N, C)) * 2)
    targets = rng.integers(1, C, size=(N, U))
    target_lengths = rng.integers(1, U + 1, size=N)
    target_lengths[0] = 0
    targets[1] = 3
    target_lengths[1] = U
    input_lengths = rng.integers(2 * U + 1, T + 1, size=N)
    return (log_probs, targets, input_lengths.astype(np.int32),
            target_lengths.astype(np.int32))


def _jax(fn, case, *extra):
    return np.asarray(fn(*(jnp.asarray(a) for a in case), *extra))


def _torch(fn, case, **kw):
    return fn(*(torch.from_numpy(np.asarray(a)) for a in case), **kw).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ctc_forward_score_matches_jax(seed):
    case = _case(seed)
    got = _torch(ctc.ctc_forward_score, case)
    np.testing.assert_allclose(got, _jax(jctc.ctc_forward_score, case),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax(ctc_loss_pallas, case, True),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_ctc_loss_wrapper_on_cpu_is_the_plain_version(seed):
    case = _case(seed, T=30, N=4, C=9, U=4)
    before = ctc_cuda.launches
    got = _torch(ctc_cuda.ctc_loss, case)
    assert ctc_cuda.launches == before           # no kernel on the CPU
    np.testing.assert_array_equal(got, _torch(ctc.ctc_forward_score, case))
    np.testing.assert_allclose(got, _jax(ctc_loss_pallas, case, True),
                               rtol=RTOL, atol=ATOL)


def test_infeasible_item_is_large_and_finite():
    """Too few frames for the labels: the plain lattice (port and JAX)
    gives -NEG_INF = 1e30, finite. (The CUDA kernel, like the Pallas one,
    masks with -1e9 and gives 1e9: tests/test_torch_kernels.py.)"""
    log_probs, targets, input_lengths, target_lengths = _case(1)
    input_lengths[2], target_lengths[2] = 3, 6
    case = (log_probs, targets, input_lengths, target_lengths)
    got = _torch(ctc.ctc_forward_score, case)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[2], 1e30, rtol=1e-6)
    np.testing.assert_allclose(got, _jax(jctc.ctc_forward_score, case),
                               rtol=RTOL, atol=ATOL)


def test_ctc_reduce_mean_matches_jax():
    rng = np.random.default_rng(0)
    losses = rng.uniform(1, 50, size=7).astype(np.float32)
    lengths = rng.integers(1, 9, size=7).astype(np.int32)
    got = ctc.ctc_reduce_mean(torch.from_numpy(losses),
                              torch.from_numpy(lengths)).item()
    want = float(jctc.ctc_reduce_mean(jnp.asarray(losses),
                                      jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_intersperse_blanks_matches_jax():
    targets = np.array([[5, 6, 7], [1, 1, 0]])
    got = ctc.intersperse_blanks(torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jctc.intersperse_blanks(jnp.asarray(targets))))


# ------------------------------------------------------------- gradients

def _grad_case(seed, infeasible=True):
    """_case's items (empty target, repeated labels) plus, with
    ``infeasible``, an item with too few frames for its labels."""
    log_probs, targets, input_lengths, target_lengths = _case(seed, N=6)
    if infeasible:
        input_lengths[2], target_lengths[2] = 4, 6
    g = np.random.default_rng(seed).uniform(0.5, 1.5, size=6)
    return (log_probs, targets, input_lengths, target_lengths), \
        g.astype(np.float32)


def _port_ctc_grad(case, g, fn=None):
    lp = torch.from_numpy(case[0]).requires_grad_(True)
    rest = [torch.from_numpy(np.asarray(a)) for a in case[1:]]
    loss = (fn or ctc_cuda.ctc_loss)(lp, *rest)
    (loss * torch.from_numpy(g)).sum().backward()
    return loss.detach().numpy(), lp.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_grads_match_pallas_kernel(seed):
    """The CTCLoss Function on CPU tensors (K3-with-history and K4's plain
    versions) against jax.grad of ctc_loss_pallas in interpret mode, with
    empty, repeated and infeasible items: rel/abs 1e-3, the JAX package's
    bound for its kernel (tests/test_lattice_kernels.py)."""
    case, g = _grad_case(seed)
    loss, got = _port_ctc_grad(case, g)
    jcase = [jnp.asarray(a) for a in case]
    jloss = np.asarray(ctc_loss_pallas(*jcase, True))
    want = np.asarray(jax.grad(lambda lp: jnp.sum(
        ctc_loss_pallas(lp, *jcase[1:], True) * jnp.asarray(g)))(jcase[0]))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_ctc_analytic_grad_matches_autograd():
    """ctc_grad on ctc_forward_history's lattice against torch.autograd
    through the plain ctc_forward_score, on feasible items: rel/abs 1e-4
    (fp32 lattices summed in another order)."""
    case, g = _grad_case(4, infeasible=False)
    loss, got = _port_ctc_grad(case, g)
    want_loss, want = _port_ctc_grad(case, g, fn=ctc.ctc_forward_score)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # d loss / d log_probs of one item sums to -g over its labels' frames:
    # every active frame's posterior mass is 1
    frames = case[2]
    np.testing.assert_allclose(got.sum(axis=2).sum(axis=0), -g * frames,
                               rtol=1e-4)


def test_ctc_grads_match_pallas_kernel_at_long_targets():
    """R3: a lattice of 1201 states (U = 600), past the card kernels' old
    1024, through the CTCLoss Function on CPU tensors against jax.grad of
    ctc_loss_pallas in interpret mode, T = 700, C = 40: loss rel 1e-5,
    grads rel/abs 1e-3 (the JAX package's bound for its kernel's grads;
    alphas and betas reach ~3,000 here, where one fp32 step is 2.4e-4)."""
    rng = np.random.default_rng(7)
    T, C, U = 700, 40, 600
    log_probs = _log_softmax(rng.normal(size=(T, 2, C)) * 2)
    targets = rng.integers(1, C, size=(2, U))
    case = (log_probs, targets, np.array([700, 650], np.int32),
            np.array([600, 300], np.int32))
    g = np.array([1.0, 0.5], np.float32)
    loss, got = _port_ctc_grad(case, g)
    jcase = [jnp.asarray(a) for a in case]
    jloss = np.asarray(ctc_loss_pallas(*jcase, True))
    want = np.asarray(jax.grad(lambda lp: jnp.sum(
        ctc_loss_pallas(lp, *jcase[1:], True) * jnp.asarray(g)))(jcase[0]))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
