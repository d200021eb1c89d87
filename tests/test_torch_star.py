"""The port's Star-CTC (haloop_tpu_torch ops/star, ops/star_cuda and the
Star-CTC branch of models/recognizer) against the JAX package's, on the
same numpy inputs.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode (``star_ctc_loss_pallas(..., interpret=True)``) and the
plain lattice ``star_ctc_forward_score``. Tolerances: the JAX package's
for its kernel against its lattice (tests/test_star_pallas.py), rtol 2e-5
and atol 2e-4 for losses and grads alike; ``intersperse_stars`` 1e-5
(one logsumexp and one logsubexp in fp32).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haloop_tpu.models import recognizer as JR
from haloop_tpu_torch import params as P
from haloop_tpu_torch.models import recognizer as R

# the modules, not the functions their packages re-export by these names
JS, JSP = (importlib.import_module(f"haloop_tpu.ops.{m}")
           for m in ("star", "star_pallas"))
TS, TSC = (importlib.import_module(f"haloop_tpu_torch.ops.{m}")
           for m in ("star", "star_cuda"))
torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-4)


def _data(T=25, N=3, V=12, S=4, seed=0, infeasible=False, full=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, N, V)).astype(np.float32)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    tg = rng.integers(1, V, (N, S)).astype(np.int32)
    il = rng.integers(max(T // 2, 4 * S + 3), T + 1, N).astype(np.int32)
    tl = rng.integers(1, S + 1, N).astype(np.int32)
    if full:                       # every frame used, full targets
        il[:], tl[:] = T, S
    if infeasible:                 # fewer frames than labels
        il[-1], tl[-1] = S - 1, S
    return lp, tg, il, tl


def test_logsubexp_matches_jax():
    """ops/semiring.logsubexp: close values, equal values (NEG_INF where
    the difference underflows) and NEG_INF operands, rel 1e-6."""
    from haloop_tpu.ops import semiring as JSR
    from haloop_tpu_torch.ops import semiring as TSR
    rng = np.random.default_rng(3)
    a = rng.normal(size=64).astype(np.float32) * 5
    b = a - np.abs(rng.normal(size=64)).astype(np.float32) * 3
    b[:8] = a[:8]                                  # exp(a) - exp(b) = 0
    b[8:16] = a[8:16] - 1e-7                       # within rounding of a
    b[16:24] = -1e30                               # log(exp(a))
    got = TSR.logsubexp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JSR.logsubexp(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got[:8] == TSR.NEG_INF).all()


@pytest.mark.parametrize("penalty", [0.0, -0.5, -2.0])
def test_intersperse_stars_matches_jax(penalty):
    lp, tg, _, _ = _data(seed=5)
    got, got_t = TS.intersperse_stars(torch.from_numpy(lp),
                                      torch.from_numpy(tg), penalty)
    want, want_t = JS.intersperse_stars(jnp.asarray(lp), jnp.asarray(tg),
                                        penalty)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("penalty", [0.0, -0.5, -2.0])
def test_star_forward_score_matches_jax(penalty):
    """The plain lattice (NEG_INF masks) against the JAX package's, and
    the kernels' numerics (``star_ctc_loss`` without grad) against both
    on feasible items."""
    args = _data(seed=1)
    want = np.asarray(JS.star_ctc_forward_score(
        *(jnp.asarray(a) for a in args), star_penalty=penalty))
    got = TS.star_ctc_forward_score(*(torch.from_numpy(a) for a in args),
                                    star_penalty=penalty)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    star_lp, star_targets = TS.intersperse_stars(
        torch.from_numpy(args[0]), torch.from_numpy(args[1]))
    loss, _ = TS.star_forward_history(star_lp, star_targets,
                                      torch.from_numpy(args[2]),
                                      torch.from_numpy(args[3]), penalty)
    np.testing.assert_allclose(loss.numpy(), want, **TOL)


@pytest.mark.parametrize("penalty", [0.0, -0.5, -2.0])
@pytest.mark.parametrize("kind", ["ragged", "full", "infeasible"])
def test_star_ctc_loss_and_grads_match_pallas(penalty, kind):
    """The StarCTCLoss Function on CPU tensors (the plain versions of
    K8a/K8b, chained through intersperse_stars) against the JAX
    package's Pallas kernels in interpret mode: losses and grads, an
    infeasible item (loss ~1e9 and the kernels' clipped gradients)
    included."""
    lp, tg, il, tl = _data(T=19, N=3, V=9, S=3, seed=2,
                           full=kind == "full",
                           infeasible=kind == "infeasible")
    g = np.array([1.0, 0.5, 2.0], np.float32)
    lpt = torch.from_numpy(lp).requires_grad_(True)
    got = TSC.star_ctc_loss(lpt, torch.from_numpy(tg), torch.from_numpy(il),
                            torch.from_numpy(tl), star_penalty=penalty)
    (got * torch.from_numpy(g)).sum().backward()

    def f(lp):
        return JSP.star_ctc_loss_pallas(lp, jnp.asarray(tg), jnp.asarray(il),
                                        jnp.asarray(tl), star_penalty=penalty,
                                        interpret=True)
    want, vjp = jax.vjp(f, jnp.asarray(lp))
    (gw,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lpt.grad.numpy(), np.asarray(gw), **TOL)
    if kind == "infeasible":
        assert got[-1].item() > 1e8


@pytest.mark.parametrize("penalty", [0.0, -0.5, -2.0])
@pytest.mark.parametrize("kind", ["ragged", "full", "infeasible"])
def test_star_forward_history_matches_pallas(penalty, kind):
    """K8a's plain version, ``star_forward_history``: its loss and its
    alpha history (N, T, 4U+3), the lattice frozen past each item's
    length, against the JAX package's forward kernel in interpret mode
    (``_lattice_fwd``: its history's state lanes PAD .. PAD + S), within
    TOL; the history is the forward's only product the backward reads."""
    lp, tg, il, tl = _data(T=19, N=3, V=9, S=3, seed=2,
                           full=kind == "full",
                           infeasible=kind == "infeasible")
    star_lp, star_targets = JS.intersperse_stars(jnp.asarray(lp),
                                                 jnp.asarray(tg))
    want, res = JSP._lattice_fwd(star_lp, star_targets, jnp.asarray(il),
                                 jnp.asarray(tl), penalty, True)
    T, N = lp.shape[:2]
    S = 4 * tg.shape[1] + 3
    want_hist = np.asarray(res[3])[:N, :T, JSP.PAD:JSP.PAD + S]
    loss, hist = TS.star_forward_history(
        torch.from_numpy(np.array(star_lp)),
        torch.from_numpy(np.array(star_targets)), torch.from_numpy(il),
        torch.from_numpy(tl), penalty)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hist.numpy(), want_hist, **TOL)
    for n, length in enumerate(il):
        assert (hist[n, max(length, 1) - 1:] == hist[n, -1]).all()


def test_star_ctc_loss_and_grads_match_pallas_at_long_targets():
    """R3: a lattice of 1203 states (U = 300), past the card kernels' old
    1019, through the StarCTCLoss Function on CPU tensors against the JAX
    package's Pallas kernels in interpret mode, T = 700, V = 40: losses
    and grads within TOL, as at the short lattices above."""
    rng = np.random.default_rng(8)
    T, V, U = 700, 40, 300
    x = rng.normal(size=(T, 2, V)).astype(np.float32) * 2
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    tg = rng.integers(1, V, (2, U)).astype(np.int32)
    il, tl = np.array([700, 640], np.int32), np.array([300, 150], np.int32)
    g = np.array([1.0, 0.5], np.float32)
    lpt = torch.from_numpy(lp).requires_grad_(True)
    got = TSC.star_ctc_loss(lpt, torch.from_numpy(tg), torch.from_numpy(il),
                            torch.from_numpy(tl), star_penalty=-0.5)
    (got * torch.from_numpy(g)).sum().backward()

    def f(lp):
        return JSP.star_ctc_loss_pallas(lp, jnp.asarray(tg), jnp.asarray(il),
                                        jnp.asarray(tl), star_penalty=-0.5,
                                        interpret=True)
    want, vjp = jax.vjp(f, jnp.asarray(lp))
    (gw,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lpt.grad.numpy(), np.asarray(gw), **TOL)


@pytest.mark.parametrize("kind", ["feasible", "infeasible", "full"])
def test_star_grad_masked_back_edge_into_a_lanes_first_state_adds_nothing(
        monkeypatch, kind):
    """K8b leaves out the back-edge term of the blanks at s = 0 mod 4 (a
    sweep lane's first state, whose s-1 is the previous lane's): the edge
    is masked there, and the plain star_grad without the term gives the
    same bits, infeasible items (whose gradients come from masked paths)
    included."""
    lp, tg, il, tl = _data(seed=11, infeasible=kind == "infeasible",
                           full=kind == "full")
    star_lp, star_targets = TS.intersperse_stars(
        torch.from_numpy(lp), torch.from_numpy(tg).long(), -0.5)
    args = (star_lp, star_targets, torch.from_numpy(il),
            torch.from_numpy(tl))
    loss, hist = TS.star_forward_history(*args, -0.5)
    g = torch.tensor([1.0, 0.5, 2.0])
    want = TS.star_grad(*args, hist, loss, g, -0.5)
    lse = TS._lse

    def without(*xs):
        if len(xs) == 6:                # the backward stencil, s-1 last
            back = xs[5].clone()
            back[:, 0::4] = TS.FILL
            xs = (*xs[:5], back)
        return lse(*xs)
    monkeypatch.setattr(TS, "_lse", without)
    got = TS.star_grad(*args, hist, loss, g, -0.5)
    assert torch.equal(got, want)
    if kind == "infeasible":
        assert loss[-1].item() > 1e8 and got[:, -1].abs().max() > 0


def test_star_ctc_loss_without_grad_is_the_plain_lattice():
    """Serving on the CPU takes the JAX package's plain lattice, as its
    dispatch does without the kernels."""
    args = _data(seed=3)
    with torch.no_grad():
        got = TSC.star_ctc_loss(*(torch.from_numpy(a) for a in args),
                                star_penalty=-0.5)
    want = TS.star_ctc_forward_score(*(torch.from_numpy(a) for a in args),
                                     star_penalty=-0.5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernels", ["0", "1"])
def test_temporal_classifier_star_loss_matches_jax(monkeypatch, kernels):
    """The recognizer's Star-CTC branch: loss and classifier grads
    against the JAX package's, with its plain lattice (HALOOP_KERNELS=0)
    and its Pallas kernels interpreted (HALOOP_KERNELS=1)."""
    monkeypatch.setenv("HALOOP_KERNELS", kernels)
    lp, tg, il, tl = _data(T=15, N=2, V=8, S=3, seed=4)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, 15, 6)).astype(np.float32)
    jp = JR.temporal_classifier_init(jax.random.PRNGKey(0), 6, 8)
    want, gw = jax.value_and_grad(lambda p: JR.temporal_classifier_loss(
        p, jnp.asarray(feats), jnp.asarray(tg), jnp.asarray(il),
        jnp.asarray(tl), star_penalty=-0.5)[0])(jp)
    tp = P.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    names = list(tp["classifier"])
    leaves = [tp["classifier"][k].requires_grad_(True) for k in names]
    got, _ = R.temporal_classifier_loss(
        tp, torch.from_numpy(feats), torch.from_numpy(tg),
        torch.from_numpy(il), torch.from_numpy(tl), star_penalty=-0.5)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for g, name in zip(grads, names):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(gw["classifier"][name]), **TOL)
