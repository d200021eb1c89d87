"""The port's RNN transducer (haloop_tpu_torch ops/scan, ops/transducer,
ops/joint, models/rnn decoder, models/recognizer Transducer) against the
JAX package's, on the same numpy inputs and transplanted params.

Tolerances: values 1e-5 (one fp32 lattice or logsumexp each, summed in
another order); gradients rtol 1e-3, atol 1e-4 (the JAX package's bound
for its joint kernel, tests/test_lattice_kernels.py). The loss runs the
prediction net in bf16 in both packages: against the JAX package's
Pallas kernels (interpret mode, HALOOP_KERNELS=1), whose bf16 rounding
the port's kernels share, the loss within rel 1e-5 and the prediction
net's grads within 2^-6 of each leaf's largest magnitude (two bf16
steps: the bf16 grads of the prediction net are sums of bf16 products);
against its plain bf16 ``lax.scan`` (HALOOP_KERNELS=0), which also rounds
gates and cells to bf16, the loss within rel 1e-3 and those grads within
2^-5. The greedy decode: hyps and lengths exactly, scores and entropies
within 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haloop_tpu.models import recognizer as JR, rnn as JRNN
from haloop_tpu_torch import params as P
from haloop_tpu_torch.models import recognizer as R, rnn as RNN

# the modules, not the functions their packages re-export by these names
JS, JT, JJ = (importlib.import_module(f"haloop_tpu.ops.{m}")
              for m in ("scan", "transducer", "joint_pallas"))
TS, TT, TJ, TJC = (importlib.import_module(f"haloop_tpu_torch.ops.{m}")
                   for m in ("scan", "transducer", "joint", "joint_cuda"))
torch.set_num_threads(1)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _log_softmax(x):
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


# ------------------------------------------------------------ scanrec_log

@pytest.mark.parametrize("seed", [0, 1])
def test_scanrec_log_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 37)).astype(np.float32)
    b = rng.normal(size=(3, 37)).astype(np.float32)
    w[:, 0] = -1e30                        # NEG_INF, as the lattice has it
    got = TS.scanrec_log(torch.from_numpy(w), torch.from_numpy(b), dim=1)
    want = JS.scanrec_log(jnp.asarray(w), jnp.asarray(b), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    seq = TS.scanrec_log_sequential(torch.from_numpy(w),
                                    torch.from_numpy(b), dim=1)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=1e-5,
                               rtol=1e-5)


# -------------------------------------------------------------- lattice

def _lattice_inputs(seed, N=3, T=13, U=5, K=11):
    rng = np.random.default_rng(seed)
    joint = _log_softmax(rng.normal(size=(N, T, U + 1, K))).astype(
        np.float32)
    targets = rng.integers(1, K, (N, U)).astype(np.int32)
    joint_lengths = np.array([T, T - 4, 0][:N], np.int32)   # a zero-length item
    target_lengths = np.array([U, 2, 3][:N], np.int32)
    return joint, targets, joint_lengths, target_lengths


@pytest.mark.parametrize("seed", [0, 1])
def test_transducer_forward_score_matches_jax(seed):
    args = _lattice_inputs(seed)
    got = TT.transducer_forward_score(*(torch.from_numpy(a) for a in args))
    want = JT.transducer_forward_score(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and the loops, on the items with frames
    seq = TT.transducer_forward_score_sequential(*(a[:2] for a in args))
    np.testing.assert_allclose(got.numpy()[:2], seq, rtol=1e-5, atol=1e-5)


def test_transducer_forward_score_grads_match_jax():
    joint, targets, jl, tl = _lattice_inputs(2)
    jt = torch.from_numpy(joint).requires_grad_(True)
    TT.transducer_forward_score(jt, torch.from_numpy(targets),
                                torch.from_numpy(jl),
                                torch.from_numpy(tl)).sum().backward()
    want = jax.grad(lambda j: JT.transducer_forward_score(
        j, jnp.asarray(targets), jnp.asarray(jl), jnp.asarray(tl)).sum())(
        jnp.asarray(joint))
    np.testing.assert_allclose(jt.grad.numpy(), np.asarray(want), **GRAD_TOL)


# ----------------------------------------------------------------- joint

def _fg(seed, N=2, T=9, U1=5, V=19):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, T, V)).astype(np.float32) * 3,
            rng.normal(size=(N, U1, V)).astype(np.float32) * 3,
            rng.normal(size=(N, T, U1)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_lse_matches_jax(seed):
    f, g, _ = _fg(seed)
    got = TJC.pairwise_lse(torch.from_numpy(f), torch.from_numpy(g))
    want = JJ.pairwise_lse(jnp.asarray(f), jnp.asarray(g), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    ref = TJ.pairwise_lse_reference(torch.from_numpy(f), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-6)


def _peaks(every):
    """f at +100 on one v and g at +100 on another, the rest N(0, 1): the
    factored form's sum underflows at the cell of f's row 2 and g's row 1
    (``every``: +200 on every row, every cell)."""
    f, g, _ = _fg(5, N=2, T=7, U1=4, V=40)
    f, g = f / 3, g / 3
    if every:
        f[..., 0], g[..., 1] = 200.0, 200.0
    else:
        f[0, 2, 3], g[0, 1, 30] = 100.0, 100.0
    return f, g


FACTORED_CASES = {
    "disjoint peaks": lambda: _peaks(False),
    "every cell marked": lambda: _peaks(True),
    "V = 16384": lambda: _fg(3, N=1, T=6, U1=3, V=16384)[:2],
    "V = 1": lambda: _fg(4, N=2, T=5, U1=3, V=1)[:2],
}


@pytest.mark.parametrize("case", list(FACTORED_CASES))
def test_pairwise_lse_factored_cases_match_jax(case):
    """The plain factored pairwise_lse (K9a's numerics: the product of the
    exponentiated rows, the cells whose sum underflows recomputed exactly)
    against the JAX kernel in interpret mode and the materialized joint,
    where the fix-up is taken, past the parent kernel's vocabulary limit,
    and at V = 1."""
    f, g = FACTORED_CASES[case]()
    ft, gt = torch.from_numpy(f), torch.from_numpy(g)
    got = TJC.pairwise_lse(ft, gt)
    want = JJ.pairwise_lse(jnp.asarray(f), jnp.asarray(g), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               TJ.pairwise_lse_reference(ft, gt).numpy(),
                               atol=1e-5, rtol=1e-6)
    marks = TJ.marks(ft, gt)
    if case == "disjoint peaks":
        expect = torch.zeros_like(marks)
        expect[0, 2, 1] = True
        assert torch.equal(marks, expect)
    elif case == "every cell marked":
        assert marks.all()
    else:
        assert not marks.any()


def test_pairwise_lse_grads_match_jax():
    f, g, dl = _fg(2)
    dl[1, 6:] = 0.0                  # frames past an item's length
    ft = torch.from_numpy(f).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    (TJC.pairwise_lse(ft, gt) * torch.from_numpy(dl)).sum().backward()
    df, dg = jax.grad(lambda f, g: (JJ.pairwise_lse(f, g, True) * dl).sum(),
                      argnums=(0, 1))(jnp.asarray(f), jnp.asarray(g))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(df), **GRAD_TOL)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(dg), **GRAD_TOL)
    assert not ft.grad[1, 6:].any()


def _grad_case(case):
    """(f, g, dlse) of a factored-backward case: the disjoint peaks (the
    cell (0, 2, 1) marked), every cell marked, or every cell marked with
    the rows of item 0 past frame 2 at dlse = 0 (there e^(mf + mg - lse)
    overflows to inf, which the select keeps from meeting the 0)."""
    f, g = _peaks(case != "disjoint peaks")
    dl = _fg(6, N=2, T=7, U1=4)[2]
    if case == "rows with dlse = 0":
        dl[0, 2:] = 0.0
    return f, g, dl


@pytest.mark.parametrize("case", ["disjoint peaks", "every cell marked",
                                  "rows with dlse = 0"])
def test_pairwise_lse_grad_factored_cases_match_jax(case):
    """The plain factored pairwise_lse_grad (K9b's numerics: the products
    of the exponentiated rows with the weights W, the marked cells' exact
    terms added) through autograd against the JAX kernel's VJP in
    interpret mode, and against the direct oracle on the same lse."""
    f, g, dl = _grad_case(case)
    ft = torch.from_numpy(f).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    (TJC.pairwise_lse(ft, gt) * torch.from_numpy(dl)).sum().backward()
    df, dg = jax.grad(lambda f, g: (JJ.pairwise_lse(f, g, True) * dl).sum(),
                      argnums=(0, 1))(jnp.asarray(f), jnp.asarray(g))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(df), **GRAD_TOL)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(dg), **GRAD_TOL)
    fd, gd, dlt = ft.detach(), gt.detach(), torch.from_numpy(dl)
    lse, mf, mg = TJ.pairwise_lse(fd, gd)
    rf, rg = TJ.pairwise_lse_grad_reference(fd, gd, lse, dlt)
    np.testing.assert_allclose(ft.grad.numpy(), rf.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(gt.grad.numpy(), rg.numpy(), **GRAD_TOL)
    marked = TJ.grad_marks(lse, dlt, mf, mg)
    if case == "disjoint peaks":
        expect = torch.zeros_like(marked)
        expect[0, 2, 1] = True
        assert torch.equal(marked, expect)
    else:
        assert torch.equal(marked, dlt != 0) and marked.any()
    if case == "rows with dlse = 0":
        assert not ft.grad[0, 2:].any()
        assert torch.isfinite(ft.grad).all() and torch.isfinite(gt.grad).all()


def _at_threshold(ulps):
    """f, g with f's row 1 at +46.4 on v = 2 and g's row 2 on v = 20 (the
    rest N(0, 1)), dlse, and the plain forward's (lse, mf, mg) with
    lse[0, 1, 2] moved (by about 0.04) so that mf + mg - lse, in fp32 as
    the backward computes it, is joint.MARK's fp32 value exactly, ``ulps``
    fp32 steps of lse below it (then over the threshold)."""
    f, g, dl = _fg(7, N=1, T=4, U1=3, V=24)
    f, g = f / 3, g / 3
    f[0, 1, 2], g[0, 2, 20] = 46.4, 46.4
    lse, mf, mg = TJ.pairwise_lse(torch.from_numpy(f), torch.from_numpy(g))
    lse = lse.numpy().copy()
    s = np.float32(mf[0, 1].item()) + np.float32(mg[0, 2].item())
    mark = np.float32(TJ.MARK)
    x = np.float32(s - mark)
    for step in (0, 1, -1, 2, -2):
        y = np.nextafter(x, np.float32(np.inf * step)) if step else x
        for _ in range(abs(step) - 1):
            y = np.nextafter(y, np.float32(np.inf * step))
        if np.float32(s - y) == mark:
            break
    assert np.float32(s - y) == mark
    assert abs(float(y) - float(lse[0, 1, 2])) < 0.1    # near the true lse
    for _ in range(ulps):
        y = np.nextafter(y, np.float32(-np.inf))
    lse[0, 1, 2] = y
    return f, g, dl, torch.from_numpy(lse), mf, mg


@pytest.mark.parametrize("ulps", [0, 1])
def test_pairwise_lse_grad_at_the_marking_threshold(ulps):
    """A cell whose mf + mg - lse is the threshold itself (unmarked: W =
    2^64 dlse, the peaks' products ~2^-64) and one fp32 step of lse past
    it (marked: the exact term): the plain factored gradient against the
    JAX kernel's backward (interpret mode) and the direct oracle, on the
    same lse."""
    f, g, dl, lse, mf, mg = _at_threshold(ulps)
    ft, gt, dlt = (torch.from_numpy(a) for a in (f, g, dl))
    marked = TJ.grad_marks(lse, dlt, mf, mg)
    assert bool(marked[0, 1, 2]) == (ulps > 0)
    assert int(marked.sum()) == (ulps > 0)
    df, dg = TJ.pairwise_lse_grad(ft, gt, lse, dlt, mf, mg)
    jdf, jdg = JJ._lse_bwd_impl(jnp.asarray(f), jnp.asarray(g),
                                jnp.asarray(lse.numpy()), jnp.asarray(dl),
                                True)
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), **GRAD_TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), **GRAD_TOL)
    rf, rg = TJ.pairwise_lse_grad_reference(ft, gt, lse, dlt)
    np.testing.assert_allclose(df.numpy(), rf.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dg.numpy(), rg.numpy(), **GRAD_TOL)
    # the cell's own term is large: the threshold cell carries weight
    assert abs(float(rf[0, 1, 2])) > 1e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_lse_grad_factored_is_nearer_exact_at_large_logits(seed):
    """g's rows peaking at 30 to 112 (as a trained prediction net's can),
    f small: the factored gradient, its exponent mf + mg - lse taken with
    the rounding of mf + mg put back, lies within 2e-6 of the exact sums
    (fp64 from the same lse) and at least 5x nearer them than the direct
    fp32 form, whose f + g rounds at the peaks' ulp (read 15-25x)."""
    rng = np.random.default_rng(seed)
    f = (rng.normal(size=(2, 9, 19)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 5, 19)).astype(np.float32)
    g[:, :, 0] += np.linspace(30, 112, 5, dtype=np.float32)
    ft, gt, dlt = (torch.from_numpy(a) for a in
                   (f, g, rng.normal(size=(2, 9, 5)).astype(np.float32)))
    lse, mf, mg = TJ.pairwise_lse(ft, gt)
    exact = [torch.zeros((2, 9, 19), dtype=torch.float64),
             torch.zeros((2, 5, 19), dtype=torch.float64)]
    for u in range(5):
        p = torch.exp(ft.double() + gt[:, u, None].double() -
                      lse[:, :, u, None].double()) * \
            dlt[:, :, u, None].double()
        exact[0] += p
        exact[1][:, u] = p.sum(dim=1)

    def err(grads):
        return max((a.double() - b).abs().max().item()
                   for a, b in zip(grads, exact))
    factored = err(TJ.pairwise_lse_grad(ft, gt, lse, dlt, mf, mg))
    direct = err(TJ.pairwise_lse_grad_reference(ft, gt, lse, dlt))
    assert factored <= 2e-6 and 5 * factored <= direct, (factored, direct)


def test_pairwise_lse_grad_at_long_targets():
    """U+1 = 2049 (the parent kernel refused past 1,816): the plain
    factored gradient against the direct oracle only (the JAX kernel
    unrolls U+1 in Python, minutes to trace at this size)."""
    f, g, dl = _fg(8, N=1, T=3, U1=2049, V=20)
    ft, gt, dlt = (torch.from_numpy(a) for a in (f, g, dl))
    lse, mf, mg = TJ.pairwise_lse(ft, gt)
    df, dg = TJ.pairwise_lse_grad(ft, gt, lse, dlt, mf, mg)
    rf, rg = TJ.pairwise_lse_grad_reference(ft, gt, lse, dlt)
    np.testing.assert_allclose(df.numpy(), rf.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dg.numpy(), rg.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- decoder

@pytest.fixture(scope="module")
def head():
    jp = JR.transducer_init(jax.random.PRNGKey(0), feat_dim=16,
                            vocab_size=24, lm_dim=16, lm_layers=2)
    return jp, P.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def test_decoder_apply_and_step_match_jax(head):
    """fp32: the prediction net over a whole sequence and step by step."""
    jp, tp = head
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 24, (3, 6)).astype(np.int32)
    state = JRNN.decoder_init_hidden(2, 3, 16)
    want, (wh, wc) = JRNN.decoder_apply(jp["lm"], jnp.asarray(ids), state,
                                        num_layers=2, batch_first=True)
    got, (h, c) = RNN.decoder_apply(tp["lm"], torch.from_numpy(ids),
                                    RNN.decoder_init_hidden(2, 3, 16),
                                    num_layers=2, batch_first=True)
    for a, b in ((got, want), (h, wh), (c, wc)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)
    tstate, jstate = RNN.decoder_init_hidden(2, 3, 16), state
    for k in range(ids.shape[1]):
        tl, tstate = RNN.decoder_step(tp["lm"], torch.from_numpy(ids[:, k]),
                                      tstate, num_layers=2)
        jl, jstate = JRNN.decoder_step(jp["lm"], jnp.asarray(ids[:, k]),
                                       jstate, num_layers=2)
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.detach().numpy(), got[:, -1].detach()
                               .numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the loss

def _loss_batch(seed=1, N=3, T=20, F=16, V=24, U=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, T, F)).astype(np.float32),
            rng.integers(1, V, (N, U)).astype(np.int32),
            np.array([T, T - 6, 9][:N], np.int32),
            np.array([U, 3, 0][:N], np.int32))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("kernels,loss_rtol,lm_step", [
    ("1", 1e-5, 2 ** -6),      # the Pallas kernels, interpreted
    ("0", 1e-3, 2 ** -5),      # the plain bf16 lax.scan
])
def test_transducer_loss_and_grads_match_jax(head, monkeypatch, kernels,
                                             loss_rtol, lm_step):
    monkeypatch.setenv("HALOOP_KERNELS", kernels)
    jp, tp = head
    batch = _loss_batch()
    want, gw = jax.value_and_grad(lambda p: JR.transducer_loss(
        p, *(jnp.asarray(a) for a in batch), lm_dim=16)[0])(jp)
    leaves = [leaf.clone().requires_grad_(True)
              for leaf in P.tree_leaves(tp)]
    it = iter(leaves)
    params = P.tree_map(lambda _: next(it), tp)
    got, _ = R.transducer_loss(params, *(torch.from_numpy(a) for a in batch),
                               lm_dim=16)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=loss_rtol)
    gw = jax.tree.map(np.asarray, gw)
    for (path, _), g in zip(_paths(tp), grads):
        w = gw
        for k in path:
            w = w[k]
        if path[0] == "lm":
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=lm_step * np.abs(w).max())
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=loss_rtol,
                                       atol=lm_step * np.abs(w).max())


# ------------------------------------------------------------ the decode

@pytest.mark.parametrize("blank_bias,max_symbols", [(0.0, None), (2.5, 6),
                                                    (4.0, None)])
def test_transducer_greedy_decode_matches_jax(head, blank_bias, max_symbols):
    """Items that emit, blank and stop on the symbol budget; a
    zero-length row starts done."""
    jp, tp = head
    jp = jax.tree.map(lambda x: x, jp)
    jp["classifier"] = dict(jp["classifier"])
    jp["classifier"]["bias"] = jp["classifier"]["bias"].at[0].add(blank_bias)
    tp = P.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    feats, _, lengths, _ = _loss_batch(seed=4, N=3)
    lengths[2] = 0
    with torch.no_grad():
        got = R.transducer_greedy_decode(tp, torch.from_numpy(feats),
                                         torch.from_numpy(lengths),
                                         lm_dim=16, max_symbols=max_symbols)
    want = JR.transducer_greedy_decode(jp, jnp.asarray(feats),
                                       jnp.asarray(lengths), lm_dim=16,
                                       max_symbols=max_symbols)
    hyps, lens, ent, score = (t.numpy() for t in got)
    jhyps, jlens, jent, jscore = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_array_equal(hyps, jhyps)
    np.testing.assert_allclose(score, jscore, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ent, jent, rtol=1e-4, atol=1e-4)
    assert lens[2] == 0 and score[2] == 0
