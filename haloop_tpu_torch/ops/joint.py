"""The RNN-T joint's logsumexp over the vocabulary, plain versions
(haloop_tpu/ops/joint_pallas.py).

    lse[n, t, u] = logsumexp_v(f[n, t, v] + g[n, u, v])

The transducer loss needs only this (N, T, U+1) reduction of the additive
joint f[:, :, None] + g[:, None], never the (N, T, U+1, V) joint itself.
``pairwise_lse`` and ``pairwise_lse_grad`` are the plain versions of
kernels K9a and K9b (``ops/joint_cuda.py``) in their numerics.
``pairwise_lse`` takes the factored form

    lse = mf[n, t] + mg[n, u] + log(s),
    s   = sum_v e^(f[n, t, v] - mf[n, t]) e^(g[n, u, v] - mg[n, u])

with mf, mg the row maxima over v: an fp32 product of the exponentiated
rows, N (T + U+1) V exponentials instead of N T (U+1) V. Where f and g
peak at different v the two shifts can overshoot max_v(f + g) so far
that every product underflows; a cell whose s is under ``TINY`` = 2^-64
(or 0) is marked (``marks``) and recomputed exactly: the max over v of f +
g, then the sum of exps. The underflowed products lose at most V 2^-126,
2^-42 of TINY for V <= 2^20.

``pairwise_lse_grad`` takes the same factored form for the backward. With
p = dlse e^(f + g - lse), the joint softmax weighted by the upstream
gradient,

    W  = dlse e^(mf + mg - lse)             (N, T, U+1)
    df = e^(f - mf) * (W  . e^(g - mg))     (T x U+1) . (U+1 x V)
    dg = e^(g - mg) * (W^T . e^(f - mf))    (U+1 x T) . (T x V)

two fp32 products and the same N (T + U+1) V exponentials. A cell is
marked where mf + mg - lse > ``MARK`` = 64 ln 2, that is where its factored
sum is under TINY: there W would pass 2^64 dlse (or overflow), so its W is
0 and its exact term p is added to df and dg. An unmarked cell has W <=
2^64 |dlse|, so a product that underflows (a factor under 2^-126) loses
less than 2^-62 |dlse| a column. W is 0 by a select, not a product, where
dlse is 0 (frames past an item's length): df is exactly 0 there and an
overflowed e^(mf + mg - lse) never meets a 0. ``pairwise_lse_reference``
and ``pairwise_lse_grad_reference`` are the oracles: the materialized
joint, and the direct sum of p over each (t, u).
"""

import math

import torch

TINY = 2.0 ** -64     # a cell's factored sum under this is recomputed
MARK = 64 * math.log(2)   # -ln(TINY): mf + mg - lse above it is marked


def _factored(f, g):
    """(mf (N, T), mg (N, U+1), s (N, T, U+1)): the row maxima and the
    sum of the products of the exponentiated rows, fp32."""
    mf = f.amax(dim=-1)
    mg = g.amax(dim=-1)
    s = torch.bmm(torch.exp(f - mf[..., None]),
                  torch.exp(g - mg[..., None]).transpose(1, 2))
    return mf, mg, s


def marks(f, g):
    """(N, T, U+1) bool: the cells whose factored sum is under TINY, which
    ``pairwise_lse`` (and K9a) recompute exactly."""
    return _factored(f.float(), g.float())[2] < TINY


def pairwise_lse(f, g):
    """f (N, T, V), g (N, U+1, V) -> (lse (N, T, U+1), mf (N, T), mg (N,
    U+1)) fp32: the logsumexp and the row maxima the backward takes, as
    K9a writes them."""
    f, g = f.float(), g.float()
    mf, mg, s = _factored(f, g)
    lse = mf[..., None] + mg[:, None] + torch.log(s)
    n, t, u = torch.nonzero(s < TINY, as_tuple=True)
    if n.numel():
        fg = f[n, t] + g[n, u]                               # (marked, V)
        m = fg.max(dim=-1, keepdim=True).values
        lse[n, t, u] = m[:, 0] + torch.log(torch.exp(fg - m).sum(dim=-1))
    return lse, mf, mg


def _exponent(lse, mf, mg):
    """mf + mg - lse (N, T, U+1) in fp32 with the rounding of mf + mg put
    back (Knuth's two-sum): where mf + mg is ~100 and lse as close, a plain
    fp32 sum would leave W off by its ulp, a relative 4e-6."""
    a, b = mf[..., None], mg[:, None]
    s = a + b
    bb = s - a
    return (s - lse) + ((a - (s - bb)) + (b - bb))


def grad_marks(lse, dlse, mf, mg):
    """(N, T, U+1) bool: the cells the backward takes exactly (its
    factored weight would pass 2^64 dlse) among those with dlse != 0."""
    return (_exponent(lse, mf, mg) > MARK) & (dlse != 0)


def _grad_factored(f, g, lse, dlse, mf, mg):
    """(df, dg, marked): the factored products alone, every marked
    cell's weight 0 (``pairwise_lse_grad`` adds their exact terms)."""
    e = _exponent(lse, mf, mg)                               # (N, T, U+1)
    marked = grad_marks(lse, dlse, mf, mg)
    w = torch.where((dlse == 0) | (e > MARK), torch.zeros_like(e),
                    dlse * torch.exp(e))
    ef = torch.exp(f - mf[..., None])
    eg = torch.exp(g - mg[..., None])
    df = ef * torch.bmm(w, eg)
    dg = eg * torch.bmm(w.transpose(1, 2), ef)
    return df, dg, marked


def pairwise_lse_grad(f, g, lse, dlse, mf, mg):
    """The analytic backward in the factored form, fp32: f (N, T, V), g
    (N, U+1, V), lse and dlse (N, T, U+1), the forward's row maxima mf (N,
    T) and mg (N, U+1) -> (df, dg). Rows whose dlse is 0 (frames past an
    item's length) contribute nothing."""
    f, g = f.float(), g.float()
    lse, dlse = lse.float(), dlse.float()
    df, dg, marked = _grad_factored(f, g, lse, dlse, mf.float(), mg.float())
    n, t, u = torch.nonzero(marked, as_tuple=True)
    if n.numel():
        p = dlse[n, t, u, None] * torch.exp(f[n, t] + g[n, u] -
                                            lse[n, t, u, None])  # (marked, V)
        df.index_put_((n, t), p, accumulate=True)
        dg.index_put_((n, u), p, accumulate=True)
    return df, dg


def pairwise_lse_reference(f, g):
    """Oracle: the logsumexp of the materialized joint."""
    return torch.logsumexp(f[:, :, None, :].float() + g[:, None, :, :].float(),
                           dim=-1)


def pairwise_lse_grad_reference(f, g, lse, dlse):
    """Oracle of the backward: with p[n, t, u, v] = exp(f + g - lse) *
    dlse, df = sum_u p and dg = sum_t p, in fp32, one (t, u) slice of the
    joint at a time."""
    f, g = f.float(), g.float()
    df = torch.zeros_like(f)
    dg = torch.empty_like(g)
    for u in range(g.shape[1]):
        p = torch.exp(f + g[:, u, None, :] - lse[:, :, u, None]) * \
            dlse[:, :, u, None]                              # (N, T, V)
        df += p
        dg[:, u] = p.sum(dim=1)
    return df, dg
