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
2^-42 of TINY for V <= 2^20. ``pairwise_lse_grad`` forms the backward's
joint softmax p = exp(f + g - lse) * dlse once for both df and dg.
``pairwise_lse_reference`` is the oracle: the materialized joint.
"""

import torch

TINY = 2.0 ** -64     # a cell's factored sum under this is recomputed


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
    """f (N, T, V), g (N, U+1, V) -> lse (N, T, U+1) fp32."""
    f, g = f.float(), g.float()
    mf, mg, s = _factored(f, g)
    lse = mf[..., None] + mg[:, None] + torch.log(s)
    n, t, u = torch.nonzero(s < TINY, as_tuple=True)
    if n.numel():
        fg = f[n, t] + g[n, u]                               # (marked, V)
        m = fg.max(dim=-1, keepdim=True).values
        lse[n, t, u] = m[:, 0] + torch.log(torch.exp(fg - m).sum(dim=-1))
    return lse


def pairwise_lse_grad(f, g, lse, dlse):
    """The analytic backward: with p[n, t, u, v] = exp(f + g - lse) *
    dlse, df = sum_u p and dg = sum_t p, in fp32. Rows whose dlse is 0
    (frames past an item's length) contribute nothing."""
    f, g = f.float(), g.float()
    df = torch.zeros_like(f)
    dg = torch.empty_like(g)
    for u in range(g.shape[1]):
        p = torch.exp(f + g[:, u, None, :] - lse[:, :, u, None]) * \
            dlse[:, :, u, None]                              # (N, T, V)
        df += p
        dg[:, u] = p.sum(dim=1)
    return df, dg


def pairwise_lse_reference(f, g):
    """Oracle: the logsumexp of the materialized joint."""
    return torch.logsumexp(f[:, :, None, :].float() + g[:, None, :, :].float(),
                           dim=-1)
