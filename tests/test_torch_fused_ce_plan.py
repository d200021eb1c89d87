"""The bf16 design of kernel K10 (``csrc/fused_ce.cu`` ``wg::ce``) on the
CPU: its launch plan (``ops/fused_ce_cuda.plan``) and the kernel's
arithmetic emulated item by item, held against the plain ``ce_nll_lse``
and the JAX package's Pallas kernel (interpret mode) on the same numpy
inputs.

The emulation follows the kernel: each work item (128-row tile, vocab
chunk) walks its chunk's 256-column vocab tiles in order; a tile's
logits are fp32 sums of the bf16 products, the columns past V (zeros
from TMA) masked to -inf in the last tile only; each row keeps a running
max in base 2 (log2(e) folded into the exponent), a sum of exp2 and the
target logit (the one column equal to the target, 0 for a target
outside [0, V)); the item writes them to its chunk, and the chunks are
merged in chunk order in natural units.

Tolerances: the emulation against ``ce_nll_lse`` within
``chip_smoke.CE_TOL`` (a logsumexp over the row's logits summed in
another order; the same limit as the card's check), and against the JAX
kernel 1e-5 in fp32 (one fp32 logsumexp in another order,
tests/test_torch_attention.py). The two planted faults of
``chip_smoke.py`` phase 14 (the last tile's V mask dropped, one chunk
left out of the merge) must read beyond CE_TOL.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from haloop_tpu.ops import fused_ce as JCE
from haloop_tpu_torch.ops import fused_ce, fused_ce_cuda

torch.set_num_threads(1)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
# (N, V, D): hap's and hala's loss, then ragged edges of rows and vocab
PLAN_SHAPES = [(16384, 50304, 768), (8192, 50304, 768), (2048, 50304, 768),
               (1, 50304, 768), (129, 4099, 768), (65, 257, 64),
               (1, 255, 64), (8192, 50257, 768), (300, 5000, 64)]


def tiles_by_block(p):
    """{block: [(row tile, vocab tile), ...]} in the order each
    persistent block of the bf16 kernel runs them."""
    out = {}
    for item in range(p.items):
        rt, vt0, vt1 = fused_ce_cuda.item_tiles(p, item)
        out.setdefault(item % p.grid, []).extend(
            (rt, vt) for vt in range(vt0, vt1))
    return out


@pytest.mark.parametrize("N,V,D", PLAN_SHAPES)
def test_plan_covers_every_tile_once(N, V, D):
    p = fused_ce_cuda.plan(N, V, D, 132)
    assert p.row_tiles == -(-N // 128) and p.vocab_tiles == -(-V // 256)
    assert p.items == p.row_tiles * p.chunks and p.grid == min(p.items, 132)
    seen = [t for tiles in tiles_by_block(p).values() for t in tiles]
    assert sorted(seen) == [(rt, vt) for rt in range(p.row_tiles)
                            for vt in range(p.vocab_tiles)]
    # no empty chunk
    assert all(vt1 > vt0 for vt0, vt1 in
               (fused_ce_cuda.vocab_range(p, c) for c in range(p.chunks)))


@pytest.mark.parametrize("N,V,D", PLAN_SHAPES)
def test_plan_is_chunk_major_and_the_same_on_every_call(N, V, D):
    p = fused_ce_cuda.plan(N, V, D, 132)
    fused_ce_cuda.plan.cache_clear()
    assert fused_ce_cuda.plan(N, V, D, 132) == p
    # consecutive items share a chunk (and so their w tiles) and walk the
    # row tiles: the first wave's blocks read the same w tiles
    for item in range(p.items):
        rt, vt0, _ = fused_ce_cuda.item_tiles(p, item)
        assert rt == item % p.row_tiles
        assert (vt0, fused_ce_cuda.vocab_range(p, item // p.row_tiles)[1]) \
            == fused_ce_cuda.vocab_range(p, item // p.row_tiles)
    starts = [fused_ce_cuda.item_tiles(p, i)[1] for i in range(p.items)]
    assert starts == sorted(starts)


def test_plan_balances_the_main_paths():
    """hap's and hala's loss shapes fill the card's 132 SMs with items of
    one size, and the busiest block runs within 1% of the mean tiles."""
    for N in (16384, 8192):
        p = fused_ce_cuda.plan(N, 50304, 768, 132)
        assert p.grid == 132
        load = [len(t) for t in tiles_by_block(p).values()]
        assert max(load) <= 1.01 * sum(load) / len(load)


def emulate(x, w, targets, p, drop_mask=False, skip_chunk=None):
    """The bf16 kernel's arithmetic (fp32 here), item by item -> (nll,
    lse). ``drop_mask`` and ``skip_chunk`` plant the two faults."""
    N, V = x.shape[0], w.shape[0]
    wp = torch.zeros((p.vocab_tiles * 256, w.shape[1]), dtype=w.dtype)
    wp[:V] = w
    t = targets.long()
    t = torch.where((t >= 0) & (t < V), t, torch.full_like(t, -1))
    part = torch.zeros((p.chunks, 3, N), dtype=torch.float32)
    for item in range(p.items):
        rt, vt0, vt1 = fused_ce_cuda.item_tiles(p, item)
        rows = slice(rt * 128, min(N, rt * 128 + 128))
        n = rows.stop - rows.start
        m = torch.full((n,), -1e30 * LOG2E)
        s = torch.zeros(n)
        g = torch.zeros(n)
        for vt in range(vt0, vt1):
            c0 = vt * 256
            logits = x[rows].float() @ wp[c0:c0 + 256].float().T
            cols = torch.arange(c0, c0 + 256)
            if not drop_mask:
                logits = logits.masked_fill(cols >= V, -math.inf)
            mn = torch.maximum(m, logits.max(1).values * LOG2E)
            s = s * torch.exp2(m - mn) + \
                torch.exp2(logits * LOG2E - mn[:, None]).sum(1)
            m = mn
            hit = cols[None, :] == t[rows, None]
            g = g + torch.where(hit, logits, 0.0).sum(1)
        part[item // p.row_tiles, :, rows] = torch.stack([m * LN2, s, g])
    m = torch.full((N,), -1e30)
    s = torch.zeros(N)
    g = torch.zeros(N)
    for c in range(p.chunks):
        if c == skip_chunk:
            continue
        m2, s2, g2 = part[c]
        mn = torch.maximum(m, m2)
        s = s * torch.exp(m - mn) + s2 * torch.exp(m2 - mn)
        m, g = mn, g + g2
    lse = m + torch.log(s)
    return lse - g, lse


def expected(x, w, targets):
    """ce_nll_lse, a target outside [0, V) adding a target term of 0."""
    V = w.shape[0]
    valid = (targets >= 0) & (targets < V)
    nll, lse = fused_ce.ce_nll_lse(x, w, targets.clamp(0, V - 1))
    return torch.where(valid, nll, lse), lse


def within(got, want):
    tol = chip_smoke.CE_TOL
    return bool(((got - want).abs() <= tol["atol"] + tol["rtol"] *
                 want.abs()).all())


def inputs(N, V, D, seed):
    """x, w rounded to bf16 (kept in fp32 for the CPU), targets at column
    0, V - 1 and past V among random ones."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(V, D)) * 0.1).astype(np.float32))
    x, w = (a.to(torch.bfloat16).float() for a in (x, w))
    t = torch.from_numpy(rng.integers(0, V, N).astype(np.int32))
    t[0] = V - 1
    if N > 3:
        t[1], t[2], t[3] = 0, V, V + 1000
    return x, w, t


@pytest.mark.parametrize("N,V,D", [(1, 255, 64), (63, 256, 64),
                                   (65, 257, 64), (129, 4099, 128),
                                   (300, 5000, 64), (200, 1030, 768)])
def test_emulation_matches_plain(N, V, D):
    x, w, t = inputs(N, V, D, N + V + D)
    p = fused_ce_cuda.plan(N, V, D, 132)
    nll, lse = emulate(x, w, t, p)
    nll_e, lse_e = expected(x, w, t)
    assert within(nll, nll_e) and within(lse, lse_e)


@pytest.mark.parametrize("N,V,D", [(70, 5000, 64), (130, 1300, 128)])
def test_emulation_matches_the_jax_kernel(N, V, D):
    x, w, t = inputs(N, V, D, 3 * N + V)
    t = t.clamp(0, V - 1)            # the JAX kernel's targets lie in [0, V)
    want_nll, want_lse = JCE._fused_ce_fwd_impl(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.asarray(t.numpy()),
        interpret=True)
    nll, lse = emulate(x, w, t, fused_ce_cuda.plan(N, V, D, 132))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("fault", ["the last tile's V mask dropped",
                                   "one chunk left out of the merge"])
def test_planted_faults_read_beyond_the_limit(fault):
    N, V, D = 130, 4099, 64
    x, w, t = inputs(N, V, D, 11)
    p = fused_ce_cuda.plan(N, V, D, 132)
    assert p.chunks > 1
    kw = dict(drop_mask=True) if "mask" in fault else \
        dict(skip_chunk=p.chunks // 2)
    nll, lse = emulate(x, w, t, p, **kw)
    nll_e, lse_e = expected(x, w, t)
    assert not (within(nll, nll_e) and within(lse, lse_e))
