"""K9a's launch plan and arithmetic (``haloop_tpu_torch/ops/joint_cuda.py``
``plan``, ``csrc/joint_lse.cu``) on the CPU: the plan at
rnn-transducer:lstm:512's joint, with a 16k vocabulary and with long
targets (blocks in flight, the ring, shared memory within the block's
232,448 bytes), and an emulation of the kernel's blocked arithmetic in
fp32 (its frame tiles and row chunks, the stages of V, each half-warp's
share of a stage with its own running f maxima, the block's running g
maxima and their rescales, the merge of the half-warps' sums in order, the
threshold and the exact fix-up) held against the plain ``pairwise_lse``
and the materialized joint: atol 1e-5, rtol 1e-6 (one fp32 logsumexp
each, summed in another order). Pure Python: no card.
"""

import pytest
import torch

from haloop_tpu_torch.ops import joint, joint_cuda

L2E = 1.4426950408889634


def test_plan_at_the_transducer_joint():
    """(16, 301, 25, 512): frame tiles of 32 and the 25 rows in one chunk
    of 28 (7 float4 groups) put 160 blocks in flight; 8 stages of 64
    columns through a ring of 4."""
    p = joint_cuda.plan(16, 301, 25, 512)
    assert (p.tiles, p.nq, p.rows, p.chunks, p.stages) == (10, 7, 28, 1, 8)
    assert p.blocks == 160 >= 130
    assert p.ring == joint_cuda.DEPTH * (32 + 28) * (64 + 4) * 4
    assert p.smem == p.ring + 2 * 64 * 28 * 4 + 3 * 32 * 4 + 16 + 16
    assert p.smem <= joint_cuda.SMEM_LIMIT
    assert joint_cuda.plan(16, 301, 25, 512) is p


def test_plan_takes_any_vocabulary():
    """V only sets the stages: 16384 (a 16k sentencepiece vocabulary,
    past the parent kernel's 6,456) and V = 1 plan with the same blocks
    and shared memory."""
    small = joint_cuda.plan(16, 301, 25, 512)
    big = joint_cuda.plan(16, 301, 25, 16384)
    assert big.stages == 256
    assert big._replace(stages=8) == small
    assert joint_cuda.plan(2, 5, 3, 1).stages == 1


def test_plan_at_long_targets():
    """U+1 = 2000: chunks of 32 rows (63 of them, the last of 16), the
    ring and shared memory still within the block's."""
    p = joint_cuda.plan(16, 301, 2000, 512)
    assert (p.nq, p.rows, p.chunks) == (8, 32, 63)
    assert p.blocks == 10 * 63 * 16
    assert p.smem == p.ring + 2 * 64 * 36 * 4 + 3 * 32 * 4 + 16 + 16
    assert p.smem <= joint_cuda.SMEM_LIMIT
    with pytest.raises(ValueError):
        joint_cuda.plan(2, 5, 3, 0)


def _ex2(x):
    return torch.exp2(x * L2E)


def emulate(f, g, skip_fixup=False):
    """K9a's arithmetic, block by block, in fp32: -> (lse, marks)."""
    N, T, V = f.shape
    U1 = g.shape[1]
    p = joint_cuda.plan(N, T, U1, V)
    R, KS, W = joint_cuda.ROWS, joint_cuda.STAGE, joint_cuda.GROUPS
    KW, UC = KS // W, p.rows
    inf = float("inf")
    lse = torch.empty((N, T, U1))
    marked = torch.zeros((N, T, U1), dtype=torch.bool)
    for n in range(N):
        for tile in range(p.tiles):
            rows = torch.arange(tile * R, tile * R + R).clamp(max=T - 1)
            for ch in range(p.chunks):
                cols = torch.arange(ch * UC, ch * UC + UC).clamp(max=U1 - 1)
                fr, gr = f[n, rows], g[n, cols]
                acc = torch.zeros((W, R, UC))
                mf = torch.full((W, R), -inf)
                mg = torch.full((UC,), -inf)
                for st in range(p.stages):
                    k0 = st * KS
                    valid = min(KS, V - k0)
                    gs = torch.full((UC, KS), -inf)
                    gs[:, :valid] = gr[:, k0:k0 + valid]
                    m = torch.maximum(mg, gs.amax(1))
                    sg, moved = _ex2(mg - m), bool((m > mg).any())
                    eg = _ex2(gs - m[:, None])                 # (UC, KS)
                    mg = m
                    for w in range(W):
                        e = torch.full((R, KW), -inf)
                        lo, hi = w * KW, min(w * KW + KW, valid)
                        if hi > lo:
                            e[:, :hi - lo] = fr[:, k0 + lo:k0 + hi]
                        ml = e.amax(1)
                        grow = ml > mf[w]
                        acc[w] = torch.where(grow[:, None], acc[w] * _ex2(
                            mf[w] - ml)[:, None], acc[w])
                        mf[w] = torch.where(grow, ml, mf[w])
                        if moved:
                            acc[w] = acc[w] * sg
                        base = torch.where(mf[w] == -inf, 0.0, mf[w])
                        e = _ex2(e - base[:, None])
                        for j in range(KW):
                            acc[w] = acc[w] + e[:, j:j + 1] * eg[:, lo + j]
                fmax = mf.amax(0)
                s = torch.zeros((R, UC))
                for w in range(W):
                    s = s + acc[w] * _ex2(mf[w] - fmax)[:, None]
                out = fmax[:, None] + mg[None] + torch.log(s)
                bad = s < joint.TINY
                if not skip_fixup:
                    for r, c in bad.nonzero().tolist():
                        fg = f[n, rows[r]] + g[n, cols[c]]
                        out[r, c] = torch.logsumexp(fg, 0)
                t, u = rows[:, None], cols[None]
                keep = (torch.arange(tile * R, tile * R + R) < T)[:, None] & \
                    (torch.arange(ch * UC, ch * UC + UC) < U1)[None]
                lse[n, t.expand(-1, UC)[keep], u.expand(R, -1)[keep]] = \
                    out[keep]
                marked[n, t.expand(-1, UC)[keep], u.expand(R, -1)[keep]] = \
                    bad[keep]
    return lse, marked


def _inputs(N, T, U1, V, seed, scale=3.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((N, T, V), generator=gen) * scale,
            torch.randn((N, U1, V), generator=gen) * scale)


def _peaks(N, T, U1, V, every):
    """f at +100 on one v and g at +100 on another, the rest N(0, 1): the
    cell of f's row 2 and g's row 1 (or, ``every``, every cell: +200 on
    every row) underflows in the factored form."""
    f, g = _inputs(N, T, U1, V, 5, scale=1.0)
    if every:
        f[..., 0], g[..., 1] = 200.0, 200.0
    else:
        f[0, 2, 3], g[0, 1, V - 2] = 100.0, 100.0
    return f, g


CASES = {
    "one stage": _inputs(2, 9, 5, 19, 0),
    "tail stage, two tiles": _inputs(2, 40, 7, 200, 1),
    "two row chunks": _inputs(1, 5, 40, 70, 2),
    "V = 1": _inputs(2, 5, 3, 1, 3),
    "V = 16384": _inputs(1, 6, 3, 16384, 4),
    "disjoint peaks": _peaks(2, 7, 4, 150, False),
    "every cell marked": _peaks(1, 6, 3, 70, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_matches_plain(case):
    f, g = CASES[case]
    got, marked = emulate(f, g)
    want = joint.pairwise_lse(f, g)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(got, joint.pairwise_lse_reference(f, g),
                               atol=1e-5, rtol=1e-6)
    assert torch.equal(marked, joint.marks(f, g))
    if case == "disjoint peaks":
        expect = torch.zeros_like(marked)
        expect[0, 2, 1] = True
        assert torch.equal(marked, expect)
        # the fix-up is what holds it: without it the cell is off
        bare, _ = emulate(f, g, skip_fixup=True)
        assert not torch.allclose(bare, want, atol=1e-5, rtol=1e-6)
    if case == "every cell marked":
        assert marked.all()
