"""K9a's and K9b's launch plans and arithmetic
(``haloop_tpu_torch/ops/joint_cuda.py`` ``plan``, ``bwd_plan``;
``csrc/joint_lse.cu``, ``csrc/joint_lse_bwd.cu``) on the CPU: the plans
at rnn-transducer:lstm:512's joint, with a 16k vocabulary and with long
targets (blocks in flight, the ring, shared memory within the block's
232,448 bytes), and emulations of the kernels' blocked arithmetic in fp32.
K9a's (its frame tiles and row chunks, the stages of V, each half-warp's
share of a stage with its own running f maxima, the block's running g
maxima and their rescales, the merge of the half-warps' sums in order, the
threshold and the exact fix-up) is held against the plain ``pairwise_lse``
and the materialized joint: atol 1e-5, rtol 1e-6 (one fp32 logsumexp
each, summed in another order). K9b's (its V slices, each thread's ring
of frames in the warps' group order, W's select and marks, past one chunk
of U+1 the blocks of U+1's rows writing dg and those of T's rows writing
df with f and g swapped, the rows' sums over the frames in the block and
the warps' rows in order, the exact fix-up) is held against the plain
factored ``pairwise_lse_grad`` and the direct ``pairwise_lse_grad_reference``:
df atol 1e-5, rtol 1e-5, dg atol 1e-4, rtol 1e-5 (``chip_smoke.JOINT_TOL``
and ``JOINT_DG_TOL``: fp32 sums of the same terms in another order, dg's
over up to 301 frames; df's over 2,049 rows stay within df's at this
input's small sums). Pure Python: no card.
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
    want = joint.pairwise_lse(f, g)[0]
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


def test_bwd_plan_at_the_transducer_joint():
    """(16, 301, 25, 512): 8 slices of 64 columns x 16 items = 128 blocks
    of 8 warps (fewer than the H100's 132 SMs), the 25 rows in one chunk of
    28 (7 float4 groups), 10 groups of 32 frames; shared memory the
    threads' rings of 16 frames, each warp's 28 dg rows of the slice and
    its 4 W rows."""
    p = joint_cuda.bwd_plan(16, 301, 25, 512)
    assert (p.slices, p.nq, p.rows, p.chunks, p.tchunks, p.warps, p.group,
            p.groups, p.depth, p.blocks) == (8, 7, 28, 1, 0, 8, 32, 10, 16,
                                             128)
    assert p.smem == 4 * (16 * 256 * 2 + 8 * 28 * 64 + 8 * 4 * 28)
    assert p.smem <= joint_cuda.SMEM_LIMIT
    assert joint_cuda.bwd_plan(16, 301, 25, 512) is p


def test_bwd_plan_takes_any_vocabulary():
    """V sets the slices, and the warps: 16384's 4,096 blocks fill 132 SMs
    twice over, so blocks of 4 warps (two an SM), groups of 16 frames and
    half the rings and dg rows; on a card of 4,096 SMs the 8 warps again.
    V = 1 plans one slice."""
    small = joint_cuda.bwd_plan(16, 301, 25, 512)
    big = joint_cuda.bwd_plan(16, 301, 25, 16384)
    assert (big.slices, big.blocks, big.warps, big.group, big.groups) == \
        (256, 4096, 4, 16, 19)
    assert big.smem == 4 * (16 * 128 * 2 + 4 * 28 * 64 + 4 * 4 * 28)
    assert joint_cuda.bwd_plan(16, 301, 25, 16384, sms=4096)._replace(
        slices=8, blocks=128) == small
    assert joint_cuda.bwd_plan(2, 5, 3, 1)[:2] == (1, 1)
    # the threshold: 264 blocks on 132 SMs
    assert joint_cuda.bwd_plan(264, 9, 5, 64).warps == 4
    assert joint_cuda.bwd_plan(263, 9, 5, 64).warps == 8


def test_bwd_plan_at_long_targets():
    """U+1 = 2049, past the parent kernel's 1,816: the grid splits by
    chunk of 32 rows, 65 of U+1's (the last of one) and 10 of T's, x 8
    slices x 4 items = 2,400 blocks, of 4 warps; shared memory within the
    block's. Past one chunk of U+1 there is always a T split (33 rows: 2
    + 1 chunks a slice). One linear grid: no bound on U+1 or the items
    but the grid's 2^31 - 1 blocks."""
    p = joint_cuda.bwd_plan(4, 301, 2049, 512)
    assert (p.nq, p.rows, p.chunks, p.tchunks, p.blocks, p.warps) == \
        (8, 32, 65, 10, 2400, 4)
    assert p.smem == 4 * (16 * 128 * 2 + 4 * 32 * 64 + 4 * 4 * 32)
    assert p.smem <= joint_cuda.SMEM_LIMIT
    assert joint_cuda.bwd_plan(1, 5, 33, 70)[2:4] == (2, 1)
    assert joint_cuda.bwd_plan(1, 5, 32, 70)[2:4] == (1, 0)
    assert joint_cuda.bwd_plan(1, 1, 100000, 1)[2:4] == (3125, 1)
    huge = joint_cuda.bwd_plan(30000, 32, 32 * 65535, 1)
    assert (huge.chunks, huge.tchunks, huge.blocks) == (65535, 1,
                                                        30000 * 65536)
    with pytest.raises(ValueError):
        joint_cuda.bwd_plan(1 << 16, 32, 32 * 65535, 1)
    with pytest.raises(ValueError):
        joint_cuda.bwd_plan(2, 5, 0, 3)


def _fma(a, b, c):
    """fp32 a * b + c rounded once, as the kernel's fmaf."""
    return (a.double() * b.double() + c.double()).float()


def frame_of(i, w, group):
    """Frame i of a thread of warp w, in its ring's order: group i / 4,
    the warp's 4 frames of each group."""
    FW = joint_cuda.BWD_FRAMES
    return (i // FW) * group + w * FW + i % FW


def _block(a, b, ls, dl, ma, mb, us, cols, p, both, skip_fixup):
    """One K9b block of an item: rows ``us`` of b held, every row of a
    streamed as its frames, lse and dlse (frames, rows) -> (the frames'
    sums, or None where ``both`` is off; the rows' sums), fp32. A frame's
    W . e^(b - mb) in four partial sums (rows u % 4, summed pairwise), the
    rows' sums a warp's frames in its ring order, the warps' rows in
    order."""
    WARPS, FW = p.warps, joint_cuda.BWD_FRAMES
    Ta = a.shape[0]
    # rows past the chunk have e^(b - mb) = W = 0: fma(0, x, s) is s
    eb = _ex2(b[us][:, cols] - mb[us, None])
    dga = torch.zeros((WARPS, len(us), len(cols)))
    exact = torch.zeros((WARPS, len(us), len(cols)))
    da = torch.full((Ta, len(cols)), float("nan")) if both else None
    for w in range(WARPS):
        for i in range(-(-Ta // p.group) * FW):   # the ring's order
            t = frame_of(i, w, p.group)
            if t >= Ta:
                continue
            e = joint._exponent(ls[t, us][None, None], ma[t][None, None],
                                mb[us][None])[0, 0]
            live = dl[t, us] != 0
            big = e > joint.MARK
            wt = torch.where(live & ~big, dl[t, us] * torch.exp(e),
                             torch.zeros(()))
            ea = _ex2(a[t, cols] - ma[t])
            acc = torch.zeros((4, len(cols)))  # rows u % 4
            for u in range(len(us)):
                acc[u % 4] = _fma(wt[u], eb[u], acc[u % 4])
                dga[w, u] = _fma(wt[u], ea, dga[w, u])
            d = ea * ((acc[0] + acc[1]) + (acc[2] + acc[3]))
            for u in (live & big).nonzero()[:, 0].tolist():
                if skip_fixup:
                    continue
                pu = dl[t, us[u]] * torch.exp(a[t, cols] + b[us[u], cols] -
                                              ls[t, us[u]])
                d = d + pu
                exact[w, u] = exact[w, u] + pu
            if both:
                da[t] = d
    rows = _fma(eb, dga[0], exact[0])
    for w in range(1, WARPS):
        rows = rows + _fma(eb, dga[w], exact[w])
    return da, rows


def emulate_bwd(f, g, lse, dlse, mf, mg, skip_fixup=False, sms=132):
    """K9b's arithmetic, block by block, in fp32: -> (df, dg). With one
    chunk of U+1's rows, a block per slice takes T's frames past them and
    writes df and dg; with more, a block per chunk of U+1's rows writes dg
    from T's frames, a block per chunk of 32 of T's rows writes df from
    U+1's rows, f and g swapped."""
    N, T, V = f.shape
    U1 = g.shape[1]
    p = joint_cuda.bwd_plan(N, T, U1, V, sms)
    S, UC = joint_cuda.BWD_SLICE, p.rows
    both = p.chunks == 1
    df = torch.full((N, T, V), float("nan"))
    dg = torch.full((N, U1, V), float("nan"))
    for n in range(N):
        for sl in range(p.slices):
            cols = torch.arange(sl * S, min(V, sl * S + S))  # the rest add 0
            for ch in range(p.chunks):
                us = torch.arange(ch * UC, min(U1, ch * UC + UC))
                d, rows = _block(f[n], g[n], lse[n], dlse[n], mf[n], mg[n],
                                 us, cols, p, both, skip_fixup)
                dg[n, us[:, None], cols[None]] = rows
                if both:
                    df[n, :, cols] = d
            for ch in range(p.tchunks):
                ts = torch.arange(ch * 32, min(T, ch * 32 + 32))
                _, rows = _block(g[n], f[n], lse[n].T, dlse[n].T, mg[n],
                                 mf[n], ts, cols, p, False, skip_fixup)
                df[n, ts[:, None], cols[None]] = rows
    return df, dg


def _dlse(N, T, U1, seed):
    gen = torch.Generator().manual_seed(seed)
    dlse = torch.randn((N, T, U1), generator=gen)
    dlse[0, T // 2:] = 0.0                 # frames past an item's length
    return dlse


BWD_CASES = {
    "one slice": _inputs(2, 9, 5, 19, 0),
    "tail slice, two groups": _inputs(2, 40, 7, 130, 1),
    "two row chunks": _inputs(1, 5, 40, 70, 2),
    "V = 1": _inputs(2, 5, 3, 1, 3),
    "V = 16384": _inputs(1, 6, 3, 16384, 4),
    "disjoint peaks": _peaks(2, 7, 4, 150, False),
    "every cell marked": _peaks(1, 6, 3, 70, True),
    "U+1 = 2049": _inputs(1, 3, 2049, 70, 6),
    "4 warps a block (a card of one SM)": _inputs(2, 40, 7, 130, 1),
    "disjoint peaks, two row chunks": _peaks(2, 7, 40, 150, False),
    "every cell marked, two row chunks": _peaks(1, 6, 40, 70, True),
    "two row chunks, two frame chunks": _inputs(1, 40, 33, 70, 7),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_emulated_bwd_kernel_matches_plain(case):
    f, g = BWD_CASES[case]
    N, T, U1 = f.shape[0], f.shape[1], g.shape[1]
    sms = 1 if "4 warps" in case else 132
    assert joint_cuda.bwd_plan(N, T, U1, f.shape[2], sms).warps == \
        (4 if sms == 1 else 8)
    dlse = _dlse(N, T, U1, len(case))
    lse, mf, mg = joint.pairwise_lse(f, g)
    df, dg = emulate_bwd(f, g, lse, dlse, mf, mg, sms=sms)
    want = joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg)
    ref = joint.pairwise_lse_grad_reference(f, g, lse, dlse)
    for got_f, got_g, (wf, wg) in ((df, dg, want), (df, dg, ref)):
        torch.testing.assert_close(got_f, wf, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got_g, wg, atol=1e-4, rtol=1e-5)
    assert not df[0, T // 2:].any()        # dlse = 0: exactly 0
    marked = joint.grad_marks(lse, dlse, mf, mg)
    if case.startswith("disjoint peaks"):
        expect = torch.zeros_like(marked)
        expect[0, 2, 1] = dlse[0, 2, 1] != 0
        assert torch.equal(marked, expect) and marked.any()
        # the exact terms are what hold it: without them df and dg are off
        bare_f, bare_g = emulate_bwd(f, g, lse, dlse, mf, mg,
                                     skip_fixup=True)
        assert not torch.allclose(bare_f, want[0], atol=1e-5, rtol=1e-5)
        assert not torch.allclose(bare_g, want[1], atol=1e-4, rtol=1e-5)
    elif case.startswith("every cell marked"):
        assert torch.equal(marked, dlse != 0)
    else:
        assert not marked.any()
