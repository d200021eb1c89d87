"""The arithmetic and the plan of the fp32 flash attention backward
(kernels K6a and K6b in fp32, ``haloop_tpu_torch/csrc/flash_bwd.cu``,
``bwd_dq_f32`` and ``bwd_dkv_f32``) on the CPU: a blockwise emulation of
those kernels, written here, against the port's plain version
(``ops.flash._backward_reference``) and the JAX package's
``_flash_backward`` in interpret mode, on the same numpy inputs from a
seed and the same o and lse (the JAX forward's).

The emulation follows the kernels. K6a: one output tile per 64 query
rows, its live key tiles [0, ceil(key_end / 64)) (``key_end``: the key
length and, causal, the tile's last row) shared out among the splits of
``flash_cuda.bwd_f32_plan`` by ``f32_split_range``; each split sums its
key tiles in order, p = 2^(s log2(e)/sqrt(D) - lse log2(e)) masked only
on a tile that straddles the tile's first row's last key, ds = p (dp -
delta), and the splits' sums are added in split order (the last split to
finish does that on the card), times 1/sqrt(D). K6b: one output tile per
64 keys, its query tiles from ``first_query_tile`` to the last (none at
or past kv_lengths[n]) shared out the same way, keys on the rows, each
masked before its first live query on a tile that starts before the
tile's last row's first query; q, do, lse and delta zero past T, as the
kernel's zero-filled loads give them. It also asserts that no key (query)
tile outside an output tile's live range holds a pair the masks leave.

Tolerance: ``chip_smoke.K6_TOL["float32"]`` through ``chip_smoke.k6_gate``,
max |d| within 2e-5 of the largest gradient (fp32 sums in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from haloop_tpu.ops import flash as JF
from haloop_tpu_torch.ops import flash as TF
from haloop_tpu_torch.ops import flash_cuda
from test_torch_flash_bwd_tiles import K6_CASES, _close, _jax, _tile, \
    first_query, masked_pairs

FT = flash_cuda.F32_TILE
LOG2E = np.float32(1.4426950408889634)
SMS = 132                       # an H100 SXM's multiprocessors


def key_tiles(kvlen, causal, t0, q0):
    """K6a: the live key tiles of the query tile at q0."""
    kend = min(kvlen, t0 + q0 + FT) if causal else kvlen
    return -(-max(kend, 0) // FT)


def query_tiles(kvlen, T, causal, t0, k0):
    """K6b: (first, count) of the key tile at k0's query tiles."""
    qt0 = max(k0 - t0, 0) // FT if causal else 0
    return qt0, (max(-(-T // FT) - qt0, 0) if k0 < kvlen else 0)


def emulate_dq(q, k, v, o, do, lse, kvl, causal, t0, P, parts=None):
    """K6a's blockwise arithmetic in P splits -> (dq, delta (N, H, T));
    each split's sums appended to ``parts``."""
    N, H, T, D = q.shape
    S = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    scale2 = np.float32(LOG2E * scale)
    delta = (do * o).sum(-1)
    dq = torch.zeros_like(q)
    for n in range(N):
        kvlen = min(int(kvl[n]), S)
        for q0 in range(0, T, FT):
            rows = np.arange(q0, min(q0 + FT, T))
            nk = key_tiles(kvlen, causal, t0, q0)
            cmax = np.full(len(rows), kvlen - 1)
            cmax_tile = kvlen - 1
            if causal:
                cmax = np.minimum(cmax, t0 + rows)
                cmax_tile = min(cmax_tile, t0 + q0)
            l2 = lse[n, :, rows] * LOG2E
            dl = delta[n, :, rows]
            sums = []
            for s in range(P):
                lo, hi = flash_cuda.f32_split_range(nk, P, s)
                acc = torch.zeros((H, len(rows), D))
                for kt in range(lo, hi):
                    k0 = kt * FT
                    kt_ = _tile(k[n], k0, FT, S)
                    vt = _tile(v[n], k0, FT, S)
                    sc = q[n, :, rows] @ kt_.transpose(1, 2)
                    dp = do[n, :, rows] @ vt.transpose(1, 2)
                    p = torch.exp2(sc * scale2 - l2[..., None])
                    if k0 + FT - 1 > cmax_tile:
                        cols = np.arange(k0, k0 + FT)
                        p = p.masked_fill(torch.from_numpy(
                            cols[None, :] > cmax[:, None]), 0.0)
                    acc = acc + (p * (dp - dl[..., None])) @ kt_
                sums.append(acc)
            for kt in range(nk, -(-S // FT)):    # tiles past the live ones
                cols = np.arange(kt * FT, min(kt * FT + FT, S))
                assert masked_pairs(rows, cols, kvlen, causal, t0).all()
            total = sums[0]
            for x in sums[1:]:
                total = total + x
            dq[n, :, rows] = total * scale
            if parts is not None:
                parts.append(sums)
    return dq, delta


def emulate_dkv(q, k, v, do, lse, delta, kvl, causal, t0, P,
                parts=None):
    """K6b's blockwise arithmetic in P splits, from K6a's delta -> (dk,
    dv); each split's (dk, dv) sums appended to ``parts``."""
    N, H, T, D = q.shape
    S = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    scale2 = np.float32(LOG2E * scale)
    dk, dv = torch.zeros_like(k), torch.zeros_like(k)
    for n in range(N):
        kvlen = min(int(kvl[n]), S)
        for k0 in range(0, S, FT):
            keys = np.arange(k0, min(k0 + FT, S))
            qt0, nt = query_tiles(kvlen, T, causal, t0, k0)
            qmin = np.array([first_query(c, kvlen, causal, t0)
                             for c in keys])
            mask_to = first_query(k0 + FT - 1, kvlen, causal, t0)
            sums = []
            for s in range(P):
                lo, hi = flash_cuda.f32_split_range(nt, P, s)
                dka = torch.zeros((H, len(keys), D))
                dva = torch.zeros((H, len(keys), D))
                for qt in range(qt0 + lo, qt0 + hi):
                    q0 = qt * FT
                    qt_ = _tile(q[n], q0, FT, T)
                    dot = _tile(do[n], q0, FT, T)
                    l2 = torch.zeros((H, FT))
                    dl = torch.zeros((H, FT))
                    real = max(min(q0 + FT, T) - q0, 0)
                    l2[:, :real] = lse[n, :, q0:q0 + real]
                    dl[:, :real] = delta[n, :, q0:q0 + real]
                    sc = k[n, :, keys] @ qt_.transpose(1, 2)      # S^T
                    dp = v[n, :, keys] @ dot.transpose(1, 2)      # dP^T
                    p = torch.exp2(sc * scale2 - (l2 * LOG2E)[:, None, :])
                    if q0 < mask_to:
                        cols = np.arange(q0, q0 + FT)
                        p = p.masked_fill(torch.from_numpy(
                            cols[None, :] < qmin[:, None]), 0.0)
                    dva = dva + p @ dot
                    dka = dka + (p * (dp - dl[:, None, :])) @ qt_
                sums.append((dka, dva))
            live = range(qt0, qt0 + nt)
            for qt in range(-(-T // FT)):            # the tiles skipped
                if qt not in live:
                    qrows = np.arange(qt * FT, min(qt * FT + FT, T))
                    assert masked_pairs(qrows, keys, kvlen, causal,
                                        t0).all()
            tk, tv = sums[0]
            for xk, xv in sums[1:]:
                tk, tv = tk + xk, tv + xv
            dk[n, :, keys] = tk * scale
            dv[n, :, keys] = tv
            if parts is not None:
                parts.append(sums)
    return dk, dv


def emulate(q, k, v, kvl, causal, t0, o, lse, do, splits):
    """K6a, then K6b on its delta, with (K6a's, K6b's) splits."""
    dq, delta = emulate_dq(q, k, v, o, do, lse, kvl, causal, t0, splits[0])
    return (dq,) + emulate_dkv(q, k, v, do, lse, delta, kvl, causal, t0,
                               splits[1])


def plan_splits(N, H, T, S, D, causal, t0, sms=SMS):
    p = flash_cuda.bwd_f32_plan(N, H, T, S, D, causal, t0, sms)
    return p.dq_splits, p.dkv_splits


def _inputs(N, H, T, S, D, causal, t0, kvl, seed):
    """numpy inputs from a seed, the JAX forward's o and lse -> (torch
    args, jax args)."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((N, H, T, D), np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((N, H, S, D), np.float32))
            for _ in range(2))
    kvl = torch.tensor(kvl, dtype=torch.int32)
    jq, jk, jv, jdo = (_jax(x) for x in (q, k, v, do))
    jkvl = jnp.asarray(kvl.numpy())
    _, (*_, jo, jlse) = JF._fwd(jq, jk, jv, jkvl, causal, t0, True)
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jlse)[:, :T, 0].reshape(N, H, T))
    return (q, k, v, kvl, causal, t0, o, lse, do), \
        (jq, jk, jv, jkvl, causal, t0, jo, jlse, jdo)


def _check(args, jargs, split_sets, one_key=False):
    """The emulation at each (K6a, K6b) splits against the plain version
    and the JAX kernels."""
    want = TF._backward_reference(*args)
    jwant = [torch.from_numpy(np.array(w)) for w in
             JF._flash_backward(*jargs, interpret=True)]
    for splits in split_sets:
        got = emulate(*args, splits)
        _close(got, want, torch.float32, f"plain, splits {splits}",
               one_key)
        _close(got, jwant, torch.float32, f"JAX, splits {splits}", one_key)
    return got


@pytest.mark.parametrize("T,S,causal,t0,D", K6_CASES)
def test_f32_tiles_match_plain_and_jax(T, S, causal, t0, D):
    """K6_CASES' shapes (N = 3, H = 2; key lengths full, mid-tile and 0),
    unsplit and in the plan's splits on an H100 (these shapes are small,
    so the plan splits most), against ``_backward_reference`` and the JAX
    kernels; the zero-length row's gradients are zero."""
    N, H = 3, 2
    args, jargs = _inputs(N, H, T, S, D, causal, t0,
                          [S, max(S // 2 + 1, 1), 0], T * 1000 + S + D + t0)
    got = _check(args, jargs, {(1, 1), plan_splits(N, H, T, S, D, causal,
                                                   t0)}, S == 1)
    for g in got:
        assert not g[2].any()


# (N, H, T, S, causal, t0, D, key lengths, forced splits): --grad-norms'
# (1, 8, 384, 64) with 2 heads, the splits the plan gives (6) and 3; key
# lengths that end inside a split (200 of 384: K6a's 4 live tiles in 3
# splits, [0, 1), [1, 2), [2, 4); in 6, empty splits too); t0 > 0
SPLIT_CASES = [
    (1, 2, 384, 384, False, 0, 64, [384], [(3, 3)]),
    (2, 2, 384, 384, False, 0, 64, [384, 200], [(3, 3), (2, 5)]),
    (2, 2, 384, 384, True, 0, 32, [384, 200], [(3, 3), (4, 2)]),
    (2, 2, 256, 384, True, 128, 64, [384, 300], [(3, 2), (5, 4)]),
    (2, 1, 200, 200, True, 70, 64, [200, 0], [(2, 2)]),
]


@pytest.mark.parametrize("N,H,T,S,causal,t0,D,kvl,forced", SPLIT_CASES)
def test_f32_splits_match_plain_and_jax(N, H, T, S, causal, t0, D, kvl,
                                        forced):
    args, jargs = _inputs(N, H, T, S, D, causal, t0, kvl, N * T + S + t0)
    planned = plan_splits(N, H, T, S, D, causal, t0)
    assert min(planned) > 1            # these shapes are split on an H100
    _check(args, jargs, {planned, *forced})


def test_plan_splits_at_grad_norms():
    """--grad-norms' (1, 8, 384, 64): 48 tiles each way, 6 key (query)
    tiles a reduction. The plan takes the split whose heaviest SM has the
    least to do, the fewest splits of those: 2 (96 blocks, 3 tiles each),
    where 3 would leave 12 SMs two blocks of 2 tiles and 6 put three
    blocks on some SMs; the grid beside its scratch."""
    p = flash_cuda.bwd_f32_plan(1, 8, 384, 384, 64, False, 0, SMS)
    assert p.dq_tiles == p.dkv_tiles == 48
    assert (p.dq_splits, p.dkv_splits) == (2, 2)
    assert p.dq_blocks == p.dkv_blocks == 96
    assert p.dq_part == 48 * 2 * FT * 64
    assert p.dkv_part == 2 * 48 * 2 * FT * 64
    load = {P: -(-48 * P // SMS) * -(-6 // P) for P in range(1, 7)}
    assert load[2] == min(load.values()) < load[3] < load[1]
    # with 2 heads the tiles cannot fill the card: a tile a block
    p = flash_cuda.bwd_f32_plan(1, 2, 384, 384, 64, False, 0, SMS)
    assert (p.dq_splits, p.dkv_splits, p.dq_blocks) == (6, 6, 72)


def test_plan_does_not_split_where_tiles_fill_the_card():
    """hala's fp32 (2, 12, 1024, 64) causal: 384 tiles each way."""
    p = flash_cuda.bwd_f32_plan(2, 12, 1024, 1024, 64, True, 0, SMS)
    assert (p.dq_splits, p.dkv_splits) == (1, 1)
    assert (p.dq_blocks, p.dkv_blocks) == (384, 384)
    assert p.dq_part == p.dkv_part == 0
    # a split never exceeds the tiles a reduction spans
    p = flash_cuda.bwd_f32_plan(1, 1, 64, 64, 64, False, 0, SMS)
    assert (p.dq_splits, p.dkv_splits) == (1, 1)


@pytest.mark.parametrize("causal,t0,kvl,P", [
    (False, 0, [384, 200, 1, 0], 3), (True, 0, [384, 200, 65], 4),
    (True, 100, [384, 130], 6), (True, 0, [384], 7)])
def test_every_live_pair_in_exactly_one_split(causal, t0, kvl, P):
    """Over all output tiles and splits, each (query, key) pair that the
    masks leave is visited by exactly one split of K6a and one of K6b,
    and no split visits a tile past its tile's reach."""
    T, S = 300, 384
    for n, kvlen in enumerate(kvl):
        live = ~masked_pairs(np.arange(T), np.arange(S), kvlen, causal, t0)
        a = np.zeros((T, S), int)
        b = np.zeros((T, S), int)
        for q0 in range(0, T, FT):
            nk = key_tiles(kvlen, causal, t0, q0)
            for s in range(P):
                lo, hi = flash_cuda.f32_split_range(nk, P, s)
                a[q0:q0 + FT, lo * FT:hi * FT] += 1
        for k0 in range(0, S, FT):
            qt0, nt = query_tiles(kvlen, T, causal, t0, k0)
            for s in range(P):
                lo, hi = flash_cuda.f32_split_range(nt, P, s)
                b[(qt0 + lo) * FT:(qt0 + hi) * FT, k0:k0 + FT] += 1
        for visits in (a, b):
            assert (visits[live] == 1).all(), n
            assert visits.max() <= 1


def test_a_split_with_no_live_tile_writes_zeros():
    """Key length 64 at T = S = 128 gives each of K6a's query tiles one
    live key tile and K6b's second key tile none; in 3 splits two of
    K6a's have no tile, and no split of that K6b tile has one: their sums
    are exactly 0, and the merged gradients still match the plain
    version."""
    N, H, T, S, D = 1, 2, 128, 128, 32
    args, _ = _inputs(N, H, T, S, D, False, 0, [64], 3)
    q, k, v, kvl, causal, t0, o, lse, do = args
    pa, pb = [], []
    dq, delta = emulate_dq(q, k, v, o, do, lse, kvl, causal, t0, 3, pa)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, kvl, causal, t0, 3, pb)
    assert [flash_cuda.f32_split_range(1, 3, s) for s in range(3)] == \
        [(0, 0), (0, 0), (0, 1)]
    for sums in pa:
        assert not sums[0].any() and not sums[1].any() and sums[2].any()
    assert all(x.any() for pair in pb[0][1:] for x in pair)
    assert not any(x.any() for pair in pb[1] for x in pair)
    ok, reads = chip_smoke.k6_gate((dq, dk, dv),
                                   TF._backward_reference(*args), "float32")
    assert ok, reads
