"""The arithmetic and the plan of the fp32 flash attention forward
(kernels K5 and K7 in fp32, ``haloop_tpu_torch/csrc/flash_fwd.cu``,
``fwd_f32``) on the CPU: a blockwise emulation of that kernel, written
here, against the port's plain versions (``ops.flash._reference``, o and
lse, and ``_packed_reference``) and the JAX package's ``_flash_forward``
/ ``flash_attention_packed`` in interpret mode, on the same numpy inputs
from a seed.

The emulation follows the kernel: one output tile per 64 query rows, its
key tiles [0, nk) by ``plan`` (the key length and, causal, the tile's
last row; a row of key length 0 visits every key tile, each key masked)
shared out among the splits of ``flash_cuda.fwd_f32_plan`` by
``f32_split_range`` (K7 unsplit, the tiles whose segment ids can meet the
query tile's); each split runs the online softmax in base 2 over its
64-key tiles in order (log2(e)/sqrt(D) folded into the exponent, the
mask only on tiles that straddle a row's last key: -1e30 log2(e) for a
masked key, -inf past S), and the splits' (m, l, acc) merge in split
order (the last split to arrive does that on the card): m = max m_s, l =
sum l_s 2^(m_s - m), o = sum acc_s 2^(m_s - m) / max(l, 1e-30). It also
asserts that no key tile outside a query tile's range holds a pair the
masks leave.

Tolerances: ``chip_smoke.ATTN_TOL["float32"]`` (2e-5, the JAX package's
bound for its flash kernel, tests/test_flash.py); lse 1e-4 (rtol 1e-5).
Rows with kv_lengths 0 are held to the plain version only (the mean of v
over S): the TPU kernel's value there depends on its tiling.
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
from test_torch_flash_tiles import K5_CASES, _ragged_segments

FT = flash_cuda.F32_TILE
LOG2E = 1.4426950408889634
NEG = -1e30
NEG2 = np.float32(NEG * LOG2E)
SMS = 132                       # an H100 SXM's multiprocessors
TOL = chip_smoke.ATTN_TOL["float32"]


def plan(kvlen, S, T, q0, causal, t0):
    """(uniform, key tiles nk) of the query tile at q0 (``plan<FT, FT>``)."""
    uniform = kvlen <= 0
    kend = S
    if not uniform:
        kend = min(kend, kvlen)
        if causal:
            kend = min(kend, t0 + min(q0 + FT, T))
    return uniform, -(-max(kend, 0) // FT)


def masked_pairs(rows, cols, kvlen, S, causal, t0, segn):
    """(rows, cols) bool: the pairs the masks remove."""
    m = np.broadcast_to((cols[None, :] >= min(kvlen, S)),
                        (len(rows), len(cols)))
    if causal:
        m = m | (cols[None, :] > t0 + rows[:, None])
    if segn is not None:
        m = m | (segn[rows][:, None] != segn[np.minimum(cols, len(segn) - 1)]
                 [None, :])
    return m


def seg_live(segn, T, S, q0, kt):
    """K7: whether key tile kt's [min, max] of segment ids meets the
    query tile's (``seg_tile_live``)."""
    qs = segn[q0:min(q0 + FT, T)]
    ks = segn[kt * FT:min(kt * FT + FT, S)]
    return not (ks.max() < qs.min() or ks.min() > qs.max())


def split_partial(qf, kf, vf, rows, tiles, kvlen, S, causal, t0, uniform,
                  segn, scale2):
    """One split's online softmax over its key tiles -> (m, l, acc) in
    base 2, per head and row."""
    H = qf.shape[0]
    D = qf.shape[-1]
    m = torch.full((H, len(rows)), float(NEG2))
    l = torch.zeros((H, len(rows)))
    acc = torch.zeros((H, len(rows), D))
    cmax = np.full(len(rows), min(kvlen, S) - 1)
    cmax_tile = min(kvlen, S) - 1
    if causal and not uniform:
        cmax = np.minimum(cmax, t0 + rows)
        cmax_tile = min(cmax_tile, t0 + int(rows[0]))
    for kt in tiles:
        k0 = kt * FT
        cols = np.arange(k0, k0 + FT)
        kt_ = torch.zeros((H, FT, D))
        vt_ = torch.zeros((H, FT, D))
        real = cols[cols < S]
        kt_[:, :len(real)] = kf[:, real]
        vt_[:, :len(real)] = vf[:, real]
        s = qf[:, rows] @ kt_.transpose(1, 2)
        if segn is not None or k0 + FT - 1 > cmax_tile:
            x = s * scale2
            msk = cols[None, :] > cmax[:, None]
            if segn is not None:
                msk = msk | (segn[rows][:, None] !=
                             segn[np.minimum(cols, S - 1)][None, :])
            x = x.masked_fill(torch.from_numpy(msk), float(NEG2))
            x = x.masked_fill(torch.from_numpy(cols >= S), -math.inf)
            mx, sc2 = x.amax(-1), 1.0
        else:
            x, mx, sc2 = s, s.amax(-1) * scale2, scale2
        mn = torch.maximum(m, mx)
        corr = torch.exp2(m - mn)
        m = mn
        p = torch.exp2(x * sc2 - m[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vt_
    return m, l, acc


def emulate(q, k, v, kv_lengths, causal, t0, P, seg=None, parts=None):
    """The kernel's blockwise arithmetic in P splits -> (o, lse); each
    query tile's split partials appended to ``parts``."""
    N, H, T, D = q.shape
    S = k.shape[2]
    scale2 = np.float32(LOG2E / math.sqrt(D))
    o = torch.zeros((N, H, T, D))
    lse = torch.zeros((N, H, T))
    for n in range(N):
        segn = None if seg is None else seg[n].numpy()
        kvlen = S if seg is not None else int(kv_lengths[n])
        for q0 in range(0, T, FT):
            rows = np.arange(q0, min(q0 + FT, T))
            uniform, nk = plan(kvlen, S, T, q0, causal, t0)
            sums = []
            for s in range(P):
                lo, hi = flash_cuda.f32_split_range(nk, P, s)
                tiles = [kt for kt in range(lo, hi) if segn is None or
                         seg_live(segn, T, S, q0, kt)]
                sums.append(split_partial(q[n], k[n], v[n], rows, tiles,
                                          kvlen, S, causal, t0, uniform,
                                          segn, scale2))
            # the skip rules drop no live tile
            visited = {kt for kt in range(nk) if segn is None or
                       seg_live(segn, T, S, q0, kt)}
            if not uniform:
                for kt in set(range(-(-S // FT))) - visited:
                    cols = np.arange(kt * FT, min(kt * FT + FT, S))
                    assert masked_pairs(rows, cols, kvlen, S, causal, t0,
                                        segn).all(), (n, q0, kt)
            if P == 1:
                m, l, acc = sums[0]
            else:
                m = torch.full_like(sums[0][0], float(NEG2))
                for ms, _, _ in sums:
                    m = torch.maximum(m, ms)
                l = torch.zeros_like(m)
                acc = torch.zeros_like(sums[0][2])
                for ms, ls, accs in sums:
                    w = torch.exp2(ms - m)
                    l = l + ls * w
                    acc = acc + accs * w[..., None]
            lc = torch.clamp(l, min=1e-30)
            o[n, :, rows] = acc / lc[..., None]
            lse[n, :, rows] = (NEG if uniform else m / LOG2E) + \
                torch.log(lc)
            if parts is not None:
                parts.append(sums)
    return o, lse


def plan_splits(N, H, T, S, D, causal, t0, sms=SMS):
    return flash_cuda.fwd_f32_plan(N, H, T, S, D, causal, t0, sms).splits


def _inputs(N, H, T, S, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            for shape in ((N, H, T, D), (N, H, S, D), (N, H, S, D))]


def _jax(x):
    return jnp.asarray(x.numpy())


def _close(got, want, what):
    ok, err, mean = chip_smoke.within(torch, got, want, TOL)
    assert ok, (what, err, mean)


def _check(q, k, v, kvl, causal, t0, split_set):
    """The emulation at each of ``split_set`` against ``_reference`` (o
    and lse) and the JAX kernel with its lse (rows of nonzero key
    length)."""
    N, H, T, D = q.shape
    o_p, lse_p = TF._reference(q, k, v, kvl, causal, t0, with_lse=True)
    live = [i for i in range(N) if int(kvl[i]) > 0]
    jo, jlse = JF._flash_forward(_jax(q[live]), _jax(k[live]), _jax(v[live]),
                                 jnp.asarray(kvl[live].numpy()), causal, t0,
                                 interpret=True, with_lse=True)
    jo = torch.from_numpy(np.array(jo))
    jlse = torch.from_numpy(np.array(jlse)[:, :T, 0].reshape(len(live), H,
                                                             T))
    for P in split_set:
        o, lse = emulate(q, k, v, kvl, causal, t0, P)
        _close(o, o_p, f"against _reference, {P} splits")
        torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
        _close(o[live], jo, f"against the JAX kernel, {P} splits")
        torch.testing.assert_close(lse[live], jlse, atol=1e-4, rtol=1e-5)
    return o


@pytest.mark.parametrize("T,S,causal,t0,D", K5_CASES)
def test_f32_tiles_match_plain_and_jax(T, S, causal, t0, D):
    """K5_CASES' shapes (N = 3, H = 2; key lengths full, mid-tile and 0),
    unsplit and in the plan's splits on an H100 (these shapes are small,
    so the plan splits wherever a tile has more than one key tile); the
    zero-length row is the mean of v over S."""
    N, H = 3, 2
    q, k, v = _inputs(N, H, T, S, D, T * 1000 + S + D + t0)
    kvl = torch.tensor([S, max(S // 2 + 1, 1), 0], dtype=torch.int32)
    o = _check(q, k, v, kvl, causal, t0,
               {1, plan_splits(N, H, T, S, D, causal, t0)})
    torch.testing.assert_close(o[2], v[2].mean(1, keepdim=True).expand(
        H, T, D), atol=1e-5, rtol=0)


# (N, H, T, S, causal, t0, D, key lengths, forced splits): --grad-norms'
# (1, 8, 384, 64) with 2 heads (the plan gives 6) and with 8 (2); key
# lengths that end inside a split (200 of 384: 4 live tiles in 3 splits,
# [0, 1), [1, 2), [2, 4); in 6, empty splits too); t0 > 0; a zero key
# length through the merge (the mean of v)
SPLIT_CASES = [
    (1, 2, 384, 384, False, 0, 64, [384], [3, 2]),
    (2, 2, 384, 384, False, 0, 64, [384, 200], [3, 6]),
    (2, 2, 384, 384, True, 0, 32, [384, 200], [3, 4]),
    (2, 2, 256, 384, True, 128, 64, [384, 300], [3, 5]),
    (2, 1, 200, 200, True, 70, 64, [200, 0], [2, 3]),
    (2, 2, 130, 300, False, 0, 32, [0, 77], [5]),
]


@pytest.mark.parametrize("N,H,T,S,causal,t0,D,kvl,forced", SPLIT_CASES)
def test_f32_splits_match_plain_and_jax(N, H, T, S, causal, t0, D, kvl,
                                        forced):
    q, k, v = _inputs(N, H, T, S, D, N * T + S + t0)
    kvl = torch.tensor(kvl, dtype=torch.int32)
    planned = plan_splits(N, H, T, S, D, causal, t0)
    assert planned > 1                 # these shapes are split on an H100
    o = _check(q, k, v, kvl, causal, t0, {planned, *forced})
    for i in range(N):
        if int(kvl[i]) == 0:
            torch.testing.assert_close(o[i], v[i].mean(1, keepdim=True)
                                       .expand(H, T, D), atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,D", [(129, 64), (300, 32), (300, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_packed_tiles_match_plain_and_jax(T, D, causal):
    """K7 in fp32, unsplit: ragged segments across the 64-row tiles and
    one segment over rows 100..200, against ``_packed_reference`` and the
    JAX packed kernel in interpret mode."""
    rng = np.random.default_rng(T + D + causal + 1)
    q, k, v = _inputs(2, 2, T, T, D, T + D + causal)
    seg_np = _ragged_segments(rng, 2, T)
    seg_np[1, 100:200] = seg_np[1, 99] + 1
    seg_np[1, 200:] = np.where(seg_np[1, 200:] > 0, seg_np[1, 200:] + 2, 0)
    seg = torch.from_numpy(seg_np)
    o, _ = emulate(q, k, v, None, causal, 0, 1, seg=seg)
    _close(o, TF._packed_reference(q, k, v, seg, causal),
           "against _packed_reference")
    want = JF.flash_attention_packed(_jax(q), _jax(k), _jax(v),
                                     jnp.asarray(seg_np), causal,
                                     interpret=True)
    _close(o, torch.from_numpy(np.array(want)), "against the JAX kernel")


def test_plan_splits_at_grad_norms():
    """--grad-norms' shape (chip_smoke.GN_ATTN, non-causal): 48 query
    tiles of 6 key tiles each; the split whose heaviest SM has the least to
    do, the fewest of those: 2 (96 blocks of 3 key tiles), beside the
    scratch of their (acc, m, l)."""
    N, H, T, D = chip_smoke.GN_ATTN
    p = flash_cuda.fwd_f32_plan(N, H, T, T, D, False, 0, SMS)
    assert (p.tiles, p.splits, p.blocks) == (48, 2, 96)
    assert p.part == 96 * FT * (D + 2)
    load = {P: -(-48 * P // SMS) * -(-6 // P) for P in range(1, 7)}
    assert load[2] == min(load.values()) < load[3] < load[1]


@pytest.mark.parametrize("N,H,T,causal", [(2, 12, 1024, True),
                                          (4, 12, 512, True),
                                          (8, 12, 1024, True),
                                          (3, 1, 64, False)])
def test_plan_does_not_split_where_tiles_fill_the_card(N, H, T, causal):
    """hala's fp32 (2, 12, 1024, 64) causal (384 tiles), phase 13's fp32
    K5 (4, 12, 512, 64) (384) and a one-key-tile reach are unsplit."""
    p = flash_cuda.fwd_f32_plan(N, H, T, T, 64, causal, 0, SMS)
    assert (p.splits, p.blocks, p.part) == (1, p.tiles, 0)


@pytest.mark.parametrize("causal,t0,kvl,P", [
    (False, 0, [384, 200, 1, 0], 3), (True, 0, [384, 200, 65], 4),
    (True, 100, [384, 130], 6), (True, 0, [384], 7)])
def test_every_live_pair_in_exactly_one_split(causal, t0, kvl, P):
    """Over all query tiles and splits, each (query, key) pair that the
    masks leave is visited by exactly one split, and no split visits a
    key tile past its query tile's reach."""
    T, S = 300, 384
    for n, kvlen in enumerate(kvl):
        live = ~masked_pairs(np.arange(T), np.arange(S), kvlen, S, causal,
                             t0, None)
        visits = np.zeros((T, S), int)
        for q0 in range(0, T, FT):
            uniform, nk = plan(kvlen, S, T, q0, causal, t0)
            assert not uniform or kvlen == 0
            for s in range(P):
                lo, hi = flash_cuda.f32_split_range(nk, P, s)
                visits[q0:q0 + FT, lo * FT:hi * FT] += 1
        assert (visits[live] == 1).all(), n
        assert visits.max() <= 1


def test_a_split_with_no_live_tile_leaves_the_merge_exact():
    """Key length 64 at T = 128, S = 256, causal: the first query tile has
    one key tile; in 3 splits two hold none (m = -1e30 log2(e), l = 0, acc
    = 0), and their weight 2^(m_s - m) is exactly 0 in the merge: o and
    lse are the unsplit kernel's bits."""
    q, k, v = _inputs(1, 2, 128, 256, 32, 3)
    kvl = torch.tensor([64], dtype=torch.int32)
    parts = []
    o3, lse3 = emulate(q, k, v, kvl, True, 0, 3, parts=parts)
    o1, lse1 = emulate(q, k, v, kvl, True, 0, 1)
    assert [flash_cuda.f32_split_range(1, 3, s) for s in range(3)] == \
        [(0, 0), (0, 0), (0, 1)]
    for m, l, acc in parts[0][:2]:
        assert (m == float(NEG2)).all() and not l.any() and not acc.any()
    assert torch.equal(o3, o1) and torch.equal(lse3, lse1)
    _close(o3, TF._reference(q, k, v, kvl, True, 0), "against _reference")
