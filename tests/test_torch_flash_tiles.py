"""The arithmetic of the bf16 flash attention forward (kernels K5 and K7,
``haloop_tpu_torch/csrc/flash_fwd.cu``, ``flash_wg``) on the CPU: a
blockwise emulation of that kernel, written here, against the port's
plain versions (``ops.flash._reference`` / ``_packed_reference``) and the
JAX package's ``flash_attention`` / ``flash_attention_packed`` in
interpret mode, on the same numpy inputs from a seed.

The emulation follows the kernel: 128-row query tiles, each split into
two 64-row halves (one consumer warpgroup each), 128-key tiles; the same
``plan`` (the key tiles a query tile visits) and skip rules (causal,
kv_lengths, K7's segment ranges; a half skips a tile wholly above its own
diagonal); the elementwise mask only on tiles that straddle a boundary;
scores scaled in base 2 with log2(e)/sqrt(D) folded in, masked to
-1e30·log2(e); P rounded to the input dtype before the normalization.
It also asserts that no skipped tile holds a (query, key) pair that the
masks leave, so the skip rules drop no live tile.

Tolerances: in bf16 ``chip_smoke.ATTN_TOL`` (atol = rtol = 2e-2, mean
|d| < 2e-3: P rounded before the normalization, where the plain version
rounds the normalized weights); in fp32 2e-5, the JAX package's bound for
its flash kernel (tests/test_flash.py); lse 1e-4 (rtol 1e-5). Rows with
kv_lengths 0 are held to the plain version only (the mean of v over S):
the TPU kernel's value there depends on its tiling.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from haloop_tpu.ops import flash as JF
from haloop_tpu_torch.ops import flash as TF

BM = BN = 128               # query rows a block, keys a tile
HALF = 64                   # query rows a consumer warpgroup
LOG2E = 1.4426950408889634
NEG = -1e30
NEG2 = np.float32(NEG * LOG2E)


def plan(kvlen, S, T, q0, causal, t0):
    """(uniform, key tiles to visit) of the query tile at q0."""
    uniform = kvlen <= 0
    kend = S
    if not uniform:
        kend = min(kend, kvlen)
        if causal:
            kend = min(kend, t0 + min(q0 + BM, T))
    return uniform, -(-max(kend, 0) // BN)


def live_tiles(segn, S, T, q0, nk):
    """K7: the key tiles whose [min, max] of segment ids meets the query
    tile's."""
    qs = segn[q0:min(q0 + BM, T)]
    qmin, qmax = int(qs.min()), int(qs.max())
    out = []
    for kt in range(nk):
        ks = segn[kt * BN:min(kt * BN + BN, S)]
        if not (int(ks.max()) < qmin or int(ks.min()) > qmax):
            out.append(kt)
    return out


def masked_pairs(rows, cols, kvlen, S, causal, t0, segn):
    """(rows, cols) bool: the pairs the masks remove."""
    r = rows[:, None]
    c = cols[None, :]
    m = (c >= kvlen) | (c >= S)
    if causal:
        m = m | (c > t0 + r)
    if segn is not None:
        m = m | (segn[np.minimum(r, len(segn) - 1)] !=
                 segn[np.minimum(c, len(segn) - 1)])
    return m


def emulate(q, k, v, kv_lengths, causal, t0, seg=None):
    """The kernel's blockwise arithmetic -> (o in q's dtype, lse fp32)."""
    N, H, T, D = q.shape
    S = k.shape[2]
    qf, kf, vf = (x.float() for x in (q, k, v))
    scale2 = np.float32(LOG2E / math.sqrt(D))
    o = torch.zeros((N, H, T, D), dtype=q.dtype)
    lse = torch.zeros((N, H, T))
    for n in range(N):
        segn = None if seg is None else seg[n].numpy()
        kvlen = S if seg is not None else int(kv_lengths[n])
        for q0 in range(0, T, BM):
            uniform, nk = plan(kvlen, S, T, q0, causal, t0)
            tiles = list(range(nk)) if segn is None else \
                live_tiles(segn, S, T, q0, nk)
            for first in (q0, q0 + HALF):
                rows = np.arange(first, min(first + HALF, T))
                if len(rows) == 0:
                    continue
                m = torch.full((H, len(rows)), float(NEG2))
                l = torch.zeros((H, len(rows)))
                acc = torch.zeros((H, len(rows), D))
                visited = set()
                for kt in tiles:
                    k0 = kt * BN
                    if causal and not uniform and k0 > t0 + first + HALF - 1:
                        continue
                    visited.add(kt)
                    cols = np.arange(k0, k0 + BN)
                    kt_ = torch.zeros((H, BN, D))
                    vt_ = torch.zeros((H, BN, D))
                    real = cols[cols < S]
                    kt_[:, :len(real)] = kf[n, :, real]
                    vt_[:, :len(real)] = vf[n, :, real]
                    s = qf[n, :, rows] @ kt_.transpose(1, 2) * scale2
                    edge = uniform or segn is not None or \
                        k0 + BN > min(kvlen, S) or \
                        (causal and k0 + BN - 1 > t0 + first)
                    if edge:
                        msk = torch.from_numpy(masked_pairs(
                            rows, cols, kvlen, S, causal, t0, segn))
                        if uniform:
                            msk[:] = True
                        s = s.masked_fill(msk, float(NEG2))
                        s = s.masked_fill(torch.from_numpy(cols >= S),
                                          -math.inf)
                    mn = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - mn)
                    m = mn
                    p = torch.exp2(s - m[..., None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + \
                        p.to(q.dtype).float() @ vt_
                # the skip rules drop no live tile
                if not uniform:
                    for kt in range(-(-S // BN)):
                        if kt in visited:
                            continue
                        cols = np.arange(kt * BN, min(kt * BN + BN, S))
                        live = ~masked_pairs(rows, cols, kvlen, S, causal,
                                             t0, segn)
                        assert not live.any(), (n, q0, first, kt)
                lc = torch.clamp(l, min=1e-30)
                o[n, :, rows] = (acc / lc[..., None]).to(q.dtype)
                lse[n, :, rows] = (NEG if uniform else m / LOG2E) + \
                    torch.log(lc)
    return o, lse


def _close(got, want, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5,
                                   msg=what)
    else:
        tol = chip_smoke.ATTN_TOL["bfloat16"]
        ok, err, mean = chip_smoke.within(torch, got, want, tol)
        assert ok, (what, err, mean)


def _inputs(rng, N, H, T, S, D, dtype):
    """q, k, v from numpy, in ``dtype`` (bf16 values exactly representable
    in the fp32 arrays handed to JAX)."""
    q = torch.from_numpy(rng.standard_normal((N, H, T, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((N, H, S, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((N, H, S, D), np.float32))
    return [x.to(dtype) for x in (q, k, v)]


def _jax(x):
    a = jnp.asarray(x.float().numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


# (T, S, causal, t0, D): tile edges at 1, 127, 128, 129, 300; t0 > 0
# with T < S
K5_CASES = [
    (1, 1, True, 0, 64),
    (127, 127, True, 0, 64),
    (128, 128, True, 0, 32),
    (129, 129, True, 0, 64),
    (300, 300, True, 0, 32),
    (300, 300, False, 0, 64),
    (128, 129, False, 0, 32),
    (129, 300, True, 7, 64),
    (127, 300, True, 7, 32),
    (1, 300, True, 7, 64),
    (300, 129, True, 0, 64),
    # the diagonal one column past a tile for a half's first row: t0 +
    # first row == k0 + 126, where a mask skipped one column too early
    # would let the row see its next key
    (129, 300, True, 62, 64),
    (64, 300, True, 126, 32),
]


@pytest.mark.parametrize("T,S,causal,t0,D", K5_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiles_match_plain_and_jax(T, S, causal, t0, D, dtype):
    """K5: key lengths full, mid-tile and 0, against ``_reference`` (o and
    lse) and the JAX kernel in interpret mode (the nonzero lengths)."""
    rng = np.random.default_rng(T * 1000 + S + D + t0)
    q, k, v = _inputs(rng, 3, 2, T, S, D, dtype)
    kvl = torch.tensor([S, max(S // 2 + 1, 1), 0], dtype=torch.int32)
    o, lse = emulate(q, k, v, kvl, causal, t0)
    o_p, lse_p = TF._reference(q, k, v, kvl, causal, t0, with_lse=True)
    _close(o, o_p, dtype, "against _reference")
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    want = JF.flash_attention(_jax(q[:2]), _jax(k[:2]), _jax(v[:2]),
                              jnp.asarray(kvl[:2].numpy()), causal, t0,
                              True)
    _close(o[:2], torch.from_numpy(np.array(want.astype(jnp.float32)))
           .to(dtype), dtype, "against the JAX kernel")


def _ragged_segments(rng, N, T):
    """pack_segments-style ids: runs 1, 2, ... of 8 to 90 tokens, so that
    segments straddle the 128-row tiles, then a 0-padded tail."""
    seg = np.zeros((N, T), np.int32)
    for r in range(N):
        fill, s = 0, 1
        while fill < T - 9:
            n = min(int(rng.integers(8, 91)), T - 9 - fill)
            seg[r, fill:fill + n] = s
            fill, s = fill + n, s + 1
    return seg


@pytest.mark.parametrize("T,D", [(129, 64), (300, 32), (300, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_tiles_match_plain_and_jax(T, D, causal, dtype):
    """K7: ragged segments across the tile boundaries, and one segment
    over rows 100..200 (it straddles 128), against ``_packed_reference``
    and the JAX packed kernel in interpret mode."""
    rng = np.random.default_rng(T + D + causal)
    q, k, v = _inputs(rng, 2, 2, T, T, D, dtype)
    seg_np = _ragged_segments(rng, 2, T)
    seg_np[1, 100:200] = seg_np[1, 99] + 1
    seg_np[1, 200:] = np.where(seg_np[1, 200:] > 0,
                               seg_np[1, 200:] + 2, 0)
    seg = torch.from_numpy(seg_np)
    o, _ = emulate(q, k, v, None, causal, 0, seg=seg)
    _close(o, TF._packed_reference(q, k, v, seg, causal), dtype,
           "against _packed_reference")
    want = JF.flash_attention_packed(_jax(q), _jax(k), _jax(v),
                                     jnp.asarray(seg_np), causal,
                                     interpret=True)
    _close(o, torch.from_numpy(np.array(want.astype(jnp.float32)))
           .to(dtype), dtype, "against the JAX kernel")


def test_skip_rules_skip():
    """The rules do skip: hap --no-pack's causal (32 x 512, 4 query tiles)
    visits 1 + 2 + 3 + 4 of 16 key tiles a head, and 64-token K7 segments
    at T = 1024 one key tile per query tile."""
    assert [plan(512, 512, 512, q0, True, 0)[1]
            for q0 in range(0, 512, BM)] == [1, 2, 3, 4]
    assert plan(300, 512, 512, 384, True, 0)[1] == 3      # ragged length
    seg = np.repeat(np.arange(1, 17), 64)
    for q0 in range(0, 1024, BM):
        assert live_tiles(seg, 1024, 1024, q0,
                          plan(1024, 1024, 1024, q0, True, 0)[1]) == \
            [q0 // BN]
