"""The arithmetic of the bf16 flash attention backward (kernels K6a and
K6b, ``haloop_tpu_torch/csrc/flash_bwd.cu``, ``flash_bwd_dq_wg`` and
``flash_bwd_dkv_wg``) on the CPU: a blockwise emulation of those kernels,
written here, against the port's plain version
(``ops.flash._backward_reference``) and the JAX package's
``_flash_backward`` in interpret mode, on the same numpy inputs from a
seed and the same o and lse (the JAX forward's).

The emulation follows the kernels. K6a: one item per 128-row query tile,
split into two 64-row halves (one consumer warpgroup each), 128-key
tiles; the same ``key_end`` (the key tiles an item visits), and a half
skips a tile wholly above its own diagonal; delta = rowsum(do * o) and
lse * log2(e) written to the scratch of (N*H, 2, Tp) fp32, Tp = T rounded
up to 4 (its padding is NaN here: the kernels never read it). K6b: one
item per 128-key tile in two 64-key halves, 64-row query tiles from the
first that can see the key tile; an item at or past kv_lengths[n] loads
nothing; the transposed orientation, keys on the rows, each masked
before its first live query, and lse and delta read from the scratch
per query column, zero past T (as TMA fills them; q and do are zero
there too, so those columns add nothing); a half skips a query tile
wholly before its rows' first live query. Both: p = 2^(s log2(e)/sqrt(D)
- lse log2(e)), the mask only on tiles that straddle a boundary, ds and
p rounded to the input dtype where the kernels round them. It also
asserts that no skipped tile holds a (query, key) pair that the masks
leave.

Tolerances: ``chip_smoke.K6_TOL`` on (dq, dk, dv) through
``chip_smoke.k6_gate``: in fp32 max |d| within 2e-5 of the largest
gradient; in bf16 max |d| 2e-2 of the largest and mean |d| 1e-2 of the
mean (ds and p rounded to bf16, where a rounding can flip between two
orders of summation).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from haloop_tpu.ops import flash as JF
from haloop_tpu_torch.ops import flash as TF

BM = 128            # K6a: query rows an item; K6b: keys an item
BN = 128            # K6a: keys a tile
BT = 64             # K6b: query rows a tile
HALF = 64           # rows of an item a consumer warpgroup owns
LOG2E = 1.4426950408889634
NONE = 1 << 30      # the first live query of a key row that has none


def item(w, NT, causal, late):
    """(n*h, tile) of work item w: head by head; when causal, heavy-light
    pairs with the heavy tile first, the late ones (K6a's query tiles,
    ``late``) or the early ones (K6b's key tiles)."""
    nh, j = divmod(w, NT)
    a = j // 2
    heavy, light = (NT - 1 - a, a) if late else (a, NT - 1 - a)
    return nh, j if not causal else (heavy if j % 2 == 0 else light)


def dq_tiles(kvlen, S, causal, t0, q0):
    """K6a: the key tiles the query tile at q0 visits."""
    kend = min(kvlen, S)
    if causal:
        kend = min(kend, t0 + q0 + BM)
    return -(-max(kend, 0) // BN)


def dkv_tiles(kvlen, S, T, causal, t0, k0):
    """K6b: (first query tile, query tiles) the key tile at k0 visits."""
    qt0 = max(k0 - t0, 0) // BT if causal else 0
    nq = -(-T // BT)
    return qt0, (max(nq - qt0, 0) if k0 < min(kvlen, S) else 0)


def first_query(row, kvlen, causal, t0):
    return NONE if row >= kvlen else (max(row - t0, 0) if causal else 0)


def masked_pairs(rows, cols, kvlen, causal, t0):
    """(query rows, key cols) bool: the pairs the masks remove."""
    m = np.broadcast_to(cols[None, :] >= kvlen, (len(rows), len(cols)))
    if causal:
        m = m | (cols[None, :] > t0 + rows[:, None])
    return m


def _tile(x, r0, rows, limit):
    """Rows [r0, r0 + rows) of x (H, R, D), zeros past ``limit``, as TMA
    loads a box."""
    out = torch.zeros((x.shape[0], rows, x.shape[2]))
    real = max(min(r0 + rows, limit) - r0, 0)
    out[:, :real] = x[:, r0:r0 + real]
    return out


def emulate_dq(q, k, v, o, do, lse, kvl, causal, t0):
    """K6a's blockwise arithmetic -> (dq in q's dtype, the scratch)."""
    N, H, T, D = q.shape
    S = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    scale2 = np.float32(LOG2E * scale)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    scratch = torch.full((N * H, 2, -(-T // 4) * 4), math.nan)
    dq = torch.zeros((N, H, T, D), dtype=q.dtype)
    for n in range(N):
        kvlen = min(int(kvl[n]), S)
        for q0 in range(0, T, BM):
            nk = dq_tiles(kvlen, S, causal, t0, q0)
            for first in (q0, q0 + HALF):
                rows = np.arange(first, min(first + HALF, T))
                if len(rows) == 0:
                    continue
                delta = (dof[n, :, rows] * of[n, :, rows]).sum(-1)
                lse2 = lse[n, :, rows] * np.float32(LOG2E)
                scratch[n * H:(n + 1) * H, 0, rows] = lse2
                scratch[n * H:(n + 1) * H, 1, rows] = delta
                cmax = np.full(len(rows), kvlen - 1)
                cmax_wg = kvlen - 1
                if causal:
                    cmax = np.minimum(cmax, t0 + rows)
                    cmax_wg = min(cmax_wg, t0 + first)
                acc = torch.zeros((H, len(rows), D))
                visited = set()
                for i in range(nk):
                    k0 = i * BN
                    if causal and k0 > t0 + first + HALF - 1:
                        continue            # wholly above these rows
                    visited.add(i)
                    kt = _tile(kf[n], k0, BN, S)
                    vt = _tile(vf[n], k0, BN, S)
                    s = qf[n, :, rows] @ kt.transpose(1, 2)
                    dp = dof[n, :, rows] @ vt.transpose(1, 2)
                    p = torch.exp2(s * scale2 - lse2[..., None])
                    if k0 + BN - 1 > cmax_wg:
                        cols = np.arange(k0, k0 + BN)
                        p = p.masked_fill(torch.from_numpy(
                            cols[None, :] > cmax[:, None]), 0.0)
                    ds = p * (dp - delta[..., None])
                    acc = acc + ds.to(q.dtype).float() @ kt
                for i in range(-(-S // BN)):    # the skipped tiles
                    if i not in visited:
                        cols = np.arange(i * BN, min(i * BN + BN, S))
                        assert masked_pairs(rows, cols, kvlen, causal,
                                            t0).all(), ("K6a", n, first, i)
                dq[n, :, rows] = (acc * scale).to(q.dtype)
    return dq, scratch


def emulate_dkv(q, k, v, do, scratch, kvl, causal, t0):
    """K6b's blockwise arithmetic, reading K6a's scratch -> (dk, dv) in
    k's and v's dtypes."""
    N, H, T, D = q.shape
    S = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    scale2 = np.float32(LOG2E * scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    dk = torch.zeros((N, H, S, D), dtype=k.dtype)
    dv = torch.zeros((N, H, S, D), dtype=v.dtype)
    nq = -(-T // BT)
    for n in range(N):
        kvlen = min(int(kvl[n]), S)
        rows_l2 = scratch[n * H:(n + 1) * H, 0, :T]
        rows_dl = scratch[n * H:(n + 1) * H, 1, :T]
        for k0 in range(0, S, BM):
            qt0, nt = dkv_tiles(kvlen, S, T, causal, t0, k0)
            for first in (k0, k0 + HALF):
                keys = np.arange(first, min(first + HALF, S))
                if len(keys) == 0:
                    continue
                qmin = np.array([first_query(c, kvlen, causal, t0)
                                 for c in keys])
                live_from = first_query(first, kvlen, causal, t0)
                mask_to = first_query(first + HALF - 1, kvlen, causal, t0)
                dka = torch.zeros((H, len(keys), D))
                dva = torch.zeros((H, len(keys), D))
                visited = set()
                for i in range(nt):
                    q0 = (qt0 + i) * BT
                    if q0 + BT - 1 < live_from:
                        continue            # wholly before these keys
                    visited.add(qt0 + i)
                    qt = _tile(qf[n], q0, BT, T)
                    dot = _tile(dof[n], q0, BT, T)
                    l2 = torch.zeros((H, BT))
                    dl = torch.zeros((H, BT))
                    real = max(min(q0 + BT, T) - q0, 0)
                    l2[:, :real] = rows_l2[:, q0:q0 + real]
                    dl[:, :real] = rows_dl[:, q0:q0 + real]
                    s = kf[n, :, keys] @ qt.transpose(1, 2)     # S^T
                    dp = vf[n, :, keys] @ dot.transpose(1, 2)   # dP^T
                    p = torch.exp2(s * scale2 - l2[:, None, :])
                    if q0 < mask_to:
                        cols = np.arange(q0, q0 + BT)
                        p = p.masked_fill(torch.from_numpy(
                            cols[None, :] < qmin[:, None]), 0.0)
                    ds = p * (dp - dl[:, None, :])
                    dva = dva + p.to(do.dtype).float() @ dot
                    dka = dka + ds.to(q.dtype).float() @ qt
                for j in range(nq):             # the skipped tiles
                    if j not in visited:
                        qrows = np.arange(j * BT, min(j * BT + BT, T))
                        assert masked_pairs(qrows, keys, kvlen, causal,
                                            t0).all(), ("K6b", n, first, j)
                dk[n, :, keys] = (dka * scale).to(k.dtype)
                dv[n, :, keys] = dva.to(v.dtype)
    return dk, dv


def emulate(q, k, v, kvl, causal, t0, o, lse, do):
    """K6a, then K6b on its scratch -> (dq, dk, dv)."""
    dq, scratch = emulate_dq(q, k, v, o, do, lse, kvl, causal, t0)
    return (dq,) + emulate_dkv(q, k, v, do, scratch, kvl, causal, t0)


def _close(got, want, dtype, what, one_key=False):
    """K6_TOL on (dq, dk, dv). With ``one_key`` (S = 1) every live row
    attends one key, so p = 1 and ds = dp - delta = 0 in exact arithmetic:
    dq and dk are rounding noise on both sides, held to 1e-4 of zero (the
    inputs are standard normal), and dv alone to K6_TOL."""
    name = "float32" if dtype == torch.float32 else "bfloat16"
    if not one_key:
        ok, reads = chip_smoke.k6_gate(got, want, name)
        assert ok, (what, reads)
        return
    for g in (*got[:2], *want[:2]):
        assert g.float().abs().max().item() <= 1e-4, what
    tol = chip_smoke.K6_TOL[name]
    rmax, rmean = chip_smoke.grad_gate(got[2], want[2],
                                       want[2].float().abs().max().item())
    assert rmax <= tol["max"] and rmean <= tol.get("mean", 1.0), \
        (what, rmax, rmean)


def _jax(x):
    a = jnp.asarray(x.float().numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


def _torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))) \
        .to(dtype)


# (T, S, causal, t0, D): tile edges at 1, 70 (lse rows that are not
# 16-byte multiples), 127, 128, 129, 300, with T != S; t0 7 and 126, and
# 65, where the diagonal meets a tile's last row or key exactly (K6b's
# key row 128 first sees query 63, the last of query tile 0; K6a's rows
# 0 and 64 see keys up to 65 + 63 = 128 and 192)
K6_CASES = [
    (1, 1, True, 0, 64),
    (70, 70, True, 0, 32),
    (127, 127, True, 0, 64),
    (128, 128, False, 0, 32),
    (129, 129, True, 0, 64),
    (300, 300, True, 0, 32),
    (300, 300, False, 0, 64),
    (70, 300, True, 126, 64),
    (129, 300, True, 7, 32),
    (129, 300, True, 65, 64),
    (127, 129, False, 0, 64),
    (1, 300, True, 126, 32),
    (300, 127, True, 0, 64),
    (128, 70, True, 7, 32),
    (300, 1, False, 0, 64),
]


@pytest.mark.parametrize("T,S,causal,t0,D", K6_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiles_match_plain_and_jax(T, S, causal, t0, D, dtype):
    """Key lengths full, mid-tile and 0, against ``_backward_reference``
    and the JAX package's kernels (``_flash_backward``, interpret mode)
    on the JAX forward's o and lse; the zero-length row's gradients are
    zero in all three."""
    rng = np.random.default_rng(T * 1000 + S + D + t0)
    N, H = 3, 2
    q, do = (torch.from_numpy(rng.standard_normal((N, H, T, D), np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((N, H, S, D), np.float32))
            .to(dtype) for _ in range(2))
    kvl = torch.tensor([S, max(S // 2 + 1, 1), 0], dtype=torch.int32)
    jq, jk, jv, jdo = (_jax(x) for x in (q, k, v, do))
    jkvl = jnp.asarray(kvl.numpy())
    _, (*_, jo, jlse) = JF._fwd(jq, jk, jv, jkvl, causal, t0, True)
    o = _torch(jo, dtype)
    lse = torch.from_numpy(np.array(jlse)[:, :T, 0].reshape(N, H, T))
    got = emulate(q, k, v, kvl, causal, t0, o, lse, do)
    _close(got, TF._backward_reference(q, k, v, kvl, causal, t0, o, lse,
                                       do), dtype, "against the plain K6",
           S == 1)
    want = JF._flash_backward(jq, jk, jv, jkvl, causal, t0, jo, jlse, jdo,
                              interpret=True)
    _close(got, [_torch(w, dtype) for w in want], dtype,
           "against the JAX kernels", S == 1)
    for g in got:
        assert not g[2].any()


def test_items_pair_heavy_with_light():
    """Each head's tiles once each; causal, K6a's pairs are (last, first),
    ... and K6b's (first, last), ..., so at hala's T = S = 1024 every pair
    visits as many tiles: 9 key tiles in K6a, 18 query tiles in K6b."""
    for NT in (1, 3, 8):
        for late in (True, False):
            for causal in (True, False):
                tiles = [item(w, NT, causal, late) for w in range(2 * NT)]
                assert sorted(tiles) == [(h, j) for h in range(2)
                                         for j in range(NT)]
    dq = [dq_tiles(1024, 1024, True, 0, item(w, 8, True, True)[1] * BM)
          for w in range(8)]
    assert dq == [8, 1, 7, 2, 6, 3, 5, 4]
    dkv = [dkv_tiles(1024, 1024, 1024, True, 0,
                     item(w, 8, True, False)[1] * BM)[1] for w in range(8)]
    assert dkv == [16, 2, 14, 4, 12, 6, 10, 8]


def test_skip_rules_skip():
    """The rules do skip: past kv_lengths a K6b item loads nothing and a
    K6a item stops at the length's tile; with t0 the first query tile
    moves up; a length of 0 visits nothing."""
    assert dq_tiles(300, 1024, False, 0, 0) == 3
    assert dq_tiles(0, 1024, True, 0, 512) == 0
    assert dkv_tiles(300, 1024, 1024, False, 0, 384) == (0, 0)
    assert dkv_tiles(300, 1024, 1024, True, 0, 256) == (4, 12)
    assert dkv_tiles(1024, 1024, 70, True, 126, 128) == (0, 2)
    assert dkv_tiles(1024, 1024, 70, True, 7, 256) == (3, 0)
