"""The designs of the decode kernels K11 (``csrc/decode_attn.cu``
``decode``), K12 (``decode_split``) and K13 (``csrc/q8_matmul.cu``
``q8_stripes`` and ``q8_persist``) emulated on
the CPU, block by block, and held against the plain versions and the JAX
package's kernels (interpret mode) on the same numpy inputs; and their
launch plans (``ops/decode_attn_cuda.plan``, ``split_rows``,
``ops/q8_matmul_cuda.plan``).

K11's emulation (``chip_smoke.k11_emulate``, which the smoke run also
uses for a planted fault) follows the kernel: each (row, head)'s attended
rows cut into the plan's cluster of runs of whole steps, each run's max
and sum of 2^(s - max) taken alone and then over the runs, the normalized
p rounded to the cache dtype, the runs' p . v added in run order. Its
limits: ``chip_smoke.K11_REL`` of the largest |y| and DECODE_TOL in bf16,
1e-5 in fp32; the caches bit for bit.

K12's emulation follows the kernel: splits of ``rows`` rows, each walked
in tiles of ``tile_rows`` rows; in a tile each of the 4 warps takes its
quarter of the rows and updates its own running max, sum and fp32
accumulator once (online softmax, p never rounded); the warps are combined
in warp order, the splits merged in split order; the new row is taken from
k_new / v_new, never from the cache. K13's: each cluster rank's k range
in stages of KS k, each stage's k cut into the k groups' 64-wide slices,
each group's fp32 partial over its slices, the groups added in group
order, the ranks in rank order, then the scale and the cast.

Tolerances: K12 max |d| within ``chip_smoke.K12_REL`` of the largest |y|
(the plain version rounds p to bf16 and the kernel does not; fp32 also
1e-5), the caches bit for bit; K13 ``chip_smoke.DECODE_TOL`` in bf16 (one
bf16 rounding of each output), 1e-5 of the largest output in fp32 (the
same fp32 products summed in another order). Each design's planted faults
must read beyond those limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from haloop_tpu.ops import decode_attn as JD
from haloop_tpu.ops.q8_matmul import q8_matmul as j_q8_matmul
from haloop_tpu_torch import quant as TQ
from haloop_tpu_torch.ops import decode_attn as TD
from haloop_tpu_torch.ops import decode_attn_cuda, q8_matmul, q8_matmul_cuda

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H100_SMS = 132


# ------------------------------------------------------------------ K12

def k12_emulate(q, k_new, v_new, k_cache, v_cache, length, starts, n_head,
                rows, tile, fault=None):
    """K12's design on the CPU -> y (B, E); the caches written at row
    ``length`` as the kernel writes them. ``fault``: "last split" (the
    merge drops the last split) or "stale row" (row ``length`` read from
    the cache as it was before the write)."""
    B, S, E = k_cache.shape
    H, D = n_head, E // n_head
    stale_k, stale_v = k_cache[:, length].clone(), v_cache[:, length].clone()
    k_cache[:, length] = k_new
    v_cache[:, length] = v_new
    kn, vn = (stale_k, stale_v) if fault == "stale row" else (k_new, v_new)
    qh = q.float().view(B, H, D)
    start = starts.long().clamp(min=0) if starts is not None else \
        torch.zeros(B, dtype=torch.long)
    scale = 1.0 / D ** 0.5
    neg = torch.tensor(-float("inf"))
    parts = []
    for r0 in range(0, length + 1, rows):
        hi = min(r0 + rows - 1, length)
        warps = [(torch.full((B, H), -float("inf")), torch.zeros(B, H),
                  torch.zeros(B, H, D)) for _ in range(4)]
        for t0 in range(r0, hi + 1, tile):
            for w in range(4):
                m, l, acc = warps[w]
                rr = torch.arange(t0 + w * tile // 4, t0 + (w + 1) * tile // 4)
                idx = rr.clamp(max=S - 1)
                k = k_cache[:, idx].float().view(B, -1, H, D)
                v = v_cache[:, idx].float().view(B, -1, H, D)
                new = (rr == length)[None, :, None, None]
                k = torch.where(new, kn.float().view(B, 1, H, D), k)
                v = torch.where(new, vn.float().view(B, 1, H, D), v)
                s = torch.einsum("bhd,bnhd->bhn", qh, k) * scale
                ok = (rr[None] >= start[:, None]) & (rr[None] <= hi)
                s = torch.where(ok[:, None, :], s, neg)
                mn = torch.maximum(m, s.amax(-1))
                live = mn > -float("inf")
                alpha = torch.where(live, torch.exp(m - mn), torch.ones(()))
                p = torch.where(live[..., None],
                                torch.exp(s - mn[..., None]),
                                torch.zeros(()))
                warps[w] = (torch.where(live, mn, m),
                            l * alpha + p.sum(-1),
                            acc * alpha[..., None] +
                            torch.einsum("bhn,bnhd->bhd", p, v))
        parts.append(_combine(warps))
    if fault == "last split":
        parts = parts[:-1]
    m, l, acc = _combine(parts)
    return (acc / l[..., None]).to(k_cache.dtype).reshape(B, E)


def _combine(states):
    """(m, l, acc) states combined in their order, as the kernel combines
    its warps and merges its splits."""
    mm = torch.stack([m for m, _, _ in states]).amax(0)
    ll, aa = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.where(m > -float("inf"), torch.exp(m - mm), torch.zeros(()))
        ll = ll + l * f
        aa = aa + acc * f[..., None]
    return mm, ll, aa


def _k12_inputs(seed, B, S, E, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, E),) * 3 + ((B, S, E),) * 2]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / \
        want.float().abs().max().item()


def _k12_case(B, S, H, D, dtype, length, starts, rows=None, seed=0):
    """(emulated y, its caches, plain y and caches, JAX gridded y and
    caches) for one case; rows defaults to the plan's on an H100."""
    E = H * D
    jx, tx = _k12_inputs(seed, B, S, E, dtype)
    itemsize = tx[3].element_size()
    tile = decode_attn_cuda.tile_rows(D, itemsize)
    if rows is None:
        rows = decode_attn_cuda.split_rows(B, H, length + 1, D, itemsize,
                                           H100_SMS)
    tst = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    q, kn, vn, kc, vc = tx
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    y = k12_emulate(q, kn, vn, k1, v1, length, tst, H, rows, tile)
    y_p = TD.decode_attend(q, kn, vn, k2, v2, length, tst, n_head=H)
    jst = None if starts is None else jnp.asarray(starts, jnp.int32)
    block = TD.pick_s_block(S, E, itemsize) or 128
    yj, kj, vj = JD.decode_attend_update_gridded(
        *jx, jnp.int32(length), jst, n_head=H, block_s=block, interpret=True)
    jax_out = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
               for a in (yj, kj, vj)]
    return dict(y=y, caches=(k1, v1), plain=(y_p, k2, v2), jax=jax_out,
                tx=tx, rows=rows, tile=tile, tst=tst)


@pytest.mark.parametrize("B,S,H,D", [(1, 256, 2, 32), (3, 512, 4, 64),
                                     (2, 1024, 2, 64), (2, 768, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["first split", "tile boundary",
                                   "last row"])
@pytest.mark.parametrize("split", ["plan", "4 tiles"])
def test_k12_design_matches_plain_and_jax(B, S, H, D, dtype, where, split):
    """The new row in the first split, on a tile boundary and in the last
    row, with left-pad starts; the plan's splits and splits of 4 tiles."""
    itemsize = 2 if dtype == "bfloat16" else 4
    tile = decode_attn_cuda.tile_rows(D, itemsize)
    length = {"first split": 5, "tile boundary": tile,
              "last row": S - 1}[where]
    starts = [1 + b for b in range(B)]
    r = _k12_case(B, S, H, D, dtype, length, starts,
                  rows=None if split == "plan" else 4 * tile, seed=S + B)
    y_p, k2, v2 = r["plain"]
    assert torch.equal(r["caches"][0], k2) and torch.equal(r["caches"][1], v2)
    np.testing.assert_array_equal(r["caches"][0].float().numpy(),
                                  r["jax"][1].numpy())
    for want in (y_p, r["jax"][0]):
        assert _rel(r["y"], want) <= chip_smoke.K12_REL
        if dtype == "float32":
            torch.testing.assert_close(r["y"], want.float(), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k12_design_masked_splits(dtype):
    """starts past the first splits (splits and tiles with no attended
    row), and a row that attends the new row alone."""
    B, S, H, D = 3, 1024, 2, 64
    itemsize = 2 if dtype == "bfloat16" else 4
    rows = 2 * decode_attn_cuda.tile_rows(D, itemsize)
    L = S - 2
    r = _k12_case(B, S, H, D, dtype, L, [3 * rows + 1, 2 * rows, L],
                  rows=rows, seed=9)
    assert torch.isfinite(r["y"].float()).all()
    for want in (r["plain"][0], r["jax"][0]):
        assert _rel(r["y"], want) <= chip_smoke.K12_REL
    torch.testing.assert_close(r["y"][2].float(), r["tx"][2][2].float(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("fault", ["last split", "stale row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k12_design_planted_faults_exceed_the_limit(fault, dtype):
    """The merge dropping the last split, and the new row read from the
    stale cache: each reads beyond K12_REL against the plain version."""
    B, S, H, D, L = 2, 512, 2, 64, 300
    r = _k12_case(B, S, H, D, dtype, L, [200, 230], seed=4)
    q, kn, vn, kc, vc = r["tx"]
    bad = k12_emulate(q, kn, vn, kc.clone(), vc.clone(), L, r["tst"], H,
                      r["rows"], r["tile"], fault=fault)
    assert _rel(r["y"], r["plain"][0]) <= chip_smoke.K12_REL
    assert _rel(bad, r["plain"][0]) > chip_smoke.K12_REL


def test_k12_plan_fills_the_card():
    """At phase 22's and long-cache hat's shapes the grid gives each SM
    eight rounds of its resident blocks (or the splits are one tile), and
    splits are whole tiles. (K12's shared memory is held to a block's and
    an SM's by a static_assert in csrc/decode_attn.cu.)"""
    for B, n in ((32, 4001), (8, 3585), (1, 4001), (3, 1024), (4, 101)):
        for D, itemsize in ((64, 2), (64, 4), (32, 2), (128, 2), (8, 2),
                            (4, 4), (128, 4)):
            tile = decode_attn_cuda.tile_rows(D, itemsize)
            rows = decode_attn_cuda.split_rows(B, 12, n, D, itemsize,
                                               H100_SMS)
            blocks = B * 12 * -(-n // rows)
            assert rows % tile == 0
            assert rows == tile or blocks >= 8 * 4 * H100_SMS
    assert decode_attn_cuda.split_rows(32, 12, 4001, 64, 2, H100_SMS) == 256


def test_k12_scratch_is_per_stream():
    """K12's partials and counters are kept per (device, stream): a call
    on another stream never shares the counters of one in flight."""
    dev = torch.device("cpu")
    try:
        a = decode_attn_cuda._k12_scratch(dev, 1, 8, 4)
        b = decode_attn_cuda._k12_scratch(dev, 2, 8, 4)
        assert a[1].data_ptr() != b[1].data_ptr()
        assert decode_attn_cuda._k12_scratch(dev, 1, 8, 4)[1] is a[1]
        assert int(a[1].abs().sum()) == int(b[1].abs().sum()) == 0
    finally:
        for stream in (1, 2):
            decode_attn_cuda._scratch.pop((dev.index, stream), None)


# ------------------------------------------------------------------ K11

def _k11_case(B, S, H, D, dtype, length, starts, cluster=None, seed=0,
              fault=None):
    """(emulated y, its caches, plain y and caches, JAX y and caches) for
    one case; the cluster defaults to the plan's on an H100."""
    E = H * D
    jx, tx = _k12_inputs(seed, B, S, E, dtype)
    itemsize = tx[3].element_size()
    step = decode_attn_cuda.step_rows(D, itemsize)
    if cluster is None:
        cluster = decode_attn_cuda.plan(B, H, length, D, itemsize,
                                        H100_SMS).cluster
    tst = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    q, kn, vn, kc, vc = tx
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    y = chip_smoke.k11_emulate(q, kn, vn, k1, v1, length, tst, H, cluster,
                               step, fault)
    y_p = TD.decode_attend(q, kn, vn, k2, v2, length, tst, n_head=H)
    jst = None if starts is None else jnp.asarray(starts, jnp.int32)
    yj, kj, vj = JD.decode_attend_update(*jx, jnp.int32(length), jst,
                                         n_head=H, interpret=True)
    jax_out = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
               for a in (yj, kj, vj)]
    return dict(y=y, caches=(k1, v1), plain=(y_p, k2, v2), jax=jax_out,
                cluster=cluster)


# (B, S, H, D, fill level, starts): GPT-2 small's longest fill at a small
# batch (a cluster of 8), hat's fill level 159, the first token
K11_CASES = [(1, 1024, 4, 64, 1000, None), (2, 1024, 2, 64, 1000, [3, 17]),
             (3, 256, 4, 32, 159, [1, 2, 3]), (2, 256, 2, 64, 0, None)]


@pytest.mark.parametrize("B,S,H,D,L,starts", K11_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cluster", ["plan", 1, 2])
def test_k11_design_matches_plain_and_jax(B, S, H, D, L, starts, dtype,
                                          cluster):
    r = _k11_case(B, S, H, D, dtype, L, starts,
                  None if cluster == "plan" else cluster, seed=S + L)
    y_p, k2, v2 = r["plain"]
    assert torch.equal(r["caches"][0], k2) and torch.equal(r["caches"][1], v2)
    np.testing.assert_array_equal(r["caches"][1].float().numpy(),
                                  r["jax"][2].numpy())
    for want in (y_p, r["jax"][0]):
        if dtype == "float32":
            torch.testing.assert_close(r["y"], want.float(), atol=1e-5,
                                       rtol=1e-5)
        else:
            assert _rel(r["y"], want) <= chip_smoke.K11_REL
            torch.testing.assert_close(r["y"].float(), want.float(),
                                       **chip_smoke.DECODE_TOL)


@pytest.mark.parametrize("fault", ["peers ignored", "first step left out"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k11_design_planted_faults_exceed_the_limit(fault, dtype):
    """The cluster's peers' (max, sum) ignored (each rank normalizing by
    its own), and each row's first step of rows left out: each reads
    beyond K11_REL against the plain version, which the sound design
    reads under, at a cluster of 8 (the plan's in bf16, on the tensor
    cores; fp32 runs on the CUDA cores without one)."""
    B, S, H, D, L = 2, 1024, 2, 64, 1000
    itemsize = 2 if dtype == "bfloat16" else 4
    planned = decode_attn_cuda.plan(B, H, L, D, itemsize, H100_SMS).cluster
    assert planned == (8 if dtype == "bfloat16" else 1)
    r = _k11_case(B, S, H, D, dtype, L, [5, 40], cluster=8, seed=7)
    bad = _k11_case(B, S, H, D, dtype, L, [5, 40], cluster=8, seed=7,
                    fault=fault)
    assert _rel(r["y"], r["plain"][0]) <= chip_smoke.K11_REL
    assert _rel(bad["y"], r["plain"][0]) > chip_smoke.K11_REL


def test_k11_plan_at_the_main_paths_shapes():
    """hat's fill levels 96 and 159 at B=32 and B=1, GPT-2 small's longest
    fill and K11's 10 MiB edge (E=768, H=12, bf16, an H100's 132 SMs):
    one block a (row, head) at hat's fills, a cluster of 8 at B=1 over
    1,000 rows and more; a thread's chunks all in flight where they fit
    16 slots."""
    P = decode_attn_cuda.plan
    assert decode_attn_cuda.tensor_cores(64, 2)
    assert P(32, 12, 96, 64, 2, H100_SMS) == (1, 112, 2, 8 * 2 * 2048 + 448)
    assert P(1, 12, 96, 64, 2, H100_SMS)[:3] == (1, 112, 2)
    assert P(32, 12, 159, 64, 2, H100_SMS)[:3] == (1, 160, 4)
    assert P(1, 12, 159, 64, 2, H100_SMS)[:3] == (1, 160, 4)
    assert P(32, 12, 1000, 64, 2, H100_SMS)[:3] == (1, 1008, 4)
    assert P(1, 12, 1000, 64, 2, H100_SMS)[:3] == (8, 128, 2)
    assert P(1, 12, 3000, 64, 2, H100_SMS)[:3] == (8, 384, 4)


def test_k11_plan_at_gpt_nanos_shapes():
    """gpt-nano (E=64, H=2: heads of 32, bf16) runs on the tensor cores,
    one block a (row, head), at its hat's steps (B=3 and B=1, a 64-row
    cache)."""
    P = decode_attn_cuda.plan
    assert decode_attn_cuda.tensor_cores(32, 2)
    assert decode_attn_cuda.step_rows(32, 2) == decode_attn_cuda.TC_ROWS
    assert P(3, 2, 33, 32, 2, H100_SMS) == (1, 48, 2, 8 * 2 * 1024 + 192)
    assert P(1, 2, 17, 32, 2, H100_SMS)[:3] == (1, 32, 2)


def test_k11_plan_takes_a_cluster_only_where_it_paid():
    """A cluster from 640 rows on (B=1, E=768, H=12 on an H100: one block
    a head read faster than a cluster of 8 up to 416 rows and level at
    512, the cluster of 8 faster from 640), and only on the tensor cores:
    fp32 and narrow heads take one block a (row, head) at any fill."""
    P = decode_attn_cuda.plan
    assert decode_attn_cuda.K11_CLUSTER_MIN_ROWS == 640
    assert P(1, 12, 638, 64, 2, H100_SMS).cluster == 1
    assert P(1, 12, 639, 64, 2, H100_SMS).cluster == 8
    assert P(1, 12, 511, 64, 2, H100_SMS).cluster == 1
    for D, itemsize in ((64, 4), (32, 4), (16, 2), (8, 2)):
        assert not decode_attn_cuda.tensor_cores(D, itemsize)
        assert P(1, 12, 3000, D, itemsize, H100_SMS).cluster == 1


@pytest.mark.parametrize("B", [1, 2, 5, 32])
@pytest.mark.parametrize("D,itemsize", [(64, 2), (128, 2), (32, 2), (8, 2),
                                        (4, 4), (32, 4), (128, 4)])
@pytest.mark.parametrize("L", [0, 15, 96, 159, 1000, 3000])
def test_k11_plan_fits_and_is_what_the_launcher_takes(B, D, itemsize, L):
    """The plan's span holds a rank's share of the rows in whole steps,
    its depth is a thread's 16-byte chunks up to 16 (or, on the tensor
    cores, a warp's 16-row chunks up to 4), its shared memory is the
    launcher's formula and fits a block's 227 KB beside the kernel's
    static arrays; on the tensor cores a cluster of up to 8 blocks from
    640 rows on, each an SM of its own and a step of rows; on the CUDA
    cores one block a (row, head)."""
    H = 12
    p = decode_attn_cuda.plan(B, H, L, D, itemsize, H100_SMS)
    step = decode_attn_cuda.step_rows(D, itemsize)
    W = decode_attn_cuda.WARPS
    per = -(-(-(-(L + 1) // p.cluster)) // step) * step
    assert p.span % step == 0 and p.span >= per
    if decode_attn_cuda.tensor_cores(D, itemsize):   # a warp's chunks
        assert step == decode_attn_cuda.TC_ROWS
        units = 2 * -(-(p.span // step) // W)
        assert p.depth == min(units, decode_attn_cuda.TC_DEPTH)
        assert p.smem == W * p.depth * step * D * itemsize + p.span * 4
    else:                                            # a thread's chunks
        units = 2 * -(-(p.span // (step // W)) // W)
        assert p.depth == min(units, decode_attn_cuda.K11_DEPTH)
        assert p.smem == p.depth * decode_attn_cuda.K11_THREADS * 16 + \
            p.span * 4
    static = 4 * (2 * W + W * D + 2 + D)        # the kernel's __shared__
    assert p.smem <= decode_attn_cuda.K11_SMEM and \
        decode_attn_cuda.K11_SMEM + static <= 232448
    assert p.cluster in (1, 2, 4, 8)
    if not decode_attn_cuda.tensor_cores(D, itemsize):
        assert p.cluster == 1
    if p.cluster > 1:
        assert B * H * p.cluster <= H100_SMS
        assert L + 1 >= decode_attn_cuda.K11_CLUSTER_MIN_ROWS
        assert L + 1 >= p.cluster * step


def test_k11_plan_refuses_scores_past_shared_memory():
    """A cache whose row fits K11's 10 MiB but whose scores do not fit a
    block's shared memory (60,000 rows of a 4-wide fp32 head) raises."""
    with pytest.raises(ValueError, match="do not fit in shared memory"):
        decode_attn_cuda.plan(1, 2, 59999, 4, 4, 2)


# ------------------------------------------------------------------ K13

def k13_emulate(x, w_q, scale, plan, drop_rank=None, drop_group=None):
    """K13's design on the CPU -> (M, N) in x's dtype, for a ``plan``
    (kind, grid, cluster size, k a rank): each rank's k in 64-wide chunks,
    chunk c summed by k group c % G (G = 8 warps in q8_stripes, 4 k groups
    in q8_persist), each group's chunks in k order, the groups in group
    order, the ranks in rank order, then the scale. ``drop_rank`` leaves
    that rank's partial out, ``drop_group`` that k group's in every rank
    (planted faults)."""
    kind, _, cl, kr = plan
    K = x.shape[1]
    groups = 8 if kind == 0 else 4
    xf, wf = x.float(), w_q.float()
    total = 0
    for rank in range(cl):
        lo, hi = rank * kr, min(K, (rank + 1) * kr)
        parts = [0] * groups
        for c, a in enumerate(range(lo, hi, 64)):
            b = min(a + 64, hi)
            parts[c % groups] = parts[c % groups] + xf[:, a:b] @ wf[:, a:b].T
        rank_sum = 0
        for i, part in enumerate(parts):
            if i != drop_group:
                rank_sum = rank_sum + part
        if rank != drop_rank:
            total = total + rank_sum
    return (total * scale.float()).to(x.dtype)


def _q8_inputs(M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N, K)) * 0.02).astype(np.float32)
    w[min(3, N - 1)] = 0
    q, s = TQ.quantize_weight(torch.from_numpy(w))
    x = rng.normal(size=(M, K)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return ((jnp.asarray(x, jd), jnp.asarray(q.numpy()),
             jnp.asarray(s.numpy())),
            (torch.from_numpy(x).to(td), q, s.to(td)))


def _q8_close(got, want, dtype):
    if dtype == "float32":
        return ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    tol = chip_smoke.DECODE_TOL
    return bool(torch.isclose(got.float(), want.float(), atol=tol["atol"],
                              rtol=tol["rtol"]).all())


# GPT-2 small's five (N, K) with narrow stand-ins for N where interpret
# mode is slow, and the card's SM count scaled to match (so that the
# stand-ins take the plans the full widths take on an H100: lm_head the
# persistent tiles), plus a ragged one
Q8_CASES = [("c_attn", 2304, 768, H100_SMS), ("attn.c_proj", 768, 768, 132),
            ("c_fc", 3072, 768, 132), ("mlp.c_proj", 768, 3072, 132),
            ("lm_head stand-in", 2048, 768, 16), ("ragged", 1000, 777, 132)]


@pytest.mark.parametrize("name,N,K,sms", Q8_CASES)
@pytest.mark.parametrize("M", [1, 17, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k13_design_matches_plain_and_jax(name, N, K, sms, M, dtype):
    jx, tx = _q8_inputs(M, K, N, dtype, N + K + M)
    plan = q8_matmul_cuda.plan(M, N, K, K % 16 == 0, sms)
    assert plan[0] == (1 if name == "lm_head stand-in" else 0)
    assert plan[2] == (4 if name == "mlp.c_proj" else 1)
    got = k13_emulate(*tx, plan)
    want_p = q8_matmul.q8_matmul(*tx)
    want_j = torch.from_numpy(np.array(jnp.asarray(
        j_q8_matmul(*jx, interpret=True), jnp.float32)))
    assert got.dtype == tx[0].dtype and got.shape == (M, N)
    assert _q8_close(got, want_p, dtype)
    assert _q8_close(got.float(), want_j, dtype)


@pytest.mark.parametrize("name,N,K,sms", Q8_CASES)
def test_k13_design_planted_fault_exceeds_the_limit(name, N, K, sms):
    """One partial dropped: the last cluster rank's where the plan splits
    K across a cluster, else the last k group's: the check fails; and
    chip_smoke.k13_dropped_slice, which plants the same fault on the card
    through K13 itself, drops the same partial."""
    _, tx = _q8_inputs(32, K, N, "bfloat16", N + K)
    plan = q8_matmul_cuda.plan(32, N, K, K % 16 == 0, sms)
    want = q8_matmul.q8_matmul(*tx)
    assert _q8_close(k13_emulate(*tx, plan), want, "bfloat16")
    if plan[2] > 1:
        bad = k13_emulate(*tx, plan, drop_rank=plan[2] - 1)
    else:
        bad = k13_emulate(*tx, plan, drop_group=(8 if plan[0] == 0 else 4)
                          - 1)
    assert not _q8_close(bad, want, "bfloat16")
    x_bad, _ = chip_smoke.k13_dropped_slice(torch, tx[0], tx[1], sms)
    torch.testing.assert_close(q8_matmul.q8_matmul(x_bad, *tx[1:]).float(),
                               k13_emulate(x_bad, *tx[1:], plan).float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(q8_matmul.q8_matmul(x_bad, *tx[1:]).float(),
                               bad.float(), atol=2e-2, rtol=2e-2)


def test_k13_plan_fills_the_card_and_fits():
    """On an H100 (132 SMs), at GPT-2 small's five weights: lm_head takes
    the persistent tiles at M 1 and 32 (one block an SM, the shared memory
    of a block), the stripes at 64 rows; the others take stripes with at
    most two chunks a warp (one past 32 rows) unless the clusters are at
    their 4 already, mlp.c_proj's K split over clusters of 4; every rank
    has some k and cl kr covers K."""
    for M in (1, 32, 64):
        for name, N, K, _ in chip_smoke.Q8_WEIGHTS:
            kind, grid, cl, kr = q8_matmul_cuda.plan(M, N, K, True, H100_SMS)
            assert cl * kr >= K and (cl - 1) * kr < K and kr % 64 == 0
            if name == "lm_head" and M <= 32:
                assert (kind, grid, cl) == (1, H100_SMS, 1)
                assert q8_matmul_cuda.persist_smem(M, K) <= 232448
            else:
                assert kind == 0 and grid == -(-N // 16) * cl
                assert -(-kr // 64) <= 8 * (2 if M <= 32 else 1) or cl == 4
    # unaligned weights never take the persistent tiles (cp.async rows)
    assert q8_matmul_cuda.plan(32, 50304, 777, False, H100_SMS)[0] == 0
