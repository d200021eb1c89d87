"""The arithmetic of the persistent int8 LSTM kernels (K1-q8, both modes,
and K2-q8, ``haloop_tpu_torch/csrc/lstm_q8.cu`` on ``csrc/persist.cuh``) on
the CPU: a blockwise emulation of those kernels, written here, against the
port's plain versions (``nn.lstm.lstm_scan_q8``, ``lstm_scan_bwd_q8``) and
the JAX package's ``_fwd`` / ``_bwd`` with ``quant=True``
(``haloop_tpu/nn/lstm_pallas.py``) in interpret mode, on the same numpy
inputs from a seed; and the routes and plans that pick the kernels.

The emulation follows a plan from ``nn.lstm_cuda.persist_plan``: clusters
of c blocks, cluster q owning c u consecutive hidden units (and, for
K1-q8, their four gate rows of wq); block r of a cluster multiplying
columns [r kc, (r + 1) kc) of the exchanged int8 rows (K1-q8: hq, the
fp32 carried h quantized at 127, h0's by the launch's first phase; K2-q8:
dgates[t+1] * s quantized with one m a batch row) by its resident slab,
in 32-deep k-steps, each of the wk warp groups summing every wk-th
k-step into its own slab; the slabs summed in order, then the c blocks'
partials in rank order. K2-q8's m is the largest of the blocks' row
maxima, each block's taken over its own cells (u units, four gates), as
the kernel publishes them. The sums are integers, exact in every order,
so the emulation must give the plain versions' bits: ys, h, c, acts, cs,
dgates, dh0, dc0 all equal. Against the JAX kernels, where an ulp apart
in a sigmoid or a sum can flip a round() of the int8 quantization: K1-q8
by the share rule of ``tests/test_torch_lstm_q8.py`` (within 1e-5 on all
but 1% of the elements) and on every element 1e-3 (fp32) or one bf16 step
of the larger magnitude, at least the JAX package's own atol of 1e-5 for
its int8 kernel (tests/test_lstm_pallas.py::test_q8_fwd_matches_oracle;
the smaller inputs here give values near 0 where one bf16 step is below
any such flip); K2-q8, whose flips spread through the rows' shared scale
over the steps, within ``chip_smoke.K2Q8_REL`` (relative L2 of each
output, tighter than the JAX package's cosine of 0.999 for its int8
grads, tests/test_lstm_pallas.py::test_q8_grads_track_oracle).

Planted faults read beyond ``chip_smoke.K1Q8_REL`` / ``K2Q8_REL``
(relative L2 against the plain version) where the sound emulation reads 0:
one block of K1-q8 multiplying a step-old hq (the missing grid barrier),
and K2-q8's m taken over a block's own columns
(``chip_smoke.k2_q8_block_max`` with the plan's u).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from haloop_tpu.nn import lstm_pallas as Q
from haloop_tpu_torch.nn import lstm, lstm_cuda

from test_torch_lstm_q8 import _f32

torch.set_num_threads(1)

KS = lstm_cuda.KS
# an H100's SMs and shared memory a block, and the clusters it holds at
# once (queried on one: 30 of 4, 15 of 8, hl_lstm_card)
SMS, SMEM = 132, 232448
CARD_CLUSTERS = {"fwd_q8": 30, "bwd_q8": 15, "fwd": 30, "bwd": 15}
KSTEP = 32                      # int8 elements of an mma.sync k-step


def cluster_product(x, rows, plan, kdim, stale=None):
    """x (B, kdim) and rows (N, kdim), int64: the cluster's (B, N) integer
    sums as the kernel forms them. ``stale`` (rank, x'): that rank
    multiplies x' instead (a planted fault)."""
    total = torch.zeros((x.shape[0], rows.shape[0]), dtype=torch.int64)
    for r in range(plan.c):
        xr = stale[1] if stale and stale[0] == r else x
        k0 = r * plan.kc
        slabs = [torch.zeros_like(total) for _ in range(plan.wk)]
        for ks in range(plan.kc // KSTEP):
            k = k0 + KSTEP * ks
            if k >= kdim:
                continue
            k1 = min(k + KSTEP, kdim)
            slabs[ks % plan.wk] += xr[:, k:k1] @ rows[:, k:k1].T
        for slab in slabs:
            total += slab
    return total


def emulate_fwd_q8(wq, s, xp, h0, c0, plan, residuals=False, fault=None):
    """K1-q8 on CPU tensors (wq int8, s fp32, xp bf16 or fp32, h0 and c0
    fp32) as the persistent kernel computes it. ``fault`` (q, r): block r
    of cluster q multiplies the hq of the step before (h_{t-2}) from the
    third step on, where the grid barrier should have made it wait."""
    T, B, H4 = xp.shape
    H = H4 // 4
    cu = plan.c * plan.u
    sdiv = (s / 127.0).float()
    wl = wq.long()
    c = c0.float()
    ys = torch.empty((T, B, H), dtype=xp.dtype)
    acts = torch.empty((T, B, 4 * H), dtype=torch.bfloat16)
    cs = torch.empty((T, B, H), dtype=torch.bfloat16)
    hq = [lstm.q8_row(h0.float()).long()]   # the first phase: h0's
    h = h0.float()
    for t in range(T):
        acc = torch.empty((B, 4 * H), dtype=torch.int64)
        for q in range(plan.clusters):
            units = torch.arange(q * cu, min((q + 1) * cu, H))
            if not len(units):
                continue
            rows = torch.cat([g * H + units for g in range(4)])
            stale = None
            if fault and fault[0] == q and t >= 2:
                stale = (fault[1], hq[t - 1])
            acc[:, rows] = cluster_product(hq[t], wl[rows], plan, H, stale)
        i, f, g, o = (xp[t].float() + acc.float() * sdiv).chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[t] = h.to(xp.dtype)
        acts[t] = torch.cat([i, f, g, o], dim=-1).to(torch.bfloat16)
        cs[t] = c.to(torch.bfloat16)
        hq.append(lstm.q8_row(h).long())
    if residuals:
        return ys, h, c, acts, cs
    return ys, h, c


def emulate_bwd_q8(dys, acts, c_prev, cs, wq, s, dh_last, dc_last, plan):
    """K2-q8 as the persistent kernel computes it: the arguments and
    results of ``nn.lstm.lstm_scan_bwd_q8``."""
    T, B, H4 = acts.shape
    H = H4 // 4
    cu = plan.c * plan.u
    wt = wq.long().T                          # (H, 4H): the slab's rows
    dh = dh_last.to(torch.bfloat16).float()
    dc = dc_last.to(torch.bfloat16).float()
    dgates = torch.empty((T, B, H4), dtype=torch.bfloat16)
    for t in range(T - 1, -1, -1):
        i, f, g, o = acts[t].float().chunk(4, dim=-1)
        tc = torch.tanh(cs[t].float())
        dh = dh + dys[t].float()
        do = dh * tc * o * (1 - o)
        dc = dc + dh * o * (1 - tc * tc)
        d = torch.cat([dc * g * i * (1 - i),
                       dc * c_prev[t].float() * f * (1 - f),
                       dc * i * (1 - g * g), do], dim=-1)
        dgates[t] = d.to(torch.bfloat16)
        dgs = d * s
        # each block's maximum over its own cells, then the largest
        pmax = torch.zeros((B, plan.blocks))
        for blk in range(min(plan.blocks, -(-H // plan.u))):
            units = torch.arange(blk * plan.u, min((blk + 1) * plan.u, H))
            if len(units):
                cols = torch.cat([gi * H + units for gi in range(4)])
                pmax[:, blk] = dgs[:, cols].abs().amax(dim=-1)
        m = torch.clamp_min(pmax.amax(dim=-1, keepdim=True), 1e-20)
        q8 = lstm.q8_row(dgs / m).long()
        acc = torch.empty((B, H), dtype=torch.int64)
        for q in range(plan.clusters):
            units = torch.arange(q * cu, min((q + 1) * cu, H))
            acc[:, units] = cluster_product(q8, wt[units], plan, H4)
        dh = acc.float() * (m / 127.0)
        dc = dc * f
    return dgates, dh, dc


def _inputs(T, B, H, seed, dtype=torch.bfloat16):
    """wq, s of a random W_hh; x_proj in ``dtype``; h0, c0; upstream
    grads; from a numpy seed."""
    rng = np.random.default_rng(seed)
    w = ((rng.random((4 * H, H)) * 2 - 1) * 2 / H ** 0.5).astype(np.float32)
    xp = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    h0, c0, dh, dc = ((rng.normal(size=(B, H)) * 0.1).astype(np.float32)
                      for _ in range(4))
    dys = rng.normal(size=(T, B, H)).astype(np.float32)
    wq, s = lstm.quantize_rows(torch.from_numpy(w))
    return (wq, s, torch.from_numpy(xp).to(dtype), torch.from_numpy(h0),
            torch.from_numpy(c0), torch.from_numpy(dys).to(torch.bfloat16),
            torch.from_numpy(dh), torch.from_numpy(dc))


def _plan(kind, H, blocks=None):
    """The card's plan (as many clusters of the kind's size as an H100
    holds), or one of at most ``blocks`` blocks."""
    c = lstm_cuda.CLUSTERS[kind]
    clusters = CARD_CLUSTERS[kind] if blocks is None else blocks // c
    plan = lstm_cuda.persist_plan(kind, H, SMS, SMEM, clusters)
    assert plan is not None and plan.c == c
    if blocks is not None:
        assert plan.blocks <= blocks
    return plan


def assert_q8_close(got, want, bf16):
    """The JAX comparison of the module docstring."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 1e-5).mean() <= 0.01, (d > 1e-5).mean()
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7,
                     1e-5) if bf16 else 1e-3
    assert (d <= top).all(), d.max()


def _rel(got, want):
    return chip_smoke.rel_err(got, want)


# (T, B, H, blocks): T in {1, 3, 6, 9}, B from 3 to 48, H from 64 to 256
# (80 and 176 not multiples of 32); blocks None: the H100's plan; 16: H
# over at most 16 blocks, which divide neither H nor its gates (as H =
# 1536 over 96 on the card)
SHAPES = [(1, 5, 64, None), (6, 48, 128, None), (9, 3, 80, None),
          (3, 17, 256, None), (9, 48, 176, 16), (6, 5, 256, 16),
          (3, 48, 96, None), (9, 7, 208, 16)]


@pytest.mark.parametrize("T,B,H,blocks", SHAPES)
def test_persistent_k1q8_emulation_matches_plain_bits_and_jax(T, B, H,
                                                              blocks):
    """Both K1-q8 modes: the emulation equals lstm_scan_q8 (with
    residuals) bit for bit, ys, the last h and c, acts and cs, and stays
    within assert_q8_close of the JAX kernel's _fwd (quant=True,
    interpreted); the residual mode changes nothing else."""
    wq, s, xp, h0, c0, *_ = _inputs(T, B, H, seed=T * 100 + B + H)
    plan = _plan("fwd_q8", H, blocks)
    got = emulate_fwd_q8(wq, s, xp, h0, c0, plan, residuals=True)
    for a, b in zip(emulate_fwd_q8(wq, s, xp, h0, c0, plan), got):
        assert torch.equal(a, b)
    want = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
    for name, g, p in zip(("ys", "h", "c", "acts", "cs"), got, want):
        assert torch.equal(g, p), (name, _rel(g, p))
    jys, jacts, jcs, jh, jc = Q._fwd(
        jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()),
        jnp.asarray(xp.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy()), True,
        interpret=True, residuals=True)
    for g, j, bf16 in zip(got, (jys, jh, jc, jacts, jcs),
                          (True, False, False, True, True)):
        assert_q8_close(g.float().numpy(), _f32(j), bf16)


@pytest.mark.parametrize("T,B,H,blocks", SHAPES)
def test_persistent_k2q8_emulation_matches_plain_bits_and_jax(T, B, H,
                                                              blocks):
    """K2-q8: the emulation equals lstm_scan_bwd_q8 bit for bit on the
    plain forward's residuals, dgates, dh0 and dc0, and stays within
    chip_smoke.K2Q8_REL (relative L2) of the JAX kernel's _bwd
    (quant=True, interpreted)."""
    wq, s, xp, h0, c0, dys, dh, dc = _inputs(T, B, H, seed=T * 7 + B + H)
    _, _, _, acts, cs = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
    c_prev = torch.cat([c0[None].to(torch.bfloat16), cs[:-1]])
    plan = _plan("bwd_q8", H, blocks)
    got = emulate_bwd_q8(dys, acts, c_prev, cs, wq, s, dh, dc, plan)
    want = lstm.lstm_scan_bwd_q8(dys, acts, c_prev, cs, wq, s, dh, dc)
    for name, g, p in zip(("dgates", "dh0", "dc0"), got, want):
        assert torch.equal(g, p), (name, _rel(g, p))
    j = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    jout = Q._bwd(jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), j(acts),
                  j(c_prev), j(cs), j(dys), jnp.asarray(dh.numpy()),
                  jnp.asarray(dc.numpy()), True, interpret=True)
    for name, g, jo in zip(("dgates", "dh0", "dc0"), got, jout):
        err = _rel(g, torch.from_numpy(_f32(jo)))
        assert err <= chip_smoke.K2Q8_REL[name], (name, err)


def test_stale_hq_fault_reads_beyond_k1q8_rel():
    """One block of K1-q8 multiplying the step-old hq (what a missing or
    early grid barrier gives) moves ys beyond K1Q8_REL, where the sound
    emulation reads 0."""
    T, B, H = 9, 48, 176
    wq, s, xp, h0, c0, *_ = _inputs(T, B, H, seed=7)
    plan = _plan("fwd_q8", H, 16)
    want = lstm.lstm_scan_q8(wq, s, xp, h0, c0)
    sound = emulate_fwd_q8(wq, s, xp, h0, c0, plan)
    faulty = emulate_fwd_q8(wq, s, xp, h0, c0, plan, fault=(1, 2))
    assert max(_rel(a, b) for a, b in zip(sound, want)) == 0
    err = _rel(faulty[0], want[0])
    assert err > chip_smoke.K1Q8_REL, err


def test_block_max_fault_reads_beyond_k2q8_rel():
    """K2-q8's row scale m over a block's own cells (u units, four gates;
    chip_smoke.k2_q8_block_max with the plan's u) instead of over the
    row's 4H moves dgates and dh0 beyond K2Q8_REL."""
    T, B, H = 9, 48, 176
    wq, s, xp, h0, c0, dys, dh, dc = _inputs(T, B, H, seed=8)
    _, _, _, acts, cs = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
    c_prev = torch.cat([c0[None].to(torch.bfloat16), cs[:-1]])
    plan = _plan("bwd_q8", H, 16)
    args = (dys, acts, c_prev, cs, wq, s, dh, dc)
    want = lstm.lstm_scan_bwd_q8(*args)
    bad = chip_smoke.k2_q8_block_max(*args, ju=plan.u)
    assert _rel(bad[0], want[0]) > chip_smoke.K2Q8_REL["dgates"]
    assert _rel(bad[1], want[1]) > chip_smoke.K2Q8_REL["dh0"]


@pytest.mark.parametrize("H", [1536, 1024, 512])
@pytest.mark.parametrize("clusters", ["sms", "card"])
def test_int8_routes_take_the_persistent_kernels_at_hac_widths(H, clusters):
    """lstm:512 (1536), the RNN-T encoder (1024) and its prediction net
    (512) have persistent K1-q8 and K2-q8 plans on 132 SMs with 227 KB a
    block: they fit (K2-q8's static row buffers beside), cover H and keep
    a block's units within 16, in less shared memory than the bf16 plans
    (an int8 slab row is kc + 16 bytes, a bf16 one 2 kc + 16); at
    lstm:512 they take 16 units a block (96 blocks against 112 for 14:
    Q8_WHOLE_SECTORS), elsewhere the fewest. The routes take them, but
    for K1-q8 below Q8_FWD_MIN_H (H = 512), which takes the per-step
    kernel."""
    for kind in ("fwd_q8", "bwd_q8"):
        ncl = None if clusters == "sms" else CARD_CLUSTERS[kind]
        plan = lstm_cuda.persist_plan(kind, H, SMS, SMEM, ncl)
        name = lstm_cuda.route(kind, torch.bfloat16, H, 48, SMS, SMEM,
                               ncl)[0]
        short = kind == "fwd_q8" and H < lstm_cuda.Q8_FWD_MIN_H
        assert name == ("tc_step" if short else "persist")
        assert plan.smem + lstm_cuda.STATIC_SMEM.get(kind, 0) <= SMEM
        assert plan.blocks <= SMS and plan.c == lstm_cuda.CLUSTERS[kind]
        assert plan.c * plan.u * plan.clusters >= H > \
            plan.c * plan.u * (plan.clusters - 1)
        assert plan.u <= 16 and plan.kc % KS == 0
        assert plan.c * plan.kc >= (H if kind == "fwd_q8" else 4 * H)
        assert plan.npw * plan.nw * 8 == plan.n and plan.nw * plan.wk <= 8
        bf = lstm_cuda.persist_plan(kind[:3], H, SMS, SMEM, ncl)
        assert plan.kc == bf.kc and plan.smem < bf.smem
        assert plan.u == (16 if H == 1536 else bf.u)
    assert lstm_cuda.Q8_FWD_MIN_H in (1024, 1536)
    plan = lstm_cuda.route("fwd_q8", torch.bfloat16, 1536, 48, SMS, SMEM,
                           CARD_CLUSTERS["fwd_q8"])[1]
    assert (plan.u, plan.clusters, plan.n, plan.kc) == (16, 24, 256, 384)
    assert plan.n * (plan.kc + 16) == 102_400      # bf16 (u = 14): 175,616


@pytest.mark.parametrize("kind", ["fwd_q8", "bwd_q8"])
def test_int8_routes_of_other_shapes(kind):
    """H = 2048 stays per-step: a block would need 18 units or more (30
    clusters of 4, 15 of 8 resident), past the kernels' 16. H % 16 != 0
    takes the CUDA-core kernel (int_step) or, at H % 32 == 0 with fp32
    x_proj (K1-q8 under --dtype float32), the per-step tensor-core one;
    H = 80 has persistent K2-q8 and, below Q8_FWD_MIN_H, per-step K1-q8;
    any batch takes the route of its H."""
    ncl = CARD_CLUSTERS[kind]
    assert lstm_cuda.route(kind, torch.bfloat16, 2048, 48, SMS, SMEM,
                           ncl) == ("tc_step", None)
    c = lstm_cuda.CLUSTERS[kind]
    assert -(-2048 // (c * ncl)) > lstm_cuda.UNITS[-1]
    for H in (40, 200, 36):
        assert lstm_cuda.route(kind, torch.bfloat16, H, 5, SMS, SMEM,
                               ncl) == ("int_step", None)
    if kind == "fwd_q8":
        assert lstm_cuda.route(kind, torch.float32, 1536, 48, SMS, SMEM,
                               ncl) == ("tc_step", None)
        assert lstm_cuda.route(kind, torch.float32, 80, 48, SMS, SMEM,
                               ncl) == ("int_step", None)
    assert lstm_cuda.route(kind, torch.bfloat16, 80, 48, SMS, SMEM,
                           ncl)[0] == ("int_step" if kind == "fwd_q8" else
                                       "persist")
    assert lstm_cuda.route(kind, torch.bfloat16, 1536, 1, SMS, SMEM, ncl) \
        == lstm_cuda.route(kind, torch.bfloat16, 1536, 256, SMS, SMEM, ncl)


def test_per_step_entry_takes_the_per_step_route():
    """``per_step`` (chip_smoke.py's same-bits check) counts the per-step
    route of the shape without asking the card."""
    before = dict(lstm_cuda.route_launches)
    for kind in ("fwd_q8", "bwd_q8"):
        plan, bar, p = lstm_cuda._launch_route(kind, torch.bfloat16, 1536,
                                               48, "cpu", per_step=True)
        assert plan is bar is p is None
    took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
            if v != before[k]}
    assert took == {"fwd_q8_tc_step": 1, "bwd_q8_tc_step": 1}
    lstm_cuda.route_launches.update(before)
