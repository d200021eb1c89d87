"""The arithmetic of the persistent LSTM kernels (K1, both modes,
``haloop_tpu_torch/csrc/lstm_fwd.cu``, and K2, ``csrc/lstm_bwd.cu``) on
the CPU, in bf16 (``csrc/persist.cuh``) and in fp32 (``persist_f32``,
``csrc/persist_f32.cuh``; below the bf16 part): blockwise emulations of
those kernels, written here, against the port's plain versions
(``nn.lstm.lstm_scan``, ``lstm_scan_bwd``) and the JAX package's ``_fwd``
/ ``_bwd`` (``haloop_tpu/nn/lstm_pallas.py``) in interpret mode, on the
same numpy inputs from a seed; and the route and plans that pick the
kernels.

The emulation follows a plan from ``nn.lstm_cuda.persist_plan``: clusters
of c blocks, cluster q owning c u consecutive hidden units (and, for K1,
their four gate rows); block r of a cluster multiplying columns [r kc,
(r + 1) kc) of the exchanged rows (h_{t-1} = ys[t-1], the previous step's
bf16 output, for K1; dgates[t+1] as stored, for K2) by its resident slab,
in 16-deep k-steps of bf16 operands with fp32 sums, in column order, each
of the wk warp groups summing every wk-th k-step into its own slab;
the slabs summed in order, then the c blocks' partials summed in rank
order (the cluster's exchange through distributed shared memory); then
the cell update (K1) or the elementwise delta (K2) in fp32 for each
block's u units. The exchange between steps goes through ys (K1) and
dgates (K2) one step at a time, as the grid barrier orders it; K2's dh0 is
one more product after the last step. Within a 16-deep k-step the
tensor core's order of summation is its own; the emulation sums those 16
products in torch's order.

Tolerance: ``chip_smoke.LSTM_TOL["bfloat16"]`` (atol = rtol = 2e-2, mean
|d| < 2e-3), the JAX package's bound for its kernel
(tests/test_lstm_pallas.py); in fp32 ``LSTM_TOL["float32"]`` (atol = rtol
= mean = 1e-4: fp32 products summed in another order). A planted fault,
one block of K1 reading h_{t-2} where it should read h_{t-1} (the missing
grid barrier), must read beyond it in either dtype.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from haloop_tpu.nn.lstm_pallas import _bwd as jax_bwd, _fwd as jax_fwd
from haloop_tpu_torch.nn import lstm, lstm_cuda

torch.set_num_threads(1)

TOL = chip_smoke.LSTM_TOL["bfloat16"]
KS = lstm_cuda.KS
# the card the plans are made for: an H100's SMs and shared memory a
# block, and the clusters it holds at once (queried on one: 30 of 4, 15
# of 8, hl_lstm_card)
SMS, SMEM = 132, 232448
CARD_CLUSTERS = {"fwd": 30, "bwd": 15}


def _bf(a):
    """bf16-rounded values in fp32."""
    return a.to(torch.bfloat16).float()


def cluster_product(x, rows, plan, kdim, stale=None):
    """x (B, kdim) and rows (N, kdim), bf16 values in fp32: the cluster's
    (B, N) product as the kernel sums it. ``stale`` (rank, x'): that rank
    multiplies x' instead (a planted fault)."""
    total = torch.zeros((x.shape[0], rows.shape[0]))
    for r in range(plan.c):
        xr = stale[1] if stale and stale[0] == r else x
        k0 = r * plan.kc
        slabs = [torch.zeros_like(total) for _ in range(plan.wk)]
        for ks in range(plan.kc // 16):
            k = k0 + 16 * ks
            if k >= kdim or k >= k0 + plan.kc:
                continue
            k1 = min(k + 16, kdim)
            slabs[ks % plan.wk] += xr[:, k:k1] @ rows[:, k:k1].T
        part = slabs[0]
        for s in slabs[1:]:
            part = part + s
        total = total + part
    return total


def emulate_fwd(w, xp, h0, c0, plan, residuals=False, fault=None):
    """K1 on CPU tensors (w, xp bf16; h0, c0 fp32) as the persistent kernel
    computes it. ``fault`` (q, r): block r of cluster q reads h_{t-2} (h0
    at t = 1) from the third step on, where the grid barrier should have
    made it read h_{t-1}."""
    T, B, H4 = xp.shape
    H = H4 // 4
    cu = plan.c * plan.u
    wf = w.float()
    c = c0.float().clone()
    h_last = h0.float().clone()
    ys = torch.empty((T, B, H), dtype=torch.bfloat16)
    acts = torch.empty((T, B, 4 * H), dtype=torch.bfloat16)
    cs = torch.empty((T, B, H), dtype=torch.bfloat16)
    hs = [_bf(h0.float())]                    # h_{t-1} in W's dtype
    for t in range(T):
        gates = torch.empty((B, 4 * H))
        for q in range(plan.clusters):
            units = torch.arange(q * cu, min((q + 1) * cu, H))
            if not len(units):
                continue
            rows = torch.cat([g * H + units for g in range(4)])
            stale = None
            if fault and fault[0] == q and t >= 2:
                stale = (fault[1], hs[t - 1])
            gates[:, rows] = xp[t].float()[:, rows] + cluster_product(
                hs[t], wf[rows], plan, H, stale)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
            torch.sigmoid(o)
        c = f * c + i * g
        h_last = o * torch.tanh(c)
        ys[t] = h_last.to(torch.bfloat16)
        acts[t] = torch.cat([i, f, g, o], -1).to(torch.bfloat16)
        cs[t] = c.to(torch.bfloat16)
        hs.append(ys[t].float())
    if residuals:
        return ys, h_last, c, acts, cs
    return ys, h_last, c


def emulate_bwd(dys, acts, c_prev, cs, w, dh_last, dc_last, plan):
    """K2 as the persistent kernel computes it: the arguments and results
    of ``nn.lstm.lstm_scan_bwd`` (bf16 residuals)."""
    T, B, H4 = acts.shape
    H = H4 // 4
    cu = plan.c * plan.u
    wt = w.float().T                          # (H, 4H): the slab's rows
    dh = _bf(dh_last.float())
    dc = _bf(dc_last.float())
    dgates = torch.empty((T, B, H4), dtype=torch.bfloat16)

    def product(d):                           # d (B, 4H) as stored
        out = torch.empty((B, H))
        for q in range(plan.clusters):
            units = torch.arange(q * cu, min((q + 1) * cu, H))
            if len(units):
                out[:, units] = cluster_product(d, wt[units], plan, H4)
        return out

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
        dh = product(dgates[t].float())
        dc = dc * f
    return dgates, dh, dc


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    w = ((rng.random((4 * H, H)) * 2 - 1) * 2 / H ** 0.5).astype(np.float32)
    xp = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    h0 = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    c0 = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    dys = rng.normal(size=(T, B, H)).astype(np.float32)
    dh = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    dc = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    return w, xp, h0, c0, dys, dh, dc


def _close(got, want):
    ok, err, mean = chip_smoke.within(torch, torch.as_tensor(np.array(got)),
                                      torch.as_tensor(np.array(want)), TOL)
    return ok, err, mean


def _plan(kind, H, blocks=None):
    """The card's plan, or one with ``blocks`` blocks."""
    c = lstm_cuda.CLUSTERS[kind]
    clusters = CARD_CLUSTERS[kind] if blocks is None else blocks // c
    plan = lstm_cuda.persist_plan(kind, H, SMS, SMEM, clusters)
    assert plan is not None
    if blocks is not None:
        assert plan.blocks == blocks
    return plan


# (T, B, H, blocks): T in {1, 2, 9}, B in {1, 5, 48}, H in {64, 96, 200};
# blocks None: the H100's plan; 16: H = 200 over 16 blocks, which divide
# neither H nor its gates (as H = 1000 over 128 on the card)
SHAPES = [(1, 5, 200, None), (2, 48, 64, None), (9, 1, 96, None),
          (9, 48, 200, 16), (2, 1, 200, None), (9, 5, 64, None),
          (1, 48, 96, None), (9, 5, 200, 16)]


@pytest.mark.parametrize("T,B,H,blocks", SHAPES)
def test_persistent_k1_emulation_matches_plain_and_jax(T, B, H, blocks):
    """Both K1 modes: the emulation against lstm_scan (with residuals) and
    the JAX kernel's _fwd in interpret mode, ys, the last h and c, acts
    and cs; ys, h and c the same in both modes."""
    w, xp, h0, c0, *_ = _inputs(T, B, H, seed=T * 100 + B + H)
    tw, txp = (torch.from_numpy(a).to(torch.bfloat16) for a in (w, xp))
    th0, tc0 = torch.from_numpy(h0), torch.from_numpy(c0)
    plan = _plan("fwd", H, blocks)
    got = emulate_fwd(tw, txp, th0, tc0, plan, residuals=True)
    plain_mode = emulate_fwd(tw, txp, th0, tc0, plan)
    for a, b in zip(plain_mode, got):
        assert torch.equal(a, b)
    want = lstm.lstm_scan(tw, txp, th0, tc0, residuals=True)
    jys, jacts, jcs, jh, jc = jax_fwd(
        jnp.asarray(tw.float().numpy()).astype(jnp.bfloat16), None,
        jnp.asarray(txp.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(h0), jnp.asarray(c0), False, interpret=True,
        residuals=True)
    jax_out = [np.asarray(jnp.asarray(a).astype(jnp.float32))
               for a in (jys, jh, jc, jacts, jcs)]
    for name, g, p, j in zip(("ys", "h", "c", "acts", "cs"), got, want,
                             jax_out):
        for ref, what in ((p.float(), "plain"), (j, "JAX")):
            ok, err, mean = _close(g.float(), ref)
            assert ok, f"{name} vs {what}: max {err:.3e} mean {mean:.3e}"


@pytest.mark.parametrize("T,B,H,blocks", SHAPES)
def test_persistent_k2_emulation_matches_plain_and_jax(T, B, H, blocks):
    """K2: the emulation against lstm_scan_bwd and the JAX kernel's _bwd in
    interpret mode, on the plain forward's residuals: dgates, dh0, dc0."""
    w, xp, h0, c0, dys, dh, dc = _inputs(T, B, H, seed=T * 100 + B + H + 1)
    tw, txp = (torch.from_numpy(a).to(torch.bfloat16) for a in (w, xp))
    th0, tc0 = torch.from_numpy(h0), torch.from_numpy(c0)
    _, _, _, acts, cs = lstm.lstm_scan(tw, txp, th0, tc0, residuals=True)
    tdys = torch.from_numpy(dys).to(torch.bfloat16)
    tdh, tdc = torch.from_numpy(dh), torch.from_numpy(dc)
    c_prev = torch.cat([tc0[None].to(torch.bfloat16), cs[:-1]])
    plan = _plan("bwd", H, None if blocks is None else 16)
    got = emulate_bwd(tdys, acts, c_prev, cs, tw, tdh, tdc, plan)
    want = lstm.lstm_scan_bwd(tdys, acts, c_prev, cs, tw, tdh, tdc)
    j = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    jdg, jdh0, jdc0 = jax_bwd(j(tw), None, j(acts), j(c_prev), j(cs),
                              j(tdys), jnp.asarray(dh), jnp.asarray(dc),
                              False, interpret=True)
    jax_out = [np.asarray(jnp.asarray(a).astype(jnp.float32))
               for a in (jdg, jdh0, jdc0)]
    for name, g, p, jo in zip(("dgates", "dh0", "dc0"), got, want, jax_out):
        for ref, what in ((p.float(), "plain"), (jo, "JAX")):
            ok, err, mean = _close(g.float(), ref)
            assert ok, f"{name} vs {what}: max {err:.3e} mean {mean:.3e}"


def test_missing_barrier_fault_reads_beyond_the_tolerance():
    """One block of K1 reading h_{t-2} for h_{t-1} (what a missing or
    early grid barrier gives) moves ys beyond LSTM_TOL, where the sound
    emulation stays within it."""
    T, B, H = 9, 48, 200
    w, xp, h0, c0, *_ = _inputs(T, B, H, seed=7)
    tw, txp = (torch.from_numpy(a).to(torch.bfloat16) for a in (w, xp))
    th0, tc0 = torch.from_numpy(h0), torch.from_numpy(c0)
    plan = _plan("fwd", H, 16)
    want = lstm.lstm_scan(tw, txp, th0, tc0)[0]
    sound = emulate_fwd(tw, txp, th0, tc0, plan)[0]
    faulty = emulate_fwd(tw, txp, th0, tc0, plan, fault=(1, 2))[0]
    assert _close(sound.float(), want.float())[0]
    ok, err, _ = _close(faulty.float(), want.float())
    assert not ok, f"the stale-h fault read only {err:.3e}"


@pytest.mark.parametrize("H", [1536, 1024, 512])
@pytest.mark.parametrize("clusters", ["sms", "card"])
def test_route_takes_the_persistent_kernels_at_hac_widths(H, clusters):
    """lstm:512 (1536), the RNN-T encoder (1024) and its prediction net
    (512) take the persistent kernels on 132 SMs with 227 KB a block, with
    as many clusters as the SMs make and with what an H100 holds; the
    plans fit the shared memory, cover H and keep a block's units within
    the kernels' 16."""
    for kind in ("fwd", "bwd"):
        ncl = None if clusters == "sms" else CARD_CLUSTERS[kind]
        name, plan = lstm_cuda.route(kind, torch.bfloat16, H, 48, SMS, SMEM,
                                     ncl)
        assert name == "persist"
        assert plan.smem <= SMEM and plan.blocks <= SMS
        assert plan.c == lstm_cuda.CLUSTERS[kind]
        assert plan.c * plan.u * plan.clusters >= H > \
            plan.c * plan.u * (plan.clusters - 1)
        assert plan.u <= 16 and plan.kc % KS == 0
        assert plan.c * plan.kc >= (H if kind == "fwd" else 4 * H)
        assert plan.npw * plan.nw * 8 == plan.n and plan.nw * plan.wk <= 8


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_route_of_other_shapes(kind):
    """bf16 H = 2048 takes the per-step tensor-core kernel (its W slices do
    not fit); fp32 the persistent fp32 kernel (H % 4 != 0 in K1 and
    H % 8 != 0 in bf16 the CUDA-core kernel); any batch takes the bf16
    route of its H."""
    assert lstm_cuda.route(kind, torch.bfloat16, 2048, 48, SMS, SMEM) == \
        ("tc_step", None)
    for H in (1536, 64):
        name, plan = lstm_cuda.route(kind, torch.float32, H, 48, SMS, SMEM)
        assert name == "persist_f32" and plan.smem <= SMEM
    assert lstm_cuda.route("fwd", torch.float32, 30, 3, SMS, SMEM) == \
        ("fma_step", None)
    assert lstm_cuda.route("bwd", torch.float32, 30, 3, SMS, SMEM)[0] == \
        "persist_f32"
    assert lstm_cuda.route(kind, torch.bfloat16, 36, 3, SMS, SMEM) == \
        ("fma_step", None)
    assert lstm_cuda.route(kind, torch.bfloat16, 1536, 1, SMS, SMEM) == \
        lstm_cuda.route(kind, torch.bfloat16, 1536, 256, SMS, SMEM)


# ------------------------------------------------------------------ fp32
#
# The fp32 kernels (persist_f32, csrc/persist_f32.cuh) from a plan of
# nn.lstm_cuda.f32_plan: clusters of c blocks as in bf16; block r of a
# cluster multiplying columns [r kc, (r + 1) kc) of the exchanged rows in
# slices of F32_KS columns, in k order, the first nsl - nres slices with W
# streamed through the ring and the last nres with W resident (the same
# values in the same order: the split changes no sum); each of the wk k
# groups summing its contiguous share of every slice's 4-column chunks
# into its own partial slab, one fp32 FFMA a column; the slabs summed in
# order, the c blocks' partials in rank order, added to x_proj (K1) or
# taken as dh_rec (K2); batch rows in tiles of 8 tm rows (hal's 64 in
# one). Within a 4-column chunk the emulation sums in torch's order.

TOL32 = chip_smoke.LSTM_TOL["float32"]
KS32 = lstm_cuda.F32_KS


def f32_plan(kind, H, B, blocks=None, nres=None):
    """The H100's fp32 plan, or one of ``blocks`` blocks; ``nres``: the
    same plan with that many resident slices (and the shared memory that
    makes)."""
    c = lstm_cuda.CLUSTERS[kind]
    clusters = CARD_CLUSTERS[kind] if blocks is None else blocks // c
    plan = lstm_cuda.f32_plan(kind, H, B, SMS, SMEM, clusters)
    assert plan is not None
    if blocks is not None:
        assert plan.blocks == blocks
    if nres is not None:
        smem = lstm_cuda.f32_layout(plan.kc, plan.n, plan.tm, plan.tn,
                                    plan.wk, plan.stages, nres)
        plan = dataclasses.replace(plan, nres=nres, smem=smem)
    return plan


def rank_partials(x, w, plan, kdim):
    """[(B, N) partial of each rank of a cluster]: x (B, kdim) . w (N,
    kdim)^T over the rank's columns, as its block sums it (every cluster
    takes the same columns, so all rows at once)."""
    cg = 8 // plan.wk                 # chunks of 4 columns a k group
    nsl = plan.kc // KS32
    out = []
    for r in range(plan.c):
        slabs = [torch.zeros((x.shape[0], w.shape[0]))
                 for _ in range(plan.wk)]
        # slices s < nstr take W from the ring, the others from the
        # resident slices: the same columns in the same order
        for s in range(nsl):
            for ch in range(8):
                k = r * plan.kc + s * KS32 + 4 * ch
                if k >= kdim:
                    continue
                grp = ch // cg
                slabs[grp] = slabs[grp] + x[:, k:k + 4] @ w[:, k:k + 4].T
        part = slabs[0]
        for sl in slabs[1:]:
            part = part + sl
        out.append(part)
    return out


def rank_sum(parts):
    total = torch.zeros_like(parts[0])
    for part in parts:
        total = total + part
    return total


def emulate_fwd_f32(w, xp, h0, c0, plan, residuals=False, fault=None):
    """K1 in fp32 as the persistent fp32 kernel computes it. ``fault`` (q,
    r): block r of cluster q reads h_{t-2} (h0 at t = 1) from the third
    step on, where the grid barrier should have made it read h_{t-1}."""
    T, B, H4 = xp.shape
    H = H4 // 4
    cu = plan.c * plan.u
    c = c0.clone()
    h_last = h0.clone()
    ys = torch.empty((T, B, H))
    acts = torch.empty((T, B, 4 * H))
    cs = torch.empty((T, B, H))
    hs = [h0]
    for t in range(T):
        gates = torch.empty((B, 4 * H))
        for b0 in range(0, B, plan.bm):       # batch tiles of bm rows
            rows = slice(b0, b0 + plan.bm)
            parts = rank_partials(hs[t][rows], w, plan, H)
            if fault and t >= 2:
                q, r = fault
                units = torch.arange(q * cu, min((q + 1) * cu, H))
                gr = torch.cat([g * H + units for g in range(4)])
                stale = rank_partials(hs[t - 1][rows], w, plan, H)[r]
                parts[r][:, gr] = stale[:, gr]
            gates[rows] = xp[t][rows] + rank_sum(parts)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
            torch.sigmoid(o)
        c = f * c + i * g
        h_last = o * torch.tanh(c)
        ys[t] = h_last
        acts[t] = torch.cat([i, f, g, o], -1)
        cs[t] = c
        hs.append(ys[t])
    if residuals:
        return ys, h_last, c, acts, cs
    return ys, h_last, c


def emulate_bwd_f32(dys, acts, c_prev, cs, w, dh_last, dc_last, plan):
    """K2 in fp32 as the persistent fp32 kernel computes it: the arguments
    and results of ``nn.lstm.lstm_scan_bwd`` (fp32 residuals)."""
    T, B, H4 = acts.shape
    wt = w.T                                  # (H, 4H): the slab's rows
    dh, dc = dh_last.clone(), dc_last.clone()
    dgates = torch.empty((T, B, H4))

    def product(d):
        out = torch.empty((d.shape[0], wt.shape[0]))
        for b0 in range(0, d.shape[0], plan.bm):
            rows = slice(b0, b0 + plan.bm)
            out[rows] = rank_sum(rank_partials(d[rows], wt, plan, H4))
        return out

    for t in range(T - 1, -1, -1):
        i, f, g, o = acts[t].chunk(4, dim=-1)
        tc = torch.tanh(cs[t])
        dh = dh + dys[t]
        do = dh * tc * o * (1 - o)
        dc = dc + dh * o * (1 - tc * tc)
        dgates[t] = torch.cat([dc * g * i * (1 - i),
                               dc * c_prev[t] * f * (1 - f),
                               dc * i * (1 - g * g), do], dim=-1)
        dh = product(dgates[t])
        dc = dc * f
    return dgates, dh, dc


def _close32(got, want):
    return chip_smoke.within(torch, torch.as_tensor(np.array(got)),
                             torch.as_tensor(np.array(want)), TOL32)


# (T, B, H, blocks): T in {1, 2, 9}, B in {1, 5, 64} (8-row tiles to 8,
# one 64-row tile above), H in {64, 96, 200}; blocks None: the H100's
# plan; 16: H = 200 over 16 blocks, which divide neither H nor its gates
SHAPES32 = [(1, 5, 200, None), (2, 64, 64, None), (9, 1, 96, None),
            (9, 64, 200, 16), (2, 1, 200, None), (9, 5, 64, None),
            (1, 64, 96, None), (9, 5, 200, 16)]


@pytest.mark.parametrize("T,B,H,blocks", SHAPES32)
def test_fp32_k1_emulation_matches_plain_and_jax(T, B, H, blocks):
    """K1 in fp32, both modes: the emulation against lstm_scan (with
    residuals) and the JAX kernel's _fwd in interpret mode (fp32, full
    precision), ys, the last h and c, acts and cs; ys, h and c the same in
    both modes."""
    w, xp, h0, c0, *_ = _inputs(T, B, H, seed=T * 100 + B + H + 5)
    tw, txp, th0, tc0 = (torch.from_numpy(a) for a in (w, xp, h0, c0))
    plan = f32_plan("fwd", H, B, blocks)
    got = emulate_fwd_f32(tw, txp, th0, tc0, plan, residuals=True)
    for a, b in zip(emulate_fwd_f32(tw, txp, th0, tc0, plan), got):
        assert torch.equal(a, b)
    want = lstm.lstm_scan(tw, txp, th0, tc0, residuals=True)
    jys, jacts, jcs, jh, jc = jax_fwd(
        jnp.asarray(w), None, jnp.asarray(xp), jnp.asarray(h0),
        jnp.asarray(c0), False, interpret=True, residuals=True)
    for name, g, pl, j in zip(("ys", "h", "c", "acts", "cs"), got, want,
                              (jys, jh, jc, jacts, jcs)):
        for ref, what in ((pl, "plain"), (np.asarray(j), "JAX")):
            ok, err, mean = _close32(g, ref)
            assert ok, f"{name} vs {what}: max {err:.3e} mean {mean:.3e}"


@pytest.mark.parametrize("T,B,H,blocks", SHAPES32)
def test_fp32_k2_emulation_matches_plain_and_jax(T, B, H, blocks):
    """K2 in fp32: the emulation against lstm_scan_bwd and the JAX
    kernel's _bwd in interpret mode, on the plain forward's residuals:
    dgates, dh0, dc0."""
    w, xp, h0, c0, dys, dh, dc = _inputs(T, B, H, seed=T * 100 + B + H + 6)
    tw, txp, th0, tc0 = (torch.from_numpy(a) for a in (w, xp, h0, c0))
    _, _, _, acts, cs = lstm.lstm_scan(tw, txp, th0, tc0, residuals=True)
    tdys, tdh, tdc = (torch.from_numpy(a) for a in (dys, dh, dc))
    c_prev = torch.cat([tc0[None], cs[:-1]])
    plan = f32_plan("bwd", H, B, blocks)
    got = emulate_bwd_f32(tdys, acts, c_prev, cs, tw, tdh, tdc, plan)
    want = lstm.lstm_scan_bwd(tdys, acts, c_prev, cs, tw, tdh, tdc)
    j = lambda a: jnp.asarray(np.asarray(a))
    jout = jax_bwd(j(tw), None, j(acts), j(c_prev), j(cs), j(tdys),
                   j(tdh), j(tdc), False, interpret=True)
    for name, g, pl, jo in zip(("dgates", "dh0", "dc0"), got, want, jout):
        for ref, what in ((pl, "plain"), (np.asarray(jo), "JAX")):
            ok, err, mean = _close32(g, ref)
            assert ok, f"{name} vs {what}: max {err:.3e} mean {mean:.3e}"


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_fp32_resident_split_changes_no_sum(kind):
    """The route's plan, the same plan with every slice of W streamed and
    with every slice resident give the same bits: slices are multiplied
    in k order whatever the split."""
    T, B, H = 3, 5, 200
    w, xp, h0, c0, dys, dh, dc = _inputs(T, B, H, seed=11)
    tw, txp, th0, tc0, tdys, tdh, tdc = (
        torch.from_numpy(a) for a in (w, xp, h0, c0, dys, dh, dc))
    _, _, _, acts, cs = lstm.lstm_scan(tw, txp, th0, tc0, residuals=True)
    c_prev = torch.cat([tc0[None], cs[:-1]])
    plan = f32_plan(kind, H, B)
    runs = []
    for nres in (plan.nres, 0, plan.kc // KS32):
        p = f32_plan(kind, H, B, nres=nres)
        runs.append(emulate_fwd_f32(tw, txp, th0, tc0, p) if kind == "fwd"
                    else emulate_bwd_f32(tdys, acts, c_prev, cs, tw, tdh,
                                         tdc, p))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_fp32_missing_barrier_fault_reads_beyond_the_tolerance():
    """One block of K1 in fp32 reading h_{t-2} for h_{t-1} moves ys beyond
    LSTM_TOL["float32"], where the sound emulation stays within it."""
    T, B, H = 9, 64, 200
    w, xp, h0, c0, *_ = _inputs(T, B, H, seed=8)
    tw, txp, th0, tc0 = (torch.from_numpy(a) for a in (w, xp, h0, c0))
    plan = f32_plan("fwd", H, B, 16)
    want = lstm.lstm_scan(tw, txp, th0, tc0)[0]
    sound = emulate_fwd_f32(tw, txp, th0, tc0, plan)[0]
    faulty = emulate_fwd_f32(tw, txp, th0, tc0, plan, fault=(1, 2))[0]
    assert _close32(sound, want)[0]
    ok, err, _ = _close32(faulty, want)
    assert not ok, f"the stale-h fault read only {err:.3e}"


@pytest.mark.parametrize("H", [2048, 1536, 1024, 512])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("clusters", ["sms", "card"])
def test_fp32_plans_at_the_widths(H, kind, clusters):
    """hal's 2048 and hac's 1536, 1024 and 512 in fp32 take the persistent
    fp32 kernel on 132 SMs with 227 KB a block: the plan fits the shared
    memory (its layout's size), takes at most the SMs, covers H with its
    clusters' units and the contraction with its blocks' columns, covers a
    block's rows with its threads' tile, keeps about F32_IN_FLIGHT bytes
    in the ring and no room for another resident slice, and takes B = 64
    in one batch tile (B = 1 in an 8-row one)."""
    ncl = None if clusters == "sms" else CARD_CLUSTERS[kind]
    K = H if kind == "fwd" else 4 * H
    for B in (64, 1):
        name, plan = lstm_cuda.route(kind, torch.float32, H, B, SMS, SMEM,
                                     ncl)
        assert name == "persist_f32"
        assert plan.smem <= SMEM and plan.blocks <= SMS
        assert plan.smem == lstm_cuda.f32_layout(
            plan.kc, plan.n, plan.tm, plan.tn, plan.wk, plan.stages,
            plan.nres)
        assert plan.c == lstm_cuda.CLUSTERS[kind]
        assert plan.c * plan.u * plan.clusters >= H > \
            plan.c * plan.u * (plan.clusters - 1)
        assert plan.kc % KS32 == 0 and plan.c * plan.kc >= K > \
            plan.c * (plan.kc - KS32)
        assert plan.n == (4 if kind == "fwd" else 1) * plan.c * plan.u
        assert plan.n <= plan.ncap and plan.c * plan.u <= 256
        assert (plan.tm, plan.tn, plan.wk) in {
            (tm, tn, wk) for tm in lstm_cuda.F32_TMS
            for tn in lstm_cuda.F32_TNS for wk in lstm_cuda.F32_WKS}
        assert -(-B // plan.bm) == 1 and plan.bm == (64 if B == 64 else 8)
        nsl = plan.kc // KS32
        slot = plan.bm * 128 + (plan.ncap * 128 if plan.nres < nsl else 0)
        assert plan.stages == nsl or \
            (plan.stages - 1) * slot >= lstm_cuda.F32_IN_FLIGHT
        if plan.nres < nsl:
            assert lstm_cuda.f32_layout(
                plan.kc, plan.n, plan.tm, plan.tn, plan.wk, plan.stages,
                plan.nres + 1) > SMEM
