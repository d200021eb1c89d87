"""The arithmetic of the persistent bf16 LSTM kernels (K1, both modes,
``haloop_tpu_torch/csrc/lstm_fwd.cu``, and K2, ``csrc/lstm_bwd.cu``, on
``csrc/persist.cuh``) on the CPU: a blockwise emulation of those kernels,
written here, against the port's plain versions (``nn.lstm.lstm_scan``,
``lstm_scan_bwd``) and the JAX package's ``_fwd`` / ``_bwd``
(``haloop_tpu/nn/lstm_pallas.py``) in interpret mode, on the same numpy
inputs from a seed; and the route that picks the kernels.

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
(tests/test_lstm_pallas.py). A planted fault, one block of K1 reading
h_{t-2} where it should read h_{t-1} (the missing grid barrier), must read
beyond it.
"""

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
    not fit); fp32, and H % 8 != 0 in bf16, the CUDA-core kernel; any
    batch takes the route of its H."""
    assert lstm_cuda.route(kind, torch.bfloat16, 2048, 48, SMS, SMEM) == \
        ("tc_step", None)
    for H in (1536, 64):
        assert lstm_cuda.route(kind, torch.float32, H, 48, SMS, SMEM) == \
            ("fma_step", None)
    assert lstm_cuda.route(kind, torch.bfloat16, 36, 3, SMS, SMEM) == \
        ("fma_step", None)
    assert lstm_cuda.route(kind, torch.bfloat16, 1536, 1, SMS, SMEM) == \
        lstm_cuda.route(kind, torch.bfloat16, 1536, 256, SMS, SMEM)
