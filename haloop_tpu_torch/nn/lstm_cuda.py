"""Kernels K1 and K2: the LSTM recurrence forward and its backward sweep in
CUDA (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``), and their int8 modes
K1-q8 and K2-q8 (``csrc/lstm_q8.cu``).

Mirrors ``haloop_tpu.nn.lstm_pallas.lstm_scan_pallas`` in its exact-weight
mode: x_proj (T, B, 4H) and W_hh (4H, H) in one dtype (bf16 or fp32),
h0/c0 (B, H) -> (ys (T, B, H) in x_proj's dtype, h_last, c_last in fp32).

``lstm_scan`` picks the path:
  * under autograd (grad enabled and an input requires it), the
    ``LSTMScan`` Function: K1 with residuals forward, K2 and one dW_hh
    matmul backward;
  * otherwise (serving, ``torch.inference_mode``) K1 without residuals.
With ``q8`` (hac ``--rnn-q8``) W_hh is quantized per row on every call
(``nn.lstm.quantize_rows``, torch ops, as the JAX package leaves it to
XLA) and the same choice runs the ``LSTMScanQ8`` Function (K1-q8 with
residuals, K2-q8) or K1-q8 without residuals.
A CPU tensor takes the plain versions in ``nn.lstm`` (through the same
Function under autograd); a CUDA tensor launches the kernels or raises.

K1 and K2 take one of four routes, decided before the launch by
``route`` from the dtype, H, B and what the card offers (never on
failure): ``persist``, one persistent launch a layer call with W_hh
resident in the SMs' shared memory (bf16, H % 8 == 0, W's slices fit;
every hac width), laid out by ``persist_plan``; ``persist_f32``, one
persistent launch a layer call in fp32 (hal's 1 x 2048 and the parity
runs: exact fp32 FFMA, W's columns resident as far as the shared memory
allows and the rest streamed every step), laid out by ``f32_plan``
(every fp32 width a compiled tile covers, K1 with H % 4 == 0);
``tc_step``, a tensor-core launch a step (bf16 whose slices do not fit);
``fma_step``, a CUDA-core launch a step (H % 8 != 0 in bf16, fp32 shapes
no fp32 plan tiles). K1-q8 and K2-q8 (kinds ``fwd_q8``, ``bwd_q8``) take
``persist`` on the same skeleton with int8 wq resident (H % 16 == 0, the
plan fits: every hac width; K1-q8 with bf16 x_proj and H of at least
``Q8_FWD_MIN_H``), else the per-step ``tc_step`` (H % 32 == 0) or
``int_step``. ``route_launches`` counts the calls of each.
"""

import ctypes
from dataclasses import astuple, dataclass

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.nn import lstm as _lstm

launches = 0              # K1 calls without residuals (one per layer run)
residual_launches = 0     # K1 calls with residuals (one per layer run)
bwd_launches = 0          # K2 calls (one per layer backward)
q8_launches = 0           # K1-q8 calls without residuals
q8_residual_launches = 0  # K1-q8 calls with residuals
q8_bwd_launches = 0       # K2-q8 calls
# the calls of each kind by route: "fwd_persist", "bwd_persist_f32",
# "bwd_tc_step", "fwd_q8_int_step", ... (K1 and K1-q8 both modes)
ROUTES = {"fwd": ("persist", "persist_f32", "tc_step", "fma_step"),
          "bwd": ("persist", "persist_f32", "tc_step", "fma_step"),
          "fwd_q8": ("persist", "tc_step", "int_step"),
          "bwd_q8": ("persist", "tc_step", "int_step")}
route_launches = {f"{k}_{r}": 0 for k, rs in ROUTES.items() for r in rs}

# the persistent kernels' fixed shape (csrc/persist.cuh): blocks a cluster
# of each kind (K1 splits its H-deep contraction in four, K2 its 4H-deep
# one in eight; the int8 kinds' sizes were picked by timing them on the
# card, PERF.md), threads (8 warps), batch rows a tile, contraction a ring
# slot (elements), and the units a block may own (even: a cluster's units
# fill whole 8-row tiles)
CLUSTERS = {"fwd": 4, "bwd": 8, "fwd_q8": 4, "bwd_q8": 8}
# The int8 plans take 16 units a block where that keeps at least this
# share of the blocks of the fewest units: each block's bf16 outputs of a
# batch row then fill whole 32-byte sectors that no other block writes
# (K1-q8's residuals, K2-q8's dgates; timed faster at H = 1536 with 96
# blocks against 112, slower at H = 1024 with 64 against 104; PERF.md)
Q8_WHOLE_SECTORS = 0.75
# K1-q8 below this width takes the per-step kernel, which is faster there
# at every sequence length timed (T = 16 to 128 at H = 512; PERF.md): a
# persistent step's cluster and grid barriers cost more than a launch
Q8_FWD_MIN_H = 1024
THREADS, BM, KS = 256, 48, 64
UNITS = (2, 4, 6, 8, 10, 12, 14, 16)
WARPS = THREADS // 32
# static shared memory of a kind's kernel beside the plan's dynamic
# shared memory: K2-q8's row scales and row maxima of a tile
STATIC_SMEM = {"bwd_q8": 2 * BM * 4}


@dataclass(frozen=True)
class Plan:
    """One persistent launch's layout (csrc/persist.cuh ``Plan``, in the
    same order)."""
    c: int          # blocks a cluster
    u: int          # hidden units a block updates; a cluster owns c u
    clusters: int   # clusters in the grid
    kc: int         # contraction a block takes (multiple of KS)
    n: int          # rows of the resident slab (the product's N)
    npw: int        # 8-row n-tiles a warp
    nw: int         # warp groups along n
    wk: int         # warp groups along k (partial slabs)
    stages: int     # ring slots (64-wide slices in flight)
    smem: int       # dynamic shared memory a block, bytes

    @property
    def blocks(self):
        return self.c * self.clusters


# The fp32 persistent kernels (csrc/persist_f32.cuh): the contraction a ring
# slice (elements: 128-byte rows), the compiled thread tiles (tm batch rows
# and tn rows of W a thread, wk k groups; HL_F32_TILES), the bytes the ring
# keeps in flight while a slice is multiplied (32 KB, the fewest slots:
# 64 and 96 KB, which leave fewer slices resident, timed K1 3-4% slower
# at hal's shape on an H100 and K2 no faster; scripts/lstm_probe.py --f32
# --variants, PERF.md), and the cells a thread updates at most
F32_KS = 32
F32_TMS, F32_TNS, F32_WKS = (1, 8), (5, 7, 9), (1, 2, 4)
F32_IN_FLIGHT = 32 * 1024
F32_CMAX = 8


@dataclass(frozen=True)
class F32Plan:
    """One fp32 persistent launch's layout (csrc/persist_f32.cuh ``Plan``,
    in the same order)."""
    c: int          # blocks a cluster
    u: int          # hidden units a block updates; a cluster owns c u
    clusters: int   # clusters in the grid
    kc: int         # contraction a block takes (multiple of F32_KS)
    n: int          # rows of W a block multiplies
    tm: int         # batch rows a thread: a batch tile of 8 tm rows
    tn: int         # rows of W a thread
    wk: int         # k groups (partial slabs, folded in order)
    stages: int     # ring slots
    nres: int       # slices of W resident (the last nres of kc / F32_KS)
    smem: int       # dynamic shared memory a block, bytes

    @property
    def blocks(self):
        return self.c * self.clusters

    @property
    def bm(self):
        return 8 * self.tm

    @property
    def ncap(self):
        return 32 // self.wk * self.tn


def f32_layout(kc, n, tm, tn, wk, stages, nres):
    """The dynamic shared memory of an fp32 plan (persist_f32.cuh
    ``Layout``): 1024 bytes of slack (the first 1 KB boundary), the
    resident slices, the ring (or the partials after a product), an
    mbarrier a slot and one for the resident slices."""
    row = F32_KS * 4
    nsl = kc // F32_KS
    wrows = 32 // wk * tn * row
    slot = 8 * tm * row + (wrows if nsl > nres else 0)
    region = -(-max(stages * slot, wk * 8 * tm * n * 4) // 16) * 16
    return 1024 + nres * wrows + region + 8 * (stages + 1)


def f32_plan(kind, H, B, sms, smem, clusters=None):
    """The fp32 persistent launch of K1 (``kind`` "fwd") or K2 ("bwd") at
    width H and batch B on a card of ``sms`` SMs, ``smem`` bytes of shared
    memory a block and ``clusters`` clusters of CLUSTERS[kind] blocks at
    once, or None where no compiled tile covers a block's rows. The fewest
    units a block (the most blocks); the tile of the fewest rows that
    covers them, then the fewest k groups; one batch tile of 8 rows up to
    B = 8, else of 64; then the ring deep enough for F32_IN_FLIGHT bytes
    and as many of W's slices resident as the rest of the shared memory
    holds."""
    c = CLUSTERS[kind]
    clusters = sms // c if clusters is None else clusters
    if clusters < 1:
        return None
    gates, kdim = (4, H) if kind == "fwd" else (1, 4 * H)
    tm = F32_TMS[0] if B <= 8 * F32_TMS[0] else F32_TMS[-1]
    u = -(-H // (c * clusters))
    n = gates * c * u
    fits = [(32 // wk * tn, wk, tn) for wk in F32_WKS for tn in F32_TNS
            if 32 // wk * tn >= n]
    # TMA boxes of at most 256 rows (a cluster's units)
    if not fits or 8 * tm * u > F32_CMAX * THREADS or c * u > 256:
        return None
    _, wk, tn = min(fits)
    kc = -(-kdim // (c * F32_KS)) * F32_KS
    nsl = kc // F32_KS
    for nres in range(nsl, -1, -1):
        slot = 8 * tm * F32_KS * 4 + \
            (32 // wk * tn * F32_KS * 4 if nsl > nres else 0)
        stages = min(nsl, max(2, 1 + -(-F32_IN_FLIGHT // slot)))
        size = f32_layout(kc, n, tm, tn, wk, stages, nres)
        if size <= smem:
            return F32Plan(c, u, -(-H // (c * u)), kc, n, tm, tn, wk,
                           stages, nres, size)
    return None


def _warp_split(nt):
    """(npw, nw, wk) for nt 8-row n-tiles over the 8 warps: nw groups of
    npw tiles times wk groups along k (the warps past nw wk sit out). The
    least work a warp (npw / wk), then the fewest slabs."""
    splits = [(npw, nt // npw, WARPS // (nt // npw)) for npw in (1, 2, 3, 4)
              if nt % npw == 0 and nt // npw <= WARPS]
    return min(splits, key=lambda s: (s[0] / s[2], s[2]))


def _plan_at(kind, H, c, u, ncl, smem):
    """The plan of ``ncl`` clusters of c blocks of u units, or None when
    its warps' split or its shared memory does not fit."""
    es = 1 if kind.endswith("_q8") else 2          # bytes an operand
    kdim = H if kind.startswith("fwd") else 4 * H
    kc = -(-kdim // (c * KS)) * KS
    n = 4 * c * u if kind.startswith("fwd") else c * u
    if n // 8 > 4 * WARPS:
        return None
    npw, nw, wk = _warp_split(n // 8)
    # the slab, then one region for the ring (as deep as the rest of the
    # shared memory allows, all kc / KS slices at most) and, after each
    # product, the partials; then an 8-byte mbarrier a slot
    slab, slot = n * (kc * es + 16), BM * (KS * es + 16)
    stages = min(kc // KS, (smem - slab - 8 * (kc // KS)) // slot)
    part = wk * BM * n * 4
    region = -(-max(stages * slot, part) // 16) * 16
    size = slab + region + 8 * stages
    if stages < 1 or size > smem:
        return None
    return Plan(c, u, ncl, kc, n, npw, nw, wk, stages, size)


def persist_plan(kind, H, sms, smem, clusters=None):
    """The persistent launch of K1 (``kind`` "fwd"), K2 ("bwd"), K1-q8
    ("fwd_q8") or K2-q8 ("bwd_q8") at width H on a card of ``sms`` SMs
    whose blocks may use ``smem`` bytes of shared memory and which holds
    ``clusters`` clusters of CLUSTERS[kind] blocks at once (default as
    many as the SMs make), or None when W's slices do not fit. The most
    blocks that fit: the fewest units a block. The int8 kinds take 16
    units a block instead where that keeps Q8_WHOLE_SECTORS of those
    blocks or more."""
    c = CLUSTERS[kind]
    clusters = sms // c if clusters is None else clusters
    smem -= STATIC_SMEM.get(kind, 0)
    fits = [u for u in UNITS if -(-H // (c * u)) <= clusters]
    if not fits:
        return None
    plan = _plan_at(kind, H, c, fits[0], -(-H // (c * fits[0])), smem)
    if plan and kind.endswith("_q8") and 16 in fits[1:]:
        whole = _plan_at(kind, H, c, 16, -(-H // (c * 16)), smem)
        if whole and whole.blocks >= Q8_WHOLE_SECTORS * plan.blocks:
            plan = whole
    return plan


def route(kind, dtype, H, B, sms, smem, clusters=None):
    """(name, plan) for K1 (``kind`` "fwd", both modes), K2 ("bwd"), K1-q8 ("fwd_q8", both modes; ``dtype`` x_proj's) or K2-q8
    ("bwd_q8"; bf16) at (dtype, H), batch B, on a card of ``sms`` SMs and
    ``smem`` bytes of shared memory a block (``clusters``: see
    persist_plan); the plan is a Plan for ``persist``, an F32Plan for
    ``persist_f32``, else None. K1-q8 below Q8_FWD_MIN_H takes the
    per-step kernel. In bf16 every B takes the route of its H (the persistent kernels loop
    over 48-row batch tiles); fp32 takes ``persist_f32`` wherever
    ``f32_plan`` fits (K1 with H % 4 == 0), its batch tile from B."""
    if dtype == torch.float32 and not kind.endswith("_q8"):
        plan = None if kind == "fwd" and H % 4 else \
            f32_plan(kind, H, B, sms, smem, clusters)
        return ("persist_f32", plan) if plan else ("fma_step", None)
    if kind.endswith("_q8"):
        step = "tc_step" if H % 32 == 0 else "int_step"
        if dtype != torch.bfloat16 or H % 16 or \
                kind == "fwd_q8" and H < Q8_FWD_MIN_H:
            return step, None
    else:
        step = "tc_step"
        if H % 8:
            return "fma_step", None
    plan = persist_plan(kind, H, sms, smem, clusters)
    return ("persist", plan) if plan else (step, None)


_cards = {}


def card(device):
    """(SMs, shared memory a block may opt into, {kind: clusters of
    CLUSTERS[kind] blocks, one an SM, resident at once}) of a CUDA
    device, queried once a cluster size (``hl_lstm_card``); raises if the
    card takes no cooperative cluster launch."""
    key = torch.device(device).index or 0
    if key not in _cards:
        _cards[key] = {}
    sizes = _cards[key]
    lib = None
    for c in sorted(set(CLUSTERS.values()) - set(sizes)):
        lib = lib or kernels.library()
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(key):
            kernels.check(lib.hl_lstm_card(c, out), "hl_lstm_card")
        sms, smem, ncl, coop, cluster = out
        if not (coop and cluster and ncl > 0):
            raise RuntimeError(
                f"lstm_scan: device {key} offers no cooperative launch in "
                f"clusters of {c} (cooperative {coop}, clusters {cluster}, "
                f"{ncl} resident at once)")
        sizes[c] = (sms, smem, ncl)
    sms, smem, _ = next(iter(sizes.values()))
    return sms, smem, {k: sizes[c][2] for k, c in CLUSTERS.items()}


def _launch_route(kind, dtype, H, B, device, per_step=False):
    """The route and, for ``persist`` and ``persist_f32``, the plan as a C
    int array, the zeroed barrier word (K2-q8: followed by 2 B zeroed
    words, its row maxima) and the plan; counts the call. ``per_step``:
    the per-step route of the shape whatever the card."""
    sms = smem = 0
    ncl = {kind: None}
    if not per_step and (dtype == torch.float32 and not kind.endswith("_q8")
                         or H % (16 if kind.endswith("_q8") else 8) == 0):
        sms, smem, ncl = card(device)
    name, plan = route(kind, dtype, H, B, sms, smem, ncl[kind])
    route_launches[f"{kind}_{name}"] += 1
    if plan is None:
        return None, None, None
    words = 1 + 2 * B if kind == "bwd_q8" else 1
    return ((ctypes.c_int * len(astuple(plan)))(*astuple(plan)),
            torch.zeros(words, dtype=torch.int32, device=device), plan)


def lstm_scan(w_hh, x_proj, h0, c0, q8=False):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (w_hh, x_proj, h0, c0)):
        return (LSTMScanQ8 if q8 else LSTMScan).apply(w_hh, x_proj, h0, c0)
    if q8:
        wq, s = _lstm.quantize_rows(w_hh)
        if x_proj.device.type == "cpu":
            return _lstm.lstm_scan_q8(wq, s, x_proj, h0, c0)
        return lstm_fwd_q8_cuda(wq, s, x_proj, h0, c0)
    if x_proj.device.type == "cpu":
        return _lstm.lstm_scan(w_hh, x_proj, h0, c0)
    return lstm_fwd_cuda(w_hh, x_proj, h0, c0)


class LSTMScan(torch.autograd.Function):
    """K1 with residuals forward; K2 and the dW_hh matmul backward
    (haloop_tpu/nn/lstm_pallas.py _vjp_fwd / _vjp_bwd). Returns grads
    for W_hh, x_proj, h0 and c0 in their dtypes."""

    @staticmethod
    def forward(ctx, w_hh, x_proj, h0, c0):
        if x_proj.device.type == "cpu":
            ys, h, c, acts, cs = _lstm.lstm_scan(w_hh, x_proj, h0, c0,
                                                 residuals=True)
        else:
            ys, h, c, acts, cs = lstm_fwd_cuda(w_hh, x_proj, h0, c0,
                                               residuals=True)
        ctx.save_for_backward(w_hh, acts, cs, h0, c0, ys)
        return ys, h, c

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        w, acts, cs, h0, c0, ys = ctx.saved_tensors
        rd = acts.dtype
        if acts.device.type == "cpu":
            c_prev = torch.cat([c0[None].to(rd), cs[:-1]], dim=0)
            dgates, dh0, dc0 = _lstm.lstm_scan_bwd(
                dys.to(rd), acts, c_prev, cs, w, dh_last, dc_last)
        else:
            dgates, dh0, dc0 = lstm_bwd_cuda(
                dys.to(rd).contiguous(), acts, cs, c0.to(rd).contiguous(),
                w, dh_last, dc_last)
        dw = _lstm.lstm_scan_dw(dgates, h0, ys)
        return (dw.to(w.dtype), dgates.to(ys.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype))


class LSTMScanQ8(torch.autograd.Function):
    """The int8 mode (haloop_tpu/nn/lstm_pallas.py _vjp_fwd / _vjp_bwd with
    quant=True): W_hh quantized per row, K1-q8 with residuals (bf16)
    forward; K2-q8 and the dW_hh matmul backward. dW_hh is straight
    through onto W_hh, in W_hh's dtype as passed."""

    @staticmethod
    def forward(ctx, w_hh, x_proj, h0, c0):
        wq, s = _lstm.quantize_rows(w_hh)
        if x_proj.device.type == "cpu":
            ys, h, c, acts, cs = _lstm.lstm_scan_q8(wq, s, x_proj, h0, c0,
                                                    residuals=True)
        else:
            ys, h, c, acts, cs = lstm_fwd_q8_cuda(wq, s, x_proj, h0, c0,
                                                  residuals=True)
        ctx.w_dtype = w_hh.dtype
        ctx.save_for_backward(wq, s, acts, cs, h0, c0, ys)
        return ys, h, c

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        wq, s, acts, cs, h0, c0, ys = ctx.saved_tensors
        rd = acts.dtype
        if acts.device.type == "cpu":
            c_prev = torch.cat([c0[None].to(rd), cs[:-1]], dim=0)
            dgates, dh0, dc0 = _lstm.lstm_scan_bwd_q8(
                dys.to(rd), acts, c_prev, cs, wq, s, dh_last, dc_last)
        else:
            dgates, dh0, dc0 = lstm_bwd_q8_cuda(
                dys.to(rd).contiguous(), acts, cs, c0.to(rd).contiguous(),
                wq, s, dh_last, dc_last)
        dw = _lstm.lstm_scan_dw(dgates, h0, ys, ctx.w_dtype)
        return (dw.to(ctx.w_dtype), dgates.to(ys.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype))


def lstm_fwd_cuda(w_hh, x_proj, h0, c0, residuals=False):
    """K1. With ``residuals`` also returns acts (T, B, 4H) and cs (T, B, H)
    in x_proj's dtype (the residual dtype of both kernel dtypes)."""
    global launches, residual_launches
    T, B, H4 = x_proj.shape
    H = H4 // 4
    if H4 != 4 * H or w_hh.shape != (H4, H):
        raise ValueError(f"lstm_scan: x_proj {tuple(x_proj.shape)} and "
                         f"W_hh {tuple(w_hh.shape)} are not (T, B, 4H) and "
                         "(4H, H)")
    if w_hh.dtype != x_proj.dtype:
        raise TypeError(f"lstm_scan: W_hh is {w_hh.dtype}, x_proj is "
                        f"{x_proj.dtype}; the kernel takes one dtype")
    if h0.shape != (B, H) or c0.shape != (B, H):
        raise ValueError(f"lstm_scan: h0/c0 must be {(B, H)}")
    kernels.require_cuda("lstm_scan", x_proj, w_hh,
                         dtypes=(torch.float32, torch.bfloat16))
    kernels.require_cuda("lstm_scan", x_proj, h0, c0)
    dev, dt = x_proj.device, x_proj.dtype
    ys = torch.empty((T, B, H), dtype=dt, device=dev)
    h_last = torch.empty((B, H), dtype=torch.float32, device=dev)
    c = c0.to(torch.float32, copy=True)
    acts = cs = None
    if residuals:
        acts = torch.empty((T, B, 4 * H), dtype=dt, device=dev)
        cs = torch.empty((T, B, H), dtype=dt, device=dev)
    if T == 0:
        h = h0.to(torch.float32, copy=True)
        return (ys, h, c, acts, cs) if residuals else (ys, h, c)
    # h enters each product in W's dtype: h0 so, and later ys[t-1]
    h_in = h0.to(dt).contiguous()
    plan, bar, p = _launch_route("fwd", dt, H, B, dev)
    if isinstance(p, F32Plan):
        # the fp32 kernel reads W_hh and h0 by TMA: 16-byte aligned rows
        if w_hh.data_ptr() % 16:
            raise ValueError("lstm_scan: the fp32 kernel takes a 16-byte "
                             "aligned W_hh")
        if h_in.data_ptr() % 16:
            h_in = h_in.clone()
    err = kernels.library().hl_lstm_fwd(
        x_proj.data_ptr(), w_hh.data_ptr(), h_in.data_ptr(), c.data_ptr(),
        ys.data_ptr(), h_last.data_ptr(),
        acts.data_ptr() if residuals else None,
        cs.data_ptr() if residuals else None, T, B, H,
        int(dt == torch.bfloat16), plan,
        bar.data_ptr() if bar is not None else None,
        kernels.stream_of(x_proj))
    kernels.check(err, "hl_lstm_fwd")
    if residuals:
        residual_launches += 1
        return ys, h_last, c, acts, cs
    launches += 1
    return ys, h_last, c


def lstm_bwd_cuda(dys, acts, cs, c0, w, dh_last, dc_last):
    """K2: the arguments of ``nn.lstm.lstm_scan_bwd`` with c0 (B, H) in
    place of the stacked c_prev; dys, acts, cs, c0 and w in one dtype.
    Returns (dgates (T, B, 4H) in that dtype, dh0, dc0 in fp32)."""
    global bwd_launches
    T, B, H4 = acts.shape
    H = H4 // 4
    if H4 != 4 * H or w.shape != (H4, H):
        raise ValueError(f"lstm_scan_bwd: acts {tuple(acts.shape)} and W "
                         f"{tuple(w.shape)} are not (T, B, 4H) and (4H, H)")
    for name, t, shape in (("dys", dys, (T, B, H)), ("cs", cs, (T, B, H)),
                           ("c0", c0, (B, H)), ("dh_last", dh_last, (B, H)),
                           ("dc_last", dc_last, (B, H))):
        if t.shape != shape:
            raise ValueError(f"lstm_scan_bwd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    dt = acts.dtype
    if any(t.dtype != dt for t in (dys, cs, c0, w)):
        raise TypeError("lstm_scan_bwd: dys, acts, cs, c0 and W must share "
                        "one dtype")
    kernels.require_cuda("lstm_scan_bwd", dys, acts, cs, c0, w,
                         dtypes=(torch.float32, torch.bfloat16))
    # the carried dh, dc enter rounded to the residual dtype, as in JAX;
    # dc is a fresh buffer, which the kernel updates in place
    dh_in = dh_last.to(dt).float().contiguous()
    dc = dc_last.to(dt).float().clone(memory_format=torch.contiguous_format)
    kernels.require_cuda("lstm_scan_bwd", acts, dh_in, dc)
    dev = acts.device
    dgates = torch.empty((T, B, H4), dtype=dt, device=dev)
    if T == 0:
        return dgates, dh_in, dc
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    # W^T (H, 4H): each block takes contiguous rows of its hidden units
    wt = w.t().contiguous()
    plan, bar, _ = _launch_route("bwd", dt, H, B, dev)
    err = kernels.library().hl_lstm_bwd(
        dys.data_ptr(), acts.data_ptr(), cs.data_ptr(), c0.data_ptr(),
        wt.data_ptr(), dh_in.data_ptr(), dc.data_ptr(), dgates.data_ptr(),
        dh0.data_ptr(), T, B, H, int(dt == torch.bfloat16), plan,
        bar.data_ptr() if bar is not None else None,
        kernels.stream_of(acts))
    kernels.check(err, "hl_lstm_bwd")
    bwd_launches += 1
    return dgates, dh0, dc


def _check_q8_weight(name, wq, s, H):
    if wq.shape != (4 * H, H) or s.shape != (4 * H,):
        raise ValueError(f"{name}: wq {tuple(wq.shape)} and s "
                         f"{tuple(s.shape)} are not (4H, H) and (4H,) for "
                         f"H={H}")
    if wq.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"{name}: wq must be int8 and s fp32, got "
                        f"{wq.dtype} and {s.dtype}")


def lstm_fwd_q8_cuda(wq, s, x_proj, h0, c0, residuals=False,
                     per_step=False):
    """K1-q8: the arguments and results of ``nn.lstm.lstm_scan_q8``;
    x_proj bf16 or fp32, the residuals bf16. ``per_step`` launches the
    per-step kernels whatever the route (chip_smoke.py holds the two
    routes to the same bits)."""
    global q8_launches, q8_residual_launches
    T, B, H4 = x_proj.shape
    H = H4 // 4
    if H4 != 4 * H:
        raise ValueError(f"lstm_scan_q8: x_proj {tuple(x_proj.shape)} is not "
                         "(T, B, 4H)")
    _check_q8_weight("lstm_scan_q8", wq, s, H)
    if h0.shape != (B, H) or c0.shape != (B, H):
        raise ValueError(f"lstm_scan_q8: h0/c0 must be {(B, H)}")
    kernels.require_cuda("lstm_scan_q8", x_proj,
                         dtypes=(torch.float32, torch.bfloat16))
    kernels.require_cuda("lstm_scan_q8", x_proj, wq, s, h0, c0)
    dev, dt = x_proj.device, x_proj.dtype
    ys = torch.empty((T, B, H), dtype=dt, device=dev)
    h_last = torch.empty((B, H), dtype=torch.float32, device=dev)
    c = c0.to(torch.float32, copy=True)
    acts = cs = None
    if residuals:
        acts = torch.empty((T, B, 4 * H), dtype=torch.bfloat16, device=dev)
        cs = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    if T == 0:
        h = h0.to(torch.float32, copy=True)
        return (ys, h, c, acts, cs) if residuals else (ys, h, c)
    h_in = h0.to(torch.float32).contiguous()
    sdiv = (s / 127.0).float()
    # step t reads its quantized h from one half and writes step t+1's to
    # the other
    hq = torch.empty((2, B, H), dtype=torch.int8, device=dev)
    plan, bar, _ = _launch_route("fwd_q8", dt, H, B, dev, per_step)
    err = kernels.library().hl_lstm_fwd_q8(
        x_proj.data_ptr(), wq.data_ptr(), sdiv.data_ptr(), h_in.data_ptr(),
        c.data_ptr(), hq.data_ptr(), ys.data_ptr(), h_last.data_ptr(),
        acts.data_ptr() if residuals else None,
        cs.data_ptr() if residuals else None, T, B, H,
        int(dt == torch.bfloat16), plan,
        bar.data_ptr() if bar is not None else None,
        kernels.stream_of(x_proj))
    kernels.check(err, "hl_lstm_fwd_q8")
    if residuals:
        q8_residual_launches += 1
        return ys, h_last, c, acts, cs
    q8_launches += 1
    return ys, h_last, c


def q8_bwd_blocks(H):
    """Blocks of K2-q8's per-step kernel along H: each writes one partial
    row maximum a batch row (csrc/lstm_q8.cu, bwd::JU units a block)."""
    return (H + 15) // 16


def lstm_bwd_q8_cuda(dys, acts, cs, c0, wq, s, dh_last, dc_last,
                     per_step=False):
    """K2-q8: the arguments of ``nn.lstm.lstm_scan_bwd_q8`` with c0 (B, H)
    in place of the stacked c_prev; dys, acts, cs and c0 in bf16.
    Returns (dgates (T, B, 4H) bf16, dh0, dc0 in fp32). ``per_step``: as
    for ``lstm_fwd_q8_cuda``."""
    global q8_bwd_launches
    T, B, H4 = acts.shape
    H = H4 // 4
    if H4 != 4 * H:
        raise ValueError(f"lstm_scan_bwd_q8: acts {tuple(acts.shape)} is not "
                         "(T, B, 4H)")
    _check_q8_weight("lstm_scan_bwd_q8", wq, s, H)
    for name, t, shape in (("dys", dys, (T, B, H)), ("cs", cs, (T, B, H)),
                           ("c0", c0, (B, H)), ("dh_last", dh_last, (B, H)),
                           ("dc_last", dc_last, (B, H))):
        if t.shape != shape:
            raise ValueError(f"lstm_scan_bwd_q8: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
    kernels.require_cuda("lstm_scan_bwd_q8", dys, acts, cs, c0,
                         dtypes=(torch.bfloat16,))
    kernels.require_cuda("lstm_scan_bwd_q8", acts, wq, s)
    # the carried dh, dc enter rounded to bf16, as in JAX; dc is a fresh
    # buffer, which the kernel updates in place
    dh_in = dh_last.to(torch.bfloat16).float().contiguous()
    dc = dc_last.to(torch.bfloat16).float().clone(
        memory_format=torch.contiguous_format)
    kernels.require_cuda("lstm_scan_bwd_q8", acts, dh_in, dc)
    dev = acts.device
    dgates = torch.empty((T, B, H4), dtype=torch.bfloat16, device=dev)
    if T == 0:
        return dgates, dh_in, dc
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    plan, bar, p = _launch_route("bwd_q8", torch.bfloat16, H, B, dev,
                                 per_step)
    # scratch: a step's quantized dgates * s and m / 127 for the next
    # step's product; the per-step kernels also carry the fp32 dgates * s
    # and the blocks' partial row maxima
    q = torch.empty((B, H4), dtype=torch.int8, device=dev)
    mq = torch.empty((B,), dtype=torch.float32, device=dev)
    dgs = pmax = None
    w = wq
    if p is None:
        # wq^T (H, 4H): each block streams contiguous rows of its units
        w = wq.t().contiguous()
        dgs = torch.empty((B, H4), dtype=torch.float32, device=dev)
        pmax = torch.empty((B, q8_bwd_blocks(H)), dtype=torch.float32,
                           device=dev)
    err = kernels.library().hl_lstm_bwd_q8(
        dys.data_ptr(), acts.data_ptr(), cs.data_ptr(), c0.data_ptr(),
        w.data_ptr(), s.data_ptr(), dh_in.data_ptr(), dc.data_ptr(),
        dgates.data_ptr(), dh0.data_ptr(),
        dgs.data_ptr() if dgs is not None else None,
        pmax.data_ptr() if pmax is not None else None,
        q.data_ptr(), mq.data_ptr(), T, B, H, plan,
        bar.data_ptr() if bar is not None else None,
        kernels.stream_of(acts))
    kernels.check(err, "hl_lstm_bwd_q8")
    q8_bwd_launches += 1
    return dgates, dh0, dc
