#!/usr/bin/env python3
"""The LSTM recurrence kernels of the PyTorch port alone on one GPU: K1
(``haloop_tpu_torch/csrc/lstm_fwd.cu``, with and without residuals) and
K2 (``csrc/lstm_bwd.cu``) in bf16, with ``--f32`` in fp32 (their
``persist_f32`` route, hal's), or with ``--q8`` their int8 modes K1-q8
(both modes) and K2-q8 (``csrc/lstm_q8.cu``): their build, what the card
offers them, the route and plan each shape takes, checks against the
plain versions, and their times.

    python3 scripts/lstm_probe.py                 # checks, then times
    python3 scripts/lstm_probe.py --against DIR   # times and rates only:
        # the tree at DIR and this one in turns (DIR, this, this, DIR),
        # each in a process of its own, at the same shapes and inputs
    python3 scripts/lstm_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)
    python3 scripts/lstm_probe.py --f32 --variants
        # fp32 plans other than the route's (ring depth, k groups) timed
        # in turns with it at hal's shape
    python3 scripts/lstm_probe.py --phases
        # where a step's time goes in the persistent kernels: the kernels
        # built with their phase stamps compiled in (-DHL_PHASES,
        # kernels.trace_phases: block 0's thread 0, each step), medians in
        # cycles; then ablations, each compiled in by a macro of its own
        # (kernels.ABLATIONS; bf16: the product's loads left out, its
        # mma.sync left out; fp32: W's stream left out, the product's
        # operand loads once a slice), whose results are wrong: the times
        # are the point

``--q8`` or ``--f32`` with any of these: those kernels instead. ``--q8``'s
checks also hold the persistent route to the same bits as the per-step
kernels (``per_step=True``) and as its variants (other units a block), and
its times include those variants' (the tree's own; a parent without them
times its routes only). Its rates are the ``--rnn-q8`` paths', with a CTC
train step's device events. ``--f32``'s checks run F32_CHECK_SHAPES
(within ``chip_smoke.LSTM_TOL["float32"]``, the route each call took, the
same bits twice); its times are hal's (256, 64, 2048), a completion token
(T = 1, B = 1) and hac lstm:512's fp32 (385, 48, 1536), with cuDNN fp32's
recurrence alone beside them; its rates hal's train and completion
tokens/s and a train step's device time.

``--kernels-only`` leaves the rates out. DIR is another checkout of the
repository (``git archive`` of a commit unpacked into a directory that
.gitignore lists); each tree builds its own kernels into its own
``build/``.

Checks (bf16): at the card tests' shapes (T = 1, B in {5, 48, 100}, H =
1000, a bf16 H that takes the per-step route) and chip_smoke's
LSTM_SHAPES, K1, K1 with residuals and K2 against ``nn.lstm.lstm_scan`` /
``lstm_scan_bwd`` within ``chip_smoke.LSTM_TOL``, the route each call
took, and the same bits on a second run. Times: K1, K1 with residuals
and K2 at the three timed shapes of LSTM_SHAPES, CUDA events around one
call behind a spin (``chip_smoke.cuda_ms``), median of 5, beside cuDNN's
``nn.LSTM`` at lstm:512's shape; the card's name and power limit are
printed first. Rates: lstm:512 CTC train and serving utterances/s at 48
x 12 s, Star-CTC train, rnn-transducer:lstm:512 train and transcription
(chip_smoke.py phases 4, 5, 12 and 10's step functions), and one CTC
train step's device time from torch.profiler. Needs one card; imports
nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (T, B, H): the card tests' edges, then the main paths' shapes
CHECK_SHAPES = ((1, 5, 1000), (1, 48, 1536), (3, 100, 1000), (9, 37, 200),
                (15, 4, 128), (6, 48, 2048), (20, 48, 1536), (25, 16, 512),
                (301, 16, 1024), (385, 48, 1536))
TIMED = ((385, 48, 1536), (301, 16, 1024), (25, 16, 512))
# --q8: the shapes above, H off the persistent route (2048: the plan does
# not fit; 40, 200: H % 16 != 0; 96: H % 32 != 0), batch tiles past one
Q8_CHECK_SHAPES = ((1, 5, 1536), (3, 100, 1024), (9, 37, 256),
                   (15, 4, 128), (6, 48, 2048), (20, 48, 1536),
                   (25, 16, 512), (301, 16, 1024), (385, 48, 1536),
                   (7, 5, 40), (20, 70, 96), (9, 37, 200))
# --q8: K1-q8 over short sequences, persistent and per-step (where the
# route's Q8_FWD_MIN_H comes from)
Q8_SHORT = tuple((T, B, H) for H, B in ((512, 16), (1024, 16), (1536, 48))
                 for T in (16, 32, 64, 128))
# --f32: the fp32 route (persist_f32) at the card tests' edges (B = 1 and
# 5: 8-row tiles; B = 70: two 64-row tiles; H = 40, 200: partial slices
# and clusters; H % 4 != 0 in K1: fma_step), hac's fp32 parity shape and
# hal's (T = 1: a completion token)
F32_CHECK_SHAPES = ((1, 1, 2048), (3, 5, 200), (9, 37, 200), (2, 64, 64),
                    (9, 1, 96), (7, 5, 40), (4, 70, 512), (5, 3, 30),
                    (6, 64, 2048), (5, 48, 1536), (3, 16, 1024),
                    (256, 64, 2048))
# --f32 times: hal's step (its first), a completion token, hac lstm:512's
# fp32 parity shape
F32_TIMED = ((256, 64, 2048), (1, 1, 2048), (385, 48, 1536))
# --q8 variants, timed beside the routes (K1-q8 persistent at every
# width): (label, the units a block may own, or None for UNITS); a plan
# that does not fit leaves the call per-step
Q8_VARIANTS = (("K1-q8 persistent", None),
               ("K1-q8 8 units a block", (8,)),
               ("K1-q8 at most 14 units a block", tuple(range(2, 16, 2))),
               ("K2-q8 at most 14 units a block", tuple(range(2, 16, 2))))


# --phases: what each kernel's stamps (csrc/lstm_fwd.cu, lstm_bwd.cu,
# lstm_q8.cu: block 0's thread 0, one item a step, hl::keep_phase) bound:
# (label, stamp a, stamp b) reads median(b - a) over the steps clear of
# the ends; b None reads stamp a itself (a duration)
PHASES = {
    "K1": (("wait", 0, 1), ("product", 1, 2),
           ("partials to the cluster barrier", 2, 3),
           ("gather and cell", 3, 4), ("grid arrive", 4, 5)),
    "K2": (("wait", 0, 1), ("product", 1, 2),
           ("partials to the cluster barrier", 2, 3),
           ("gather and delta", 3, 4), ("grid arrive", 4, 5)),
    "K1-q8": (("wait", 0, 1), ("product", 1, 2),
              ("partials to the cluster barrier", 2, 3),
              ("gather and cell", 3, 4), ("grid arrive", 4, 5)),
    "K2-q8": (("wait for q", 0, 1), ("product", 1, 2),
              ("partials to the cluster barrier", 2, 3),
              ("gather and dequantize", 3, 4),
              ("delta, row maxima, first arrive", 4, 5),
              ("dgates stores, wait for the maxima", 5, 6),
              ("row scales, quantize", 6, 7)),
    # the fp32 kernels (persist_f32): stamps 2 and 7 are the ring's waits
    # inside the product, all of them and the first slice's
    "F32": (("grid wait", 0, 1), ("product", 1, 3),
            ("of which ring waits", 2, None), ("the first slice's", 7, None),
            ("exchange (partials, fold, cluster barrier, gather)", 3, 4),
            ("cell or delta, grid arrive", 4, 5),
            ("cluster wait, W prefetch", 5, 6)),
}


# --phases' ablations (kernels.ABLATIONS, compiled in by
# kernels.trace_phases): the bf16 product (csrc/persist.cuh) without its
# loads or its mma.sync; the fp32 one (csrc/persist_f32.cuh) without W's
# streamed slices, or with its shared-memory operands loaded once a slice
# instead of once a 4-column chunk (its FFMAs alone). The results are
# wrong; the times are the point
ABLATIONS = {"as is": (), "without the loads": ("HL_ABLATE_LOADS",),
             "without the mma": ("HL_ABLATE_MMA",)}
F32_ABLATIONS = {"as is": (),
                 "without the W stream": ("HL_ABLATE_W_STREAM",),
                 "without the product's loads": ("HL_ABLATE_OPERAND_LOADS",)}
# --f32 --variants: plans other than the route's, timed in turns with it
# at hal's shape (nn/lstm_cuda.py constants patched in this process):
# (label, {constant: value})
F32_VARIANTS = (("the plan", {}),
                ("64 KB in flight", {"F32_IN_FLIGHT": 64 * 1024}),
                ("96 KB in flight", {"F32_IN_FLIGHT": 96 * 1024}),
                ("one k group (K2: a 160-row tile)", {"F32_WKS": (1,)}))


def phase_cells(buf, kind, T):
    """'label cycles' of each phase of ``kind`` from stamps ``buf`` (8 x
    items), medians over the steps clear of the ends; and the cycles of a
    whole step."""
    import numpy as np
    d = buf[:, 2:min(T, buf.shape[1]) - 2]
    cells = [f"{label} {np.median(d[a] if b is None else d[b] - d[a]):.0f}"
             for label, a, b in PHASES[kind]]
    return np.median(d[0, 1:] - d[0, :-1]), cells


def phase_report(tree, q8=False, f32=False, ablations=()):
    """Per-step medians of the stamped phases (cycles): K1 and K2 in bf16
    at the three timed shapes (or K1-q8, both modes, and K2-q8; K1-q8 on
    its persistent route at every width), or with ``f32`` K1 (both
    modes) and K2 in fp32 at hal's shape; block 0 (a full block); built
    with ``ablations`` compiled in."""
    import numpy as np
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree, phases=True,
                                        ablations=ablations)
    lib = kernels.library()
    dev = torch.device("cuda", 0)
    if q8:
        lstm_cuda.Q8_FWD_MIN_H = 0
    for T, B, H in (F32_TIMED[:1] if f32 else TIMED):
        if q8:
            fargs, bargs = q8_inputs(torch, cs, lstm, T, B, H)
            runs = (("K1-q8", "K1-q8",
                     lambda: lstm_cuda.lstm_fwd_q8_cuda(*fargs),
                     lib.hl_lstm_q8_phases),
                    ("K1-q8 residual", "K1-q8",
                     lambda: lstm_cuda.lstm_fwd_q8_cuda(*fargs,
                                                        residuals=True),
                     lib.hl_lstm_q8_phases),
                    ("K2-q8", "K2-q8",
                     lambda: lstm_cuda.lstm_bwd_q8_cuda(*bargs),
                     lib.hl_lstm_q8_phases))
        else:
            dtype = torch.float32 if f32 else torch.bfloat16
            w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, dtype)
            bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
            k1, k2 = ("F32", "F32") if f32 else ("K1", "K2")
            runs = (("K1", k1, lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0),
                     lib.hl_lstm_fwd_phases),
                    ("K2", k2, lambda: lstm_cuda.lstm_bwd_cuda(*bargs),
                     lib.hl_lstm_bwd_phases))
            if f32:
                runs = runs[:1] + (
                    ("K1 residual", k1, lambda: lstm_cuda.lstm_fwd_cuda(
                        w, xp, h0, c0, residuals=True),
                     lib.hl_lstm_fwd_phases),) + runs[1:]
        for name, kind, fn, get in runs:
            fn()
            torch.cuda.synchronize()
            buf = np.zeros((kernels.PHASES, kernels.PHASE_ITEMS), np.int64)
            kernels.check(get(buf.ctypes.data), "hl_lstm_phases")
            step, cells = phase_cells(buf, kind, T)
            print(f"{name} ({T}, {B}, {H}) cycles a step: {step:.0f}; " +
                  ", ".join(cells), flush=True)


def load(tree, phases=False, ablations=()):
    """chip_smoke, kernels, nn.lstm and nn.lstm_cuda of ``tree``; with
    ``phases`` its kernels built with the phase stamps (and
    ``ablations``) compiled in."""
    sys.path.insert(0, str(tree))
    import chip_smoke
    from haloop_tpu_torch import kernels
    if phases:
        kernels.trace_phases(*ablations)
    from haloop_tpu_torch.nn import lstm, lstm_cuda
    assert Path(chip_smoke.__file__).resolve().parent == tree.resolve()
    return chip_smoke, kernels, lstm, lstm_cuda


def ptxas_lines(log, name="persist_step"):
    """The ptxas report of the entry functions whose name holds ``name``."""
    out, keep = [], 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if name in line else 0
        if keep:
            out.append(line.strip())
            keep = max(keep - 1, 0)
    return out


def bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0):
    """The plain residuals of (w, xp, h0, c0) and upstream grads from a
    seed, as chip_smoke.py phase 5 makes them."""
    dev = xp.device
    _, _, _, acts, cs_ = lstm.lstm_scan(w, xp, h0, c0, residuals=True)
    g = torch.Generator().manual_seed(T + H)
    dys = torch.randn((T, B, H), generator=g).to(dev, acts.dtype)
    dh = torch.randn((B, H), generator=g).to(dev) * 0.1
    dc = torch.randn((B, H), generator=g).to(dev) * 0.1
    return dys, acts, cs_, c0.to(acts.dtype), w, dh, dc


def checks(tree):
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    dev = torch.device("cuda", 0)
    sms, smem, ncl = lstm_cuda.card(dev)
    print(f"card: {sms} SMs, {smem} B of shared memory a block; resident "
          f"at once: " + ", ".join(
              f"{ncl[k]} clusters of {c} ({k})"
              for k, c in lstm_cuda.CLUSTERS.items()) +
          "; cooperative cluster launch accepted", flush=True)
    tol = cs.LSTM_TOL["bfloat16"]
    bad = []
    for T, B, H in CHECK_SHAPES:
        w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, torch.bfloat16)
        routes = {k: lstm_cuda.route(k, torch.bfloat16, H, B, sms, smem,
                                     ncl[k]) for k in ("fwd", "bwd")}
        before = dict(lstm_cuda.route_launches)
        ys, h, c = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0)
        ys_r, h_r, c_r, acts, cs_ = lstm_cuda.lstm_fwd_cuda(
            w, xp, h0, c0, residuals=True)
        bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
        dg, dh0, dc0 = lstm_cuda.lstm_bwd_cuda(*bargs)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                if v != before[k]}
        want_took = {f"fwd_{routes['fwd'][0]}": 2,
                     f"bwd_{routes['bwd'][0]}": 1}
        ye, he, ce = lstm.lstm_scan(w, xp, h0, c0)
        _, _, _, acts_e, cs_e = lstm.lstm_scan(w, xp, h0, c0, residuals=True)
        dys, acts_p, cs_p, c0r, _, dh, dc = bargs
        c_prev = torch.cat([c0r[None], cs_p[:-1]])
        dg_e, dh0_e, dc0_e = lstm.lstm_scan_bwd(dys, acts_p, c_prev, cs_p, w,
                                                dh, dc)
        res = {}
        for name, got, want in (("ys", ys, ye), ("h", h, he), ("c", c, ce),
                                ("acts", acts, acts_e), ("cs", cs_, cs_e),
                                ("dgates", dg, dg_e), ("dh0", dh0, dh0_e),
                                ("dc0", dc0, dc0_e)):
            ok, err, mean = cs.within(torch, got, want, tol)
            res[name] = (ok, err, mean)
        same_r = (torch.equal(ys, ys_r) and torch.equal(h, h_r) and
                  torch.equal(c, c_r))
        again = (lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0),
                 lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0, residuals=True),
                 lstm_cuda.lstm_bwd_cuda(*bargs))
        twice = all(torch.equal(a, b) for a, b in zip(
            (*again[0], *again[1], *again[2]),
            (ys, h, c, ys_r, h_r, c_r, acts, cs_, dg, dh0, dc0)))
        ok = (all(v[0] for v in res.values()) and same_r and twice and
              took == want_took)
        plan = routes["fwd"][1], routes["bwd"][1]
        print(f"{'ok ' if ok else 'BAD'} (T, B, H) = {(T, B, H)}: routes "
              f"{took}; " + ", ".join(f"max|d{k}| {v[1]:.2e}"
                                      for k, v in res.items()) +
              f"; residual mode's ys/h/c those of K1 {same_r}; same bits "
              f"twice {twice}; plans fwd {plan[0]} bwd {plan[1]}",
              flush=True)
        if not ok:
            bad.append((T, B, H))
    return bad


def times(tree):
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    kernels.library()
    dev = torch.device("cuda", 0)
    res = {}
    for T, B, H in TIMED:
        w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, torch.bfloat16)
        bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
        key = f"({T}, {B}, {H})"
        res[f"K1 {key}"] = cs.cuda_ms(
            lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0))
        res[f"K1 residual {key}"] = cs.cuda_ms(
            lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0, residuals=True))
        res[f"K2 {key}"] = cs.cuda_ms(
            lambda: lstm_cuda.lstm_bwd_cuda(*bargs))
        if (T, B, H) == TIMED[0]:
            ref = torch.nn.LSTM(H, H).to(dev, torch.bfloat16)
            x = xp[..., :H].contiguous()
            with torch.inference_mode():
                res[f"cuDNN forward {key}"] = cs.cuda_ms(lambda: ref(x))
            x.requires_grad_(True)
            out = ref(x)[0]
            grad = torch.randn_like(out)
            res[f"cuDNN backward {key}"] = cs.cuda_ms(
                lambda: torch.autograd.grad(out, (x, *ref.parameters()),
                                            grad, retain_graph=True))
    return res


def device_ms(torch, fn, events=False):
    """The device's busy time in one call of ``fn`` (the union of its
    kernels' spans), from torch.profiler after a traced warm-up call; with
    ``events`` also the count of device events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.autograd.DeviceType.CUDA
    spans = []

    def keep(p):
        spans.extend((e.start_ns(), e.end_ns())
                     for e in p.profiler.kineto_results.events()
                     if e.device_type() == cuda and
                     not e.is_user_annotation())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return (busy / 1e6, len(spans)) if events else busy / 1e6


def rates(tree):
    """Utterances/s of the paths K1 and K2 serve, each the median of 5
    host-timed calls that end in a host read (chip_smoke.host_ms)."""
    import torch
    cs, kernels, _, _ = load(tree)
    kernels.library()
    dev = torch.device("cuda", 0)
    out = {}
    system = cs.make_system(torch, dev, "--arch", "lstm:512")
    _, batch = cs.eval_batch(system)

    def step():
        system.train_step(*batch)
    ms, _ = cs.host_ms(torch, step)
    out["lstm:512 CTC train utt/s"] = 48 / ms * 1e3
    out["lstm:512 CTC train step device ms"] = device_ms(torch, step)

    def serve():
        _, feats, feat_lens, _ = system._forward_impl(*batch, train=False)
        return [t.cpu() for t in system._decode_impl(feats, feat_lens,
                                                     train=False)]
    with torch.inference_mode():
        ms, _ = cs.host_ms(torch, serve)
    out["lstm:512 serving utt/s"] = 48 / ms * 1e3
    del system
    system = cs.make_system(torch, dev, "--arch", "lstm:512",
                            "--star-penalty", str(cs.STAR_PENALTY))
    ms, _ = cs.host_ms(torch, lambda: system.train_step(*batch))
    out["lstm:512 Star-CTC train utt/s"] = 48 / ms * 1e3
    del system
    system = cs.make_system(torch, dev, "--arch", "rnn-transducer:lstm:512")
    tb = cs.transducer_batch(system)
    ms, _ = cs.host_ms(torch, lambda: system.train_step(*tb))
    out["rnn-transducer:lstm:512 train utt/s"] = 16 / ms * 1e3

    def transcribe():
        _, feats, feat_lens, _ = system._forward_impl(*tb, train=False)
        o = system._decode_impl(feats, feat_lens,
                                max_steps=tb[1].shape[1] + 1, train=False)
        return [t.cpu() for t in o[:4]]
    with torch.inference_mode():
        ms, _ = cs.host_ms(torch, transcribe)
    out["rnn-transducer:lstm:512 transcription utt/s"] = 16 / ms * 1e3
    return out


class variant:
    """lstm_cuda's units a block may own set to a variant's, and K1-q8
    persistent at every width, for the duration (a probe of one process
    only)."""

    def __init__(self, lstm_cuda, units):
        self.m, self.units = lstm_cuda, units

    def __enter__(self):
        self.saved = self.m.UNITS, self.m.Q8_FWD_MIN_H
        self.m.UNITS = self.units or self.m.UNITS
        self.m.Q8_FWD_MIN_H = 0

    def __exit__(self, *exc):
        self.m.UNITS, self.m.Q8_FWD_MIN_H = self.saved


def f32_checks(tree):
    """K1 (both modes) and K2 in fp32 against the plain versions within
    LSTM_TOL["float32"] at F32_CHECK_SHAPES: the route each call took, the
    same bits twice, and the residual mode's ys/h/c those of K1."""
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log, "persist_f32"):
        print("ptxas:", line, flush=True)
    dev = torch.device("cuda", 0)
    sms, smem, ncl = lstm_cuda.card(dev)
    tol = cs.LSTM_TOL["float32"]
    bad = []
    for T, B, H in F32_CHECK_SHAPES:
        w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, torch.float32)
        routes = {k: lstm_cuda.route(k, torch.float32, H, B, sms, smem,
                                     ncl[k]) for k in ("fwd", "bwd")}
        before = dict(lstm_cuda.route_launches)
        out = (*lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0),
               *lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0, residuals=True))
        bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
        out += lstm_cuda.lstm_bwd_cuda(*bargs)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                if v != before[k]}
        want_took = {f"fwd_{routes['fwd'][0]}": 2,
                     f"bwd_{routes['bwd'][0]}": 1}
        dys, acts_p, cs_p, c0r, _, dh, dc = bargs
        want = (*lstm.lstm_scan(w, xp, h0, c0),
                *lstm.lstm_scan(w, xp, h0, c0, residuals=True),
                *lstm.lstm_scan_bwd(dys, acts_p, torch.cat(
                    [c0r[None], cs_p[:-1]]), cs_p, w, dh, dc))
        names = ("ys", "h", "c", "ys_r", "h_r", "c_r", "acts", "cs",
                 "dgates", "dh0", "dc0")
        res = {n: cs.within(torch, g, e, tol)
               for n, g, e in zip(names, out, want)}
        again = (*lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0),
                 *lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0, residuals=True),
                 *lstm_cuda.lstm_bwd_cuda(*bargs))
        twice = all(torch.equal(a, b) for a, b in zip(out, again))
        same_r = all(torch.equal(a, b) for a, b in zip(out[:3], out[3:6]))
        ok = (all(v[0] for v in res.values()) and twice and same_r and
              took == want_took)
        print(f"{'ok ' if ok else 'BAD'} fp32 (T, B, H) = {(T, B, H)}: "
              f"routes {took}; " + ", ".join(
                  f"max|d{k}| {v[1]:.2e}" for k, v in res.items()
                  if k in ("ys", "acts", "cs", "dgates", "dh0", "dc0")) +
              f"; same bits twice {twice}; residual mode's ys/h/c those "
              f"of K1 {same_r}; plans fwd {routes['fwd'][1]} bwd "
              f"{routes['bwd'][1]}", flush=True)
        if not ok:
            bad.append((T, B, H))
    return bad


def cudnn_recurrence(torch, cs, T, B, H, dev):
    """cuDNN fp32's recurrence alone at (T, B, H), as chip_smoke.py phase
    29 times it: nn.LSTM on inputs of width 1, frozen weights (TF32 off):
    {forward, forward under autograd, backward to x}."""
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(T + H)
    ref = torch.nn.LSTM(1, H).to(dev).requires_grad_(False)
    x = torch.randn((T, B, 1), generator=g).to(dev)
    out = {}
    with torch.inference_mode():
        out["forward"] = cs.cuda_ms(lambda: ref(x))
    xg = x.clone().requires_grad_(True)
    out["under autograd"] = cs.cuda_ms(lambda: ref(xg))
    y = ref(xg)[0]
    grad = torch.randn_like(y)
    out["backward"] = cs.cuda_ms(lambda: torch.autograd.grad(
        y, (xg,), grad, retain_graph=True))
    return out


def f32_times(tree):
    """K1, K1 with residuals and K2 in fp32 at F32_TIMED (CUDA events
    around one call behind a spin, median of 5), cuDNN's recurrence alone
    at hal's shape beside them."""
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    kernels.library()
    dev = torch.device("cuda", 0)
    res = {}
    for T, B, H in F32_TIMED:
        w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, torch.float32)
        key = f"fp32 ({T}, {B}, {H})"
        res[f"K1 {key}"] = cs.cuda_ms(
            lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0))
        if T == 1:
            continue
        res[f"K1 residual {key}"] = cs.cuda_ms(
            lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0, residuals=True))
        bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
        res[f"K2 {key}"] = cs.cuda_ms(lambda: lstm_cuda.lstm_bwd_cuda(*bargs))
        if (T, B, H) == F32_TIMED[0]:
            for k, v in cudnn_recurrence(torch, cs, T, B, H, dev).items():
                res[f"cuDNN recurrence alone, {k} {key}"] = v
    return res


def f32_variants(tree):
    """K1, K1 with residuals and K2 in fp32 at hal's shape with each of
    F32_VARIANTS' plans, in turns, twice; each with its plans."""
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    kernels.library()
    dev = torch.device("cuda", 0)
    sms, smem, ncl = lstm_cuda.card(dev)
    T, B, H = F32_TIMED[0]
    w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, torch.float32)
    bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
    for _ in range(2):
        for label, patch in F32_VARIANTS:
            saved = {k: getattr(lstm_cuda, k) for k in patch}
            for k, v in patch.items():
                setattr(lstm_cuda, k, v)
            try:
                ms = [cs.cuda_ms(fn) for fn in (
                    lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0),
                    lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0,
                                                    residuals=True),
                    lambda: lstm_cuda.lstm_bwd_cuda(*bargs))]
                plans = [lstm_cuda.route(k, torch.float32, H, B, sms, smem,
                                         ncl[k])[1] for k in ("fwd", "bwd")]
            finally:
                for k, v in saved.items():
                    setattr(lstm_cuda, k, v)
            print(f"{label}: K1 {ms[0]:.4f} ms, K1 residual {ms[1]:.4f}, "
                  f"K2 {ms[2]:.4f}; plans fwd {plans[0]} bwd {plans[1]}",
                  flush=True)


def f32_rates(tree):
    """hal's train step (tokens/s, median of 5 host-timed steps that end in
    a host read; its device time from torch.profiler) and completion
    (tokens/s, 256 top-1 tokens at B = 1) at the rnnlm arch's 1 x 2048,
    64 x 256, as chip_smoke.py phase 30 drives them."""
    import math
    import tempfile
    import torch
    cs, kernels, _, _ = load(tree)
    kernels.library()
    from haloop_tpu_torch import rnnlm
    from haloop_tpu_torch.models import rnn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, B, H = cs.HAL_SHAPE
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = cs.hal_corpus(tmp)
        args = rnnlm.make_parser().parse_args([
            "--train", f"bytes:{corpus}", "--rnn-size", str(H),
            "--num-layers", "1", "--batch-size", str(B), "--bptt-len",
            str(T), "--device", "cuda"])
        system = rnnlm.System(args)
    chunk = torch.from_numpy(system.dataset[0].astype("int64")).to(
        system.device)
    inputs = torch.cat([system.prompt, chunk[:-1]])
    state = [system.state]

    def step():
        state[0], loss, _, _ = system.train_step(inputs, chunk, state[0])
        assert math.isfinite(loss.item())
    ms, _ = cs.host_ms(torch, step)
    out["hal train tokens/s"] = B * T / ms * 1e3
    out["hal train step device ms"] = device_ms(torch, step)
    x, st = system.prepare_prompt(b"\nthe ")
    with torch.inference_mode():
        logits, st = rnn.decoder_apply(system.params, x, st,
                                       num_layers=system.num_layers)
    l0 = logits[-1, 0]
    cms, _ = cs.host_ms(torch, lambda: system.sample_ids(l0, st, T, 1))
    out["hal completion tokens/s"] = T / cms * 1e3
    return out


def q8_inputs(torch, cs, lstm, T, B, H, bwd=True):
    """(fwd args, bwd args) of K1-q8 and K2-q8 as chip_smoke.py phase 5b
    makes them: wq, s from the bf16 W; K2-q8 on the plain residuals (None
    without ``bwd``)."""
    dev = torch.device("cuda", 0)
    w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, torch.bfloat16)
    wq, s = lstm.quantize_rows(w)
    if not bwd:
        return (wq, s, xp, h0, c0), None
    _, _, _, acts, cs_ = lstm.lstm_scan_q8(wq, s, xp, h0, c0,
                                           residuals=True)
    g = torch.Generator().manual_seed(T + H)
    dys = torch.randn((T, B, H), generator=g).to(dev, torch.bfloat16)
    dh = torch.randn((B, H), generator=g).to(dev) * 0.1
    dc = torch.randn((B, H), generator=g).to(dev) * 0.1
    return ((wq, s, xp, h0, c0),
            (dys, acts, cs_, c0.to(torch.bfloat16), wq, s, dh, dc))


def q8_runs(lstm_cuda, fargs, bargs, **kw):
    """K1-q8, K1-q8 with residuals and K2-q8 once each: their outputs in
    one tuple."""
    return (*lstm_cuda.lstm_fwd_q8_cuda(*fargs, **kw),
            *lstm_cuda.lstm_fwd_q8_cuda(*fargs, residuals=True, **kw),
            *lstm_cuda.lstm_bwd_q8_cuda(*bargs, **kw))


def q8_checks(tree):
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log, "persist_q8"):
        print("ptxas:", line, flush=True)
    dev = torch.device("cuda", 0)
    sms, smem, ncl = lstm_cuda.card(dev)
    bad = []
    names = ("ys", "h", "c", "ys_r", "h_r", "c_r", "acts", "cs", "dgates",
             "dh0", "dc0")
    for T, B, H in Q8_CHECK_SHAPES:
        fargs, bargs = q8_inputs(torch, cs, lstm, T, B, H)
        routes = {k: lstm_cuda.route(k, torch.bfloat16, H, B, sms, smem,
                                     ncl[k]) for k in ("fwd_q8", "bwd_q8")}
        before = dict(lstm_cuda.route_launches)
        got = q8_runs(lstm_cuda, fargs, bargs)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                if v != before[k]}
        want_took = {f"fwd_q8_{routes['fwd_q8'][0]}": 2,
                     f"bwd_q8_{routes['bwd_q8'][0]}": 1}
        twice = all(torch.equal(a, b) for a, b in
                    zip(got, q8_runs(lstm_cuda, fargs, bargs)))
        step = q8_runs(lstm_cuda, fargs, bargs, per_step=True)
        differ = [n for n, a, b in zip(names, got, step)
                  if not torch.equal(a, b)]
        vdiffer = {}
        for label, units in Q8_VARIANTS:
            with variant(lstm_cuda, units):
                out = q8_runs(lstm_cuda, fargs, bargs)
            vdiffer[label] = [n for n, a, b in zip(names, got, out)
                              if not torch.equal(a, b)]
        wq, s, xp, h0, c0 = fargs
        dys, acts, cs_, c0r, _, _, dh, dc = bargs
        want = (*lstm.lstm_scan_q8(wq, s, xp, h0, c0),
                *lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True),
                *lstm.lstm_scan_bwd_q8(dys, acts,
                                       torch.cat([c0r[None], cs_[:-1]]),
                                       cs_, wq, s, dh, dc))
        errs = [cs.rel_err(a, b) for a, b in zip(got, want)]
        limits = [cs.K1Q8_REL] * 8 + [cs.K2Q8_REL[k]
                                      for k in ("dgates", "dh0", "dc0")]
        ok = (all(e <= lim for e, lim in zip(errs, limits)) and twice and
              took == want_took and not differ and
              not any(vdiffer.values()))
        print(f"{'ok ' if ok else 'BAD'} (T, B, H) = {(T, B, H)}: routes "
              f"{took}; rel err K1-q8 {max(errs[:8]):.2e}, dgates "
              f"{errs[8]:.2e} dh0 {errs[9]:.2e} dc0 {errs[10]:.2e}; same "
              f"bits twice {twice}; outputs other than the per-step "
              f"kernels' {differ}; other than the variants' {vdiffer}; "
              f"plans fwd_q8 {routes['fwd_q8'][1]} bwd_q8 "
              f"{routes['bwd_q8'][1]}", flush=True)
        if not ok:
            bad.append((T, B, H))
    return bad


def q8_times(tree):
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    kernels.library()
    res = {}
    variants = hasattr(lstm_cuda, "Q8_FWD_MIN_H")
    for T, B, H in TIMED:
        fargs, bargs = q8_inputs(torch, cs, lstm, T, B, H)
        key = f"({T}, {B}, {H})"

        def timed(label):
            res[f"K1-q8 {label}{key}"] = cs.cuda_ms(
                lambda: lstm_cuda.lstm_fwd_q8_cuda(*fargs))
            res[f"K1-q8 residual {label}{key}"] = cs.cuda_ms(
                lambda: lstm_cuda.lstm_fwd_q8_cuda(*fargs, residuals=True))
            res[f"K2-q8 {label}{key}"] = cs.cuda_ms(
                lambda: lstm_cuda.lstm_bwd_q8_cuda(*bargs))
        timed("")
        if variants:
            res[f"K1-q8 per-step {key}"] = cs.cuda_ms(
                lambda: lstm_cuda.lstm_fwd_q8_cuda(*fargs, per_step=True))
            res[f"K2-q8 per-step {key}"] = cs.cuda_ms(
                lambda: lstm_cuda.lstm_bwd_q8_cuda(*bargs, per_step=True))
            for label, units in Q8_VARIANTS:
                with variant(lstm_cuda, units):
                    if label.startswith("K1-q8"):
                        res[f"{label} {key}"] = cs.cuda_ms(
                            lambda: lstm_cuda.lstm_fwd_q8_cuda(*fargs))
                        res[f"{label}, residual mode {key}"] = cs.cuda_ms(
                            lambda: lstm_cuda.lstm_fwd_q8_cuda(
                                *fargs, residuals=True))
                    else:
                        res[f"{label} {key}"] = cs.cuda_ms(
                            lambda: lstm_cuda.lstm_bwd_q8_cuda(*bargs))
    if variants:
        # K1-q8's persistent and per-step kernels over short sequences
        # (Q8_FWD_MIN_H: 0 here, every width persistent), both modes
        min_h, lstm_cuda.Q8_FWD_MIN_H = lstm_cuda.Q8_FWD_MIN_H, 0
        for T, B, H in Q8_SHORT:
            fargs, _ = q8_inputs(torch, cs, lstm, T, B, H, bwd=False)
            for r in (False, True):
                for step in (False, True):
                    res[f"K1-q8{' residual' if r else ''}"
                        f"{' per-step' if step else ' persistent'} "
                        f"({T}, {B}, {H})"] = cs.cuda_ms(
                        lambda: lstm_cuda.lstm_fwd_q8_cuda(
                            *fargs, residuals=r, per_step=step))
        lstm_cuda.Q8_FWD_MIN_H = min_h
    return res


def q8_rates(tree):
    """Utterances/s of the --rnn-q8 paths K1-q8 and K2-q8 serve (medians
    of 5 host-timed calls that end in a host read), and a CTC train
    step's device busy time and device events."""
    import torch
    cs, kernels, _, _ = load(tree)
    kernels.library()
    dev = torch.device("cuda", 0)
    out = {}
    system = cs.make_system(torch, dev, "--arch", "lstm:512", "--rnn-q8")
    _, batch = cs.eval_batch(system)

    def step():
        system.train_step(*batch)
    ms, _ = cs.host_ms(torch, step)
    out["lstm:512 --rnn-q8 CTC train utt/s"] = 48 / ms * 1e3
    busy, events = device_ms(torch, step, events=True)
    out["lstm:512 --rnn-q8 CTC train step device ms"] = busy
    out["lstm:512 --rnn-q8 CTC train step device events"] = events

    def serve():
        _, feats, feat_lens, _ = system._forward_impl(*batch, train=False)
        return [t.cpu() for t in system._decode_impl(feats, feat_lens,
                                                     train=False)]
    with torch.inference_mode():
        ms, _ = cs.host_ms(torch, serve)
    out["lstm:512 --rnn-q8 serving utt/s"] = 48 / ms * 1e3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    ap.add_argument("--phases", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--q8", action="store_true",
                      help="K1-q8 and K2-q8 instead of K1 and K2")
    mode.add_argument("--f32", action="store_true",
                      help="K1 and K2 in fp32 (hal's route)")
    ap.add_argument("--variants", action="store_true",
                    help="with --f32: other plans timed beside the route's")
    ap.add_argument("--phase-report", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ablate", nargs="*", default=[],
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe needs one GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    flag = ["--q8"] if a.q8 else ["--f32"] if a.f32 else []
    if a.variants:
        print(card, flush=True)
        f32_variants(a.tree)
        return
    if a.phase_report:
        phase_report(a.tree, a.q8, a.f32, a.ablate)
        return
    if a.phases:
        print(card, flush=True)
        for label, ablations in (F32_ABLATIONS if a.f32
                                 else ABLATIONS).items():
            print(f"-- {label}", flush=True)
            subprocess.run([sys.executable, __file__, "--tree", str(a.tree),
                            "--phase-report", "--ablate", *ablations] + flag,
                           check=True)
        return
    times_of = q8_times if a.q8 else f32_times if a.f32 else times
    rates_of = q8_rates if a.q8 else f32_rates if a.f32 else rates
    if a.times_only:
        res = times_of(a.tree)
        if not a.kernels_only:
            res.update(rates_of(a.tree))
        print(json.dumps(res), flush=True)
        return
    print(card, flush=True)
    if a.against:
        runs = []
        for tree in (a.against, a.tree, a.tree, a.against):
            flags = (["--kernels-only"] if a.kernels_only else []) + flag
            r = subprocess.run([sys.executable, __file__, "--tree",
                                str(tree), "--times-only", *flags],
                               capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"{tree}: exit {r.returncode}\n{r.stderr}")
            runs.append((tree, json.loads(r.stdout.splitlines()[-1])))
        for label in runs[0][1]:
            cells = ", ".join(f"{'this' if t == a.tree else 'parent'} "
                              f"{res[label]:.4f}" for t, res in runs)
            unit = "" if label.endswith(("/s", "events")) else " ms"
            print(f"{label}:{unit} {cells}", flush=True)
        print(json.dumps({"card": card, "runs": [
            {"tree": str(t), "ms": res} for t, res in runs]}), flush=True)
        return
    bad = (q8_checks if a.q8 else f32_checks if a.f32 else checks)(a.tree)
    for label, ms in times_of(a.tree).items():
        print(f"{label}: {ms:.4f} ms", flush=True)
    if bad:
        raise SystemExit(f"disagree with the plain versions: {bad}")


if __name__ == "__main__":
    main()
