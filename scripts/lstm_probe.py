#!/usr/bin/env python3
"""The LSTM recurrence kernels of the PyTorch port alone on one GPU: K1
(``haloop_tpu_torch/csrc/lstm_fwd.cu``, with and without residuals) and
K2 (``csrc/lstm_bwd.cu``) in bf16, or with ``--q8`` their int8 modes K1-q8
(both modes) and K2-q8 (``csrc/lstm_q8.cu``): their build, what the card
offers them, the route and plan each shape takes, checks against the
plain versions, and their times.

    python3 scripts/lstm_probe.py                 # checks, then times
    python3 scripts/lstm_probe.py --against DIR   # times and rates only:
        # the tree at DIR and this one in turns (DIR, this, this, DIR),
        # each in a process of its own, at the same shapes and inputs
    python3 scripts/lstm_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)
    python3 scripts/lstm_probe.py --phases
        # where a step's time goes in the persistent kernels: a copy of
        # this tree under build/lstm_phases*/ with clock64 stamps added
        # (block 0, thread 0, each step), medians in cycles; then again
        # with the product's loads left out (it multiplies whatever the
        # ring holds) and with its mma.sync left out (the results are
        # wrong there, the times are the point)

``--q8`` with any of these: K1-q8 and K2-q8 instead. Its checks also
hold the persistent route to the same bits as the per-step kernels
(``per_step=True``) and as its variants (other units a block), and its
times include those
variants' (the tree's own; a parent without them times its routes only).
Its rates are the ``--rnn-q8`` paths', with a CTC train step's device
events.

``--kernels-only`` leaves the rates out. DIR is another checkout of the
repository (``git archive`` of a commit unpacked into a directory that
.gitignore lists); each tree builds its own kernels into its own
``build/``.

Checks: at the card tests' shapes (T = 1, B in {5, 48, 100}, H = 1000, a
bf16 H that takes the per-step route) and chip_smoke's LSTM_SHAPES, K1,
K1 with residuals and K2 against ``nn.lstm.lstm_scan`` /
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
# --q8 variants, timed beside the routes (K1-q8 persistent at every
# width): (label, the units a block may own, or None for UNITS); a plan
# that does not fit leaves the call per-step
Q8_VARIANTS = (("K1-q8 persistent", None),
               ("K1-q8 8 units a block", (8,)),
               ("K1-q8 at most 14 units a block", tuple(range(2, 16, 2))),
               ("K2-q8 at most 14 units a block", tuple(range(2, 16, 2))))


# --phases: for each source, (anchor, stamp index, after, loop variable):
# a stamp goes before the anchor's first occurrence (after it, with
# after); K1 and K1-q8 stamp steps t, K2 and K2-q8 their products (s,
# sidx); the stamps of each kernel, in order, bound its PHASES
STAMPS = {
    "lstm_fwd.cu": (
        ("      if (t > 0 && b0 == 0) grid_wait(", 0, False, "t"),
        ("      if (t > 0 && b0 == 0) grid_wait(bar, (unsigned)t * "
         "gridDim.x);", 1, True, "t"),
        ("      if (wkg < p.wk) store_partial<NPW>(", 2, False, "t"),
        ("      hl::cluster_wait();         // every block's partials are "
         "written", 3, True, "t"),
        ("      hl::cluster_arrive();       // this block is done with the "
         "partials", 4, False, "t"),
        ("    if (t + 1 < T) grid_arrive(bar);", 5, True, "t")),
    "lstm_bwd.cu": (
        ("        if (b0 == 0) grid_wait(", 0, False, "s"),
        ("        if (b0 == 0) grid_wait(bar, (unsigned)s * gridDim.x);", 1,
         True, "s"),
        ("        if (wkg < p.wk) store_partial<NPW>(", 2, False, "s"),
        ("        hl::cluster_wait();     // every block's partials are "
         "written", 3, True, "s"),
        ("        hl::cluster_arrive();   // this block is done with the "
         "partials", 4, False, "s"),
        ("    if (t >= 0) grid_arrive(bar);", 5, True, "s")),
    "lstm_q8.cu": (
        ("      if (b0 == 0) ph.wait(bar);", 0, False, "t"),
        ("      if (b0 == 0) ph.wait(bar);", 1, True, "t"),
        ("      if (wkg < p.wk) store_partial<NPW>(", 2, False, "t"),
        ("      hl::cluster_wait();         // every block's partials are "
         "written", 3, True, "t"),
        ("      hl::cluster_arrive();       // this block is done with the "
         "partials", 4, False, "t"),
        ("    if (t + 1 < T) ph.arrive(bar);", 5, True, "t"),
        ("        ph.wait(bar);\n        int acc", 0, False, "sidx"),
        ("        ph.wait(bar);", 1, True, "sidx"),
        ("        if (wkg < p.wk) store_partial<NPW>(", 2, False, "sidx"),
        ("        hl::cluster_wait();     // every block's partials are "
         "written", 3, True, "sidx"),
        ("        hl::cluster_arrive();   // this block is done with the "
         "partials", 4, False, "sidx"),
        ("      // while the others arrive", 5, False, "sidx"),
        ("      if (threadIdx.x < rows) {\n        const float m = fmaxf(",
         6, False, "sidx"),
        ("      ph.arrive(bar);\n    }\n  }\n", 7, False, "sidx")),
}
PHASES = {
    "K1": ("wait", "product", "partials to the cluster barrier",
           "gather and cell", "grid arrive"),
    "K2": ("wait", "product", "partials to the cluster barrier",
           "gather and delta", "grid arrive"),
    "K1-q8": ("wait", "product", "partials to the cluster barrier",
              "gather and cell", "grid arrive"),
    # (the second arrive falls between the last stamp and the next
    # step's first)
    "K2-q8": ("wait for q", "product", "partials to the cluster barrier",
              "gather and dequantize", "delta, row maxima, first arrive",
              "dgates stores, wait for the maxima", "row scales, quantize"),
}
STAMP_DEF = """
__device__ long long hl_phase[8][1024];
__device__ __forceinline__ void stamp(int ph, int step) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && step < 1024)
    hl_phase[ph][step] = clock64();
}
"""
STAMP_READ = """
extern "C" int hl_lstm_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, hl_phase, sizeof(hl_phase));
}
"""


# --phases' ablations of the product (csrc/persist.cuh): (old, new) text
ABLATIONS = {
    "as is": (),
    "without the loads": (
        ("  for (int s = 0; s < ahead; ++s) load(s);\n", ""),
        ("    mbar_wait(bars + 8 * slot, (par >> slot) & 1);\n", ""),
        ("      load(s + stages);\n", "")),
    "without the mma": (
        ("      if (wkg >= wk || (wk > 1 && (s * STEPS + kk) % wk != wkg))",
         "      if (true)"),),
}


def phases_tree(dst, ablation=()):
    """A copy of this tree's port and chip_smoke.py at ``dst`` with a
    clock64 stamp at each phase boundary of the persistent kernels and C
    entry points ``hl_lstm_phases_{fwd,bwd,q8}`` that read them back;
    ``ablation`` edits csrc/persist.cuh further ((old, new) pairs)."""
    import shutil
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(HERE / "haloop_tpu_torch", dst / "haloop_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dst / "chip_smoke.py")
    csrc = dst / "haloop_tpu_torch" / "csrc"
    persist = (csrc / "persist.cuh").read_text()
    for old, new in ablation:
        assert old in persist, old
        persist = persist.replace(old, new)
    (csrc / "persist.cuh").write_text(persist)
    for name, stamps in STAMPS.items():
        src = (csrc / name).read_text()
        ns = "namespace persist_q8 {" if name == "lstm_q8.cu" else \
            "namespace persist_step {"
        src = src.replace(ns, STAMP_DEF + "\n" + ns, 1)
        src += STAMP_READ.replace("hl_lstm_phases",
                                  f"hl_lstm_phases_{name[5:-3]}")
        for anchor, ph, after, var in stamps:
            assert anchor in src, (name, anchor)
            ind = anchor[:len(anchor) - len(anchor.lstrip())]
            guard = "" if "t + 1 < T" in anchor or \
                "t >= 0) grid_arrive" in anchor else "if (b0 == 0) "
            st = f"{ind}{guard}stamp({ph}, {var});"
            i = src.index(anchor)
            if after:
                i += len(anchor)
                src = src[:i] + "\n" + st + src[i:]
            else:
                src = src[:i] + st + "\n" + src[i:]
        (csrc / name).write_text(src)
    kp = dst / "haloop_tpu_torch" / "kernels.py"
    k = kp.read_text().replace(
        '"hl_lstm_card": [_I, _P],',
        '"hl_lstm_card": [_I, _P],\n    "hl_lstm_phases_fwd": [_P],\n'
        '    "hl_lstm_phases_bwd": [_P],\n    "hl_lstm_phases_q8": [_P],')
    kp.write_text(k)


def phase_report(tree, q8=False):
    """Per-step medians of the stamped phases (cycles), K1 and K2 (or
    K1-q8, both modes, and K2-q8; K1-q8 on its persistent route at every
    width) at the three timed shapes, block 0 (a full block)."""
    import numpy as np
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    lib = kernels.library()
    dev = torch.device("cuda", 0)
    if q8:
        lstm_cuda.Q8_FWD_MIN_H = 0
    for T, B, H in TIMED:
        if q8:
            fargs, bargs = q8_inputs(torch, cs, lstm, T, B, H)
            runs = (("K1-q8", lambda: lstm_cuda.lstm_fwd_q8_cuda(*fargs),
                     lib.hl_lstm_phases_q8),
                    ("K1-q8 residual", lambda: lstm_cuda.lstm_fwd_q8_cuda(
                        *fargs, residuals=True), lib.hl_lstm_phases_q8),
                    ("K2-q8", lambda: lstm_cuda.lstm_bwd_q8_cuda(*bargs),
                     lib.hl_lstm_phases_q8))
        else:
            w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H,
                                           torch.bfloat16)
            bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
            runs = (("K1", lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0),
                     lib.hl_lstm_phases_fwd),
                    ("K2", lambda: lstm_cuda.lstm_bwd_cuda(*bargs),
                     lib.hl_lstm_phases_bwd))
        for kind, fn, get in runs:
            fn()
            torch.cuda.synchronize()
            buf = np.zeros((8, 1024), np.int64)
            kernels.check(get(buf.ctypes.data), "hl_lstm_phases")
            d = buf[:, 2:min(T, 1024) - 2]   # steps clear of the ends
            cells = [f"{name} {np.median(d[i + 1] - d[i]):.0f}"
                     for i, name in enumerate(PHASES[kind.split()[0]])]
            step = np.median(d[0, 1:] - d[0, :-1])
            print(f"{kind} ({T}, {B}, {H}) cycles a step: {step:.0f}; " +
                  ", ".join(cells), flush=True)


def load(tree):
    sys.path.insert(0, str(tree))
    import chip_smoke
    from haloop_tpu_torch import kernels
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
    ap.add_argument("--q8", action="store_true",
                    help="K1-q8 and K2-q8 instead of K1 and K2")
    ap.add_argument("--phase-report", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe needs one GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if a.phase_report:
        phase_report(a.tree, a.q8)
        return
    if a.phases:
        print(card, flush=True)
        for i, (label, edits) in enumerate(ABLATIONS.items()):
            print(f"-- {label}", flush=True)
            dst = HERE / "build" / f"lstm_phases{i}"
            phases_tree(dst, edits)
            subprocess.run([sys.executable, __file__, "--tree", str(dst),
                            "--phase-report"] + (["--q8"] if a.q8 else []),
                           check=True)
        return
    if a.times_only:
        res = (q8_times if a.q8 else times)(a.tree)
        if not a.kernels_only:
            res.update((q8_rates if a.q8 else rates)(a.tree))
        print(json.dumps(res), flush=True)
        return
    print(card, flush=True)
    if a.against:
        runs = []
        for tree in (a.against, a.tree, a.tree, a.against):
            flags = (["--kernels-only"] if a.kernels_only else []) + \
                (["--q8"] if a.q8 else [])
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
    bad = (q8_checks if a.q8 else checks)(a.tree)
    for label, ms in (q8_times if a.q8 else times)(a.tree).items():
        print(f"{label}: {ms:.4f} ms", flush=True)
    if bad:
        raise SystemExit(f"disagree with the plain versions: {bad}")


if __name__ == "__main__":
    main()
