#!/usr/bin/env python3
"""The bf16 LSTM recurrence kernels of the PyTorch port alone on one GPU:
K1 (``haloop_tpu_torch/csrc/lstm_fwd.cu``, with and without residuals) and
K2 (``csrc/lstm_bwd.cu``): their build, what the card offers them, the
route and plan each shape takes, checks against the plain versions, and
their times.

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


# --phases: (file, anchor line, stamp index, loop variable) the stamps go
# before (index < 0: after) the anchor; K1 stamps steps t, K2 products s
STAMPS = (
    ("lstm_fwd.cu", "      if (t > 0 && b0 == 0) grid_wait(bar, (unsigned)t * "
     "gridDim.x);", 0, "t"),
    ("lstm_fwd.cu", "      if (t > 0 && b0 == 0) grid_wait(bar, (unsigned)t * "
     "gridDim.x);", -1, "t"),
    ("lstm_fwd.cu", "      if (wkg < p.wk) store_partial<NPW>(p_s, p.n, p.u, "
     "cu, ng, wkg, acc);", 2, "t"),
    ("lstm_fwd.cu", "      cluster_wait();             // every block's "
     "partials are written", -3, "t"),
    ("lstm_fwd.cu", "      cluster_arrive();           // this block is done "
     "with the partials", 4, "t"),
    ("lstm_fwd.cu", "    if (t + 1 < T) grid_arrive(bar);", -5, "t"),
    ("lstm_bwd.cu", "        if (b0 == 0) grid_wait(bar, (unsigned)s * "
     "gridDim.x);", 0, "s"),
    ("lstm_bwd.cu", "        if (b0 == 0) grid_wait(bar, (unsigned)s * "
     "gridDim.x);", -1, "s"),
    ("lstm_bwd.cu", "        if (wkg < p.wk) store_partial<NPW>(p_s, p.n, "
     "p.u, cu, ng, wkg, acc);", 2, "s"),
    ("lstm_bwd.cu", "        cluster_wait();         // every block's "
     "partials are written", -3, "s"),
    ("lstm_bwd.cu", "        cluster_arrive();       // this block is done "
     "with the partials", 4, "s"),
    ("lstm_bwd.cu", "    if (t >= 0) grid_arrive(bar);", -5, "s"),
)
PHASES = ("wait", "product", "partials to the cluster barrier",
          "gather and cell", "grid arrive")
STAMP_DEF = """
__device__ long long hl_phase[6][1024];
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
        ("      if (wkg >= wk || (wk > 1 && (s * (KS / 16) + kk) % wk != "
         "wkg))", "      if (true)"),),
}


def phases_tree(dst, ablation=()):
    """A copy of this tree's port and chip_smoke.py at ``dst`` with a
    clock64 stamp at each phase boundary of both persistent kernels and
    a C entry point ``hl_lstm_phases`` that reads them back; ``ablation``
    edits csrc/persist.cuh further ((old, new) pairs)."""
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
    for name in ("lstm_fwd.cu", "lstm_bwd.cu"):
        src = (csrc / name).read_text()
        src = src.replace("namespace persist_step {",
                          STAMP_DEF + "\nnamespace persist_step {", 1)
        src += STAMP_READ.replace("hl_lstm_phases",
                                  f"hl_lstm_phases_{name[5:8]}")
        for file, anchor, ph, var in STAMPS:
            if file != name:
                continue
            assert anchor in src, (name, anchor)
            ind = anchor[:len(anchor) - len(anchor.lstrip())]
            guard = "" if "grid_arrive" in anchor else "if (b0 == 0) "
            st = f"{ind}{guard}stamp({abs(ph)}, {var});"
            src = src.replace(anchor, f"{st}\n{anchor}" if ph >= 0 else
                              f"{anchor}\n{st}", 1)
        (csrc / name).write_text(src)
    kp = dst / "haloop_tpu_torch" / "kernels.py"
    k = kp.read_text().replace(
        '"hl_lstm_card": [_I, _P],',
        '"hl_lstm_card": [_I, _P],\n    "hl_lstm_phases_fwd": [_P],\n'
        '    "hl_lstm_phases_bwd": [_P],')
    kp.write_text(k)


def phase_report(tree):
    """Per-step medians of the stamped phases (cycles), K1 and K2 at the
    three timed shapes, block 0 (a full block)."""
    import numpy as np
    import torch
    cs, kernels, lstm, lstm_cuda = load(tree)
    lib = kernels.library()
    dev = torch.device("cuda", 0)
    for T, B, H in TIMED:
        w, xp, h0, c0 = cs.lstm_inputs(torch, dev, T, B, H, torch.bfloat16)
        bargs = bwd_inputs(torch, cs, lstm, T, B, H, w, xp, h0, c0)
        for kind, fn, get in (
                ("K1", lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0),
                 lib.hl_lstm_phases_fwd),
                ("K2", lambda: lstm_cuda.lstm_bwd_cuda(*bargs),
                 lib.hl_lstm_phases_bwd)):
            fn()
            torch.cuda.synchronize()
            buf = np.zeros((6, 1024), np.int64)
            kernels.check(get(buf.ctypes.data), "hl_lstm_phases")
            d = buf[:, 2:min(T, 1024) - 2]   # steps clear of the ends
            cells = [f"{name} {np.median(d[i + 1] - d[i]):.0f}"
                     for i, name in enumerate(PHASES)]
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


def device_ms(torch, fn):
    """The device's busy time in one call of ``fn`` (the union of its
    kernels' spans), from torch.profiler after a traced warm-up call."""
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
    return busy / 1e6


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    ap.add_argument("--phases", action="store_true")
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
        phase_report(a.tree)
        return
    if a.phases:
        print(card, flush=True)
        for i, (label, edits) in enumerate(ABLATIONS.items()):
            print(f"-- {label}", flush=True)
            dst = HERE / "build" / f"lstm_phases{i}"
            phases_tree(dst, edits)
            subprocess.run([sys.executable, __file__, "--tree", str(dst),
                            "--phase-report"], check=True)
        return
    if a.times_only:
        res = times(a.tree)
        if not a.kernels_only:
            res.update(rates(a.tree))
        print(json.dumps(res), flush=True)
        return
    print(card, flush=True)
    if a.against:
        runs = []
        for tree in (a.against, a.tree, a.tree, a.against):
            flags = ["--kernels-only"] if a.kernels_only else []
            r = subprocess.run([sys.executable, __file__, "--tree",
                                str(tree), "--times-only", *flags],
                               capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"{tree}: exit {r.returncode}\n{r.stderr}")
            runs.append((tree, json.loads(r.stdout.splitlines()[-1])))
        for label in runs[0][1]:
            cells = ", ".join(f"{'this' if t == a.tree else 'parent'} "
                              f"{res[label]:.4f}" for t, res in runs)
            unit = "" if label.endswith("/s") else " ms"
            print(f"{label}:{unit} {cells}", flush=True)
        print(json.dumps({"card": card, "runs": [
            {"tree": str(t), "ms": res} for t, res in runs]}), flush=True)
        return
    bad = checks(a.tree)
    for label, ms in times(a.tree).items():
        print(f"{label}: {ms:.4f} ms", flush=True)
    if bad:
        raise SystemExit(f"disagree with the plain versions: {bad}")


if __name__ == "__main__":
    main()
