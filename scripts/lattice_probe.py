#!/usr/bin/env python3
"""The lattice kernels of the PyTorch port on ``csrc/lattice.cuh``'s
skeleton alone on one GPU: the forwards K3 (CTC,
``haloop_tpu_torch/csrc/ctc_fwd.cu``) and K8a (Star-CTC,
``csrc/star_fwd.cu``) and the backwards K4 (CTC, ``csrc/ctc_bwd.cu``) and
K8b (Star-CTC, ``csrc/star_bwd.cu``, both on ``csrc/lattice_bwd.cuh``):
their build, checks against the plain ``ctc_forward_history``,
``star_forward_history``, ``ctc_grad`` and ``star_grad``, and their
times.

    python3 scripts/lattice_probe.py               # checks, then times
    python3 scripts/lattice_probe.py --against DIR # times and rates only:
        # the tree at DIR and this one in turns (DIR, this, this, DIR),
        # each in a process of its own, at the same shapes and inputs
    python3 scripts/lattice_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)
    python3 scripts/lattice_probe.py --variants
        # this tree's plan variants timed in turns: one sweep warp or a
        # warpgroup, 4 or 8 scatter warps, rings of (frames, slots); K8a
        # with 1 or 4 loader warps, 16 sweep warps, a ring of 4 x 2; K3
        # with 4 states a lane over two warps (its plan: 2 over a
        # warpgroup)
    python3 scripts/lattice_probe.py --phases
        # cycles a frame: the kernels built with their clock64 stamps
        # (-DHL_PHASES, into build/haloop_tpu_torch_phases/) in block 0
        # (the backward sweep's lane 0: ring wait, stencil, beta row, edge
        # barrier; the scatter's first thread, a slot's ring wait, rows and
        # loads over its frames; K3's and K8a's sweep lane 0: ring wait,
        # stencil, history row, edge barrier), medians; then again in copies
        # under build/lattice_ablation*/ with the scatter's rows left out
        # (the sweep alone), with the loads left out, and so on
        # (``--only TEXT``: the ablations whose name holds it)

``--kernels-only`` (with --against or --times-only) leaves the rates out.
DIR is another checkout of the repository (``git archive`` of a commit
unpacked into a directory that .gitignore lists); each tree builds its
own kernels into its own ``build/``. Shapes and inputs are
``chip_smoke.py``'s (phases 3, 6 and 9): lstm:512's train lattices, K3
and K4 at (T'=385, N=48, C=512, U=96), K8a and K8b at (385, 48, 2V=1024,
U=96); K3 also at S' = 2049 and 4095 (``CTC_LONG``), K8a at
``chip_smoke.STAR_LONG``'s S = 1027 and 4091 (N=5). Times are
CUDA events around one call behind a spin (``chip_smoke.cuda_ms``),
median of 5, the card's name and power limit printed first: the kernel,
its plain version, ``F.ctc_loss``'s backward beside K4 (no PyTorch call
computes K8a's or K8b's function), the bound, and the kernel's cycles a
frame of the longest item at the card's maximum SM clock. Rates:
lstm:512 CTC train and serving and Star-CTC train
utterances/s at 48 x 12 s (``chip_smoke.host_ms``) and each step's
device time from torch.profiler. Needs one card; imports nothing of JAX.
"""

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def load(tree):
    sys.path.insert(0, str(tree))
    import chip_smoke
    from haloop_tpu_torch import kernels
    from haloop_tpu_torch.ops import ctc, ctc_cuda, star, star_cuda
    assert Path(chip_smoke.__file__).resolve().parent == tree.resolve()
    return chip_smoke, kernels, (ctc, ctc_cuda, star, star_cuda)


@contextlib.contextmanager
def patched(**attrs):
    """Module attributes set for a block (a plan variant): those of
    ``ops.lattice_cuda`` (SWEEP_WARPS, RINGS, the scatter_warps rule,
    FWD_SWEEP_WARPS or LOADER_WARPS) and ``ops.ctc_cuda``'s
    FWD_MIN_PER_LANE, the plan caches cleared on the way in and out."""
    from haloop_tpu_torch.ops import ctc_cuda, lattice_cuda
    mods = {k: ctc_cuda if k == "FWD_MIN_PER_LANE" else lattice_cuda
            for k in attrs}
    old = {k: getattr(mods[k], k) for k in attrs}
    caches = [getattr(lattice_cuda, f) for f in ("plan", "forward_plan")
              if hasattr(lattice_cuda, f)]
    for k, v in attrs.items():
        setattr(mods[k], k, v)
    for c in caches:
        c.cache_clear()
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mods[k], k, v)
        for c in caches:
            c.cache_clear()


def ptxas_lines(log):
    """ptxas's report of the lattice kernels' entry functions."""
    out, keep = [], 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if ("ctc_" in line or "star_" in line) else 0
        if keep:
            if "registers" in line or "spill" in line or "entry" in line:
                out.append(line.strip()[:150])
            keep -= 1
    return out


def lattices(torch, cs, ops):
    """The train shapes' lattices as chip_smoke phases 6 and 9 draw them:
    {name: (kernel call, plain call, frames)}, each call a closure."""
    ctc, ctc_cuda, star, star_cuda = ops
    dev = torch.device("cuda", 0)
    args, _ = cs.ctc_inputs(torch, dev)
    lp, targets, il, tl = args
    T, N, C = lp.shape
    S = 2 * targets.shape[1] + 1
    hist = torch.empty((N, T, S), device=dev)
    loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    g = torch.rand(N, generator=torch.Generator().manual_seed(5)).to(dev) \
        + 0.5
    cargs = (*args, hist, loss, g)
    star_lp, star_targets, sil, stl, *_ = cs.star_inputs(torch, dev)
    sargs = (star_lp, star_targets, sil, stl)
    shist = torch.empty((N, T, 2 * star_targets.shape[1] + 1), device=dev)
    sloss = star_cuda.star_fwd_cuda(*sargs, cs.STAR_PENALTY, history=shist)
    bargs = (*sargs, shist, sloss, g, cs.STAR_PENALTY)
    out = {"K4": (cargs, ctc_cuda.ctc_bwd_cuda, ctc.ctc_grad, il),
           "K8b": (bargs, star_cuda.star_bwd_cuda, star.star_grad, sil),
           "K3 history": (args, lambda *a: ctc_cuda.ctc_fwd_cuda(
               *a, history=hist), ctc.ctc_forward_history, il),
           "K3": (args, ctc_cuda.ctc_fwd_cuda, None, il),
           "K8a history": (sargs, lambda *a: star_cuda.star_fwd_cuda(
               *a, cs.STAR_PENALTY, history=shist), fwd_plain(star, cs),
               sil),
           "K8a": (sargs, lambda *a: star_cuda.star_fwd_cuda(
               *a, cs.STAR_PENALTY), None, sil)}
    for T, N, V, U, seed in STAR_LONG:
        raw, tg, lil, ltl = cs.long_lattice_inputs(torch, dev, T, N, V, U,
                                                   seed)
        largs = (*star.intersperse_stars(raw, tg), lil, ltl)
        lhist = torch.empty((N, T, 4 * U + 3), device=dev)
        out[f"K8a history S={4 * U + 3}"] = (
            largs, lambda *a, h=lhist: star_cuda.star_fwd_cuda(
                *a, cs.STAR_PENALTY, history=h), fwd_plain(star, cs), lil)
    for T, N, C, U, seed in CTC_LONG:
        largs = cs.long_lattice_inputs(torch, dev, T, N, C, U, seed)
        lhist = torch.empty((N, T, 2 * U + 1), device=dev)
        out[f"K3 history S'={2 * U + 1}"] = (
            largs, lambda *a, h=lhist: ctc_cuda.ctc_fwd_cuda(*a, history=h),
            ctc.ctc_forward_history, largs[2])
    return out


# K8a's long lattices (chip_smoke.STAR_LONG at this tree): S = 1027, 4091
STAR_LONG = ((700, 5, 20, 256, 1), (2300, 5, 20, 1022, 2))
# K3's (T, N, C, U, seed): S' = 2049 (chip_smoke's long-lattice phase) and
# 4095, the longest K3 takes
CTC_LONG = ((2100, 3, 40, 1024, 11), (4200, 5, 40, 2047, 13))


def fwd_plain(star, cs):
    """K8a's plain version with the history: (loss, history)."""
    return lambda *a: star.star_forward_history(*a, cs.STAR_PENALTY)


def checks(tree):
    """K4 and K8b at the train shapes against their plain versions within
    CTC_GRAD_TOL, the same bits twice, one launch a call; the
    long lattices of chip_smoke's R3 phase. -> the labels that failed."""
    import torch
    cs, kernels, ops = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    _, ctc_cuda, _, star_cuda = ops
    bad = []
    for name, (args, kernel, plain, _) in lattices(torch, cs, ops).items():
        if plain is None:
            continue
        if name.startswith(("K8a", "K3")):
            T, N = args[0].shape[:2]
            S = args[1].shape[1] * 2 + 1     # 4U+3 from 2U+1; 2U+1 from U
            if name.startswith("K8a"):
                tol, htol = cs.STAR_TOL, cs.STAR_HIST_TOL
                fwd = lambda **k: star_cuda.star_fwd_cuda(
                    *args, cs.STAR_PENALTY, **k)
            else:
                tol, htol = cs.CTC_TOL, cs.CTC_HIST_TOL
                fwd = lambda **k: ctc_cuda.ctc_fwd_cuda(*args, **k)
            hist = torch.empty((N, T, S), device=args[0].device)
            loss = fwd(history=hist)
            loss_e, hist_e = plain(*args)
            ok = cs.close(loss, loss_e, tol)[0] and \
                cs.close(hist, hist_e, htol)[0]
            hist2 = torch.empty_like(hist)
            same = torch.equal(loss, fwd(history=hist2)) and \
                torch.equal(hist, hist2) and torch.equal(loss, fwd())
            print(f"{'ok ' if ok and same else 'BAD'} {name}: max|dloss| "
                  f"{(loss - loss_e).abs().max().item():.3e}, max|dhist| "
                  f"{(hist - hist_e).abs().max().item():.3e}; same bits "
                  f"twice {same}", flush=True)
            if not (ok and same):
                bad.append(name)
            continue
        mod = ctc_cuda if name == "K4" else star_cuda
        n0 = mod.bwd_launches
        got = kernel(*args)
        torch.cuda.synchronize()
        once = mod.bwd_launches == n0 + 1
        want = plain(*args)
        err = (got - want).abs()
        ok = bool((err <= cs.CTC_GRAD_TOL + cs.CTC_GRAD_TOL *
                   want.abs()).all())
        same = torch.equal(got, kernel(*args))
        print(f"{'ok ' if ok and same and once else 'BAD'} {name}: "
              f"max|d| {err.max().item():.3e}; same bits twice {same}; "
              f"one launch {once}", flush=True)
        if not (ok and same and once):
            bad.append(name)
    try:
        print(f"long lattices: {cs.phase_long_lattice(torch, 'cuda')}",
              flush=True)
    except RuntimeError as e:
        print(f"BAD long lattices: {e}", flush=True)
        bad.append("long lattices")
    return bad


def times(tree, variants=()):
    """Per lattice: the kernel's time (and each plan variant's, where the
    tree takes them), the plain version's, the library's, the bound and
    cycles a frame."""
    import torch
    cs, kernels, ops = load(tree)
    kernels.library()
    res = {}
    for name, (args, kernel, plain, il) in lattices(torch, cs, ops).items():
        ms = cs.cuda_ms(lambda: kernel(*args))
        res[f"{name} ms"] = ms
        res[f"{name} cycles a frame"] = cs.cycles_a_frame(
            ms, il, args[0].shape[0])[0]
        for label, attrs in variants:
            if family(label) != family(name):
                continue
            try:
                with patched(**attrs):
                    res[f"{name} {label} ms"] = cs.cuda_ms(
                        lambda: kernel(*args))
            except ValueError:          # no plan of the variant fits
                res[f"{name} {label} ms"] = None
        if plain is not None:
            res[f"{name} plain ms"] = cs.cuda_ms(lambda: plain(*args))
    lp, targets, il, tl, hist, loss, g = lattices(torch, cs, ops)["K4"][0]
    lpg = lp.clone().requires_grad_(True)
    ref = torch.nn.functional.ctc_loss(lpg, targets, il, tl,
                                       reduction="none")
    res["F.ctc_loss backward ms"] = cs.cuda_ms(
        lambda: torch.autograd.grad(ref, lpg, g, retain_graph=True))
    T, N, C = lp.shape
    U = targets.shape[1]
    res["K4 bound ms"] = cs.k4_bound(il, N, T, 2 * U + 1, U, C)[0]
    return res


def family(label):
    """The kernel a lattice or a variant belongs to: K3, K8a or the
    backwards."""
    return next((k for k in ("K3", "K8a") if label.startswith(k)), "bwd")


def rates(tree):
    """lstm:512 CTC and Star-CTC train utterances/s at 48 x 12 s (median
    of 5 steps that end in a host read) and each step's device time; CTC
    serving (the eval forward and decode, results on the host) the
    same."""
    import torch
    cs, kernels, _ = load(tree)
    kernels.library()
    sys.path.insert(0, str(HERE / "scripts"))
    import lstm_probe
    dev = torch.device("cuda", 0)
    out = {}
    for label, flags in (("CTC", ()),
                         ("Star-CTC", ("--star-penalty",
                                       str(cs.STAR_PENALTY)))):
        system = cs.make_system(torch, dev, "--arch", "lstm:512", *flags)
        _, batch = cs.eval_batch(system)

        def step():
            system.train_step(*batch)
        ms, _ = cs.host_ms(torch, step)
        out[f"lstm:512 {label} train utt/s"] = 48 / ms * 1e3
        out[f"lstm:512 {label} train step device ms"] = \
            lstm_probe.device_ms(torch, step)
        if label == "CTC":
            def serve():
                with torch.inference_mode():
                    _, feats, lens, _ = system._forward_impl(*batch,
                                                             train=False)
                    res = system._decode_impl(feats, lens, train=False)
                    return [t.cpu() for t in res]
            ms, _ = cs.host_ms(torch, serve)
            out["lstm:512 CTC serving utt/s"] = 48 / ms * 1e3
            out["lstm:512 CTC serving device ms"] = \
                lstm_probe.device_ms(torch, serve)
        del system
        torch.cuda.empty_cache()
    return out


# --phases: the kernels built with their phase stamps (kernels.trace_phases:
# block 0's frames; the backward sweep's lane 0: ring wait, stencil, beta
# row, edge barrier; the scatter's first thread, a slot's ring wait, class
# sums, refill and copy-out; K3's and K8a's sweep lane 0: ring wait,
# stencil, history row, edge barrier), then again in copies with the (old, new) text
# edits of an ablation to the lattice headers
FWD_PHASES = ("ring wait", "stencil", "history row", "edge barrier")
# sweep: a frame's share of the slot's ring wait, then per frame; scatter:
# group 0's slots (every other one), over the frames of two slots: its
# share of a frame's throughput
PHASES = ("ring wait", "stencil", "beta row", "edge barrier",
          "scatter: ring wait", "scatter: sums", "scatter: refill",
          "scatter: copy-out")
ABLATIONS = {
    "as is": (),
    "without the scatter's rows": (
        ("    for (int k = gt; k < n_short; k += nsg) {",
         "    for (int k = n_short; k < n_short; k += nsg) {"),
        ("    for (int k = warp; k < n_long; k += wg) {",
         "    for (int k = n_long; k < n_long; k += wg) {"),
        ("    if (!L.dense) {\n      for (int c = gt; c < L.C; c += nsg) {",
         "    if (true) {\n      for (int c = L.C; c < L.C; c += nsg) {")),
    "without the loads": (
        ("          cp_async4(al + (size_t)f * L.slot + a, h - (size_t)f * L.S);\n"
         "          cp_async4(em + (size_t)f * L.slot + a, e - (size_t)f * "
         "em_step);\n", ""),),
    "busy waits": (
        ("        \"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\\n\"",
         "        \"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n\""),),
    "rows without the long classes": (
        ("    for (int k = warp; k < n_long; k += wg) {",
         "    for (int k = n_long; k < n_long; k += wg) {"),),
    "forwards without the edge exchange": (
        ("        if (w > 0 && i > 0) {   // the previous warp's word",
         "        if (false) {   // the previous warp's word"),
        ("      if (!fwd_tagged(K) && L.sweep > 1 && i + 1 < len) {",
         "      if (false) {"),),
    "forwards without the ring waits": (
        ("    fwd_enter(L, sm, b);\n", ""),),
    "forwards without the shuffle": (
        ("      const float up = __shfl_up_sync(0xffffffffu, a[K - 1], 1);",
         "      const float up = a[K - 1];"),),
    "forwards with K3's stencil of maxima": (
        ("        v[j] = lse2(x[j], l1, e[j]);",
         "        v[j] = fmaxf(x[j], l1) + e[j];"),
        ("        v[j] = lse3(x[j], l1, l2 + ((skip >> j) & 1 ? 0.f : NEG), "
         "e[j]);",
         "        v[j] = fmaxf(fmaxf(x[j], l1), l2 + ((skip >> j) & 1 ? 0.f "
         ": NEG)) + e[j];")),
}


def ablation_tree(dst, ablation):
    """A copy of this tree's port and chip_smoke.py at ``dst`` with the
    (old, new) edits of ``ablation`` to the lattice sources (whichever of
    lattice_bwd.cuh, lattice.cuh and ctc_fwd.cu holds the old text
    once)."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(HERE / "haloop_tpu_torch", dst / "haloop_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dst / "chip_smoke.py")
    csrc = dst / "haloop_tpu_torch" / "csrc"
    srcs = {n: (csrc / n).read_text() for n in ("lattice_bwd.cuh",
                                                 "lattice.cuh", "ctc_fwd.cu")}
    for old, new in ablation:
        (n,) = [n for n, h in srcs.items() if h.count(old) == 1]
        srcs[n] = srcs[n].replace(old, new)
    for n, h in srcs.items():
        (csrc / n).write_text(h)


def phase_report(tree):
    """Medians over block 0's frames (the first and last 8 left out) of
    each stamped phase, and the kernel's time, for K4 and K8b."""
    import numpy as np
    import torch
    cs, kernels, ops = load(tree)
    kernels.trace_phases()
    lib = kernels.library()
    cases = lattices(torch, cs, ops)
    _, ctc_cuda, _, star_cuda = ops
    shape = (kernels.PHASES, kernels.PHASE_ITEMS)
    plans = {"K4": ctc_cuda.plan(193, 512), "K8b": star_cuda.plan(387, 1024)}
    for name, fn in (("K4", lib.hl_ctc_bwd_phases),
                     ("K8b", lib.hl_star_bwd_phases)):
        args, kernel, _, il = cases[name]
        kernel(*args)
        torch.cuda.synchronize()
        buf = np.zeros(shape, np.int64)
        kernels.check(fn(buf.ctypes.data), "phases")
        frames = min(int(il[0]), kernels.PHASE_ITEMS)
        F = plans[name].frames
        sw = buf[:4, 8:frames - 8]
        sc = buf[4:, 1:frames // (2 * F) - 1] / (2 * F)
        cells = [f"{ph} {np.median(sw[i]):.0f}" for i, ph in
                 enumerate(PHASES[1:4], 1)] + [
            f"ring wait (mean) {sw[0].mean():.0f}"] + [
            f"{ph} {np.median(sc[i]):.0f}" for i, ph in
            enumerate(PHASES[4:])]
        print(f"{name}: cycles a frame, sweep {np.median(sw[1:].sum(0)) + sw[0].mean():.0f} "
              f"(ring waits once a slot of {F} frames), scatter "
              f"{np.median(sc.sum(0)):.0f} ({frames} frames in block 0); " +
              ", ".join(cells), flush=True)
        ms = cs.cuda_ms(lambda: kernel(*args))
        print(f"{name}: {ms:.4f} ms", flush=True)
    for name, fn, p in (("K3", lib.hl_ctc_fwd_phases,
                         ctc_cuda.fwd_plan(193, 512)),
                        ("K8a", lib.hl_star_fwd_phases,
                         star_cuda.fwd_plan(387, 1024))):
        args, kernel, _, il = cases[f"{name} history"]
        kernel(*args)
        torch.cuda.synchronize()
        buf = np.zeros(shape, np.int64)
        kernels.check(fn(buf.ctypes.data), "phases")
        frames = min(int(il[0]), kernels.PHASE_ITEMS)
        sw = buf[:len(FWD_PHASES), 8:frames - 8]
        print(f"{name} with history, plan {tuple(p)}: cycles a frame, sweep "
              f"{np.median(sw[1:].sum(0)) + sw[0].mean():.0f} (ring waits "
              f"once a slot of {p.frames} frames; {frames} frames in block "
              f"0); " +
              ", ".join([f"{ph} {np.median(sw[i]):.0f}" for i, ph in
                         enumerate(FWD_PHASES[1:], 1)] +
                        [f"ring wait (mean) {sw[0].mean():.0f}"]),
              flush=True)
        args0, kernel0 = cases[name][:2]
        print(f"{name} with history: "
              f"{cs.cuda_ms(lambda: kernel(*args)):.4f} ms, without: "
              f"{cs.cuda_ms(lambda: kernel0(*args0)):.4f} ms", flush=True)


VARIANTS = (("one sweep warp", dict(SWEEP_WARPS=1)),
            ("8 scatter warps", dict(scatter_warps=lambda C, K: 8)),
            ("4 scatter warps", dict(scatter_warps=lambda C, K: 4)),
            ("ring 4 x 2", dict(RINGS=((4, 2),))),
            ("ring 2 x 2", dict(RINGS=((2, 2),))),
            ("ring 1 x 2", dict(RINGS=((1, 2),))),
            ("K8a 1 loader warp", dict(LOADER_WARPS=1)),
            ("K8a 4 loader warps", dict(LOADER_WARPS=4)),
            ("K8a 16 sweep warps", dict(FWD_SWEEP_WARPS=16)),
            ("K8a ring 4 x 2", dict(RINGS=((4, 2),))),
            ("K3 4 states a lane", dict(FWD_MIN_PER_LANE=4)),
            ("K3 8 states a lane", dict(FWD_MIN_PER_LANE=8)),
            ("K3 4 loader warps", dict(LOADER_WARPS=4)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--only", default="",
                    help="with --phases: the ablations whose name holds it")
    ap.add_argument("--phase-report", action="store_true",
                    help=argparse.SUPPRESS)     # one --phases tree
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
    if a.times_only:
        res = times(a.tree)
        if not a.kernels_only:
            res.update(rates(a.tree))
        print(json.dumps(res), flush=True)
        return
    print(card, flush=True)
    if a.phases:
        for i, (label, edits) in enumerate(ABLATIONS.items()):
            if edits and a.only not in label:
                continue
            dst = HERE
            if edits:
                dst = HERE / "build" / f"lattice_ablation{i}"
                ablation_tree(dst, edits)
            print(f"--- {label}", flush=True)
            r = subprocess.run([sys.executable, __file__, "--tree", str(dst),
                                "--phase-report"], capture_output=True,
                               text=True)
            print(r.stdout, end="", flush=True)
            if r.returncode:
                raise SystemExit(f"{dst}: exit {r.returncode}\n{r.stderr}")
        return
    if a.variants:
        for rnd in range(2):
            for label, ms in times(a.tree, VARIANTS).items():
                print(f"round {rnd} {label}: {ms}", flush=True)
        return
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
        for label in runs[1][1]:
            cells = ", ".join(
                f"{'this' if t == a.tree else 'other'} "
                f"{res[label] if res.get(label) is None else round(res[label], 4)}"
                for t, res in runs if label in res)
            print(f"{label}: {cells}", flush=True)
        print(json.dumps({"card": card, "runs": [
            {"tree": str(t), "ms": res} for t, res in runs]}), flush=True)
        return
    bad = checks(a.tree)
    for label, ms in times(a.tree).items():
        print(f"{label}: {ms}", flush=True)
    if bad:
        raise SystemExit(f"disagree with the plain versions: {bad}")


if __name__ == "__main__":
    main()
