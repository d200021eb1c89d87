#!/usr/bin/env python3
"""The lattice kernels of the PyTorch port on ``csrc/lattice.cuh``'s
skeleton alone on one GPU: the forward K8a (Star-CTC,
``haloop_tpu_torch/csrc/star_fwd.cu``) and the backwards K4 (CTC,
``csrc/ctc_bwd.cu``) and K8b (Star-CTC, ``csrc/star_bwd.cu``, both on
``csrc/lattice_bwd.cuh``): their build, checks against the plain
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
        # with 1 or 4 loader warps, 16 sweep warps, a ring of 4 x 2
    python3 scripts/lattice_probe.py --phases
        # cycles a frame: the kernels built with their clock64 stamps
        # (-DHL_PHASES, into build/haloop_tpu_torch_phases/) in block 0
        # (the backward sweep's lane 0: ring wait, stencil, beta row, edge
        # barrier; the scatter's first thread, a slot's ring wait, rows and
        # loads over its frames; K8a's sweep lane 0: ring wait, stencil,
        # history row, edge barrier), medians; then again in copies under
        # build/lattice_ablation*/ with the scatter's rows left out (the
        # sweep alone), with the loads left out, and so on

``--kernels-only`` (with --against or --times-only) leaves the rates out.
DIR is another checkout of the repository (``git archive`` of a commit
unpacked into a directory that .gitignore lists); each tree builds its
own kernels into its own ``build/``. Shapes and inputs are
``chip_smoke.py``'s (phases 6 and 9): lstm:512's train lattices, K4 at
(T'=385, N=48, C=512, U=96), K8a and K8b at (385, 48, 2V=1024, U=96);
K8a also at ``chip_smoke.STAR_LONG``'s S = 1027 and 4091 (N=5). Times are
CUDA events around one call behind a spin (``chip_smoke.cuda_ms``),
median of 5, the card's name and power limit printed first: the kernel,
its plain version, ``F.ctc_loss``'s backward beside K4 (no PyTorch call
computes K8a's or K8b's function), the bound, and the kernel's cycles a
frame of the longest item at the card's maximum SM clock. K3 with its
history is timed too. Rates: lstm:512 CTC and Star-CTC train
utterances/s at 48 x 12 s (``chip_smoke.host_ms``) and each train step's
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
    """``ops.lattice_cuda``'s module attributes set for a block (a plan
    variant: SWEEP_WARPS, RINGS, the scatter_warps rule, FWD_SWEEP_WARPS
    or LOADER_WARPS), the plan caches cleared on the way in and out."""
    from haloop_tpu_torch.ops import lattice_cuda
    old = {k: getattr(lattice_cuda, k) for k in attrs}
    caches = [getattr(lattice_cuda, f) for f in ("plan", "forward_plan")
              if hasattr(lattice_cuda, f)]
    for k, v in attrs.items():
        setattr(lattice_cuda, k, v)
    for c in caches:
        c.cache_clear()
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(lattice_cuda, k, v)
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
               *a, history=hist), None, il),
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
    return out


# K8a's long lattices (chip_smoke.STAR_LONG at this tree): S = 1027, 4091
STAR_LONG = ((700, 5, 20, 256, 1), (2300, 5, 20, 1022, 2))


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
        if name.startswith("K8a"):
            T, N = args[0].shape[:2]
            hist = torch.empty((N, T, args[1].shape[1] * 2 + 1),
                               device=args[0].device)
            loss = star_cuda.star_fwd_cuda(*args, cs.STAR_PENALTY,
                                           history=hist)
            loss_e, hist_e = plain(*args)
            ok = cs.close(loss, loss_e, cs.STAR_TOL)[0] and \
                cs.close(hist, hist_e, cs.STAR_HIST_TOL)[0]
            same = torch.equal(loss, star_cuda.star_fwd_cuda(
                *args, cs.STAR_PENALTY, history=hist))
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
        if plain is None:
            continue
        res[f"{name} cycles a frame"] = cs.cycles_a_frame(
            ms, il, args[0].shape[0])[0] if hasattr(cs, "cycles_a_frame") \
            else None
        for label, attrs in variants:
            if label.startswith("K8a") != name.startswith("K8a"):
                continue
            with patched(**attrs):
                res[f"{name} {label} ms"] = cs.cuda_ms(lambda: kernel(*args))
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


def rates(tree):
    """lstm:512 CTC and Star-CTC train utterances/s at 48 x 12 s (median
    of 5 steps that end in a host read) and each step's device time."""
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
        del system
        torch.cuda.empty_cache()
    return out


# --phases: the kernels built with their phase stamps (kernels.trace_phases:
# block 0's frames; the backward sweep's lane 0: ring wait, stencil, beta
# row, edge barrier; the scatter's first thread, a slot's ring wait, class
# sums, refill and copy-out; K8a's sweep lane 0: ring wait, stencil,
# history row, edge barrier), then again in copies with the (old, new) text
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
}


def ablation_tree(dst, ablation):
    """A copy of this tree's port and chip_smoke.py at ``dst`` with the
    (old, new) edits of ``ablation`` to lattice_bwd.cuh or lattice.cuh
    (whichever holds the old text once)."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(HERE / "haloop_tpu_torch", dst / "haloop_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dst / "chip_smoke.py")
    csrc = dst / "haloop_tpu_torch" / "csrc"
    hdrs = {n: (csrc / n).read_text() for n in ("lattice_bwd.cuh",
                                                 "lattice.cuh")}
    for old, new in ablation:
        (n,) = [n for n, h in hdrs.items() if h.count(old) == 1]
        hdrs[n] = hdrs[n].replace(old, new)
    for n, h in hdrs.items():
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
    args, kernel, _, il = cases["K8a history"]
    kernel(*args)
    torch.cuda.synchronize()
    buf = np.zeros(shape, np.int64)
    kernels.check(lib.hl_star_fwd_phases(buf.ctypes.data), "phases")
    frames = min(int(il[0]), kernels.PHASE_ITEMS)
    F = ops[3].fwd_plan(387, 1024).frames
    sw = buf[:len(FWD_PHASES), 8:frames - 8]
    print(f"K8a with history: cycles a frame, sweep "
          f"{np.median(sw[1:].sum(0)) + sw[0].mean():.0f} (ring waits once "
          f"a slot of {F} frames; {frames} frames in block 0); " +
          ", ".join([f"{ph} {np.median(sw[i]):.0f}" for i, ph in
                     enumerate(FWD_PHASES[1:], 1)] +
                    [f"ring wait (mean) {sw[0].mean():.0f}"]), flush=True)
    print(f"K8a with history: {cs.cuda_ms(lambda: kernel(*args)):.4f} ms",
          flush=True)


VARIANTS = (("one sweep warp", dict(SWEEP_WARPS=1)),
            ("8 scatter warps", dict(scatter_warps=lambda C, K: 8)),
            ("4 scatter warps", dict(scatter_warps=lambda C, K: 4)),
            ("ring 4 x 2", dict(RINGS=((4, 2),))),
            ("ring 2 x 2", dict(RINGS=((2, 2),))),
            ("ring 1 x 2", dict(RINGS=((1, 2),))),
            ("K8a 1 loader warp", dict(LOADER_WARPS=1)),
            ("K8a 4 loader warps", dict(LOADER_WARPS=4)),
            ("K8a 16 sweep warps", dict(FWD_SWEEP_WARPS=16)),
            ("K8a ring 4 x 2", dict(RINGS=((4, 2),))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--phases", action="store_true")
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
