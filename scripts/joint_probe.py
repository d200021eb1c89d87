#!/usr/bin/env python3
"""The RNN-T joint's logsumexp kernels K9a and K9b of the PyTorch port
(``haloop_tpu_torch/csrc/joint_lse.cu``, ``joint_lse_bwd.cu``) alone on
one GPU: their build, checks against the plain factored ``pairwise_lse``
and ``pairwise_lse_grad`` (K9a also against the materialized joint), and
their times.

    python3 scripts/joint_probe.py               # checks, then times
    python3 scripts/joint_probe.py --against DIR # times and rates only:
        # the tree at DIR and this one in turns (DIR, this, this, DIR),
        # each in a process of its own, at the same shapes and inputs
    python3 scripts/joint_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)
    python3 scripts/joint_probe.py --same-lse DIR
        # K9a's lse from the tree at DIR and from this one on every input,
        # compared bit for bit
    python3 scripts/joint_probe.py --phases [--only TEXT]
        # K9b built with its phase stamps (-DHL_PHASES, into
        # build/haloop_tpu_torch_phases/): each block's cycles of set-up,
        # frames and the rows' merge, and its time, as is and in copies under
        # build/joint_ablation*/ with parts of it left out (ABLATIONS)

``--kernels-only`` (with --against or --times-only) leaves the rates out.
DIR is another checkout of the repository (``git archive`` of a commit
unpacked into a directory that .gitignore lists); each tree builds its
own kernels into its own ``build/``. Inputs are ``chip_smoke.py``'s
(phase 8, ``joint_inputs``): rnn-transducer:lstm:512's joint (N=16,
T'=301, U+1=25, V=512), the same with V = 16384 (``JOINT_V16K``), the
disjoint peaks (the fix-ups taken at 16 cells), every cell marked (the
fix-ups' cost) and U+1 = 2049 at (4, 301, 2049, 512) (``JOINT_U2049``); a
tree whose kernel refuses a shape reads null there. Times are CUDA events
around one call behind a spin (``chip_smoke.cuda_ms``), median of 5, the
card's name and power limit printed first: each kernel, and where no cell
is marked its plain version and its bound (``chip_smoke.k9a_bound``,
``k9b_bound``: computed here, so an older tree reads the same bounds),
K9a's ``torch.logsumexp`` of the materialized joint, and at V = 512 the
autograd backward of that (K9b's library call). Rates:
rnn-transducer:lstm:512 train and eval utterances/s at batch 16
(``chip_smoke.host_ms``), each call's device time and busy share from
torch.profiler, and the peak memory of one rnn-transducer:lstm:16384
train step at batch 4. Needs one card; imports nothing of JAX.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHAPE = (16, 301, 25, 512)


def load(tree):
    sys.path.insert(0, str(tree))
    import chip_smoke
    from haloop_tpu_torch import kernels
    from haloop_tpu_torch.ops import joint, joint_cuda
    assert Path(chip_smoke.__file__).resolve().parent == tree.resolve()
    return chip_smoke, kernels, joint, joint_cuda


def inputs(torch, cs):
    """{label: (f, g, dlse)} at phase 8's shapes and seeds, drawn as
    ``chip_smoke.joint_inputs`` draws them (a copy here: an older tree's
    chip_smoke has no such function, and --against times both trees on
    the same inputs)."""
    dev = torch.device("cuda", 0)
    out = {}
    for label, shape, peaks, seed in (
            ("V=512", SHAPE, None, 9),
            ("V=16384", (16, 301, 25, 16384), None, 10),
            ("disjoint peaks", SHAPE, "disjoint", 11),
            ("every cell marked", SHAPE, "every", 12),
            ("U+1=2049", (4, 301, 2049, 512), None, 13)):
        gen = torch.Generator().manual_seed(seed)
        N, T, U1, V = shape
        scale = 3.0 if peaks is None else 1.0
        f = torch.randn((N, T, V), generator=gen) * scale
        g = torch.randn((N, U1, V), generator=gen) * scale
        if peaks == "disjoint":
            f[:, 7, 3], g[:, 2, V - 5] = 100.0, 100.0
        elif peaks == "every":
            f[..., 0], g[..., 1] = 200.0, 200.0
        lens = torch.randint(T // 2, T + 1, (N,), generator=gen)
        dlse = torch.randn((N, T, U1), generator=gen)
        dlse[torch.arange(T)[None, :] >= lens[:, None]] = 0.0
        out[label] = (f.to(dev), g.to(dev), dlse.to(dev))
    return out


def ptxas_lines(log):
    """ptxas's report of K9a's entry functions."""
    out, keep = [], 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if "joint_lse" in line else 0
        if keep:
            if "registers" in line or "spill" in line or "entry" in line:
                out.append(line.strip()[:150])
            keep -= 1
    return out


def checks(tree):
    """K9a at every input against the plain version and the materialized
    joint within JOINT_TOL, its row maxima exact; K9b against the plain
    version within ``chip_smoke.k9b_tols`` (df, dg) and, on the inputs
    without marked cells, the fp64 form within ``k9b_exact``'s limits (the
    only check of a sum past 301 rows), df exactly 0 on
    rows with dlse = 0; each one launch a call and the same bits twice,
    the marked cells the plain versions mark. -> the labels that
    failed."""
    import torch
    cs, kernels, joint, joint_cuda = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    bad = []
    for label, (f, g, dlse) in inputs(torch, cs).items():
        n0, b0 = joint_cuda.launches, joint_cuda.bwd_launches
        lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
        df, dg = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
        torch.cuda.synchronize()
        once = (joint_cuda.launches, joint_cuda.bwd_launches) == \
            (n0 + 1, b0 + 1)
        ok, err = cs.close(lse, joint.pairwise_lse(f, g)[0], cs.JOINT_TOL)
        ok_r, err_r = cs.close(lse, joint.pairwise_lse_reference(f, g),
                               cs.JOINT_TOL)
        maxima = torch.equal(mf, f.amax(-1)) and torch.equal(mg, g.amax(-1))
        want = joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg)
        tol_f, tol_g = cs.k9b_tols(f.shape[1], g.shape[1])
        ok_f, err_f = cs.close(df, want[0], tol_f or cs.JOINT_TOL)
        ok_g, err_g = cs.close(dg, want[1], tol_g or cs.JOINT_DG_TOL)
        ok_f, ok_g = ok_f or tol_f is None, ok_g or tol_g is None
        ok_x = True               # the fp64 bound, where no cell is marked
        if not bmarked_any(joint, lse, dlse, mf, mg):
            exact, limits, _ = cs.k9b_exact(joint, f, g, lse, dlse, mf, mg)
            ok_x = all(cs.within_limit(d, w, lim)[0]
                       for d, w, lim in zip((df, dg), exact, limits))
            del exact, limits
        zero = not df[~dlse.any(dim=2)].any()
        df2, dg2 = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
        same = torch.equal(lse, joint_cuda.lse_fwd_cuda(f, g)[0]) and \
            torch.equal(df, df2) and torch.equal(dg, dg2)
        marked = int(joint.marks(f, g).sum())
        bmarked = int(joint.grad_marks(lse, dlse, mf, mg).sum())
        good = ok and ok_r and maxima and ok_f and ok_g and ok_x and zero \
            and same and once
        print(f"{'ok ' if good else 'BAD'} K9a/K9b {label}: max|dlse| "
              f"{err:.3e} (materialized joint {err_r:.3e}), row maxima "
              f"exact {maxima}; max|ddf| {err_f:.3e} max|ddg| {err_g:.3e}, "
              f"within the fp64 bound {ok_x}, "
              f"df 0 where dlse is {zero}; {marked} / {bmarked} marked "
              f"cells; one launch {once}; same bits twice {same}",
              flush=True)
        if not good:
            bad.append(label)
    return bad


def bmarked_any(joint, lse, dlse, mf, mg):
    return bool(joint.grad_marks(lse, dlse, mf, mg).any())


def bwd_call(joint, joint_cuda, f, g, dlse):
    """A call of the tree's K9b on its forward's outputs: with the row
    maxima where its K9a writes them (``bwd_plan``), else lse alone."""
    if hasattr(joint_cuda, "bwd_plan"):
        lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
        return lambda: joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
    lse = joint.pairwise_lse(f, g)
    return lambda: joint_cuda.lse_bwd_cuda(f, g, lse, dlse)


def times(tree):
    """Per input: K9a's and K9b's times (null where the tree's kernel
    refuses the shape), and for the unmarked ones the plain versions',
    the libraries' (K9b's at V=512) and the bounds."""
    import torch
    cs, kernels, joint, joint_cuda = load(tree)
    kernels.library()
    res = {}
    for label, (f, g, dlse) in inputs(torch, cs).items():
        calls = {"K9a": lambda: joint_cuda.lse_fwd_cuda(f, g),
                 "K9b": bwd_call(joint, joint_cuda, f, g, dlse)}
        for name, fn in calls.items():
            try:
                res[f"{name} {label} ms"] = cs.cuda_ms(fn)
            except ValueError as e:
                print(f"{name} {label}: {e}", file=sys.stderr, flush=True)
                res[f"{name} {label} ms"] = None
        if label.startswith(("V=", "U+1=")):
            N, T, V = f.shape
            U1 = g.shape[1]
            live = int((dlse != 0).sum())
            res[f"K9a {label} plain ms"] = cs.cuda_ms(
                lambda: joint.pairwise_lse(f, g))
            res[f"K9a {label} library ms"] = cs.cuda_ms(
                lambda: torch.logsumexp(f[:, :, None] + g[:, None], -1))
            res[f"K9a {label} bound ms"] = cs.bound(
                4 * (N * T * V + N * U1 * V + N * T * U1), 0,
                2.0 * N * T * U1 * V + N * (T + U1) * V)[0]
            res[f"K9b {label} bound ms"] = cs.bound(
                4 * (2 * N * T * V + 2 * N * U1 * V + 2 * N * T * U1 +
                     N * T + N * U1), 0,
                4.0 * live * V + N * (T + U1) * V)[0]
            if hasattr(joint_cuda, "bwd_plan"):
                lse, mf, mg = joint.pairwise_lse(f, g)
                res[f"K9b {label} plain ms"] = cs.cuda_ms(
                    lambda: joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg))
        if label == "V=512":
            fr = f.clone().requires_grad_(True)
            gr = g.clone().requires_grad_(True)
            out = torch.logsumexp(fr[:, :, None] + gr[:, None], -1)
            res["K9b V=512 library ms"] = cs.cuda_ms(
                lambda: torch.autograd.grad(out, (fr, gr), dlse,
                                            retain_graph=True))
            del out
    return res


def rates(tree):
    """rnn-transducer:lstm:512 train and eval utterances/s at batch 16
    (median of 5 calls that end in a host read), each call's device busy
    time and its share of the call."""
    import torch
    cs, kernels, _, _ = load(tree)
    kernels.library()
    sys.path.insert(0, str(HERE / "scripts"))
    import lstm_probe
    dev = torch.device("cuda", 0)
    system = cs.make_system(torch, dev, "--arch", "rnn-transducer:lstm:512")
    batch = cs.transducer_batch(system)
    B, U = batch[1].shape

    def step():
        system.train_step(*batch)

    def transcribe():
        with torch.inference_mode():
            _, feats, lens, _ = system._forward_impl(*batch, train=False)
            out = system._decode_impl(feats, lens, max_steps=U + 1,
                                      train=False)
            return [t.cpu() for t in out[:4]]
    out = {}
    for label, fn in (("train", step), ("eval", transcribe)):
        ms, _ = cs.host_ms(torch, fn)
        busy = lstm_probe.device_ms(torch, fn)
        out[f"rnn-transducer:lstm:512 {label} utt/s"] = B / ms * 1e3
        out[f"rnn-transducer:lstm:512 {label} device ms"] = busy
        out[f"rnn-transducer:lstm:512 {label} busy share"] = busy / ms
    del system, batch
    torch.cuda.empty_cache()
    system = cs.make_system(torch, dev, "--arch", "rnn-transducer:lstm:16384")
    batch = cs.transducer_batch(system, B=4)
    system.train_step(*batch)                    # built, warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system.train_step(*batch)
    torch.cuda.synchronize()
    out["rnn-transducer:lstm:16384 train peak GiB"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    return out


# --phases: K9b's source edited in a copy of the tree, (old, new) each; an
# ablation's gradients are wrong, its times and stamps are what it reads
ABLATIONS = {
    "as is": (),
    "without the FMAs": (
        ("              acc[x][h][c] = fmaf(ys[x][h], eg[4 * q + h][c], "
         "acc[x][h][c]);\n",
         "              acc[x][h][c] += ys[x][h];\n"),
        ("            dga[4 * q + h][c] = fmaf(ys[x][h], ef[x][c], "
         "dga[4 * q + h][c]);\n", "")),
    "without the frames' copies": (
        ("          if (ok[0]) cp_async8(dst, src);\n", ""),),
    "without the ring's waits": (
        ("    wait_groups<RING - 1>();               // group k landed\n",
         ""),),
    "without the df stores": (
        ("          if (ok[0])\n            *reinterpret_cast<float2*>(drow)",
         "          if (d[x][0] == -1.f)\n"
         "            *reinterpret_cast<float2*>(drow)"),),
    "without W's exponentials": (
        ("      const float wt = live && !big ? pd[jj] * expf(e) : 0.f;",
         "      const float wt = live && !big ? pd[jj] * e : 0.f;"),),
    "8 warps a block at every size": (
        ("    warps = 4 if blocks >= 2 * sms else 8\n",
         "    warps = 8\n"),),
    "4 warps a block at every size": (
        ("    warps = 4 if blocks >= 2 * sms else 8\n",
         "    warps = 4\n"),),
}


def ablation_tree(dst, edits):
    """A copy of this tree's port and chip_smoke.py at ``dst`` with the
    (old, new) ``edits`` to csrc/joint_lse_bwd.cu or ops/joint_cuda.py
    (whichever holds the old text once)."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(HERE / "haloop_tpu_torch", dst / "haloop_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dst / "chip_smoke.py")
    pkg = dst / "haloop_tpu_torch"
    srcs = {p: p.read_text() for p in (pkg / "csrc" / "joint_lse_bwd.cu",
                                       pkg / "ops" / "joint_cuda.py")}
    for old, new in edits:
        (p,) = [p for p, text in srcs.items() if text.count(old) == 1]
        srcs[p] = srcs[p].replace(old, new)
    for p, text in srcs.items():
        p.write_text(text)


def phase_report(tree):
    """K9b with its phase stamps at V=512, V=16384, every cell marked and
    U+1=2049: per block
    thread 0's cycles of set-up, frames and the rows' merge (median and
    max over the blocks of each kind: past one chunk of U+1, the blocks
    of U+1's rows and those of T's apart) and a frame's share, and the
    kernel's time."""
    import numpy as np
    import torch
    cs, kernels, joint, joint_cuda = load(tree)
    kernels.trace_phases()
    lib = kernels.library()
    ins = inputs(torch, cs)
    for label in ("V=512", "V=16384", "every cell marked", "U+1=2049"):
        f, g, dlse = ins[label]
        lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
        joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
        torch.cuda.synchronize()
        buf = np.zeros((kernels.PHASES, kernels.PHASE_ITEMS), np.int64)
        kernels.check(lib.hl_joint_bwd_phases(buf.ctypes.data), "phases")
        (N, T, V), U1 = f.shape, g.shape[1]
        p = joint_cuda.bwd_plan(N, T, U1, V, kernels.multiprocessors(0))
        ph = buf[:3, :min(p.blocks, kernels.PHASE_ITEMS)]
        per_z = p.slices * N                       # blocks of one chunk
        kinds = [("", ph, T)] if p.chunks == 1 else [
            ("T's rows: ", ph[:, :p.tchunks * per_z], U1),
            ("U+1's rows: ", ph[:, p.tchunks * per_z:], T)]
        ms = cs.cuda_ms(lambda: joint_cuda.lse_bwd_cuda(f, g, lse, dlse,
                                                        mf, mg))
        for kind, x, frames in kinds:
            if not x.size:
                continue
            cells = ", ".join(
                f"{name} median {np.median(x[i]):.0f} max {x[i].max()}"
                for i, name in enumerate(("set-up", "frames", "merge")))
            per = -(-frames // p.group) * joint_cuda.BWD_FRAMES
            print(f"K9b {label}, bwd_plan {tuple(p)}: {ms:.4f} ms; cycles "
                  f"a block, {kind}(thread 0): {cells}; a frame "
                  f"{np.median(x[1]) / per:.0f} (a warp's {per} frames)",
                  flush=True)


def save_lse(tree, out):
    """K9a's lse at every input, from ``tree``'s kernel, into ``out``."""
    import torch
    cs, kernels, joint, joint_cuda = load(tree)
    first = (lambda x: x[0] if isinstance(x, tuple) else x)
    torch.save({label: first(joint_cuda.lse_fwd_cuda(f, g)).cpu()
                for label, (f, g, _) in inputs(torch, cs).items()}, out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--only", default="",
                    help="with --phases: the ablations whose name holds "
                    "it (or one of its comma-separated parts)")
    ap.add_argument("--phase-report", action="store_true",
                    help=argparse.SUPPRESS)     # one --phases tree
    ap.add_argument("--same-lse", type=Path)
    ap.add_argument("--save-lse", type=Path, help=argparse.SUPPRESS)
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
    if a.save_lse:
        save_lse(a.tree, a.save_lse)
        return
    if a.times_only:
        res = times(a.tree)
        if not a.kernels_only:
            res.update(rates(a.tree))
        print(json.dumps(res), flush=True)
        return
    print(card, flush=True)
    if a.same_lse:
        outs = []
        for i, tree in enumerate((a.same_lse, a.tree)):
            out = HERE / "build" / f"joint_lse{i}.pt"
            r = subprocess.run([sys.executable, __file__, "--tree",
                                str(tree), "--save-lse", str(out)],
                               capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"{tree}: exit {r.returncode}\n{r.stderr}")
            outs.append(torch.load(out))
        for label, lse in outs[1].items():
            print(f"K9a {label}: the same bits as {a.same_lse}: "
                  f"{torch.equal(lse, outs[0][label])}", flush=True)
        return
    if a.phases:
        for i, (label, edits) in enumerate(ABLATIONS.items()):
            if edits and not any(x in label for x in a.only.split(",")):
                continue
            dst = HERE
            if edits:
                dst = HERE / "build" / f"joint_ablation{i}"
                ablation_tree(dst, edits)
            print(f"--- {label}", flush=True)
            r = subprocess.run([sys.executable, __file__, "--tree", str(dst),
                                "--phase-report"], capture_output=True,
                               text=True)
            print(r.stdout, end="", flush=True)
            if r.returncode:
                raise SystemExit(f"{dst}: exit {r.returncode}\n{r.stderr}")
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
                f"{res[label] if res.get(label) is None else round(res[label], 5)}"
                for t, res in runs if label in res)
            print(f"{label}: {cells}", flush=True)
        print(json.dumps({"card": card, "runs": [
            {"tree": str(t), "ms": res} for t, res in runs]}), flush=True)
        return
    bad = checks(a.tree)
    for label, ms in times(a.tree).items():
        print(f"{label}: {ms}", flush=True)
    if bad:
        raise SystemExit(f"disagree with the plain version: {bad}")


if __name__ == "__main__":
    main()
