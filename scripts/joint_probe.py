#!/usr/bin/env python3
"""The RNN-T joint's logsumexp kernel K9a of the PyTorch port
(``haloop_tpu_torch/csrc/joint_lse.cu``) alone on one GPU: its build,
checks against the plain factored ``pairwise_lse`` and the materialized
joint, and its times.

    python3 scripts/joint_probe.py               # checks, then times
    python3 scripts/joint_probe.py --against DIR # times and rates only:
        # the tree at DIR and this one in turns (DIR, this, this, DIR),
        # each in a process of its own, at the same shapes and inputs
    python3 scripts/joint_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)

``--kernels-only`` (with --against or --times-only) leaves the rates out.
DIR is another checkout of the repository (``git archive`` of a commit
unpacked into a directory that .gitignore lists); each tree builds its
own kernels into its own ``build/``. Inputs are ``chip_smoke.py``'s
(phase 8, ``joint_inputs``): rnn-transducer:lstm:512's joint (N=16,
T'=301, U+1=25, V=512), the same with V = 16384 (``JOINT_V16K``; a tree
whose kernel refuses it reads null), the disjoint peaks (K9a's fix-up
taken at 16 cells) and every cell marked (the fix-up's cost). Times are
CUDA events around one call behind a spin (``chip_smoke.cuda_ms``),
median of 5, the card's name and power limit printed first: the kernel,
its plain version, ``torch.logsumexp`` of the materialized joint, the
bound (``chip_smoke.k9a_bound``), and K9b beside. Rates:
rnn-transducer:lstm:512 train and eval utterances/s at batch 16
(``chip_smoke.host_ms``) and each call's device time and busy share from
torch.profiler. Needs one card; imports nothing of JAX.
"""

import argparse
import json
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
            ("every cell marked", SHAPE, "every", 12)):
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
    joint within JOINT_TOL, one launch a call, the same bits twice, the
    marked cells the plain version marks. -> the labels that failed."""
    import torch
    cs, kernels, joint, joint_cuda = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    bad = []
    for label, (f, g, _) in inputs(torch, cs).items():
        n0 = joint_cuda.launches
        lse = joint_cuda.lse_fwd_cuda(f, g)
        torch.cuda.synchronize()
        once = joint_cuda.launches == n0 + 1
        ok, err = cs.close(lse, joint.pairwise_lse(f, g), cs.JOINT_TOL)
        ok_r, err_r = cs.close(lse, joint.pairwise_lse_reference(f, g),
                               cs.JOINT_TOL)
        same = torch.equal(lse, joint_cuda.lse_fwd_cuda(f, g))
        marked = int(joint.marks(f, g).sum())
        good = ok and ok_r and same and once
        print(f"{'ok ' if good else 'BAD'} K9a {label}: max|d| {err:.3e} "
              f"(materialized joint {err_r:.3e}); {marked} marked cells; "
              f"one launch {once}; same bits twice {same}", flush=True)
        if not good:
            bad.append(label)
    return bad


def times(tree):
    """Per input: K9a's time (null where the tree's kernel refuses the
    shape), and for the unmarked ones the plain version's, the library's,
    the bound and K9b's."""
    import torch
    cs, kernels, joint, joint_cuda = load(tree)
    kernels.library()
    res = {}
    for label, (f, g, dlse) in inputs(torch, cs).items():
        try:
            res[f"K9a {label} ms"] = cs.cuda_ms(
                lambda: joint_cuda.lse_fwd_cuda(f, g))
        except ValueError as e:
            print(f"K9a {label}: {e}", file=sys.stderr, flush=True)
            res[f"K9a {label} ms"] = None
        if label.startswith("V="):
            N, T, V = f.shape
            U1 = g.shape[1]
            res[f"K9a {label} plain ms"] = cs.cuda_ms(
                lambda: joint.pairwise_lse(f, g))
            res[f"K9a {label} library ms"] = cs.cuda_ms(
                lambda: torch.logsumexp(f[:, :, None] + g[:, None], -1))
            res[f"K9a {label} bound ms"] = cs.bound(
                4 * (N * T * V + N * U1 * V + N * T * U1), 0,
                2.0 * N * T * U1 * V + N * (T + U1) * V)[0]
            lse = joint.pairwise_lse(f, g)
            res[f"K9b {label} ms"] = cs.cuda_ms(
                lambda: joint_cuda.lse_bwd_cuda(f, g, lse, dlse))
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
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe needs one GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
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
