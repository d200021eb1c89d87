#!/usr/bin/env python3
"""Kernel K10 of the PyTorch port (the lm_head product fused with its
cross-entropy, ``haloop_tpu_torch/csrc/fused_ce.cu``) alone on one GPU:
its build, checks against the plain ``ce_nll_lse`` and its times.

    python3 scripts/ce_probe.py                # build, checks, times
    python3 scripts/ce_probe.py --against DIR  # times and rates only: the
        # tree at DIR and this one in turns (DIR, this, this, DIR), each in
        # a process of its own, at the same shapes and inputs
    python3 scripts/ce_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)
    python3 scripts/ce_probe.py --phases
        # cycles a vocab tile of each consumer warpgroup, from copies of
        # this tree under build/ce_phases*/ with clock64 stamps added (as
        # is, and without the fold), and the kernel's time in each

``--kernels-only`` (with --against or --times-only) leaves the rates out.
DIR is another checkout of the repository (``git archive`` of a commit
unpacked into a directory that .gitignore lists); each tree builds its
own kernels into its own ``build/``. The shapes are the main paths': hap's
loss (N=16384: 16 x 1024 packed and 32 x 512 unpacked rows) and hala's (N
= 8192: 8 x 1024), V = 50304, D = 768, bf16, inputs as ``chip_smoke.py``
phase 14 draws them. Times are CUDA events around one call behind a spin
(``chip_smoke.cuda_ms``), median of 5, the card's name and power limit
printed first: the kernel, its plain version, one PyTorch call of the
same function (``torch.logsumexp(x @ w.T) - gather``), the cuBLAS product
``torch.mm(x, w.T)`` alone (the floor a fused kernel approaches), and the
bound (operations: the product at 989 TFLOP/s and 4 fp32 operations a
logit at 67 TFLOP/s). The rates are hap's packed and --no-pack real tokens/s and hala's train
tokens/s, with one hala update's device time (``flash_fwd_probe.rates``).
Needs one card; imports nothing of JAX.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
V, D = 50304, 768
SHAPES = (("hap", 16384), ("hala", 8192))


def load(tree):
    sys.path.insert(0, str(tree))
    import chip_smoke
    from haloop_tpu_torch import kernels
    from haloop_tpu_torch.ops import fused_ce, fused_ce_cuda
    assert Path(chip_smoke.__file__).resolve().parent == tree.resolve()
    return chip_smoke, kernels, fused_ce, fused_ce_cuda


def inputs(torch, N, V, D, seed=None, dtype=None):
    """x, w, targets as chip_smoke.py phase 14 draws them."""
    g = torch.Generator().manual_seed(N if seed is None else seed)
    dev = torch.device("cuda", 0)
    dtype = dtype or torch.bfloat16
    x = torch.randn((N, D), generator=g).to(dev, dtype)
    w = (torch.randn((V, D), generator=g) * 0.02).to(dev, dtype)
    t = torch.randint(1, min(V, 50257), (N,), generator=g).to(dev)
    return x, w, t


def expected(torch, fused_ce, x, w, t):
    """The plain version's (nll, lse), a target outside [0, V) adding a
    target term of 0."""
    V = w.shape[0]
    valid = (t >= 0) & (t < V)
    nll, lse = fused_ce.ce_nll_lse(x, w, t.clamp(0, V - 1))
    return torch.where(valid, nll, lse), lse


def ptxas_lines(log):
    """The ptxas report of fused_ce.cu's entry functions, and every line
    that mentions wgmma (serialization warnings)."""
    out, keep = [], 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if ("2wg2ce" in line or "merge_chunks" in line or
                         "5fp32k2ce" in line) else 0
        if keep or "wgmma" in line:
            out.append(line.strip())
            keep = max(keep - 1, 0)
    return out


def checks(tree):
    """The tile edges in N, V and D, the targets at column 0, at V - 1 and
    past V, the main paths' shapes: each within chip_smoke.CE_TOL of the
    plain version, the same bits twice, one launch of the bf16 route a
    call. -> the labels that failed."""
    import torch
    cs, kernels, fused_ce, fused_ce_cuda = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    bad = []
    cases = [(N, v, d) for d in (64, 768) for v in (255, 256, 257, 4099)
             for N in (1, 63, 64, 65, 127, 129)]
    cases += [(N, v, 768) for v in (50257, 50304) for N in (1, 129, 8192)]
    cases += [(N, V, D) for _, N in SHAPES]
    for N, v, d in cases:
        x, w, t = inputs(torch, N, v, d, seed=N * 7 + v + d)
        t[0] = v - 1                       # the last column
        if N > 1:
            t[1] = 0
        if N > 3:
            t[2], t[3] = v, v + 1000       # no such column: term 0
        before = fused_ce_cuda.wg_launches
        nll, lse = fused_ce_cuda.ce_fwd_cuda(x, w, t)
        torch.cuda.synchronize()
        nll_e, lse_e = expected(torch, fused_ce, x, w, t)
        err = max((nll - nll_e).abs().max().item(),
                  (lse - lse_e).abs().max().item())
        ok = all(bool(((a - b).abs() <= cs.CE_TOL["atol"] +
                       cs.CE_TOL["rtol"] * b.abs()).all())
                 for a, b in ((nll, nll_e), (lse, lse_e)))
        same = torch.equal(nll, fused_ce_cuda.ce_fwd_cuda(x, w, t)[0])
        route = fused_ce_cuda.wg_launches - before == 2
        label = f"N={N} V={v} D={d}"
        print(f"{'ok ' if ok and same and route else 'BAD'} {label}: "
              f"max|dnll, dlse| {err:.3e}; same bits twice {same}; "
              f"bf16 route {route}", flush=True)
        if not (ok and same and route):
            bad.append(label)
    return bad


def times(tree):
    """Per shape: the kernel, plain, library and product-alone times and
    the bound (ms)."""
    import torch
    cs, kernels, fused_ce, fused_ce_cuda = load(tree)
    kernels.library()
    res = {}
    for name, N in SHAPES:
        x, w, t = inputs(torch, N, V, D)
        res[f"K10 {name} N={N}"] = cs.cuda_ms(
            lambda: fused_ce_cuda.ce_fwd_cuda(x, w, t))
        res[f"plain {name} N={N}"] = cs.cuda_ms(
            lambda: fused_ce.ce_nll_lse(x, w, t))

        def library():
            logits = x @ w.T
            return torch.logsumexp(logits.float(), -1) - \
                logits.gather(1, t[:, None])[:, 0].float()
        res[f"library {name} N={N}"] = cs.cuda_ms(library)
        res[f"torch.mm(x, w.T) {name} N={N}"] = cs.cuda_ms(
            lambda: torch.mm(x, w.T))
        res[f"bound {name} N={N}"] = cs.bound(
            x.element_size() * (N * D + V * D) + 4 * 3 * N,
            2.0 * N * V * D, cs.CE_ELEM * N * V)[0]
        del x, w, t
        torch.cuda.empty_cache()
    return res


def rates(tree):
    sys.path.insert(0, str(HERE / "scripts"))
    import flash_fwd_probe
    return flash_fwd_probe.rates(tree)


# --phases: clock64 stamps in a copy of csrc/fused_ce.cu, (old, new) text
PHASE_EDITS = (
    ("namespace wg {\n",
     "__device__ long long hl_ce_phase[2][4][1024];\n\nnamespace wg {\n"),
    ("  float acc[128];\n  int it = 0;\n",
     "  float acc[128];\n  int it = 0, ph_t = 0;\n"),
    ("    for (int vt = vt0; vt < vt1; ++vt) {\n",
     "    for (int vt = vt0; vt < vt1; ++vt, ++ph_t) {\n"
     "      const long long ph0 = clock64();\n      long long ph_w = 0;\n"),
    ("        hl::mbar_wait(full(st), (it / STAGES) & 1);\n",
     "        const long long pa = clock64();\n"
     "        hl::mbar_wait(full(st), (it / STAGES) & 1);\n"
     "        ph_w += clock64() - pa;\n"),
    ("      hl::wgmma_wait<0>();\n      if (lane == 0) hl::mbar_arrive(",
     "      const long long ph2 = clock64();\n"
     "      hl::wgmma_wait<0>();\n      if (lane == 0) hl::mbar_arrive("),
    ("      hl::fence_regs(acc);\n      const int c0 = vt * BN;\n",
     "      hl::fence_regs(acc);\n      const long long ph3 = clock64();\n"
     "      const int c0 = vt * BN;\n"),
    ("      fold(acc, m, s, gt, tg, c0, tq, V - c0 - 2 * tq);\n",
     "      fold(acc, m, s, gt, tg, c0, tq, V - c0 - 2 * tq);\n"
     "      if (blockIdx.x == 0 && tid % 128 == 0 && ph_t < 1024) {\n"
     "        long long* q = &hl_ce_phase[c][0][ph_t];\n"
     "        q[0] = ph_w;\n        q[1024] = ph2 - ph0 - ph_w;\n"
     "        q[2048] = ph3 - ph2;\n        q[3072] = clock64() - ph3;\n"
     "      }\n"),
)
PHASE_READ = """
extern "C" int hl_ce_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, hl_ce_phase, sizeof(hl_ce_phase));
}
"""
PHASES = ("ring waits", "product issue", "product drain", "fold")
# --phases' ablations: (old, new) text after the stamps
ABLATIONS = {
    "as is": (),
    "without the fold": (
        ("      fold(acc, m, s, gt, tg, c0, tq, V - c0 - 2 * tq);\n",
         "      if (acc[0] == 12345.f) gt[0] += acc[127];\n"),),
}


def phases_tree(dst, ablation=()):
    """A copy of this tree's port and chip_smoke.py at ``dst`` with the
    stamps of PHASE_EDITS, then the (old, new) edits of ``ablation``, and
    an entry point ``hl_ce_phases``."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(HERE / "haloop_tpu_torch", dst / "haloop_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dst / "chip_smoke.py")
    src_path = dst / "haloop_tpu_torch" / "csrc" / "fused_ce.cu"
    src = src_path.read_text()
    for old, new in PHASE_EDITS + tuple(ablation):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src_path.write_text(src + PHASE_READ)
    kp = dst / "haloop_tpu_torch" / "kernels.py"
    k = kp.read_text()
    anchor = '    "hl_empty": [_P],'
    assert anchor in k
    kp.write_text(k.replace(anchor, anchor + '\n    "hl_ce_phases": [_P],'))


def phase_report(tree):
    """Medians over block 0's vocab tiles (the first 8 left out) of each
    consumer's stamped phases at each main-path shape, and the kernel's
    time."""
    import numpy as np
    import torch
    cs, kernels, fused_ce, fused_ce_cuda = load(tree)
    lib = kernels.library()
    for name, N in SHAPES:
        x, w, t = inputs(torch, N, V, D)
        fused_ce_cuda.ce_fwd_cuda(x, w, t)
        torch.cuda.synchronize()
        buf = np.zeros((2, len(PHASES), 1024), np.int64)
        kernels.check(lib.hl_ce_phases(buf.ctypes.data), "hl_ce_phases")
        p = fused_ce_cuda.plan(N, V, D, kernels.multiprocessors(x.device))
        tiles = sum(vt1 - vt0 for rt, vt0, vt1 in
                    (fused_ce_cuda.item_tiles(p, i)
                     for i in range(0, p.items, p.grid)))
        d = buf[:, :, 8:min(tiles, 1024)]
        for c in range(2):
            cells = [f"{ph} {np.median(d[c, i]):.0f}"
                     for i, ph in enumerate(PHASES)]
            print(f"{name} N={N} consumer {c}: cycles a tile "
                  f"{np.median(d[c].sum(0)):.0f} ({tiles} tiles in block "
                  f"0); " + ", ".join(cells), flush=True)
        ms = cs.cuda_ms(lambda: fused_ce_cuda.ce_fwd_cuda(x, w, t))
        print(f"{name} N={N}: {ms:.4f} ms", flush=True)
        del x, w, t


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
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
            dst = HERE / "build" / f"ce_phases{i}"
            phases_tree(dst, edits)
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
            cells = ", ".join(f"{'this' if t == a.tree else 'other'} "
                              f"{res[label]:.4f}" for t, res in runs
                              if label in res)
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
