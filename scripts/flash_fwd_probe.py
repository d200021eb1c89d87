#!/usr/bin/env python3
"""The bf16 flash attention forward of the PyTorch port (kernels K5, K5
with its lse, and K7, ``haloop_tpu_torch/csrc/flash_fwd.cu``) alone on
one GPU: its build, checks against the plain versions, and its times.

    python3 scripts/flash_fwd_probe.py                # checks, then times
    python3 scripts/flash_fwd_probe.py --against DIR  # times and rates
        # only: the tree at DIR and this one in turns (DIR, this, this,
        # DIR), each in a process of its own, at the same shapes and inputs
    python3 scripts/flash_fwd_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)

DIR is another checkout of the repository (``git archive`` of a commit
unpacked into a directory that .gitignore lists); each tree builds its
own kernels into its own ``build/``. The shapes are ``chip_smoke.py``'s:
K5 at hap --no-pack's (32, 12, 512, 64) causal with ragged key lengths,
K5 with its lse at hala's (8, 12, 1024, 64), K7 at hap's packed (16, 12,
1024, 64) with 64-token and with pack_segments' ragged segments. Times
are CUDA events around one call behind a spin (``chip_smoke.cuda_ms``),
median of 5, the card's name and power limit printed first. The rates
are the hap and hala paths that run these kernels (``rates``). Needs one
card; imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def load(tree):
    sys.path.insert(0, str(tree))
    import chip_smoke
    from haloop_tpu_torch import kernels
    from haloop_tpu_torch.ops import flash, flash_cuda
    from haloop_tpu_torch.score import pack_segments
    assert Path(chip_smoke.__file__).resolve().parent == tree.resolve()
    return chip_smoke, kernels, flash, flash_cuda, pack_segments


def ptxas_lines(log, name="flash"):
    """The ptxas report of the entry functions whose name holds ``name``,
    and every line that mentions wgmma (serialization warnings)."""
    out, keep = [], 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if name in line else 0
        if keep or "wgmma" in line:
            out.append(line.strip())
            keep = max(keep - 1, 0)
    return out


def cases(torch, cs, pack_segments):
    """(label, fn, plain fn, library fn, kind) at the main path's shapes;
    kind is "k5", "k5_lse" or "k7"."""
    import numpy as np
    dev = torch.device("cuda", 0)
    out = []
    H, D = 12, 64
    q, k, v = cs.qkv_views(torch, dev, 32, H, 512, D, torch.bfloat16, 11)
    lens = torch.randint(256, 513, (32,),
                         generator=torch.Generator().manual_seed(2))
    lens[0] = 512
    kvl = lens.to(dev, torch.int32)
    out.append(("K5 (32, 12, 512, 64) causal, ragged key lengths",
                (q, k, v, kvl), "k5"))
    q, k, v = cs.qkv_views(torch, dev, 8, H, 1024, D, torch.bfloat16, 21)
    kvl = torch.full((8,), 1024, dtype=torch.int32, device=dev)
    out.append(("K5 with lse (8, 12, 1024, 64) causal", (q, k, v, kvl),
                "k5_lse"))
    N, T = 16, 1024
    rng = np.random.default_rng(0)
    ragged = [rng.integers(1, 50257, int(n)).tolist()
              for n in rng.integers(8, 300, 400)]
    seg_ragged = next(iter(pack_segments(iter(ragged), T, N, 50256)))[3]
    seg_64 = np.repeat(np.arange(1, T // 64 + 1), 64)[None].repeat(N, 0)
    for label, seg_np in (("64-token segments", seg_64),
                          ("ragged segments", seg_ragged)):
        q, k, v = cs.qkv_views(torch, dev, N, H, T, D, torch.bfloat16, 13)
        seg = torch.from_numpy(np.ascontiguousarray(seg_np, np.int32)) \
            .to(dev)
        out.append((f"K7 (16, 12, 1024, 64) {label}", (q, k, v, seg), "k7"))
    return out


def run_case(flash, flash_cuda, args, kind):
    q, k, v, x = args
    if kind == "k5":
        return (lambda: flash_cuda.flash_fwd_cuda(q, k, v, x, True, 0),
                lambda: flash._reference(q, k, v, x, True, 0))
    if kind == "k5_lse":
        return (lambda: flash_cuda.flash_fwd_cuda(q, k, v, x, True, 0,
                                                  with_lse=True),
                lambda: flash._reference(q, k, v, x, True, 0,
                                         with_lse=True))
    return (lambda: flash_cuda.flash_packed_cuda(q, k, v, x, True),
            lambda: flash._packed_reference(q, k, v, x, True))


def times(tree):
    import torch
    cs, kernels, flash, flash_cuda, pack_segments = load(tree)
    kernels.library()
    res = {}
    for label, args, kind in cases(torch, cs, pack_segments):
        kern, _ = run_case(flash, flash_cuda, args, kind)
        res[label] = cs.cuda_ms(kern)
    return res


def rates(tree):
    """The paths K5 and K7 serve, at GPT-2 small's widths (``decoder``,
    random weights from seed 0, no checkpoint written): hap --no-pack's
    32 x 512 and hap's packed 16 x 1024 (64-token segments) real tokens/s,
    and hala's 8 x 1024 update tokens/s (forward, backward, clip, AdamW),
    each the median of 7 calls that end in a host read, as in
    ``chip_smoke.py`` phases 16 and 20."""
    import numpy as np
    import torch
    cs, kernels, _, _, pack_segments = load(tree)
    from haloop_tpu_torch import attention_loop as TAL
    from haloop_tpu_torch import params as P
    from haloop_tpu_torch.init import create_model
    from haloop_tpu_torch.models import gpt as G
    from haloop_tpu_torch.score import cast_params
    kernels.library()
    dev = torch.device("cuda", 0)
    spec = create_model("decoder")
    cfg = spec.config
    params = P.tree_map(lambda t: t.to(dev),
                        spec.init(torch.Generator().manual_seed(0)))
    bf16 = cast_params(params, "bfloat16")
    rng = np.random.default_rng(0)
    sents = [rng.integers(1, 50257, 64).tolist() for _ in range(16 * 16)]
    (inp, tgt, pos, seg, _), = list(pack_segments(iter(sents), 1024, 16,
                                                  50256))
    x = rng.integers(1, 50257, (32, 512)).astype(np.int32)
    batches = {
        "hap packed 16 x 1024 real tokens/s": [
            torch.from_numpy(a).to(dev) for a in (inp, tgt, pos, seg)],
        "hap --no-pack 32 x 512 real tokens/s": [
            torch.from_numpy(a).to(dev) for a in (np.concatenate(
                [np.full((32, 1), 50256, np.int32), x[:, :-1]], 1), x)]}
    out = {}
    for label, b in batches.items():
        kw = {} if len(b) == 2 else dict(positions=b[2], segment_ids=b[3])

        @torch.inference_mode()
        def batch():
            return G.forward_all(bf16, cfg, b[0], b[1], reduction="none",
                                 **kw).sum().item()
        ms, _ = cs.host_ms(torch, batch, reps=7)
        out[label] = int((b[1] != 0).sum()) / ms * 1e3
    step = TAL.TrainStep(cfg, cs.hala_args(), params, 200000)
    X = torch.from_numpy(rng.integers(1, 50257, (1, 8, 1024)).astype(
        np.int32)).to(dev)
    Y = TAL.lm_targets(X)
    ms, _ = cs.host_ms(torch, lambda: step(X, Y), reps=7)
    out["hala 8 x 1024 train tokens/s"] = X.numel() / ms * 1e3
    return out


def checks(tree):
    """Each piece of the design on its own input, then the main path's
    shapes and tile edges against the plain versions."""
    import torch
    cs, kernels, flash, flash_cuda, pack_segments = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    dev = torch.device("cuda", 0)
    tol = cs.ATTN_TOL["bfloat16"]
    bad = []

    def report(label, got, want):
        ok, err, mean = cs.within(torch, got, want, tol)
        print(f"{'ok ' if ok else 'BAD'} {label}: max|d| {err:.3e} mean "
              f"{mean:.3e}", flush=True)
        if not ok:
            bad.append(label)

    g = torch.Generator().manual_seed(0)
    for D in (64, 32):
        # P V alone: q = 0 makes every score 0, o the mean of v's rows
        k, v = (torch.randn((2, 2, 256, D), generator=g).to(dev,
                                                            torch.bfloat16)
                for _ in range(2))
        q = torch.zeros((2, 2, 256, D), device=dev, dtype=torch.bfloat16)
        kvl = torch.tensor([256, 200], dtype=torch.int32, device=dev)
        report(f"P V alone (q = 0), D={D}",
               flash_cuda.flash_fwd_cuda(q, k, v, kvl, False, 0),
               flash._reference(q, k, v, kvl, False, 0))
        # then Q K^T as well
        q = torch.randn((2, 2, 256, D), generator=g).to(dev, torch.bfloat16)
        report(f"random, D={D}, not causal",
               flash_cuda.flash_fwd_cuda(q, k, v, kvl, False, 0),
               flash._reference(q, k, v, kvl, False, 0))
        for T, S, t0 in ((1, 1, 0), (127, 127, 0), (128, 128, 0),
                         (129, 129, 0), (300, 300, 0), (100, 300, 7),
                         (129, 300, 0), (1, 129, 128)):
            q = torch.randn((3, 2, T, D), generator=g).to(dev, torch.bfloat16)
            k, v = (torch.randn((3, 2, S, D), generator=g).to(
                dev, torch.bfloat16) for _ in range(2))
            kvl = torch.tensor([S, max(S // 2 + 1, 1), 0], dtype=torch.int32,
                               device=dev)
            o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, t0,
                                               with_lse=True)
            o_e, lse_e = flash._reference(q, k, v, kvl, True, t0,
                                          with_lse=True)
            report(f"causal T={T} S={S} t0={t0} D={D}", o, o_e)
            dl = (lse - lse_e).abs().max().item()
            print(f"    lse max|d| {dl:.3e}", flush=True)
            if not dl <= 1e-3:
                bad.append(f"lse T={T} S={S} t0={t0} D={D}")
    # a view that broadcasts k and v over the heads (stride 0)
    q = torch.randn((2, 4, 200, 64), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((2, 1, 200, 64), generator=g).to(
        dev, torch.bfloat16).expand(2, 4, 200, 64) for _ in range(2))
    kvl = torch.tensor([200, 150], dtype=torch.int32, device=dev)
    try:
        report("k, v expanded over the heads (stride 0)",
               flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0),
               flash._reference(q, k, v, kvl, True, 0))
    except (RuntimeError, ValueError) as e:
        print(f"k, v expanded over the heads (stride 0): refused: {e}",
              flush=True)
    for label, args, kind in cases(torch, cs, pack_segments):
        kern, plain = run_case(flash, flash_cuda, args, kind)
        got, want = kern(), plain()
        if kind == "k5_lse":
            dl = (got[1] - want[1]).abs().max().item()
            print(f"    lse max|d| {dl:.3e}", flush=True)
            if not dl <= 1e-3:
                bad.append(label + " lse")
            got, want = got[0], want[0]
        report(label, got, want)
    torch.cuda.synchronize()
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe needs one GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if a.times_only:
        print(json.dumps(dict(times(a.tree), **rates(a.tree))), flush=True)
        return
    print(card, flush=True)
    if a.against:
        runs = []
        for tree in (a.against, a.tree, a.tree, a.against):
            r = subprocess.run([sys.executable, __file__, "--tree",
                                str(tree), "--times-only"],
                               capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"{tree}: exit {r.returncode}\n{r.stderr}")
            runs.append((tree, json.loads(r.stdout.splitlines()[-1])))
        for label in runs[0][1]:
            cells = ", ".join(f"{'this' if t == a.tree else 'other'} "
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
