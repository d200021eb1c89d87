#!/usr/bin/env python3
"""The decode kernels of the PyTorch port alone on one GPU: K11 (one-token
decode attention, ``haloop_tpu_torch/csrc/decode_attn.cu``
``hl_decode_attn``), K12 (the split decode attention over a long cache,
``hl_decode_attn_split``) and K13 (the int8-weight product,
``csrc/q8_matmul.cu``): their build, checks and times.

    python3 scripts/decode_probe.py                 # checks, then times
    python3 scripts/decode_probe.py --against DIR   # times and rates only:
        # the tree at DIR and this one in turns (DIR, this, this, DIR),
        # each in a process of its own, at the same shapes and inputs
    python3 scripts/decode_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)
    python3 scripts/decode_probe.py --phases
        # K11's cycles by phase: the kernels built with their clock64
        # stamps (-DHL_PHASES, into build/haloop_tpu_torch_phases/),
        # decode_tc's thread 0 of every block, medians over the blocks at
        # each of K11_CASES
    python3 scripts/decode_probe.py --clusters
        # K11 at B=1 over fills from 192 to 1024 rows, each cluster size
        # forced, beside the plan's

``--kernels-only`` leaves the rates out; ``--k11-only`` (with
``--times-only``) times K11 alone. DIR is another checkout of the
repository (``git archive`` of a commit unpacked into a directory that
.gitignore lists); each tree builds its own kernels into its own
``build/``.

Checks: chip_smoke.py's phases 15 (K11 at ``chip_smoke.K11_CASES``: hat
--batch's steps at fill levels 96 and 159, B=32 with left-pad starts and
B=1, GPT-2 small's longest fill and K11's 10 MiB edge, gpt-nano's hat
steps (heads of 32); planted faults; one kernel a call), 22 (K12 at
decoder:50304:4096's step: S=4096, E=768, H=12, bf16, fill level 4000,
B=32 with left-pad starts and B=1, starts past the first splits, the new
row in the first split; planted faults; one launch a call) and 23 (K13
on GPT-2 small's five int8 weights at M=32 and M=1 and a ragged one;
planted faults; the floor of a launch), after the ptxas report of the
three kernels. Times: K11 at each of K11_CASES beside SDPA over the
head-split cache (at hat's L=96 also the host's microseconds a call,
wrapper and launch, ``host_us``), and, where the tree has K11's
``plan``, the B=1 cases with each cluster size forced (1, 2, 4, 8); K12
at phase 22's first two cases beside SDPA; K13 on each weight at M=32
and M=1 beside cuBLAS's ``x @ w_deq.T``, a decode step's 49 calls summed
(each timed alone), K13 on a (16, 768) weight, and an empty kernel where
the tree has one; where the tree has ``q8_bulk``
(``q8_matmul_cuda.q8_bulk_cuda``, the stripes fed by cp.async.bulk), it
too on the weights that K13 plans as stripes without a cluster, after a
check that it gives K13's bits: CUDA events around one call behind a
spin (``chip_smoke.cuda_ms``), median of 5; the card's name and power
limit are printed first. Rates: hat (GPT-2 small, 32-token prompts, 128
greedy tokens, B=32 and B=1; phase 17's shapes) with one call's device
busy time and K11's kernel time (torch.profiler), long-cache hat
(decoder:50304:4096, 3456-token prompts, 128 greedy tokens, B=8 and B=1;
phase 24's shapes) and ``hat --q8`` (GPT-2 small, 32-token prompts, 128
tokens, B=32 and B=1; phase 25's), tokens/s as the median of 3
host-timed calls that end in a host read, on random weights from a seed.
Needs one card; imports nothing of JAX.
"""

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# phase 22's first two cases: (label, B, fill level, left-pad starts)
K12_CASES = (("B=32, starts", 32, 4000, True), ("B=1", 1, 4000, False))


def load(tree):
    sys.path.insert(0, str(tree))
    import chip_smoke
    from haloop_tpu_torch import kernels
    assert Path(chip_smoke.__file__).resolve().parent == tree.resolve()
    return chip_smoke, kernels


def ptxas_lines(log, names=("decode", "q8_stripes", "q8_persist")):
    """The ptxas report of the entry functions whose name holds one of
    ``names``."""
    out, keep = [], 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if any(n in line for n in names) else 0
        if keep:
            out.append(line.strip())
            keep = max(keep - 1, 0)
    return out


def k12_inputs(torch, dev, B, L, pad, S=4096, E=768):
    """phase 22's inputs for one case (its seeds)."""
    g = torch.Generator().manual_seed(B + L)
    qkv = torch.randn((B, 3 * E), generator=g).to(dev, torch.bfloat16)
    q, kn, vn = qkv.split(E, dim=-1)
    kc = torch.randn((B, S, E), generator=g).to(dev, torch.bfloat16)
    vc = torch.randn((B, S, E), generator=g).to(dev, torch.bfloat16)
    starts = torch.randint(0, 16, (B,), generator=g).to(dev) if pad else None
    return q, kn, vn, kc, vc, starts


@contextlib.contextmanager
def k11_cluster(dac, cluster):
    """K11's plan with its cluster forced to up to ``cluster`` blocks (the
    plan's rule given every block an SM of its own and any fill; each rank
    still takes a step of rows)."""
    names = ("K11_MAX_CLUSTER", "K11_CLUSTER_MIN_ROWS", "multiprocessors")
    old = {n: getattr(dac, n) for n in names}
    dac.K11_MAX_CLUSTER, dac.K11_CLUSTER_MIN_ROWS = cluster, 0
    dac.multiprocessors = lambda device: 10 ** 6
    dac.plan.cache_clear()
    try:
        yield
    finally:
        for n, v in old.items():
            setattr(dac, n, v)
        dac.plan.cache_clear()


def this_smoke():
    """This checkout's chip_smoke.py (its K11_CASES and inputs), whichever
    tree is timed: both trees take the same shapes and inputs."""
    spec = importlib.util.spec_from_file_location("this_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(torch, fn, n=200, reps=5):
    """Host microseconds a call of ``fn`` takes to return (its wrapper and
    launch, not the kernel): ``n`` calls queued behind a spin that keeps
    the card busy longer than the host takes to queue them, median of
    ``reps`` loops."""
    import statistics
    import time
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def k11_times(torch, cs, dac, dev):
    """K11 at this checkout's K11_CASES beside SDPA and the bound; at hat's
    L=96 the host's time a call (``host_us``); the B=1 cases with each
    cluster size forced, where the tree plans one."""
    res = {}
    this = this_smoke()
    for label, B, S, L, pad, E, H in this.K11_CASES:
        q, kn, vn, kc, vc, starts = this.k11_inputs(torch, dev, B, S, L,
                                                    pad, E)

        def k11():
            return dac.decode_attn_cuda(q, kn, vn, kc, vc, L, starts,
                                        n_head=H)
        res[f"K11 {label}"] = cs.cuda_ms(k11)
        if L == 96:
            res[f"K11 host us a call {label}"] = host_us(torch, k11)
        res[f"SDPA {label}"] = cs.sdpa_decode_ms(torch, q, kc, vc, L,
                                                 starts, H)
        res[f"K11 bound {label}"] = this.decode_bound(starts, B, L, E,
                                                      H)[0]
        if B == 1 and hasattr(dac, "plan"):
            for cl in (1, 2, 4, 8):
                with k11_cluster(dac, cl):
                    got = dac.plan(B, H, L, E // H, 2,
                                   dac.multiprocessors(dev)).cluster
                    if got == cl:
                        res[f"K11 {label} cluster {cl}"] = cs.cuda_ms(k11)
        del kc, vc
    return res


def times(tree, k11_only=False):
    import torch
    cs, kernels = load(tree)
    from haloop_tpu_torch import quant
    from haloop_tpu_torch.ops import decode_attn_cuda, q8_matmul_cuda
    kernels.library()
    bulk = hasattr(q8_matmul_cuda, "q8_bulk_cuda")
    dev = torch.device("cuda", 0)
    res = k11_times(torch, cs, decode_attn_cuda, dev)
    if k11_only:
        return res
    H = 12
    for label, B, L, pad in K12_CASES:
        q, kn, vn, kc, vc, starts = k12_inputs(torch, dev, B, L, pad)
        res[f"K12 {label}"] = cs.cuda_ms(
            lambda: decode_attn_cuda.decode_attn_split_cuda(
                q, kn, vn, kc, vc, L, starts, n_head=H))
        res[f"SDPA {label}"] = cs.sdpa_decode_ms(torch, q, kc, vc, L, starts,
                                                 H)
        del kc, vc
    step = {}
    for M in (32, 1):
        for name, N, K, n in cs.Q8_WEIGHTS:
            g = torch.Generator().manual_seed(N + K + M)
            w_q, scale = quant.quantize_weight(
                torch.randn((N, K), generator=g) * 0.02)
            w_q, scale = w_q.to(dev), scale.to(dev, torch.bfloat16)
            x = torch.randn((M, K), generator=g).to(dev, torch.bfloat16)
            w_deq = w_q.to(torch.bfloat16) * scale[:, None]
            k = cs.cuda_ms(lambda: q8_matmul_cuda.q8_matmul_cuda(x, w_q,
                                                                 scale))
            lib = cs.cuda_ms(lambda: x @ w_deq.T)
            res[f"K13 {name} M={M}"] = k
            res[f"cuBLAS {name} M={M}"] = lib
            if bulk and q8_matmul_cuda.plan(
                    M, N, K, True, kernels.multiprocessors(dev))[::2] == \
                    (0, 1):                    # stripes without a cluster
                if not torch.equal(q8_matmul_cuda.q8_bulk_cuda(x, w_q, scale),
                                   q8_matmul_cuda.q8_matmul_cuda(x, w_q,
                                                                 scale)):
                    raise SystemExit(f"q8_bulk {name} M={M}: not the bits "
                                     f"of K13")
                res[f"K13 q8_bulk {name} M={M}"] = cs.cuda_ms(
                    lambda: q8_matmul_cuda.q8_bulk_cuda(x, w_q, scale))
            step[M] = [a + n * b for a, b in zip(step.get(M, [0, 0]),
                                                 (k, lib))]
        res[f"K13 decode step M={M}"], res[f"cuBLAS decode step M={M}"] = \
            step[M]
        w16, s16 = quant.quantize_weight(torch.randn((16, 768), device=dev)
                                         * 0.02)
        x16 = torch.ones((M, 768), device=dev, dtype=torch.bfloat16)
        s16 = s16.to(torch.bfloat16)
        res[f"K13 (16, 768) M={M}"] = cs.cuda_ms(
            lambda: q8_matmul_cuda.q8_matmul_cuda(x16, w16, s16))
    if hasattr(q8_matmul_cuda, "empty_kernel"):
        res["empty kernel"] = cs.cuda_ms(
            lambda: q8_matmul_cuda.empty_kernel(dev))
    return res


# --phases: decode_tc's stamps (kernels.trace_phases), in this order
PHASES = ("issue", "q, landed", "q . k", "max exchange", "sum exchange",
          "p . v", "store")


def phase_report(tree):
    """Each of K11_CASES: the median over its blocks of each stamped
    phase's cycles (thread 0 of each block), and the call's time, with the
    kernels built with their phase stamps."""
    import numpy as np
    import torch
    cs, kernels = load(tree)
    from haloop_tpu_torch.ops import decode_attn_cuda as dac
    kernels.trace_phases()
    lib = kernels.library()
    dev = torch.device("cuda", 0)
    for label, B, S, L, pad, E, H in cs.K11_CASES:
        q, kn, vn, kc, vc, starts = cs.k11_inputs(torch, dev, B, S, L, pad,
                                                  E)

        def k11():
            return dac.decode_attn_cuda(q, kn, vn, kc, vc, L, starts,
                                        n_head=H)
        k11()
        torch.cuda.synchronize()
        buf = np.zeros((kernels.PHASES, kernels.PHASE_ITEMS), np.int64)
        kernels.check(lib.hl_k11_phases(buf.ctypes.data), "phases")
        blocks = B * H * dac.plan(B, H, L, E // H, 2,
                                  dac.multiprocessors(dev)).cluster
        ph = buf[:len(PHASES), :min(blocks, kernels.PHASE_ITEMS)]
        print(f"K11 {label}: cycles a block {np.median(ph.sum(0)):.0f} "
              f"(median; the slowest {ph.sum(0).max()}); " +
              ", ".join(f"{n} {np.median(ph[i]):.0f}"
                        for i, n in enumerate(PHASES)) +
              f"; {cs.cuda_ms(k11):.4f} ms", flush=True)


def clusters(tree):
    """K11 at B=1, fills of 192 to 1024 rows (S=1024), each cluster size
    forced, beside the plan's: where a cluster starts to pay."""
    import torch
    cs, kernels = load(tree)
    from haloop_tpu_torch.ops import decode_attn_cuda as dac
    kernels.library()
    dev = torch.device("cuda", 0)
    for L in (191, 255, 319, 415, 511, 639, 767, 1023):
        q, kn, vn, kc, vc, st = cs.k11_inputs(torch, dev, 1, 1024, L, False)

        def k11():
            return dac.decode_attn_cuda(q, kn, vn, kc, vc, L, st,
                                        n_head=12)
        planned = dac.plan(1, 12, L, 64, 2, dac.multiprocessors(dev))
        cells = [f"plan (cluster {planned.cluster}) {cs.cuda_ms(k11):.5f}"]
        for cl in (1, 2, 4, 8):
            with k11_cluster(dac, cl):
                if dac.plan(1, 12, L, 64, 2,
                            dac.multiprocessors(dev)).cluster == cl:
                    cells.append(f"cluster {cl} {cs.cuda_ms(k11):.5f}")
        print(f"K11 B=1, L={L}: " + ", ".join(cells) + " ms", flush=True)


def random_gpt(torch, dev, arch, q8=False):
    """(config, bf16 params) of ``arch`` with random weights from seed 0
    (hai's init), int8 matmul weights with ``q8`` (``--q8``)."""
    from haloop_tpu_torch.init import create_model
    from haloop_tpu_torch.models import gpt as G
    from haloop_tpu_torch.params import tree_map
    from haloop_tpu_torch.quant import quantize_gpt_params
    from haloop_tpu_torch.score import cast_params
    cfg = create_model(arch).config
    params = tree_map(lambda t: t.to(dev),
                      G.gpt_init(torch.Generator().manual_seed(0), cfg))
    if q8:
        params = quantize_gpt_params(params)
    return cfg, cast_params(params, "bfloat16")


def rates(tree):
    """tokens/s of long-cache hat (phase 24's shapes) and hat --q8 (phase
    25's), each the median of 3 host-timed generate calls."""
    import numpy as np
    import torch
    cs, kernels = load(tree)
    from haloop_tpu_torch.models import gpt as G
    kernels.library()
    dev = torch.device("cuda", 0)
    sys.path.insert(0, str(HERE / "scripts"))
    import lstm_probe
    out = {}
    for arch, q8, width, batches in (("decoder", False, 32, (32, 1)),
                                     ("decoder:50304:4096", False, 3456,
                                      (8, 1)),
                                     ("decoder", True, 32, (32, 1))):
        cfg, params = random_gpt(torch, dev, arch, q8)
        rng = np.random.default_rng(3 if width > 32 else 1)
        for B in batches:
            lo = width - 512 if width > 32 else 17
            lens = rng.integers(lo, width + 1, B) if B > 1 else \
                np.array([width])
            if width > 32:
                lens[0] = width
            ids = np.zeros((B, width), np.int32)
            for b, n in enumerate(lens):
                ids[b, width - n:] = rng.integers(1, 50257, n)
            ids = torch.from_numpy(ids).to(dev)
            lens = torch.from_numpy(lens.astype(np.int32)).to(dev) \
                if B > 1 else None

            @torch.inference_mode()
            def gen():
                return G.generate(params, cfg, ids, 128, top_k=1,
                                  stop_token=-1, prompt_lengths=lens)[0] \
                    .sum().item()
            gen()
            ms, _ = cs.host_ms(torch, gen, reps=3, warm=False)
            label = "long-cache hat" if width > 32 else \
                "hat --q8" if q8 else "hat"
            out[f"{label} B={B} tokens/s"] = B * 128 / ms * 1e3
            if label == "hat":
                busy = lstm_probe.device_ms(torch, gen)
                _, by_name = cs.profile_step(torch, gen, f"{label} B={B}")
                k11 = sum(t for name, (_, t) in by_name.items()
                          if "decode<" in name or "decode_tc<" in name) / 1e6
                out[f"hat B={B} call ms"] = ms
                out[f"hat B={B} device busy ms"] = busy
                out[f"hat B={B} K11 ms"] = k11
        del params
        torch.cuda.empty_cache()
    return out


def checks(tree):
    import torch
    cs, kernels = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_decode(torch, dev)
    cs.phase_decode_long(torch, dev)
    cs.phase_q8(torch, dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    ap.add_argument("--k11-only", action="store_true",
                    help="with --times-only: K11's times alone")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--phase-report", action="store_true",
                    help=argparse.SUPPRESS)     # the --phases tree
    ap.add_argument("--clusters", action="store_true")
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
        res = times(a.tree, a.k11_only)
        if not (a.kernels_only or a.k11_only):
            res.update(rates(a.tree))
        print(json.dumps(res), flush=True)
        return
    print(card, flush=True)
    if a.phases:
        r = subprocess.run([sys.executable, __file__, "--tree", str(a.tree),
                            "--phase-report"], capture_output=True,
                           text=True)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            raise SystemExit(f"--phases: exit {r.returncode}\n{r.stderr}")
        return
    if a.clusters:
        clusters(a.tree)
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
                f"{'this' if t == a.tree else 'parent'} "
                + (f"{res[label]:.5f}" if label in res else "none")
                for t, res in runs)
            unit = "" if label.endswith("/s") or "host us" in label \
                else " ms"
            print(f"{label}:{unit} {cells}", flush=True)
        print(json.dumps({"card": card, "runs": [
            {"tree": str(t), "ms": res} for t, res in runs]}), flush=True)
        return
    checks(a.tree)
    for label, ms in times(a.tree).items():
        print(f"{label}: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
