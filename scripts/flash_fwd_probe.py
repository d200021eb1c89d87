#!/usr/bin/env python3
"""The flash attention kernels of the PyTorch port alone on one GPU: the
forward (K5, K5 with its lse, and K7, ``haloop_tpu_torch/csrc/flash_fwd.cu``)
and the backward (K6a dq, K6b dk and dv, ``csrc/flash_bwd.cu``), each in
bf16 and in fp32: their build, checks against the plain versions, and
their times.

    python3 scripts/flash_fwd_probe.py                # checks, then times
    python3 scripts/flash_fwd_probe.py --backward     # the backward only
    python3 scripts/flash_fwd_probe.py --against DIR  # times and rates
        # only: the tree at DIR and this one in turns (DIR, this, this,
        # DIR), each in a process of its own, at the same shapes and inputs
    python3 scripts/flash_fwd_probe.py --tree DIR --times-only
        # one tree's times and rates as a JSON line (what --against runs)
    python3 scripts/flash_fwd_probe.py --clocks
        # fp32 K5 with its lse, K6a and K6b at hala's fp32 shape, each
        # called for ~2 s while nvidia-smi samples the SM clock and power

With ``--backward`` the checks and times are K6a's and K6b's alone and
the rates hala's alone; ``--kernels-only`` leaves the rates out (to
compare design variants quickly). The checks and times cover both
dtypes; in fp32 the checks also force other splits than
``flash_cuda.fwd_f32_plan``'s (the forward's keys) and ``bwd_f32_plan``'s
(the backward's reduction) (``forced_splits``, ``forced_fwd_splits``),
and the times at --grad-norms' shape with other splits forced
(``F32_SPLITS``; a parent tree without the split has none, and --against
prints only the lines both trees time).

DIR is another checkout of the repository (``git archive`` of a commit
unpacked into a directory that .gitignore lists); each tree builds its
own kernels into its own ``build/``. The shapes are ``chip_smoke.py``'s:
K5 at hap --no-pack's (32, 12, 512, 64) causal with ragged key lengths,
K5 with its lse at hala's (8, 12, 1024, 64), K7 at hap's packed (16, 12,
1024, 64) with 64-token and with pack_segments' ragged segments; in fp32
K5 with its lse at --grad-norms' (1, 8, 384, 64) non-causal
(``chip_smoke.GN_ATTN``) and hala's fp32 (2, 12, 1024, 64) causal, and K5
at (4, 12, 512, 64) causal with ragged key lengths, each beside SDPA in
fp32; K6a and K6b at hala's (8, 12, 1024, 64) causal in bf16, and in
fp32 at hala's fp32 (2, 12, 1024, 64) causal and --grad-norms' shape,
each beside SDPA's backward in the same dtype (dq, dk, dv from one
autograd call). Times are CUDA events around one call behind a spin
(``chip_smoke.cuda_ms``), median of 5, the card's name and power limit
printed first. The rates are the hap and hala paths that run these
kernels, and the device time of one hala update from torch.profiler
(``rates``). Needs one card; imports nothing of JAX.
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


def ragged_lengths(torch, N, T):
    """chip_smoke's ragged key lengths: T // 2 to T, the first T."""
    lens = torch.randint(T // 2, T + 1, (N,),
                         generator=torch.Generator().manual_seed(2))
    lens[0] = T
    return lens.to("cuda", torch.int32)


def cases(torch, cs, pack_segments):
    """(label, (q, k, v, kv_lengths or segment ids, causal), kind) at the
    main path's shapes; kind is "k5", "k5_lse" or "k7"."""
    import numpy as np
    dev = torch.device("cuda", 0)
    out = []
    H, D = 12, 64
    q, k, v = cs.qkv_views(torch, dev, 32, H, 512, D, torch.bfloat16, 11)
    out.append(("K5 (32, 12, 512, 64) causal, ragged key lengths",
                (q, k, v, ragged_lengths(torch, 32, 512), True), "k5"))
    q, k, v = cs.qkv_views(torch, dev, 8, H, 1024, D, torch.bfloat16, 21)
    kvl = torch.full((8,), 1024, dtype=torch.int32, device=dev)
    out.append(("K5 with lse (8, 12, 1024, 64) causal",
                (q, k, v, kvl, True), "k5_lse"))
    for label, (N, Hh, T, Dd), causal, ragged, kind in F32_CASES:
        q, k, v = cs.qkv_views(torch, dev, N, Hh, T, Dd, torch.float32, 41)
        kvl = ragged_lengths(torch, N, T) if ragged else \
            torch.full((N,), T, dtype=torch.int32, device=dev)
        out.append((label, (q, k, v, kvl, causal), kind))
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
        out.append((f"K7 (16, 12, 1024, 64) {label}",
                    (q, k, v, seg, True), "k7"))
    return out


# the fp32 forward's timed shapes: (label, (N, H, T, D), causal, ragged
# key lengths, kind)
F32_CASES = [
    ("fp32 K5 with lse (1, 8, 384, 64) non-causal (--grad-norms)",
     (1, 8, 384, 64), False, False, "k5_lse"),
    ("fp32 K5 with lse (2, 12, 1024, 64) causal", (2, 12, 1024, 64), True,
     False, "k5_lse"),
    ("fp32 K5 (4, 12, 512, 64) causal, ragged key lengths",
     (4, 12, 512, 64), True, True, "k5")]


def run_case(flash, flash_cuda, args, kind):
    q, k, v, x, causal = args
    if kind == "k5":
        return (lambda: flash_cuda.flash_fwd_cuda(q, k, v, x, causal, 0),
                lambda: flash._reference(q, k, v, x, causal, 0))
    if kind == "k5_lse":
        return (lambda: flash_cuda.flash_fwd_cuda(q, k, v, x, causal, 0,
                                                  with_lse=True),
                lambda: flash._reference(q, k, v, x, causal, 0,
                                         with_lse=True))
    return (lambda: flash_cuda.flash_packed_cuda(q, k, v, x, causal),
            lambda: flash._packed_reference(q, k, v, x, causal))


def k6_args(torch, cs, flash_cuda, N, H, T, S, D, kvl, causal, t0, seed,
            views=True, dtype=None):
    """The arguments of the backward as hala makes them: q, k, v views of
    one projection (T == S) with K5's o and lse, and do a head-split view
    of an (N, T, H D) gradient; bf16 unless ``dtype``."""
    dev = torch.device("cuda", 0)
    dtype = dtype or torch.bfloat16
    if views and T == S:
        q, k, v = cs.qkv_views(torch, dev, N, H, T, D, dtype, seed)
    else:
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=g).to(dev, dtype)
                   for shape in ((N, H, T, D), (N, H, S, D), (N, H, S, D)))
    kvl = torch.as_tensor(kvl, dtype=torch.int32).to(dev)
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, causal, t0,
                                       with_lse=True)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn((N, T, H * D), generator=g).to(dev, dtype) \
        .reshape(N, T, H, D).transpose(1, 2)
    return q, k, v, kvl, causal, t0, o, lse, do


# the backward's timed shapes: (label, N, H, T, causal, dtype name)
K6_TIMED = [("(8, 12, 1024, 64) causal", 8, 12, 1024, True, "bfloat16"),
            ("fp32 (2, 12, 1024, 64) causal", 2, 12, 1024, True,
             "float32"),
            ("fp32 (1, 8, 384, 64) non-causal (--grad-norms)", 1, 8, 384,
             False, "float32")]


def forced_splits(flash_cuda, dq, dkv):
    """A ``bwd_f32_plan`` whose splits are (dq, dkv) (each at most the
    reduction's tiles), for ``flash_cuda.bwd_f32_plan = ...``."""
    from types import SimpleNamespace
    plan = flash_cuda.bwd_f32_plan

    def forced(N, H, T, S, D, causal, t0, sms):
        p = vars(plan(N, H, T, S, D, causal, t0, sms)).copy()
        for name, splits, outs in (("dq", dq, 1), ("dkv", dkv, 2)):
            p[f"{name}_splits"] = splits
            p[f"{name}_blocks"] = p[f"{name}_tiles"] * splits
            p[f"{name}_part"] = p[f"{name}_blocks"] * outs * \
                flash_cuda.F32_TILE * D if splits > 1 else 0
        return SimpleNamespace(**p)
    return forced


def forced_fwd_splits(flash_cuda, splits):
    """A ``fwd_f32_plan`` whose splits are ``splits`` (at most the key
    tiles), for ``flash_cuda.fwd_f32_plan = ...``."""
    from types import SimpleNamespace
    plan = flash_cuda.fwd_f32_plan

    def forced(N, H, T, S, D, causal, t0, sms):
        p = plan(N, H, T, S, D, causal, t0, sms)
        tile = flash_cuda.F32_TILE
        return SimpleNamespace(
            tiles=p.tiles, splits=splits, blocks=p.tiles * splits,
            part=p.tiles * splits * tile * (D + 2) if splits > 1 else 0)
    return forced


def times(tree, backward_only=False):
    """-> {label: ms}: the kernels at the main path's shapes (the fp32
    forward's beside SDPA in fp32), and fp32 K5 with its lse and K6a/K6b
    at --grad-norms' shape also with the plan's splits forced to each of
    F32_SPLITS (where the tree splits)."""
    import torch
    import torch.nn.functional as F
    cs, kernels, flash, flash_cuda, pack_segments = load(tree)
    kernels.library()
    res = {}
    if not backward_only:
        for label, args, kind in cases(torch, cs, pack_segments):
            kern, _ = run_case(flash, flash_cuda, args, kind)
            res[label] = cs.cuda_ms(kern)
            if label.startswith("fp32"):
                q, k, v, _, causal = args
                res[f"SDPA {label}"] = cs.cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal))
            if label.startswith("fp32") and "--grad-norms" in label and \
                    hasattr(flash_cuda, "fwd_f32_plan"):
                plan = flash_cuda.fwd_f32_plan
                for p in F32_SPLITS:
                    flash_cuda.fwd_f32_plan = forced_fwd_splits(flash_cuda,
                                                                p)
                    try:
                        res[f"{label} splits {p}"] = cs.cuda_ms(kern)
                    finally:
                        flash_cuda.fwd_f32_plan = plan
    for label, N, H, T, causal, dtype in K6_TIMED:
        args = k6_args(torch, cs, flash_cuda, N, H, T, T, 64, [T] * N,
                       causal, 0, 21, dtype=getattr(torch, dtype))
        b = flash_cuda._bwd_args(*args)
        flash_cuda._bwd_dq(b)              # the scratch that K6b reads
        res[f"K6a {label}"] = cs.cuda_ms(lambda: flash_cuda._bwd_dq(b))
        res[f"K6b {label}"] = cs.cuda_ms(lambda: flash_cuda._bwd_dkv(b))
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in args[:3])
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        res[f"SDPA backward {label}"] = cs.cuda_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), args[-1], retain_graph=True))
        del out, ql, kl, vl, b
        if dtype == "float32" and not causal and \
                hasattr(flash_cuda, "bwd_f32_plan"):
            plan = flash_cuda.bwd_f32_plan
            for p in F32_SPLITS:
                flash_cuda.bwd_f32_plan = forced_splits(flash_cuda, p, p)
                b = flash_cuda._bwd_args(*args)
                flash_cuda._bwd_dq(b)
                res[f"K6a {label} splits {p}"] = cs.cuda_ms(
                    lambda: flash_cuda._bwd_dq(b))
                res[f"K6b {label} splits {p}"] = cs.cuda_ms(
                    lambda: flash_cuda._bwd_dkv(b))
                flash_cuda.bwd_f32_plan = plan
    return res


# the splits timed beside the plan's at --grad-norms' shape
F32_SPLITS = (1, 2, 3, 6)


def device_ms(torch, fn):
    """The device's busy time in one call of ``fn`` (the union of its
    kernels' spans), from torch.profiler after a traced warm-up call, as
    ``chip_smoke.profile_step`` reads it."""
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


def rates(tree, backward_only=False):
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
    for label, b in ({} if backward_only else batches).items():
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
    out["hala 8 x 1024 update device ms"] = device_ms(torch,
                                                      lambda: step(X, Y))
    return out


def checks_backward(torch, cs, flash, flash_cuda):
    """K6a and K6b: dV = P^T dO and dQ = dS K alone (q = 0, lse = 0, o =
    0: p = 1, ds = dp), then K5's o and lse at tile edges (T at 1, and T,
    S at 70, 127, 128, 129, 300; t0 up to 126; key lengths full, mid-tile
    and 0; D 64 and 32) and hala's shape, full and ragged key lengths, within
    ``chip_smoke.K6_TOL``; the same bits twice. Then fp32 (``checks_f32``).
    -> labels that failed."""
    dev = torch.device("cuda", 0)
    tol = cs.K6_TOL["bfloat16"]
    bad = []

    def report(label, args, tol=tol):
        plan = ""
        if args[0].dtype == torch.float32:
            p = flash_cuda._bwd_args(*args).plan
            plan = f" (splits {p.dq_splits}, {p.dkv_splits})"
        got = flash_cuda.flash_bwd_cuda(*args)
        torch.cuda.synchronize()
        want = flash._backward_reference(*args)
        worst = []
        for tag, a, b in zip(("dq", "dk", "dv"), got, want):
            top = b.float().abs().max().item()
            if top == 0:                 # dk with q = 0: exactly zero
                ok = not a.float().abs().max().item()
                worst.append(f"{tag} all zero {ok}")
            else:
                rmax, rmean = cs.grad_gate(a, b, top)
                ok = rmax <= tol["max"] and rmean <= tol.get("mean", 1.0)
                worst.append(f"{tag} {rmax:.2e}/{rmean:.2e}")
            if not ok:
                bad.append(f"{label} {tag}")
        again = flash_cuda.flash_bwd_cuda(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same:
            bad.append(f"{label} not the same bits twice")
        ok = not any(x.startswith(label) for x in bad)
        print(f"{'ok ' if ok else 'BAD'} K6 {label}{plan}: max/mean of "
              f"the largest/mean {', '.join(worst)}; same bits twice "
              f"{same}", flush=True)

    g = torch.Generator().manual_seed(5)
    for D in (64, 32):
        for causal in (False, True):
            N, H, T = 2, 2, 256
            k, v, do = (torch.randn((N, H, T, D), generator=g).to(
                dev, torch.bfloat16) for _ in range(3))
            q = torch.zeros_like(k)
            o = torch.zeros_like(k)
            lse = torch.zeros((N, H, T), device=dev)
            kvl = torch.tensor([T, 200], dtype=torch.int32, device=dev)
            report(f"p = 1 (q, lse, o = 0) D={D} causal={causal}",
                   (q, k, v, kvl, causal, 0, o, lse, do))
    for D in (64, 32):
        # no row with a single live key: there p = 1 and ds = dp - delta
        # = 0 in exact arithmetic, and dq, dk are rounding noise on both
        # sides (T = 1 causal needs t0 > 0)
        for T, S, causal, t0 in ((1, 129, False, 0), (70, 70, True, 0),
                                 (127, 127, True, 0), (128, 128, False, 0),
                                 (129, 129, True, 0), (300, 300, True, 0),
                                 (70, 300, True, 126), (129, 300, True, 7),
                                 (129, 300, True, 65), (300, 129, False, 0),
                                 (1, 300, True, 126), (300, 70, True, 0)):
            kvl = [S, max(S // 2 + 1, 1), 0]
            report(f"T={T} S={S} causal={causal} t0={t0} D={D}",
                   k6_args(torch, cs, flash_cuda, 3, 2, T, S, D, kvl,
                           causal, t0, T + S + D, views=False))
    report("hala (8, 12, 1024, 64) causal",
           k6_args(torch, cs, flash_cuda, 8, 12, 1024, 1024, 64,
                   [1024] * 8, True, 0, 21))
    report("hala (8, 12, 1024, 64) causal, ragged key lengths",
           k6_args(torch, cs, flash_cuda, 8, 12, 1024, 1024, 64,
                   cs.K6_RAGGED, True, 0, 23))
    checks_f32(torch, cs, flash_cuda, report)
    return bad


def checks_f32(torch, cs, flash_cuda, report):
    """fp32 K6a/K6b within K6_TOL["float32"]: the same tile edges, hala's
    fp32 (2, 12, 1024, 64) causal (full, K6_RAGGED's first two lengths,
    t0 = 64 with T = 960) and --grad-norms' (1, 8, 384, 64) non-causal,
    each at the plan's splits and with other splits forced (1, 2, 3, 6,
    and K6a / K6b apart)."""
    f32 = dict(dtype=torch.float32, tol=cs.K6_TOL["float32"])
    plan = flash_cuda.bwd_f32_plan
    cases = []
    for D in (64, 32):
        for T, S, causal, t0 in ((1, 129, False, 0), (70, 70, True, 0),
                                 (129, 129, True, 0), (300, 300, True, 0),
                                 (70, 300, True, 126), (129, 300, True, 65),
                                 (300, 129, False, 0), (300, 70, True, 0)):
            cases.append((f"fp32 T={T} S={S} causal={causal} t0={t0} D={D}",
                          (3, 2, T, S, D, [S, max(S // 2 + 1, 1), 0],
                           causal, t0, T + S + D, False)))
    N, H, T, D = cs.GN_ATTN
    cases += [
        ("fp32 hala (2, 12, 1024, 64) causal",
         (2, 12, 1024, 1024, 64, [1024] * 2, True, 0, 21, True)),
        ("fp32 hala (2, 12, 1024, 64) causal, ragged",
         (2, 12, 1024, 1024, 64, cs.K6_RAGGED[:2], True, 0, 23, True)),
        ("fp32 (2, 12, 960, 1024, 64) causal t0=64, ragged",
         (2, 12, 960, 1024, 64, cs.K6_RAGGED[:2], True, 64, 24, False)),
        (f"fp32 --grad-norms {cs.GN_ATTN}",
         (N, H, T, T, D, [T] * N, False, 0, 41, True)),
        (f"fp32 --grad-norms {cs.GN_ATTN} x2, ragged, zero",
         (2, H, T, T, D, [200, 0], False, 0, 42, True))]
    for label, (N, H, T, S, D, kvl, causal, t0, seed, views) in cases:
        args = k6_args(torch, cs, flash_cuda, N, H, T, S, D, kvl, causal,
                       t0, seed, views=views, dtype=f32["dtype"])
        report(label, args, f32["tol"])
        if "--grad-norms" in label or "t0=64" in label:
            for dq, dkv in ((1, 1), (2, 2), (3, 3), (6, 6), (2, 5)):
                flash_cuda.bwd_f32_plan = forced_splits(flash_cuda, dq, dkv)
                try:
                    report(f"{label}, forced splits ({dq}, {dkv})", args,
                           f32["tol"])
                finally:
                    flash_cuda.bwd_f32_plan = plan


def checks_fwd_f32(torch, cs, flash, flash_cuda, pack_segments):
    """fp32 K5 (o within ATTN_TOL["float32"], lse within 1e-3) at the
    64-row tiles' edges (T, S at 1, 63, 64, 65, 127, 129, 300; t0 up to
    128; key lengths full, mid-tile and 0; D 64 and 32), at
    --grad-norms' shape (also x2 with key lengths [200, 0]) and at (2,
    12, 960, 1024) causal t0 = 64 with ragged lengths, each at the plan's
    splits and with other splits forced; fp32 K7 against
    ``_packed_reference``; the same bits twice each. -> labels that
    failed."""
    dev = torch.device("cuda", 0)
    tol = cs.ATTN_TOL["float32"]
    bad = []
    g = torch.Generator().manual_seed(7)

    def report(label, q, k, v, kvl, causal, t0):
        p = flash_cuda.fwd_f32_plan(*q.shape[:3], k.shape[2], q.shape[3],
                                    causal, t0, cs_sms)
        o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, causal, t0,
                                           with_lse=True)
        o2, lse2 = flash_cuda.flash_fwd_cuda(q, k, v, kvl, causal, t0,
                                             with_lse=True)
        torch.cuda.synchronize()
        o_e, lse_e = flash._reference(q, k, v, kvl, causal, t0,
                                      with_lse=True)
        ok, err, mean = cs.within(torch, o, o_e, tol)
        dl = (lse - lse_e).abs().max().item()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        ok = ok and dl <= 1e-3 and same
        print(f"{'ok ' if ok else 'BAD'} fp32 K5 {label} ({p.splits} "
              f"split(s), {p.blocks} blocks): max|d| {err:.3e} mean "
              f"{mean:.3e}, lse max|d| {dl:.3e}; same bits twice {same}",
              flush=True)
        if not ok:
            bad.append(f"fp32 K5 {label}")

    cs_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for D in (64, 32):
        for T, S, causal, t0 in ((1, 1, True, 0), (63, 63, True, 0),
                                 (64, 64, True, 0), (65, 65, True, 0),
                                 (127, 127, True, 0), (129, 129, True, 0),
                                 (300, 300, True, 0), (100, 300, True, 7),
                                 (129, 300, True, 62), (64, 300, True, 126),
                                 (1, 129, True, 128), (300, 300, False, 0),
                                 (128, 129, False, 0), (65, 300, False, 0)):
            q = torch.randn((3, 2, T, D), generator=g).to(dev)
            k, v = (torch.randn((3, 2, S, D), generator=g).to(dev)
                    for _ in range(2))
            kvl = torch.tensor([S, max(S // 2 + 1, 1), 0],
                               dtype=torch.int32, device=dev)
            report(f"T={T} S={S} causal={causal} t0={t0} D={D}", q, k, v,
                   kvl, causal, t0)
    N, H, T, D = cs.GN_ATTN
    plan = flash_cuda.fwd_f32_plan
    for label, (n, h, t, s_, causal, t0, lens) in (
            (f"--grad-norms {cs.GN_ATTN}", (N, H, T, T, False, 0, [T])),
            (f"--grad-norms {cs.GN_ATTN} x2, key lengths [200, 0]",
             (2, H, T, T, False, 0, [200, 0])),
            ("(2, 12, 960, 1024, 64) causal t0=64, ragged",
             (2, 12, 960, 1024, True, 64, cs.K6_RAGGED[:2]))):
        q = torch.randn((n, h, t, D), generator=g).to(dev)
        k, v = (torch.randn((n, h, s_, D), generator=g).to(dev)
                for _ in range(2))
        kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
        report(label, q, k, v, kvl, causal, t0)
        for p in (1, 2, 3, 6):
            flash_cuda.fwd_f32_plan = forced_fwd_splits(flash_cuda, p)
            try:
                report(f"{label}, forced splits {p}", q, k, v, kvl, causal,
                       t0)
            finally:
                flash_cuda.fwd_f32_plan = plan
    for label, args, kind in cases(torch, cs, pack_segments):
        if kind != "k7" or "ragged" not in label:
            continue
        q, k, v, seg, causal = args
        q, k, v = (x.float() for x in (q, k, v))
        for c in (True, False):
            got = flash_cuda.flash_packed_cuda(q, k, v, seg, c)
            again = flash_cuda.flash_packed_cuda(q, k, v, seg, c)
            ok, err, mean = cs.within(torch, got, flash._packed_reference(
                q, k, v, seg, c), tol)
            ok = ok and torch.equal(got, again)
            print(f"{'ok ' if ok else 'BAD'} fp32 {label} causal={c}: "
                  f"max|d| {err:.3e} mean {mean:.3e}", flush=True)
            if not ok:
                bad.append(f"fp32 {label} causal={c}")
    return bad


def checks(tree, backward_only=False):
    """Each piece of the design on its own input, then the main path's
    shapes and tile edges against the plain versions."""
    import torch
    cs, kernels, flash, flash_cuda, pack_segments = load(tree)
    kernels.library()
    print(f"build {kernels.build_seconds} s", flush=True)
    for line in ptxas_lines(kernels.build_log):
        print("ptxas:", line, flush=True)
    bad = checks_backward(torch, cs, flash, flash_cuda)
    if backward_only:
        return bad
    bad += checks_fwd_f32(torch, cs, flash, flash_cuda, pack_segments)
    dev = torch.device("cuda", 0)

    def report(label, got, want):
        tol = cs.ATTN_TOL[str(want.dtype).removeprefix("torch.")]
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


def clocks(tree):
    """fp32 K5 with its lse, K6a, then K6b, at hala's fp32 (2, 12, 1024,
    64) causal, each called back to back for ~2 s while ``nvidia-smi``
    samples the SM clock and the power draw every 100 ms: the median clock
    under the load, and each kernel's FFMA rate (its operations over its
    time, as chip_smoke.attn_bound and k6_bound count them: 2, 3 or 4
    products a (query, key) pair) against the card's 128 FFMA a clock an
    SM at that clock and at the data sheet's 67 TFLOP/s."""
    import statistics
    import time
    import torch
    cs, kernels, flash, flash_cuda, _ = load(tree)
    kernels.library()
    N, H, T, D = 2, 12, 1024, 64
    args = k6_args(torch, cs, flash_cuda, N, H, T, T, D, [T] * N, True, 0,
                   21, dtype=torch.float32)
    b = flash_cuda._bwd_args(*args)
    flash_cuda._bwd_dq(b)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = N * T * (T + 1) // 2
    q, k, v, kvl = args[:4]
    for name, fn, products, elem in (
            ("K5-lse", lambda b: flash_cuda.flash_fwd_cuda(
                q, k, v, kvl, True, 0, with_lse=True), 2, cs.ATTN_ELEM),
            ("K6a", flash_cuda._bwd_dq, 3, cs.K6_ELEM),
            ("K6b", flash_cuda._bwd_dkv, 4, cs.K6_ELEM)):
        ms = cs.cuda_ms(lambda: fn(b))
        flops = 2.0 * products * pairs * H * D + elem * pairs * H
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        try:
            end = time.time() + 2.0
            while time.time() < end:
                for _ in range(50):
                    fn(b)
                torch.cuda.synchronize()
        finally:
            smi.terminate()
            out = smi.communicate(timeout=30)[0]
        rows = [[float(x) for x in line.split(",")]
                for line in out.splitlines() if line.strip()]
        mhz = statistics.median(r[0] for r in rows[2:] or rows)
        watts = statistics.median(r[1] for r in rows[2:] or rows)
        rate = flops / ms / 1e9
        peak = 128 * 2 * sms * mhz * 1e6 / 1e12
        print(f"{name} fp32 ({N}, {H}, {T}, {D}) causal: {ms:.4f} ms, "
              f"{rate:.1f} TFLOP/s; SM clock under load {mhz:.0f} MHz "
              f"({len(rows)} samples), power {watts:.1f} W: {rate / peak:.1%}"
              f" of {peak:.1f} TFLOP/s at that clock, {rate / 67:.1%} of "
              f"the data sheet's 67", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--against", type=Path)
    ap.add_argument("--backward", action="store_true",
                    help="check and time K6a and K6b only")
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --against or --times-only: no rates")
    ap.add_argument("--clocks", action="store_true",
                    help="fp32 K6a/K6b's FFMA rate beside the SM clock")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe needs one GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if a.times_only:
        res = times(a.tree, a.backward)
        if not a.kernels_only:
            res.update(rates(a.tree, a.backward))
        print(json.dumps(res), flush=True)
        return
    print(card, flush=True)
    if a.clocks:
        clocks(a.tree)
        return
    if a.against:
        runs = []
        for tree in (a.against, a.tree, a.tree, a.against):
            flags = [f for f, on in (("--backward", a.backward),
                                     ("--kernels-only", a.kernels_only))
                     if on]
            r = subprocess.run([sys.executable, __file__, "--tree",
                                str(tree), "--times-only", *flags],
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
    bad = checks(a.tree, a.backward)
    for label, ms in times(a.tree, a.backward).items():
        print(f"{label}: {ms:.4f} ms", flush=True)
    if bad:
        raise SystemExit(f"disagree with the plain versions: {bad}")


if __name__ == "__main__":
    main()
