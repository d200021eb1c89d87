"""Build and load the hand-written CUDA kernels.

Every ``haloop_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``), one compiler process per file, all started together,
and linked into one shared library with a plain C interface,
``build/haloop_tpu_torch/libkernels.so`` under the repository root, which
is loaded with ``ctypes``. The build happens at the first launch and again
whenever the sources' hash changes; importing this module builds nothing,
so the CPU tests (which have no ``nvcc``) import it freely.

Each C entry point returns the ``cudaError_t`` of its launches; ``check``
turns a nonzero code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build" / "haloop_tpu_torch"
LIB = BUILD / "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # xp, w, h0, c, ys, h_last, acts, cs, T, B, H, bf16, plan (host
    # int[10] in bf16, int[11] in fp32, or null), barrier word, stream
    "hl_lstm_fwd": [_P] * 8 + [_I] * 4 + [_P] * 3,
    # dys, acts, cs, c0, wt, dh_init, dc, dgates, dh0, T, B, H, bf16, plan,
    # barrier word, stream
    "hl_lstm_bwd": [_P] * 9 + [_I] * 4 + [_P] * 3,
    # cluster size, out (host int[5])
    "hl_lstm_card": [_I, _P],
    # xp, wq, sdiv, h0, c, hq, ys, h_last, acts, cs, T, B, H, bf16, plan
    # (host int[10] or null), barrier word, stream
    "hl_lstm_fwd_q8": [_P] * 10 + [_I] * 4 + [_P] * 3,
    # dys, acts, cs, c0, w (wq, or wq^T without a plan), s, dh_init, dc,
    # dgates, dh0, dgs, pmax, q, mq, T, B, H, plan, barrier words, stream
    "hl_lstm_bwd_q8": [_P] * 14 + [_I] * 3 + [_P] * 3,
    # log_probs, targets, input_lengths, target_lengths, loss, hist,
    # T, N, C, U, the plan (K, sweep warps, loader warps, frames, depth,
    # smem), stream
    "hl_ctc_fwd": [_P] * 6 + [_I] * 10 + [_P],
    # log_probs, targets, input_lengths, target_lengths, hist, loss, g,
    # dlogp, T, N, C, U, the plan (K, sweep warps, scatter warps, frames,
    # depth, dense, smem), stream
    "hl_ctc_bwd": [_P] * 8 + [_I] * 11 + [_P],
    # f, g, lse, mf, mg, N, T, U1, V, the plan (nq,
    # chunks, smem), vec, stream
    "hl_joint_lse": [_P] * 5 + [_I] * 8 + [_P],
    # f, g, lse, dlse, mf, mg, df, dg, N, T, U1, V, the plan (nq, chunks,
    # tchunks, warps, smem), vec, stream
    "hl_joint_lse_bwd": [_P] * 8 + [_I] * 10 + [_P],
    # star_lp, star_targets, input_lengths, target_lengths, loss, hist,
    # penalty, T, N, C2, U, the plan (K, sweep warps, loader warps, frames,
    # depth, smem), stream
    "hl_star_fwd": [_P] * 6 + [_F] + [_I] * 10 + [_P],
    # star_lp, star_targets, input_lengths, target_lengths, hist, loss, g,
    # dlp, penalty, T, N, C2, U, the plan (K, sweep warps, scatter warps,
    # frames, depth, dense, smem), stream
    "hl_star_bwd": [_P] * 8 + [_F] + [_I] * 11 + [_P],
    # q, k, v, kv_lengths, seg, o, lse, part, counters, dims (host
    # int[17]), causal, t0, bf16, splits (fp32), stream
    "hl_flash_fwd": [_P] * 10 + [_I] * 4 + [_P],
    # q, k, v, o, do, kv_lengths, lse, scratch, dq, part, counters, dims
    # (host int[29]), causal, t0, bf16, splits (fp32), stream
    "hl_flash_bwd_dq": [_P] * 12 + [_I] * 4 + [_P],
    # q, k, v, do, kv_lengths, lse, scratch, dk, dv, part, counters, dims
    # (host int[29]), causal, t0, bf16, splits (fp32), stream
    "hl_flash_bwd_dkv": [_P] * 12 + [_I] * 4 + [_P],
    # x, w, targets, nll, lse, partial, N, V, D, chunks, grid, bf16, stream
    "hl_fused_ce": [_P] * 6 + [_I] * 6 + [_P],
    # q, k_new, v_new, k_cache, v_cache, starts, y, B, S, E, H, length,
    # q_sb, kn_sb, vn_sb, bf16, the plan (cluster, span, depth, smem),
    # stream
    "hl_decode_attn": [_P] * 7 + [_I] * 13 + [_P],
    # (no arguments): K11's kernel launches so far
    "hl_decode_kernels": [],
    # q, k_new, v_new, k_cache, v_cache, starts, y, part, counters, B, S,
    # E, H, length, rows, q_sb, kn_sb, vn_sb, bf16, stream
    "hl_decode_attn_split": [_P] * 9 + [_I] * 10 + [_P],
    # (no arguments): K12's kernel launches so far
    "hl_decode_split_kernels": [],
    # x, w, scale, y, M, N, K, x_bf16, scale_bf16, aligned, kind, grid,
    # cl, kr, stream
    "hl_q8_matmul": [_P] * 4 + [_I] * 10 + [_P],
    # stream
    "hl_empty": [_P],
}

# the entry points of a trace_phases build: each copies its file's stamps
# (PHASES x PHASE_ITEMS int64, csrc/sm90.cuh) of the last launch out
PHASE_ENTRIES = ("hl_k11_phases", "hl_ctc_fwd_phases", "hl_star_fwd_phases",
                 "hl_ctc_bwd_phases", "hl_star_bwd_phases",
                 "hl_joint_bwd_phases", "hl_lstm_fwd_phases",
                 "hl_lstm_bwd_phases", "hl_lstm_q8_phases")
PHASES, PHASE_ITEMS = 8, 4096
# the ablations a trace_phases build may compile in (scripts/lstm_probe.py
# --phases): the bf16 and int8 persistent product (csrc/persist.cuh)
# without its ring's loads or without its mma.sync, the fp32 one
# (csrc/persist_f32.cuh) without W's streamed slices or with its
# shared-memory operands loaded once a slice
ABLATIONS = ("HL_ABLATE_LOADS", "HL_ABLATE_MMA", "HL_ABLATE_W_STREAM",
             "HL_ABLATE_OPERAND_LOADS")

_lib = None
_build_error = None      # the failed build's error, raised again
_sms = {}                # device index -> multiprocessors
build_seconds = None     # wall time of the last build in this process
build_log = ""           # nvcc's output of that build (ptxas -v lines)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def sources_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the CUDA kernels can only be built where the CUDA "
                       "toolkit is installed")


def build():
    """Compile csrc/*.cu into LIB unless an up-to-date build exists.
    Returns the library path."""
    global build_seconds, build_log
    digest = sources_hash()
    stamp = LIB.with_suffix(".sha256")
    if LIB.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB
    nvcc = _nvcc()
    objs = BUILD / f"obj.{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    # one nvcc per source, all at once; then one link
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"),
               str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    log = []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    cmd = [nvcc, "-shared", "-o", str(tmp),
           *sorted(str(p) for p in objs.glob("*.o"))]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    shutil.rmtree(objs)
    os.replace(tmp, LIB)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(log) + r.stdout + r.stderr
    return LIB


def trace_phases(*ablations):
    """Build, at the first launch, with the kernels' phase stamps compiled
    in (``-DHL_PHASES``; ``csrc/sm90.cuh`` stamp / keep_phase) into a
    library of its own beside the plain one, and bind the entry points
    that copy the stamps out: the --phases runs of scripts/decode_probe.py,
    scripts/lattice_probe.py, scripts/joint_probe.py and
    scripts/lstm_probe.py. ``ablations`` are further macros compiled in
    (``-D<name>``, ABLATIONS: parts of a kernel left out, whose results are
    wrong and whose times are the point), each set in a library of its
    own. Call it before ``library``."""
    global BUILD, LIB
    if _lib is not None:
        raise RuntimeError("trace_phases: the plain library is loaded")
    unknown = set(ablations) - set(ABLATIONS)
    if unknown:
        raise ValueError(f"trace_phases: no ablation {sorted(unknown)}")
    if "-DHL_PHASES" not in NVCC_FLAGS:
        NVCC_FLAGS.append("-DHL_PHASES")
        NVCC_FLAGS.extend(f"-D{a}" for a in ablations)
        BUILD = BUILD.with_name("_".join(
            [BUILD.name, "phases", *(a.lower() for a in ablations)]))
        LIB = BUILD / LIB.name
        for name in PHASE_ENTRIES:
            _SIGNATURES[name] = [_P]


def library():
    """The loaded kernel library, built on first use. A build that failed
    is not tried again in the same process: its error is raised again."""
    global _lib, _build_error
    if _build_error is not None:
        raise _build_error
    if _lib is None:
        try:
            path = build()
        except RuntimeError as e:
            _build_error = e
            raise
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(tensor):
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


def multiprocessors(device):
    """The streaming multiprocessors of ``device`` (132 on an H100 SXM),
    read once a device."""
    import torch
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _sms[idx]


def require_cuda(name, *tensors, dtypes=None):
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device (and, with ``dtypes``, of one of those dtypes)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on {dev}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if dtypes is not None and t.dtype not in dtypes:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
