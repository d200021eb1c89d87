"""Kernels K9a and K9b: the RNN-T joint's logsumexp over the vocabulary
and its backward in CUDA (``csrc/joint_lse.cu``, ``csrc/joint_lse_bwd.cu``).

Mirrors ``haloop_tpu.ops.joint_pallas.pairwise_lse``:
f (N, T, V), g (N, U+1, V) fp32 -> lse[n, t, u] = logsumexp_v(f[n, t, v] +
g[n, u, v]) (N, T, U+1) fp32, never materializing the (N, T, U+1, V) joint.
K9a computes it in the factored form of ``ops.joint.pairwise_lse``: the
row maxima mf, mg over v, an fp32 product of e^(f - mf) and e^(g - mg)
streamed over V on the CUDA cores, mf + mg + log of it, and the cells
whose sum underflows (below ``joint.TINY``, where f and g peak at
different v) recomputed exactly in the same launch; any V. ``plan``
gives its launch. K9b computes df and dg in the factored form of
``ops.joint.pairwise_lse_grad`` from the row maxima K9a writes beside
lse: one block per (item, slice of 64 vocabulary columns) takes the
item's frames in one pass over f, dg summed over them in the block, the
marked cells' exact terms added in the same launch; past 32 rows of U+1
the grid also splits by chunk of rows, blocks of U+1's rows writing dg and
blocks of T's rows df; any V, any U+1.
``bwd_plan`` gives its launch. ``pairwise_lse`` picks the path:
  * under autograd (grad enabled and f or g requires it), the
    ``PairwiseLSE`` Function: K9a forward (lse with the row maxima), K9b
    backward;
  * otherwise K9a alone.
A CPU tensor takes the plain versions in ``ops.joint`` (through the same
Function under autograd); a CUDA tensor launches the kernels or raises.
"""

import functools
from typing import NamedTuple

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.ops import joint as _joint

SMEM_LIMIT = 232448   # bytes of shared memory a block may use (H100)
launches = 0          # K9a calls
bwd_launches = 0      # K9b calls

# K9a (csrc/joint_lse.cu): a block of WARPS warps per (item, tile of ROWS
# frames, chunk of up to 32 of the U+1 rows); its GROUPS half-warps split
# each stage of STAGE vocabulary columns; a ring of DEPTH stages
WARPS, ROWS, STAGE, DEPTH = 8, 32, 64, 4
GROUPS = 2 * WARPS


class Plan(NamedTuple):
    tiles: int          # frame tiles of ROWS
    nq: int             # float4 groups of a chunk's g rows
    chunks: int         # chunks of 4 nq of the U+1 rows
    blocks: int         # tiles x chunks x N
    stages: int         # STAGE-column stages of V
    ring: int           # bytes of the ring of DEPTH stages
    smem: int           # bytes of dynamic shared memory

    @property
    def rows(self):
        """g rows a chunk."""
        return 4 * self.nq


def _g_stride(nq):
    return 4 * nq if nq % 2 else 4 * nq + 4


@functools.lru_cache(maxsize=256)
def plan(N, T, U1, V):
    """K9a's launch (pure Python; the kernel's ``layout`` byte for byte):
    the U+1 rows in chunks of up to 32 (4 nq, the least that hold them
    where U+1 <= 32), frame tiles of 32, V in stages of 64 columns. At
    rnn-transducer:lstm:512's joint (16, 301, 25, 512): 10 tiles x 1
    chunk x 16 items = 160 blocks."""
    if min(N, T, U1, V) < 1:
        raise ValueError(f"pairwise_lse: empty shapes {(N, T, U1, V)}")
    nq = min(8, -(-U1 // 4))
    chunks = -(-U1 // (4 * nq))
    tiles = -(-T // ROWS)
    ring = DEPTH * (ROWS + 4 * nq) * (STAGE + 4) * 4
    smem = ring + 2 * STAGE * _g_stride(nq) * 4 + 3 * 32 * 4 + 2 * WARPS + 16
    if smem > SMEM_LIMIT:
        raise ValueError(f"pairwise_lse: {smem} bytes of shared memory")
    return Plan(tiles, nq, chunks, tiles * chunks * N, -(-V // STAGE), ring,
                smem)


# K9b (csrc/joint_lse_bwd.cu): a block of 8 or 4 warps per (item, slice of
# BWD_SLICE vocabulary columns, 2 a lane, and where U+1 passes one chunk,
# chunk of rows), in one linear grid; each warp takes BWD_FRAMES frames of
# each group; each thread's ring holds BWD_DEPTH frames
BWD_SLICE, BWD_FRAMES, BWD_DEPTH = 64, 4, 16


class BwdPlan(NamedTuple):
    slices: int         # BWD_SLICE-column slices of V
    nq: int             # float4 groups of a chunk of the U+1 rows
    chunks: int         # chunks of 4 nq of the U+1 rows
    tchunks: int        # chunks of 32 of the T rows where chunks > 1, else 0
    warps: int          # a block's warps
    groups: int         # groups of T, BWD_FRAMES frames a warp
    depth: int          # frames in flight a thread
    blocks: int         # slices x N, x (chunks + tchunks) where chunks > 1
    smem: int           # bytes of dynamic shared memory

    @property
    def rows(self):
        """Rows a chunk."""
        return 4 * self.nq

    @property
    def group(self):
        """Frames a group."""
        return self.warps * BWD_FRAMES


@functools.lru_cache(maxsize=256)
def bwd_plan(N, T, U1, V, sms=132):
    """K9b's launch (pure Python; the kernel's ``layout`` byte for byte):
    V in slices of 64 columns, a block each with the item. Where the U+1
    rows fit one chunk of up to 32 (4 nq, the least that hold them), the
    block streams T's frames past them, df and dg from one pass. Past 32
    rows the grid also splits by chunk of 32 rows: a block per chunk of
    U+1's rows streams T's frames (dg), a block per chunk of T's rows
    streams U+1's rows as its frames (df), each writing its rows' sums
    alone, so a long target fills the card and nothing is summed across
    blocks (those of T's rows first: the longer where U+1 > T). 8 warps a
    block, or 4 where the blocks fill the card's ``sms`` multiprocessors
    twice (two an SM then overlap one's set-up and merge with the other's
    frames: V = 16384 read 0.588 ms against 0.688, V = 512's 128 blocks
    0.0331 against 0.0258; PERF.md); frames in groups of 4 a warp. Shared
    memory: the threads' rings, each warp's row sums of a chunk, each
    warp's W rows of a group. At rnn-transducer:lstm:512's joint (16, 301,
    25, 512): 8 slices x 16 items = 128 blocks of 8 warps, one chunk of 28
    rows."""
    if min(N, T, U1, V) < 1:
        raise ValueError(f"pairwise_lse_grad: empty shapes {(N, T, U1, V)}")
    nq = min(8, -(-U1 // 4))
    uc = 4 * nq
    chunks = -(-U1 // uc)
    tchunks = -(-T // 32) if chunks > 1 else 0
    slices = -(-V // BWD_SLICE)
    blocks = slices * N * (chunks + tchunks if chunks > 1 else 1)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"pairwise_lse_grad: {blocks} blocks for one grid")
    warps = 4 if blocks >= 2 * sms else 8
    smem = 4 * (BWD_DEPTH * 32 * warps * 2 + warps * uc * BWD_SLICE +
                warps * BWD_FRAMES * uc)
    return BwdPlan(slices, nq, chunks, tchunks, warps,
                   -(-T // (warps * BWD_FRAMES)), BWD_DEPTH, blocks, smem)


def pairwise_lse(f, g):
    """f (N, T, V), g (N, U+1, V) -> (N, T, U+1) fp32."""
    if torch.is_grad_enabled() and (f.requires_grad or g.requires_grad):
        return PairwiseLSE.apply(f, g)
    if f.device.type == "cpu":
        return _joint.pairwise_lse(f, g)[0]
    return lse_fwd_cuda(f, g)[0]


class PairwiseLSE(torch.autograd.Function):
    """K9a forward, K9b backward (haloop_tpu/ops/joint_pallas.py _lse_fwd
    / _lse_bwd); the forward's row maxima saved for the backward."""

    @staticmethod
    def forward(ctx, f, g):
        if f.device.type == "cpu":
            lse, mf, mg = _joint.pairwise_lse(f, g)
        else:
            lse, mf, mg = lse_fwd_cuda(f, g)
        ctx.save_for_backward(f, g, lse, mf, mg)
        return lse

    @staticmethod
    def backward(ctx, dlse):
        f, g, lse, mf, mg = ctx.saved_tensors
        if f.device.type == "cpu":
            df, dg = _joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg)
        else:
            df, dg = lse_bwd_cuda(f, g, lse, dlse, mf, mg)
        return df.to(f.dtype), dg.to(g.dtype)


def _check(name, f, g):
    if f.dim() != 3 or g.dim() != 3 or f.shape[0] != g.shape[0] or \
            f.shape[2] != g.shape[2]:
        raise ValueError(f"{name}: f and g must be (N, T, V) and (N, U+1, V), "
                         f"got {tuple(f.shape)} and {tuple(g.shape)}")
    kernels.require_cuda(name, f, g, dtypes=(torch.float32,))


def lse_fwd_cuda(f, g):
    """K9a: one launch, any V. -> (lse (N, T, U+1), mf (N, T), mg (N,
    U+1)): the logsumexp and the row maxima, written by the same launch."""
    global launches
    N, T, V = f.shape
    U1 = g.shape[1]
    f, g = f.contiguous(), g.contiguous()
    _check("pairwise_lse", f, g)
    out = (torch.empty((N, T, U1), dtype=torch.float32, device=f.device),
           torch.empty((N, T), dtype=torch.float32, device=f.device),
           torch.empty((N, U1), dtype=torch.float32, device=f.device))
    if out[0].numel() == 0:
        return out
    p = plan(N, T, U1, V)
    vec = V % 4 == 0 and f.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    err = kernels.library().hl_joint_lse(
        f.data_ptr(), g.data_ptr(), *(x.data_ptr() for x in out), N, T, U1, V,
        p.nq, p.chunks, p.smem, int(vec), kernels.stream_of(f))
    kernels.check(err, "hl_joint_lse")
    launches += 1
    return out


def lse_bwd_cuda(f, g, lse, dlse, mf, mg):
    """K9b: one launch, any V and U+1. -> (df (N, T, V), dg (N, U+1, V))
    fp32."""
    global bwd_launches
    N, T, V = f.shape
    U1 = g.shape[1]
    f, g = f.contiguous(), g.contiguous()
    lse, dlse = lse.float().contiguous(), dlse.float().contiguous()
    mf, mg = mf.float().contiguous(), mg.float().contiguous()
    _check("pairwise_lse_grad", f, g)
    if lse.shape != (N, T, U1) or dlse.shape != (N, T, U1) or \
            mf.shape != (N, T) or mg.shape != (N, U1):
        raise ValueError(f"pairwise_lse_grad: lse and dlse must be "
                         f"{(N, T, U1)}, mf {(N, T)}, mg {(N, U1)}")
    kernels.require_cuda("pairwise_lse_grad", f, lse, dlse, mf, mg)
    df = torch.empty_like(f)
    dg = torch.empty_like(g)
    if f.numel() == 0 or g.numel() == 0:
        return df.zero_(), dg.zero_()
    p = bwd_plan(N, T, U1, V, kernels.multiprocessors(f.device))
    vec = V % 2 == 0 and all(x.data_ptr() % 8 == 0 for x in (f, g, df))
    err = kernels.library().hl_joint_lse_bwd(
        f.data_ptr(), g.data_ptr(), lse.data_ptr(), dlse.data_ptr(),
        mf.data_ptr(), mg.data_ptr(), df.data_ptr(), dg.data_ptr(), N, T, U1,
        V, p.nq, p.chunks, p.tchunks, p.warps, p.smem, int(vec),
        kernels.stream_of(f))
    kernels.check(err, "hl_joint_lse_bwd")
    bwd_launches += 1
    return df, dg
