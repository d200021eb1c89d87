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
gives its launch. ``pairwise_lse`` picks the path:
  * under autograd (grad enabled and f or g requires it), the
    ``PairwiseLSE`` Function: K9a forward, K9b backward (df and dg from
    one joint softmax);
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
BWD_ROWS = 16         # K9b: frames per block (csrc/joint_lse_bwd.cu ROWS)
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


def pairwise_lse(f, g):
    """f (N, T, V), g (N, U+1, V) -> (N, T, U+1) fp32."""
    if torch.is_grad_enabled() and (f.requires_grad or g.requires_grad):
        return PairwiseLSE.apply(f, g)
    if f.device.type == "cpu":
        return _joint.pairwise_lse(f, g)
    return lse_fwd_cuda(f, g)


class PairwiseLSE(torch.autograd.Function):
    """K9a forward, K9b backward (haloop_tpu/ops/joint_pallas.py _lse_fwd
    / _lse_bwd)."""

    @staticmethod
    def forward(ctx, f, g):
        if f.device.type == "cpu":
            lse = _joint.pairwise_lse(f, g)
        else:
            lse = lse_fwd_cuda(f, g)
        ctx.save_for_backward(f, g, lse)
        return lse

    @staticmethod
    def backward(ctx, dlse):
        f, g, lse = ctx.saved_tensors
        if f.device.type == "cpu":
            df, dg = _joint.pairwise_lse_grad(f, g, lse, dlse)
        else:
            df, dg = lse_bwd_cuda(f, g, lse, dlse)
        return df.to(f.dtype), dg.to(g.dtype)


def _check(name, f, g):
    if f.dim() != 3 or g.dim() != 3 or f.shape[0] != g.shape[0] or \
            f.shape[2] != g.shape[2]:
        raise ValueError(f"{name}: f and g must be (N, T, V) and (N, U+1, V), "
                         f"got {tuple(f.shape)} and {tuple(g.shape)}")
    kernels.require_cuda(name, f, g, dtypes=(torch.float32,))


def lse_fwd_cuda(f, g):
    """K9a: one launch, any V."""
    global launches
    N, T, V = f.shape
    U1 = g.shape[1]
    f, g = f.contiguous(), g.contiguous()
    _check("pairwise_lse", f, g)
    lse = torch.empty((N, T, U1), dtype=torch.float32, device=f.device)
    if lse.numel() == 0:
        return lse
    p = plan(N, T, U1, V)
    vec = V % 4 == 0 and f.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    err = kernels.library().hl_joint_lse(
        f.data_ptr(), g.data_ptr(), lse.data_ptr(), N, T, U1, V, p.nq,
        p.chunks, p.smem, int(vec), kernels.stream_of(f))
    kernels.check(err, "hl_joint_lse")
    launches += 1
    return lse


def lse_bwd_cuda(f, g, lse, dlse):
    """K9b: (df (N, T, V), dg (N, U+1, V)) fp32."""
    global bwd_launches
    N, T, V = f.shape
    U1 = g.shape[1]
    f, g = f.contiguous(), g.contiguous()
    lse, dlse = lse.float().contiguous(), dlse.float().contiguous()
    _check("pairwise_lse_grad", f, g)
    if lse.shape != (N, T, U1) or dlse.shape != (N, T, U1):
        raise ValueError(f"pairwise_lse_grad: lse and dlse must be "
                         f"{(N, T, U1)}")
    kernels.require_cuda("pairwise_lse_grad", f, lse, dlse)
    if 2 * BWD_ROWS * U1 * 4 > SMEM_LIMIT:
        raise ValueError(f"pairwise_lse_grad: {U1} joint rows do not fit the "
                         "kernel's shared memory")
    df = torch.empty_like(f)
    dg = torch.empty_like(g)
    if f.numel() == 0 or g.numel() == 0:
        return df.zero_(), dg.zero_()
    # each block's partial dg, summed over the frame tiles in a fixed order
    tiles = (T + BWD_ROWS - 1) // BWD_ROWS
    partial = torch.empty((N, tiles, U1, V), dtype=torch.float32,
                          device=f.device)
    err = kernels.library().hl_joint_lse_bwd(
        f.data_ptr(), g.data_ptr(), lse.data_ptr(), dlse.data_ptr(),
        df.data_ptr(), dg.data_ptr(), partial.data_ptr(), N, T, U1, V,
        kernels.stream_of(f))
    kernels.check(err, "hl_joint_lse_bwd")
    bwd_launches += 1
    return df, dg
