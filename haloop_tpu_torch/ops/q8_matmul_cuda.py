"""Kernel K13: the int8-weight product y = (x @ w_q.T) * scale in CUDA
(``csrc/q8_matmul.cu``), for x of at most 64 rows.

Mirrors ``haloop_tpu.ops.q8_matmul.q8_matmul``: only the int8 bytes of
the weight cross device memory. A CPU tensor takes the plain
``ops.q8_matmul.q8_matmul``; a CUDA tensor launches the kernel or raises.
bf16 x takes one of two kernels (``plan``): persistent blocks that walk
64-column tiles of whole weight rows for long weights (lm_head), or
16-column stripes, with K split across a cluster of 2 or 4 blocks where
it is long, the ranks' partials summed in rank order.
"""

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.kernels import multiprocessors
from haloop_tpu_torch.ops import q8_matmul as _q8

launches = 0                     # K13 calls
WARPS = 8                        # csrc/q8_matmul.cu: WARPS (q8_stripes)
# q8_persist as csrc/q8_matmul.cu's launch_bf16 instantiates it,
# Persist<MT, NW, WC, NT, CPW>: NW warps, WC column groups, NT 8-column
# tiles a group, and Persist::STAGES
PERSIST_WARPS, PERSIST_WC, PERSIST_NT, PERSIST_STAGES = 16, 4, 2, 3
PERSIST_NB = 8 * PERSIST_NT * PERSIST_WC     # columns a tile
BLOCK_SMEM = 232448              # an H100 block's shared memory at most


def persist_smem(M, K):
    """q8_persist's dynamic shared memory: x (16 MT rows of K rounded up
    to 64, bf16), the ring of tiles (PERSIST_NB columns x that K, int8),
    and all but one k group's sums of a tile in fp32."""
    mt, kp = -(-M // 16), -(-K // 64) * 64
    wk = PERSIST_WARPS // PERSIST_WC
    return 16 * mt * kp * 2 + PERSIST_STAGES * PERSIST_NB * kp + \
        (wk - 1) * mt * PERSIST_NB * 16 * 4


def plan(M, N, K, aligned, sms):
    """K13's launch for bf16 x -> (kind, grid, cluster size, k a rank).
    Kind 1 (q8_persist) where the weight has at least two 64-column tiles
    an SM, x at most 32 rows and the whole call's shared memory fits: one
    block an SM. Else kind 0 (q8_stripes): a block a 16-column tile, in
    clusters of the fewest blocks (1, 2, 4) that leave each warp at most
    two 64-k chunks (one when x has more than 32 rows) of the rank's k,
    every rank some k."""
    if aligned and M <= 32 and -(-N // PERSIST_NB) >= 2 * sms and \
            persist_smem(M, K) <= BLOCK_SMEM:
        return 1, min(-(-N // PERSIST_NB), sms), 1, -(-K // 64) * 64
    per_block = WARPS * (2 if M <= 32 else 1)          # chunks a round
    cl = 1
    while cl < 4 and -(-K // (64 * cl)) > per_block and \
            (2 * cl - 1) * (-(-K // (128 * cl)) * 64) < K:
        cl *= 2
    return 0, -(-N // 16) * cl, cl, -(-K // (64 * cl)) * 64


def q8_matmul(x, w_q, scale):
    """x (M <= 64, K) bf16 or fp32, w_q (N, K) int8, scale (N,) bf16 or
    fp32 -> (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return _q8.q8_matmul(x, w_q, scale)
    return q8_matmul_cuda(x, w_q, scale)


def q8_matmul_cuda(x, w_q, scale):
    """K13."""
    global launches
    kernels.require_cuda("q8_matmul", x, w_q, scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q8_matmul: unsupported dtype {x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"q8_matmul: the weight must be int8, not "
                        f"{w_q.dtype}")
    if scale.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q8_matmul: unsupported scale dtype {scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[1] or \
            scale.shape != (w_q.shape[0],):
        raise ValueError(f"q8_matmul: shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)} "
                         f"do not make (M, K) . (N, K)^T with (N,) scales")
    M, K = x.shape
    N = w_q.shape[0]
    if M > _q8.MAX_ROWS:
        raise ValueError(f"q8_matmul: {M} rows; the kernel takes at most "
                         f"{_q8.MAX_ROWS}")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_()
    aligned = K % 16 == 0 and x.data_ptr() % 16 == 0 and \
        w_q.data_ptr() % 16 == 0
    kind, grid, cl, kr = plan(M, N, K, aligned, multiprocessors(x.device))
    err = kernels.library().hl_q8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), M, N,
        K, int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        int(aligned), kind, grid, cl, kr, kernels.stream_of(x))
    kernels.check(err, "hl_q8_matmul")
    launches += 1
    return y


def q8_bulk_cuda(x, w_q, scale):
    """``q8_bulk`` (kind 2 of ``hl_q8_matmul``): the stripes without a
    cluster, their rows brought into shared memory by cp.async.bulk, for
    bf16 x, 16-byte aligned, where ``plan`` picks such stripes (the same
    bits then). No plan picks it: ``scripts/decode_probe.py`` times it
    against K13 (not counted)."""
    M, K = x.shape
    N = w_q.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    kernels.check(kernels.library().hl_q8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), M, N,
        K, 1, int(scale.dtype == torch.bfloat16), 1, 2, -(-N // 16), 1,
        -(-K // 64) * 64, kernels.stream_of(x)), "hl_q8_matmul")
    return y


def empty_kernel(device):
    """Launch an empty kernel on ``device``'s current stream (not counted):
    timed beside K13, the floor of one launch under the same timing."""
    kernels.check(kernels.library().hl_empty(
        torch.cuda.current_stream(device).cuda_stream), "hl_empty")
