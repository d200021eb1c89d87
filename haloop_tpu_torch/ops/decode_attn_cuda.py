"""Kernels K11 and K12: one-token decode attention over a flat (B, S, E)
KV cache in CUDA (``csrc/decode_attn.cu``).

Both mirror ``haloop_tpu.ops.decode_attn``: the new token's k/v row is
written into the caches at row ``length`` (in place; only that row) and y
(B, E) is returned. K11 (``decode_attend_update``) takes caches up to the
JAX package's 10 MiB a row and keeps the TPU kernel's whole-row softmax,
its normalized p rounded to the cache dtype: a block of 256 threads a
(row, head), or, on the tensor cores, a thread-block cluster of up to 8
blocks that split the attended rows where B x H blocks would leave the
card idle and the fill is long (``plan``). Its k and v chunks are all
requested at once by cp.async into a shared-memory ring (streaming
through it where they do not fit), the scores go to shared memory, the
max and sum take one exchange each (through distributed shared memory
across a cluster), and the blocks' p . v sums merge in rank order; in
bf16 with heads of 32, 64 or 128 both products run on the tensor cores
(``tensor_cores``: mma.sync, q and the rounded p as row 0 of A),
elsewhere on the CUDA cores. K12
(``decode_attend_update_gridded``) splits S across blocks, each split one
pass over tiles of k and v in an online softmax, and the last split of a
(row, head) to finish merges the splits' partials in split order, all in
one launch. ``route`` picks the wrapper by shape, as the JAX package
does. A CPU tensor takes the plain ``ops.decode_attn.decode_attend``; a
CUDA tensor launches the kernel or raises.
"""

import functools
from typing import NamedTuple

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.kernels import multiprocessors
from haloop_tpu_torch.ops import decode_attn as _da

K11_CACHE_LIMIT = 10 * 2 ** 20   # bytes of one row's k and v caches
THREADS = 128                    # csrc/decode_attn.cu: K12's block size
K11_THREADS = 256                # and K11's
WARPS = K11_THREADS // 32
# K11 (csrc/decode_attn.cu): a thread's ring slots when its chunks stream,
# the largest cluster, the dynamic shared memory a plan may take (a block's
# 227 KB less the kernel's static arrays), and the fewest attended rows
# that take a cluster (B=1 on an H100, each cluster size forced by
# scripts/decode_probe.py --clusters: one block a head read faster than a
# cluster of 8 up to 416 rows and level at 512; the cluster of 8 fastest
# from 640 rows on, 0.01098 ms against one block's 0.01178 and a cluster
# of 4's 0.01133; PERF.md)
K11_DEPTH, K11_MAX_CLUSTER, K11_SMEM = 16, 8, 225280
K11_CLUSTER_MIN_ROWS = 640
# K11 on the tensor cores: rows a warp's chunk, a warp's ring slots of a
# chunk when its chunks stream
TC_ROWS, TC_DEPTH = 16, 4
# K12's tiling, as csrc/decode_attn.cu's K12<T, D> has it (16 bytes a lane
# of k and of v): WARPS warps, ITER steps of 32 lanes each a tile, and
# BLOCKS_PER_SM resident blocks an SM (the static_assert there)
K12_WARPS, K12_ITER, K12_BLOCKS_PER_SM = 4, 4, 4
launches = 0                     # K11 calls (one launch each)
split_launches = 0               # K12 calls (one launch each)
_scratch = {}                    # (device, stream) -> (part, counters) of K12


def route(S, E, itemsize):
    """The wrapper a one-token step without entropy calls over a cache of
    S rows of E values (haloop_tpu/models/gpt.py:212-227): K11's when a
    row's k and v fit 10 MiB, else K12's when ``pick_s_block`` finds a
    block, else None (the plain head-split attention)."""
    if 2 * S * E * itemsize <= K11_CACHE_LIMIT:
        return decode_attend_update
    if _da.pick_s_block(S, E, itemsize) is not None:
        return decode_attend_update_gridded
    return None


class Plan(NamedTuple):
    cluster: int        # blocks a (row, head) takes, one cluster
    span: int           # rows a block holds scores for (whole steps)
    depth: int          # ring slots: a thread's 16-byte chunks, or on the
                        # tensor cores a warp's 16-row chunks
    smem: int           # bytes of dynamic shared memory a block


def tensor_cores(D, itemsize):
    """Whether K11 runs on the tensor cores (``decode_tc``: bf16 heads of
    32, 64 or 128) rather than on the CUDA cores (``decode``: one block a
    (row, head), no cluster)."""
    return itemsize == 2 and D in (32, 64, 128)


def step_rows(D, itemsize):
    """The rows K11 cuts a (row, head)'s runs in: on the tensor cores a
    warp's chunk of TC_ROWS; on the CUDA cores one step of its warps, 16
    bytes a lane, so a row takes D * itemsize / 16 lanes and a warp
    512 / (D * itemsize) rows."""
    if tensor_cores(D, itemsize):
        return TC_ROWS
    return WARPS * 32 * 16 // (D * itemsize)


@functools.lru_cache(maxsize=1024)
def plan(B, H, length, D, itemsize, sms):
    """K11's launch at fill level ``length`` (rows 0 .. length attended at
    most): on the tensor cores, from ``K11_CLUSTER_MIN_ROWS`` rows on, the
    cluster doubles, up to ``K11_MAX_CLUSTER``, while the B x H (row,
    head)s' clusters still fit the card's ``sms`` multiprocessors one block
    an SM and each rank keeps a step of rows (so only small batches at long
    fills take one: B=1 over 12 heads of 1001 rows takes 8); span is a
    rank's share of the rows in whole steps (``step_rows``); ``depth`` ring
    slots take a thread's 16-byte chunks (a k and a v chunk a step it
    takes; ``K11_DEPTH`` when they stream), or on the tensor cores a
    warp's chunks of TC_ROWS rows (``TC_DEPTH``), all of them where they
    fit. Raises ValueError where the scores do not fit in shared memory."""
    n = length + 1
    step = step_rows(D, itemsize)
    cluster = 1
    while tensor_cores(D, itemsize) and n >= K11_CLUSTER_MIN_ROWS and \
            cluster < K11_MAX_CLUSTER and B * H * 2 * cluster <= sms and \
            n >= 2 * cluster * step:
        cluster *= 2
    span = -(-(-(-n // cluster)) // step) * step
    if tensor_cores(D, itemsize):          # a warp's chunks, in slots
        units = 2 * -(-(span // TC_ROWS) // WARPS)
        depth = min(units, TC_DEPTH)
        smem = WARPS * depth * TC_ROWS * D * itemsize + span * 4
    else:                                  # a thread's 16-byte chunks
        units = 2 * -(-(span // (step // WARPS)) // WARPS)
        depth = min(units, K11_DEPTH)
        smem = depth * K11_THREADS * 16 + span * 4
    if smem > K11_SMEM:
        raise ValueError(f"decode_attend_update: the scores of {span} rows "
                         f"do not fit in shared memory")
    return Plan(cluster, span, depth, smem)


def tile_rows(D, itemsize):
    """Rows of one K12 tile at head width D: 16 bytes a lane, so a row
    takes D * itemsize / 16 lanes."""
    return K12_WARPS * K12_ITER * 32 * 16 // (D * itemsize)


def split_rows(B, H, n, D, itemsize, sms):
    """K12's split over the ``n`` rows up to the new one: the largest
    tile times a power of two that still gives each of the card's ``sms``
    multiprocessors eight rounds of its K12_BLOCKS_PER_SM resident blocks
    (short splits keep the last round's tail short; the rule comes from
    timing 256- to 2048-row splits on an H100, PERF.md), else one tile."""
    tile = tile_rows(D, itemsize)
    want = 8 * K12_BLOCKS_PER_SM * sms
    rows = tile
    while rows < n and B * H * -(-n // (2 * rows)) >= want:
        rows *= 2
    return rows


def kernel_launches():
    """The kernels K12's C entry has launched in this process (one a
    call; ``split_launches`` counts the calls)."""
    return kernels.library().hl_decode_split_kernels()


def k11_kernel_launches():
    """The kernels K11's C entry has launched in this process (one a
    call; ``launches`` counts the calls)."""
    return kernels.library().hl_decode_kernels()


def _k12_scratch(device, stream, n_part, n_ctr):
    """K12's fp32 partials and int32 counters on ``device``, kept between
    calls: the kernel leaves the counters 0, and calls run in the order
    of the stream they share, so each stream has its own."""
    key = device.index, stream
    part, ctr = _scratch.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if ctr is None or ctr.numel() < n_ctr:
        ctr = torch.zeros(n_ctr, dtype=torch.int32, device=device)
    _scratch[key] = part, ctr
    return part, ctr


def decode_attend_update(q, k_new, v_new, k_cache, v_cache, length,
                         starts=None, *, n_head):
    """K11 -> y (B, E); k_cache and v_cache updated at row ``length``."""
    if q.device.type == "cpu":
        return _da.decode_attend(q, k_new, v_new, k_cache, v_cache, length,
                                 starts, n_head=n_head)
    return decode_attn_cuda(q, k_new, v_new, k_cache, v_cache, length,
                            starts, n_head=n_head)


def decode_attend_update_gridded(q, k_new, v_new, k_cache, v_cache, length,
                                 starts=None, *, n_head):
    """K12 -> y (B, E); k_cache and v_cache updated at row ``length``."""
    if q.device.type == "cpu":
        return _da.decode_attend(q, k_new, v_new, k_cache, v_cache, length,
                                 starts, n_head=n_head)
    return decode_attn_split_cuda(q, k_new, v_new, k_cache, v_cache, length,
                                  starts, n_head=n_head)


def _check(name, q, k_new, v_new, k_cache, v_cache, length, starts,
           n_head):
    """The device, dtype and shape rules both kernels share -> (length,
    starts as int32 or None)."""
    B, S, E = k_cache.shape
    kernels.require_cuda(name, k_cache, v_cache,
                         dtypes=(torch.bfloat16, torch.float32))
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{name}: k and v caches differ")
    for what, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, E) or t.dtype != k_cache.dtype or \
                t.device != k_cache.device or t.stride(1) != 1:
            raise ValueError(f"{name}: {what} must be a (B, E) "
                             f"{k_cache.dtype} tensor on the cache's device "
                             f"with contiguous rows")
    D = E // n_head
    vec = 16 // k_cache.element_size()
    if E % n_head or THREADS % D or D % vec:
        raise ValueError(f"{name}: head_dim {D} must divide {THREADS} and "
                         f"be a multiple of {vec}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: caches must be 16-byte aligned")
    length = int(length)
    if not 0 <= length < S:
        raise ValueError(f"{name}: row {length} is outside the cache of {S} "
                         f"rows")
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
        kernels.require_cuda(name, starts)
        if starts.shape != (B,) or starts.device != k_cache.device:
            raise ValueError(f"{name}: starts must be (B,) on the cache's "
                             f"device")
    return length, starts


def decode_attn_cuda(q, k_new, v_new, k_cache, v_cache, length, starts=None,
                     *, n_head):
    """K11."""
    global launches
    B, S, E = k_cache.shape
    length, starts = _check("decode_attend_update", q, k_new, v_new,
                            k_cache, v_cache, length, starts, n_head)
    if 2 * S * E * k_cache.element_size() > K11_CACHE_LIMIT:
        raise ValueError(f"decode_attend_update: a cache of {S} x {E} "
                         f"{k_cache.dtype} rows is past K11's 10 MiB a row; "
                         f"route() sends it to K12")
    y = torch.empty((B, E), dtype=k_cache.dtype, device=k_cache.device)
    if B == 0:
        return y
    p = plan(B, n_head, length, E // n_head, k_cache.element_size(),
             multiprocessors(k_cache.device))
    err = kernels.library().hl_decode_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), starts.data_ptr() if starts is not None else None,
        y.data_ptr(), B, S, E, n_head, length, q.stride(0), k_new.stride(0),
        v_new.stride(0), int(k_cache.dtype == torch.bfloat16), *p,
        kernels.stream_of(k_cache))
    kernels.check(err, "hl_decode_attn")
    launches += 1
    return y


def decode_attn_split_cuda(q, k_new, v_new, k_cache, v_cache, length,
                           starts=None, *, n_head):
    """K12: one launch a call."""
    global split_launches
    B, S, E = k_cache.shape
    length, starts = _check("decode_attend_update_gridded", q, k_new, v_new,
                            k_cache, v_cache, length, starts, n_head)
    y = torch.empty((B, E), dtype=k_cache.dtype, device=k_cache.device)
    if B == 0:
        return y
    D = E // n_head
    rows = split_rows(B, n_head, length + 1, D, k_cache.element_size(),
                      multiprocessors(k_cache.device))
    stream = kernels.stream_of(k_cache)
    part, ctr = _k12_scratch(k_cache.device, stream,
                             B * n_head * (length // rows + 1) * (D + 2),
                             B * n_head)
    err = kernels.library().hl_decode_attn_split(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), starts.data_ptr() if starts is not None else None,
        y.data_ptr(), part.data_ptr(), ctr.data_ptr(), B, S, E, n_head,
        length, rows, q.stride(0), k_new.stride(0), v_new.stride(0),
        int(k_cache.dtype == torch.bfloat16), stream)
    kernels.check(err, "hl_decode_attn_split")
    split_launches += 1
    return y
