"""Kernels K5, K6a/K6b and K7: flash attention in CUDA. The forward
(``csrc/flash_fwd.cu``) with per-batch key lengths and causal offset
(K5), or with per-token segment ids for packed rows (K7), and the
backward of K5 (``csrc/flash_bwd.cu``): dq (K6a), then dk and dv (K6b).
In bf16 each is a warp-specialized Hopper kernel (wgmma fed by TMA
through an mbarrier ring), in fp32 a CUDA-core one (exact FFMA in
register tiles of 64 rows; where the output tiles alone leave SMs idle K5
splits its keys, ``fwd_f32_plan``, and K6a and K6b their reduction,
``bwd_f32_plan``, over blocks, and the splits merge in split order inside
the launch; K7 runs unsplit).

Mirrors ``haloop_tpu.ops.flash.flash_attention`` and
``flash_attention_packed``:
  * ``flash_attention(q, k, v, kv_lengths, causal, t0)``: under autograd
    (grad enabled and q, k or v requiring it) the ``FlashAttention``
    Function, whose forward is K5 with the row lse and whose backward is
    K6a then K6b from that lse (``flash_bwd_cuda``); otherwise K5 alone.
  * ``flash_attention_packed(q, k, v, segment_ids, causal)``: under
    autograd the ``FlashAttentionPacked`` Function (K7 forward, a
    backward that recomputes through ``_packed_reference``, as the JAX
    package's does); otherwise K7 alone.
A CPU tensor takes the plain versions in ``ops.flash``; a CUDA tensor
launches the kernel or raises.

q (N, H, T, D), k, v (N, H, S, D) may be strided views (the GPT's
head-split q/k/v are views of its fused projection); each row of D must
be contiguous and 16-byte aligned. The kernels write o, dq, dk and dv in
(N, T, H, D) memory order and return them as (N, H, T, D) views, so the
caller's swap back to (N, T, H*D) costs no copy. The backward takes the
output gradient's rows where autograd puts them (the GPT's is a
head-split view of the c_proj input's gradient: no copy); only a
gradient whose rows are not contiguous and 16-byte aligned (an expanded
one, from ``o.sum()``) is copied first. delta = rowsum(do * o) is K6a's
prologue, not a separate pass; K6a writes it, with the lse in base 2,
into a scratch that K6b reads (``_scratch``).
"""

import ctypes
from types import SimpleNamespace

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.ops import flash as _flash

HEAD_DIMS = (32, 64)          # the head widths the kernel is built for
F32_TILE = 64                 # fp32 K5/K6a/K6b: query rows and keys a tile
_counters = {}                # (device, stream) -> fp32 split counters
launches = 0                  # K5 calls
lse_launches = 0              # K5 calls that also write the lse
packed_launches = 0           # K7 calls
bwd_dq_launches = 0           # K6a calls
bwd_dkv_launches = 0          # K6b calls


def flash_attention(q, k, v, kv_lengths, causal=False, t0=0):
    """-> o (N, H, T, D) in v's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_lengths, causal, t0)[0]
    if q.device.type == "cpu":
        return _flash._reference(q, k, v, kv_lengths, causal, t0)
    return flash_fwd_cuda(q, k, v, kv_lengths, causal, t0)


def flash_attention_packed(q, k, v, segment_ids, causal=True):
    """q, k, v (N, H, T, D), segment_ids (N, T) -> o (N, H, T, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionPacked.apply(q, k, v, segment_ids, causal)
    if q.device.type == "cpu":
        return _flash._packed_reference(q, k, v, segment_ids, causal)
    return flash_packed_cuda(q, k, v, segment_ids, causal)


class FlashAttention(torch.autograd.Function):
    """K5 forward with the row lse -> (o, lse (N, H, T) fp32); the
    backward is K6a and K6b from that lse (``_backward_reference`` on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal, t0):
        if q.device.type == "cpu":
            o, lse = _flash._reference(q, k, v, kv_lengths, causal, t0,
                                       with_lse=True)
        else:
            o, lse = flash_fwd_cuda(q, k, v, kv_lengths, causal, t0,
                                    with_lse=True)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, kv_lengths, o, lse)
        ctx.causal, ctx.t0 = causal, t0
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kv_lengths, o, lse = ctx.saved_tensors
        args = (q, k, v, kv_lengths, ctx.causal, ctx.t0, o, lse, do)
        if q.device.type == "cpu":
            dq, dk, dv = _flash._backward_reference(*args)
        else:
            dq, dk, dv = flash_bwd_cuda(*args)
        return dq, dk, dv, None, None, None


class FlashAttentionPacked(torch.autograd.Function):
    """K7 forward; the backward recomputes through the materialized
    ``_packed_reference`` under autograd (the JAX package's
    ``_packed_bwd``: no backward kernel there either)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal):
        ctx.save_for_backward(q, k, v, segment_ids)
        ctx.causal = causal
        if q.device.type == "cpu":
            return _flash._packed_reference(q, k, v, segment_ids, causal)
        return flash_packed_cuda(q, k, v, segment_ids, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, segment_ids = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = _flash._packed_reference(*qkv, segment_ids, ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, qkv, g)
        return dq, dk, dv, None, None


def _check(name, q, k, v, *more):
    for t in (q, k, v, *more):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.bfloat16,
                                                 torch.float32):
            raise TypeError(f"{name}: q, k, v must share one dtype, bf16 "
                            f"or fp32; got {q.dtype}, {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected (N, H, T, D) tensors")
        if not _rows_ok(t):
            raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                             "aligned, strides multiples of 16 bytes under "
                             "2^40")
    N, H, T, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (N, H) or k.shape[3] != D:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not agree")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} is not one of {HEAD_DIMS}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: o and do must be shaped as q "
                         f"{tuple(q.shape)}")


def _rows_ok(t):
    """Whether the kernels take t's rows where they are: contiguous and
    16-byte aligned, every byte stride a multiple of 16 and under 2^40
    (the rule of the TMA tensor maps that the bf16 forward reads q, k and v
    through; the one statement of that rule)."""
    align = 16 // t.element_size()
    return t.dim() == 4 and t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
        and not any(s % align or s * t.element_size() >= 1 << 40
                    for s in t.stride()[:3])


def _heads_last(N, H, T, D, like):
    """An (N, H, T, D) view of a fresh (N, T, H, D) tensor."""
    return torch.empty((N, T, H, D), dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _launch(name, q, k, v, kv_lengths, seg, causal, t0, with_lse):
    N, H, T, D = q.shape
    S = k.shape[2]
    o = _heads_last(N, H, T, D, q)
    lse = torch.empty((N, H, T), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0:
        return o, lse
    dims = [N, H, T, S, D] + _strides(q, k, v, o)
    dims = (ctypes.c_int * len(dims))(*dims)
    bf16 = q.dtype == torch.bfloat16
    splits, part, ctr = 1, None, None
    if not bf16 and seg is None:         # fp32 K7 runs unsplit
        plan = fwd_f32_plan(N, H, T, S, D, causal, t0,
                            kernels.multiprocessors(q.device))
        if plan.splits > 1:
            splits = plan.splits
            part = torch.empty(plan.part, dtype=torch.float32,
                               device=q.device)
            ctr = _split_counters(q.device, kernels.stream_of(q),
                                  plan.tiles)
    err = kernels.library().hl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_lengths),
        _ptr(seg), o.data_ptr(), _ptr(lse), _ptr(part), _ptr(ctr), dims,
        int(causal), int(t0), int(bf16), splits, kernels.stream_of(q))
    kernels.check(err, name)
    return o, lse


def flash_fwd_cuda(q, k, v, kv_lengths, causal=False, t0=0, with_lse=False):
    """K5: -> o, or (o, lse) with ``with_lse``."""
    global launches, lse_launches
    _check("flash_attention", q, k, v)
    kv_lengths = kv_lengths.to(torch.int32).contiguous()
    kernels.require_cuda("flash_attention", kv_lengths)
    if kv_lengths.device != q.device:
        raise ValueError("flash_attention: kv_lengths on another device")
    if kv_lengths.shape != (q.shape[0],):
        raise ValueError("flash_attention: kv_lengths must be (N,)")
    o, lse = _launch("hl_flash_fwd", q, k, v, kv_lengths, None, causal, t0,
                     with_lse)
    launches += 1
    if with_lse:
        lse_launches += 1
        return o, lse
    return o


def flash_bwd_cuda(q, k, v, kv_lengths, causal, t0, o, lse, do):
    """K6a then K6b: -> (dq, dk, dv) in q's dtype, from K5's o and lse
    (N, H, T) fp32 and the output gradient do."""
    b = _bwd_args(q, k, v, kv_lengths, causal, t0, o, lse, do)
    if b.launch:
        _bwd_dq(b)
        _bwd_dkv(b)
    return b.dq, b.dk, b.dv


def _bwd_args(q, k, v, kv_lengths, causal, t0, o, lse, do):
    """The checks and the allocations of K6a/K6b -> their launch
    arguments (``_bwd_dq``, then ``_bwd_dkv``, which reads the scratch
    that K6a writes)."""
    if do.device == q.device and do.dtype == q.dtype and not _rows_ok(do):
        do = do.contiguous()           # an expanded or odd-strided grad
    _check("flash_attention backward", q, k, v, o, do)
    kv_lengths = kv_lengths.to(torch.int32).contiguous()
    kernels.require_cuda("flash_attention backward", kv_lengths, lse)
    if kv_lengths.device != q.device or lse.device != q.device:
        raise ValueError("flash_attention backward: kv_lengths or lse on "
                         "another device")
    N, H, T, D = q.shape
    S = k.shape[2]
    if kv_lengths.shape != (N,) or lse.shape != (N, H, T) or \
            lse.dtype != torch.float32:
        raise ValueError("flash_attention backward: kv_lengths must be "
                         "(N,) and lse (N, H, T) fp32")
    dq = _heads_last(N, H, T, D, q)
    dk, dv = _heads_last(N, H, S, D, k), _heads_last(N, H, S, D, v)
    if T == 0 or S == 0:
        for t in (dq, dk, dv):
            t.zero_()
    dims = [N, H, T, S, D] + _strides(q, k, v, o, do, dq, dk, dv)
    bf16 = q.dtype == torch.bfloat16
    plan = None if bf16 else bwd_f32_plan(
        N, H, T, S, D, causal, t0, kernels.multiprocessors(q.device))
    part = ctr = None
    if plan is not None and max(plan.dq_splits, plan.dkv_splits) > 1:
        # one scratch for both: K6b runs after K6a's merges on the stream
        part = torch.empty(max(plan.dq_part, plan.dkv_part),
                           dtype=torch.float32, device=q.device)
        ctr = _split_counters(q.device, kernels.stream_of(q),
                              max(plan.dq_tiles, plan.dkv_tiles))
    return SimpleNamespace(
        q=q, k=k, v=v, o=o, do=do, kv_lengths=kv_lengths, lse=lse,
        scratch=_scratch(N, H, T, q), dq=dq, dk=dk, dv=dv,
        causal=int(causal), t0=int(t0),
        dims=(ctypes.c_int * len(dims))(*dims), bf16=int(bf16), plan=plan,
        part=part, ctr=ctr, launch=N * H * T * S > 0)


def f32_split_range(n, splits, s):
    """The reduction tiles [lo, hi) of an output tile's ``n`` live ones
    that split ``s`` of ``splits`` takes in the fp32 K6a/K6b
    (``split_range`` in csrc/flash_bwd.cu): an even share of the tiles
    that tile visits, so that causal splits balance by live tiles."""
    return n * s // splits, n * (s + 1) // splits


def _splits(tiles, reach, sms):
    """P for ``tiles`` output tiles whose reduction spans at most
    ``reach`` tiles: 1 where the tiles fill the ``sms``; else the P whose
    heaviest SM has the least to do, ceil(tiles P / sms) blocks of
    ceil(reach / P) tiles each, the smallest P of those (fewer partials
    to merge; an SM with one block runs it faster than two that share
    it). At (1, 8, 384, 64) that is 2 (96 blocks): 2 read faster than 3
    and 6 on an H100 (PERF.md, PR 22)."""
    if tiles >= sms or reach <= 1:
        return 1
    return min(range(1, reach + 1),
               key=lambda p: (-(-tiles * p // sms) * -(-reach // p), p))


def fwd_f32_plan(N, H, T, S, D, causal, t0, sms):
    """The grid of the fp32 K5 on a card of ``sms`` multiprocessors: query
    tiles of F32_TILE rows, their keys split as fp32 K6a's are (the dq
    side of ``bwd_f32_plan``) -> SimpleNamespace(tiles, splits, blocks
    (tiles x splits), part: the fp32 scratch of the splits' (acc, m, l),
    0 with one split)."""
    p = bwd_f32_plan(N, H, T, S, D, causal, t0, sms)
    return SimpleNamespace(
        tiles=p.dq_tiles, splits=p.dq_splits, blocks=p.dq_blocks,
        part=p.dq_blocks * F32_TILE * (D + 2) if p.dq_splits > 1 else 0)


def bwd_f32_plan(N, H, T, S, D, causal, t0, sms):
    """The grids of the fp32 K6a (query tiles of F32_TILE rows, the keys
    split) and K6b (key tiles, the queries split) on a card of ``sms``
    multiprocessors -> SimpleNamespace(dq_tiles, dq_splits, dq_blocks,
    dq_part, and the same of dkv): tiles, splits, blocks (tiles x
    splits), and the fp32 scratch the splits' sums take (0 with one
    split). The key lengths are not read: a tile's reach is what its
    shapes allow (K6a's latest query tile: S, or t0 + T causal; every
    query tile for K6b's first key tile)."""
    tile = F32_TILE
    qt, kt = -(-T // tile), -(-S // tile)
    reach_k = -(-max(min(S, t0 + qt * tile) if causal else S, 0) // tile)
    out = {}
    for name, tiles, reach, outs in (("dq", N * H * qt, reach_k, 1),
                                     ("dkv", N * H * kt, qt, 2)):
        p = _splits(tiles, reach, sms)
        out.update({f"{name}_tiles": tiles, f"{name}_splits": p,
                    f"{name}_blocks": tiles * p,
                    f"{name}_part": tiles * p * outs * tile * D if p > 1
                    else 0})
    return SimpleNamespace(**out)


def _split_counters(device, stream, n):
    """fp32 K5's and K6's per-tile arrival counters on ``device``, kept
    between calls: each launch leaves them 0, and calls run in the order
    of the stream they share, so each stream has its own."""
    key = device.index, stream
    ctr = _counters.get(key)
    if ctr is None or ctr.numel() < n:
        ctr = _counters[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return ctr


def _scratch(N, H, T, q):
    """What K6a writes and K6b reads: in bf16 (N*H, 2, Tp) fp32, each
    row's lse * log2(e) then delta = rowsum(do * o), Tp = T rounded up to
    4 so that K6b's TMA map of it has 16-byte row strides; in fp32 delta
    (N, H, T)."""
    shape = (N * H, 2, -(-T // 4) * 4) if q.dtype == torch.bfloat16 else \
        (N, H, T)
    return torch.empty(shape, dtype=torch.float32, device=q.device)


def _bwd_dq(b):
    """K6a: b.dq, and b.scratch for K6b."""
    global bwd_dq_launches
    err = kernels.library().hl_flash_bwd_dq(
        b.q.data_ptr(), b.k.data_ptr(), b.v.data_ptr(), b.o.data_ptr(),
        b.do.data_ptr(), b.kv_lengths.data_ptr(), b.lse.data_ptr(),
        b.scratch.data_ptr(), b.dq.data_ptr(), _ptr(b.part), _ptr(b.ctr),
        b.dims, b.causal, b.t0, b.bf16, b.plan.dq_splits if b.plan else 1,
        kernels.stream_of(b.q))
    kernels.check(err, "hl_flash_bwd_dq")
    bwd_dq_launches += 1


def _bwd_dkv(b):
    """K6b: b.dk and b.dv, reading the b.scratch that K6a wrote."""
    global bwd_dkv_launches
    err = kernels.library().hl_flash_bwd_dkv(
        b.q.data_ptr(), b.k.data_ptr(), b.v.data_ptr(), b.do.data_ptr(),
        b.kv_lengths.data_ptr(), b.lse.data_ptr(), b.scratch.data_ptr(),
        b.dk.data_ptr(), b.dv.data_ptr(), _ptr(b.part), _ptr(b.ctr), b.dims,
        b.causal, b.t0, b.bf16, b.plan.dkv_splits if b.plan else 1,
        kernels.stream_of(b.q))
    kernels.check(err, "hl_flash_bwd_dkv")
    bwd_dkv_launches += 1


def _ptr(t):
    return t.data_ptr() if t is not None else None


def flash_packed_cuda(q, k, v, segment_ids, causal=True):
    """K7: segment-blocked self-attention (T == S, t0 = 0)."""
    global packed_launches
    _check("flash_attention_packed", q, k, v)
    seg = segment_ids.to(torch.int32).contiguous()
    kernels.require_cuda("flash_attention_packed", seg)
    if seg.device != q.device:
        raise ValueError("flash_attention_packed: segment ids on another "
                         "device")
    N, H, T, _ = q.shape
    if k.shape[2] != T or seg.shape != (N, T):
        raise ValueError("flash_attention_packed: self-attention over "
                         "(N, T) segment ids only")
    o, _ = _launch("hl_flash_fwd", q, k, v, None, seg, causal, 0, False)
    packed_launches += 1
    return o
