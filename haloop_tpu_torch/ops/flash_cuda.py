"""Kernels K5, K6a/K6b and K7: flash attention in CUDA. The forward
(``csrc/flash_fwd.cu``) with per-batch key lengths and causal offset
(K5), or with per-token segment ids for packed rows (K7): in bf16 one
warp-specialized Hopper kernel (wgmma fed by TMA through an mbarrier
ring), in fp32 a CUDA-core one; the backward of K5
(``csrc/flash_bwd.cu``): dq (K6a), then dk and dv (K6b).

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
prologue, not a separate pass.
"""

import ctypes
from types import SimpleNamespace

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.ops import flash as _flash

HEAD_DIMS = (32, 64)          # the head widths the kernel is built for
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
    err = kernels.library().hl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_lengths.data_ptr() if kv_lengths is not None else None,
        seg.data_ptr() if seg is not None else None, o.data_ptr(),
        lse.data_ptr() if lse is not None else None, dims, int(causal),
        int(t0), int(q.dtype == torch.bfloat16), kernels.stream_of(q))
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
    arguments (``_bwd_dq``, then ``_bwd_dkv``, which reads the delta that
    K6a writes)."""
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
    delta = torch.empty((N, H, T), dtype=torch.float32, device=q.device)
    dims = [N, H, T, S, D] + _strides(q, k, v, o, do, dq, dk, dv)
    return SimpleNamespace(
        q=q, k=k, v=v, o=o, do=do, kv_lengths=kv_lengths, lse=lse,
        delta=delta, dq=dq, dk=dk, dv=dv, causal=int(causal), t0=int(t0),
        dims=(ctypes.c_int * len(dims))(*dims),
        bf16=int(q.dtype == torch.bfloat16), launch=N * H * T * S > 0)


def _bwd_dq(b):
    """K6a: b.dq, and b.delta for K6b."""
    global bwd_dq_launches
    err = kernels.library().hl_flash_bwd_dq(
        b.q.data_ptr(), b.k.data_ptr(), b.v.data_ptr(), b.o.data_ptr(),
        b.do.data_ptr(), b.kv_lengths.data_ptr(), b.lse.data_ptr(),
        b.delta.data_ptr(), b.dq.data_ptr(), b.dims, b.causal, b.t0, b.bf16,
        kernels.stream_of(b.q))
    kernels.check(err, "hl_flash_bwd_dq")
    bwd_dq_launches += 1


def _bwd_dkv(b):
    """K6b: b.dk and b.dv, reading the b.delta that K6a wrote."""
    global bwd_dkv_launches
    err = kernels.library().hl_flash_bwd_dkv(
        b.q.data_ptr(), b.k.data_ptr(), b.v.data_ptr(), b.do.data_ptr(),
        b.kv_lengths.data_ptr(), b.lse.data_ptr(), b.delta.data_ptr(),
        b.dk.data_ptr(), b.dv.data_ptr(), b.dims, b.causal, b.t0, b.bf16,
        kernels.stream_of(b.q))
    kernels.check(err, "hl_flash_bwd_dkv")
    bwd_dkv_launches += 1


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
