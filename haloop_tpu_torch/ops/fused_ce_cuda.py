"""Kernel K10: the lm_head product fused with its cross-entropy in CUDA
(``csrc/fused_ce.cu``).

Mirrors ``haloop_tpu.ops.fused_ce.fused_ce_nll``: x (N, D), w (V, D),
targets (N,) -> nll (N,) fp32, never materializing the (N, V) logits.
``fused_ce_nll`` picks the path:
  * under autograd (grad enabled and x or w requiring it), the
    ``FusedCENLL`` Function: K10 forward (nll and lse), and the JAX
    package's analytic backward from the saved lse in torch ops
    (``ops.fused_ce.ce_nll_grad``; XLA in the JAX package);
  * otherwise K10 alone.
A CPU tensor takes the plain ``ops.fused_ce.ce_nll_lse``; a CUDA tensor
launches the kernel or raises.

bf16 takes the persistent warp-specialized kernel (a TMA producer warp,
two wgmma consumer warpgroups, an mbarrier ring) over work items (128-row
tile, vocab chunk of 256-column tiles) in the order and count of
``plan``; fp32 a grid of (64-row tile, chunk) blocks on CUDA cores. Each
item writes its rows' running (max, sum of exps, target logit), and a
second small kernel merges the chunks in a fixed order, so the result is
the same from run to run.
"""

import functools
from typing import NamedTuple

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.ops import fused_ce as _ce

TC_ROWS, TC_COLS = 128, 256    # bf16 kernel: rows and vocab columns a tile
FMA_ROWS, FMA_COLS = 64, 64    # fp32 kernel
TC_K = 64                      # bf16: the k slice; D must be a multiple
WAVES = 8                      # fp32: blocks per SM to aim for
ITEM_COST = 1                  # bf16: an item's fixed cost, in k slices
launches = 0                   # K10 calls
wg_launches = 0                # of which the bf16 warp-specialized kernel


class Plan(NamedTuple):
    chunks: int        # vocab chunks (each a run of vocab tiles)
    row_tiles: int
    vocab_tiles: int
    items: int         # row_tiles * chunks, chunk-major
    grid: int          # blocks launched


def vocab_range(p, chunk):
    """The vocab tiles [vt0, vt1) of ``chunk``, as the kernels split
    them."""
    per = -(-p.vocab_tiles // p.chunks)
    vt0 = min(p.vocab_tiles, chunk * per)
    return vt0, min(p.vocab_tiles, vt0 + per)


def item_tiles(p, item):
    """Item ``item`` of the bf16 kernel: (row tile, vt0, vt1)."""
    return (item % p.row_tiles, *vocab_range(p, item // p.row_tiles))


@functools.lru_cache(maxsize=256)
def plan(N, V, D, sms, bf16=True):
    """K10's launch. bf16: the chunk count whose items, dealt to
    min(items, sms) persistent blocks in turn (block b runs items b, b +
    grid, ...), give the least time to the busiest block, counted in k
    slices (D / 64 a tile) plus ``ITEM_COST`` an item (ties: fewer
    chunks). fp32: enough
    chunks for ~``WAVES`` blocks an SM, one block a (row tile, chunk)."""
    if not bf16:
        row_tiles, vt = -(-N // FMA_ROWS), -(-V // FMA_COLS)
        chunks = max(1, min(vt, -(-WAVES * sms // row_tiles)))
        return Plan(chunks, row_tiles, vt, row_tiles * chunks,
                    row_tiles * chunks)
    row_tiles, vt = -(-N // TC_ROWS), -(-V // TC_COLS)
    if vt == 0:
        return Plan(1, row_tiles, 0, row_tiles, min(row_tiles, sms))
    nks = D // TC_K
    best = None
    for chunks in range(1, vt + 1):
        per = -(-vt // chunks)
        if (chunks - 1) * per >= vt:         # an empty chunk
            continue
        last = vt - (chunks - 1) * per       # the last chunk's tiles
        items = row_tiles * chunks
        grid = min(items, sms)
        lo = (chunks - 1) * row_tiles        # the last chunk's first item
        worst = 0
        for b in range(grid):
            n = -(-(items - b) // grid)
            in_last = n - max(0, -(-(lo - b) // grid))
            worst = max(worst, n * (per * nks + ITEM_COST) -
                        in_last * (per - last) * nks)
        if best is None or worst < best[0]:
            best = (worst, Plan(chunks, row_tiles, vt, items, grid))
    return best[1]


def fused_ce_nll(x, w, targets):
    """-> nll (N,) fp32 (the caller masks padding targets)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return FusedCENLL.apply(x, w, targets)
    if x.device.type == "cpu":
        return _ce.ce_nll_lse(x, w, targets)[0]
    return ce_fwd_cuda(x, w, targets)[0]


class FusedCENLL(torch.autograd.Function):
    """K10 forward; backward from the saved lse in torch ops."""

    @staticmethod
    def forward(ctx, x, w, targets):
        if x.device.type == "cpu":
            nll, lse = _ce.ce_nll_lse(x, w, targets)
        else:
            nll, lse = ce_fwd_cuda(x, w, targets)
        ctx.save_for_backward(x, w, targets, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dx, dw = _ce.ce_nll_grad(x, w, targets, lse, g.float())
        return dx, dw, None


def ce_fwd_cuda(x, w, targets):
    """K10: -> (nll (N,), lse (N,)) fp32."""
    global launches, wg_launches
    targets = targets.to(torch.int32).contiguous()
    kernels.require_cuda("fused_ce_nll", x, w, dtypes=(torch.bfloat16,
                                                       torch.float32))
    kernels.require_cuda("fused_ce_nll", targets)
    if x.dtype != w.dtype:
        raise TypeError(f"fused_ce_nll: x {x.dtype} and w {w.dtype} differ")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] or \
            targets.shape != (x.shape[0],):
        raise ValueError(f"fused_ce_nll: x (N, D), w (V, D), targets (N,); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(targets.shape)}")
    if targets.device != x.device:
        raise ValueError("fused_ce_nll: targets on another device")
    N, D = x.shape
    V = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and D % TC_K:
        raise ValueError(f"fused_ce_nll: the bf16 kernel takes D a multiple "
                         f"of {TC_K}, got {D}")
    if bf16 and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("fused_ce_nll: the bf16 kernel's TMA loads take x "
                         "and w at 16-byte aligned addresses")
    if not bf16 and D % 4:
        raise ValueError(f"fused_ce_nll: the fp32 kernel takes D a multiple "
                         f"of 4, got {D}")
    nll = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return nll, lse
    p = plan(N, V, D, kernels.multiprocessors(x.device), bf16)
    # each chunk's (max, sum of exps, target logit) per row
    partial = torch.empty((p.chunks, 3, N), dtype=torch.float32,
                          device=x.device)
    err = kernels.library().hl_fused_ce(
        x.data_ptr(), w.data_ptr(), targets.data_ptr(), nll.data_ptr(),
        lse.data_ptr(), partial.data_ptr(), N, V, D, p.chunks, p.grid,
        int(bf16), kernels.stream_of(x))
    kernels.check(err, "hl_fused_ce")
    launches += 1
    wg_launches += bf16
    return nll, lse
