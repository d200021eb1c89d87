"""Kernels K3 and K4: the CTC forward and backward lattices in CUDA
(``csrc/ctc_fwd.cu``, ``csrc/ctc_bwd.cu``).

Mirrors ``haloop_tpu.ops.ctc_pallas.ctc_loss_pallas``: (T, N, C)
log-softmax emissions -> (N,) positive NLL, with its analytic backward.
``ctc_loss`` picks the path:
  * under autograd (grad enabled and log_probs requires it), the
    ``CTCLoss`` Function: K3 with its alpha history forward, K4 backward;
  * otherwise (serving) K3 alone.
A CPU tensor takes the plain versions in ``ops.ctc`` (through the same
Function under autograd); a CUDA tensor launches the kernels or raises.
Both run on the warp-specialized lattice skeleton of
``csrc/lattice.cuh``: K3 sweeps the frames with K states a lane in
registers while loader warps gather the emissions into a ring (the launch
``fwd_plan`` gives), K4 is its backward mirror (``csrc/lattice_bwd.cuh``,
the launch ``plan`` gives).
"""

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.ops import ctc as _ctc
from haloop_tpu_torch.ops import lattice_cuda

MAX_STATES = lattice_cuda.MAX_STATES   # 2U+1: the lattice kernels' range
# K3's least states a lane: even, so that a register's index fixes its
# state's type (blank or label); 2 at S' = 193 reads faster than 4 over two
# warps (PERF.md)
FWD_MIN_PER_LANE = 2
launches = 0          # K3 calls without the alpha history (serving)
history_launches = 0  # K3 calls that write the history (under autograd)
bwd_launches = 0      # K4 calls


def plan(S, C):
    """K4's launch for S = 2U+1 states and C classes
    (``lattice_cuda.plan``; K >= 2, the stencil's reach)."""
    return lattice_cuda.plan(S, C, 2, "ctc_grad")


def fwd_plan(S, C):
    """K3's launch for S = 2U+1 states and C classes
    (``lattice_cuda.forward_plan``; K even, at least FWD_MIN_PER_LANE)."""
    return lattice_cuda.forward_plan(S, C, FWD_MIN_PER_LANE, "ctc_loss")


def ctc_loss(log_probs, targets, input_lengths, target_lengths,
             history=None):
    """(T, N, C) log-probs -> (N,) fp32 NLL.

    ``history``, when given on the card, is an (N, T, 2U+1) fp32 buffer
    that receives the alpha lattice; the CPU path takes no history.
    """
    if history is None and torch.is_grad_enabled() and \
            log_probs.requires_grad:
        return CTCLoss.apply(log_probs, targets, input_lengths,
                             target_lengths)
    if log_probs.device.type == "cpu":
        if history is not None:
            raise ValueError("ctc_loss: history is written by the CUDA "
                             "kernel only")
        return _ctc.ctc_forward_score(log_probs, targets, input_lengths,
                                      target_lengths)
    return ctc_fwd_cuda(log_probs, targets, input_lengths, target_lengths,
                        history)


class CTCLoss(torch.autograd.Function):
    """K3 with its alpha history forward, K4 backward
    (haloop_tpu/ops/ctc_pallas.py _ctc_fwd / _ctc_bwd)."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths):
        if log_probs.device.type == "cpu":
            loss, hist = _ctc.ctc_forward_history(
                log_probs, targets, input_lengths, target_lengths)
        else:
            T, N = log_probs.shape[:2]
            hist = torch.empty((N, T, 2 * targets.shape[1] + 1),
                               dtype=torch.float32, device=log_probs.device)
            loss = ctc_fwd_cuda(log_probs, targets, input_lengths,
                                target_lengths, hist)
        ctx.save_for_backward(log_probs, hist, loss)
        ctx.lattice = (targets, input_lengths, target_lengths)
        return loss

    @staticmethod
    def backward(ctx, g):
        log_probs, hist, loss = ctx.saved_tensors
        args = (log_probs, *ctx.lattice, hist, loss, g)
        if log_probs.device.type == "cpu":
            dlogp = _ctc.ctc_grad(*args)
        else:
            dlogp = ctc_bwd_cuda(*args)
        return dlogp.to(log_probs.dtype), None, None, None


def _lattice_args(name, log_probs, targets, input_lengths, target_lengths):
    """Checks the lattice's arguments and puts them on the card as the
    kernels take them: log_probs fp32 contiguous, the rest int32."""
    T, N, C = log_probs.shape
    U = targets.shape[1]
    S = 2 * U + 1
    if S > MAX_STATES:
        raise ValueError(f"{name}: {S} lattice states (U={U}) exceed the "
                         f"kernel's {MAX_STATES}")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"{name}: log_probs must be float32, got "
                        f"{log_probs.dtype}")
    dev = log_probs.device
    log_probs = log_probs.contiguous()
    targets = targets.to(device=dev, dtype=torch.int32).contiguous()
    input_lengths = torch.as_tensor(input_lengths).to(
        device=dev, dtype=torch.int32).contiguous()
    target_lengths = torch.as_tensor(target_lengths).to(
        device=dev, dtype=torch.int32).contiguous()
    if input_lengths.shape != (N,) or target_lengths.shape != (N,) \
            or targets.shape[0] != N:
        raise ValueError(f"{name}: batch sizes of the arguments disagree")
    return log_probs, targets, input_lengths, target_lengths


def ctc_fwd_cuda(log_probs, targets, input_lengths, target_lengths,
                 history=None):
    """K3: (N,) NLL; with ``history`` (N, T, 2U+1) fp32 also the alpha
    lattice."""
    global launches, history_launches
    T, N, C = log_probs.shape
    U = targets.shape[1]
    log_probs, targets, input_lengths, target_lengths = _lattice_args(
        "ctc_loss", log_probs, targets, input_lengths, target_lengths)
    loss = torch.empty(N, dtype=torch.float32, device=log_probs.device)
    if N == 0:
        return loss
    tensors = [log_probs, targets, input_lengths, target_lengths, loss]
    if history is not None:
        if history.shape != (N, T, 2 * U + 1) or \
                history.dtype != torch.float32:
            raise ValueError(f"ctc_loss: history must be float32 of shape "
                             f"{(N, T, 2 * U + 1)}")
        tensors.append(history)
    kernels.require_cuda("ctc_loss", *tensors)
    p = fwd_plan(2 * U + 1, C)
    err = kernels.library().hl_ctc_fwd(
        log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
        target_lengths.data_ptr(), loss.data_ptr(),
        history.data_ptr() if history is not None else None,
        T, N, C, U, p.per_lane, p.sweep_warps, p.loader_warps, p.frames,
        p.depth, p.smem, kernels.stream_of(log_probs))
    kernels.check(err, "hl_ctc_fwd")
    if history is None:
        launches += 1
    else:
        history_launches += 1
    return loss


def ctc_bwd_cuda(log_probs, targets, input_lengths, target_lengths, hist,
                 loss, g):
    """K4: the arguments of ``ops.ctc.ctc_grad`` -> dlogp (T, N, C) fp32."""
    global bwd_launches
    T, N, C = log_probs.shape
    U = targets.shape[1]
    S = 2 * U + 1
    log_probs, targets, input_lengths, target_lengths = _lattice_args(
        "ctc_grad", log_probs, targets, input_lengths, target_lengths)
    p = plan(S, C)
    if hist.shape != (N, T, S) or loss.shape != (N,) or g.shape != (N,):
        raise ValueError(f"ctc_grad: hist, loss and g must be {(N, T, S)}, "
                         f"{(N,)} and {(N,)}")
    g = g.float().contiguous()
    kernels.require_cuda("ctc_grad", log_probs, hist, loss, g,
                         dtypes=(torch.float32,))
    dlogp = torch.empty((T, N, C), dtype=torch.float32,
                        device=log_probs.device)
    if N == 0:
        return dlogp
    kernels.require_cuda("ctc_grad", log_probs, targets, input_lengths,
                         target_lengths, dlogp)
    err = kernels.library().hl_ctc_bwd(
        log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
        target_lengths.data_ptr(), hist.data_ptr(), loss.data_ptr(),
        g.data_ptr(), dlogp.data_ptr(), T, N, C, U, p.per_lane,
        p.sweep_warps, p.scatter_warps, p.frames, p.depth,
        int(p.dense), p.smem,
        kernels.stream_of(log_probs))
    kernels.check(err, "hl_ctc_bwd")
    bwd_launches += 1
    return dlogp
