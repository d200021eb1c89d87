"""Kernels K8a and K8b: the Star-CTC lattice forward and backward in CUDA
(``csrc/star_fwd.cu``, ``csrc/star_bwd.cu``).

Mirrors ``haloop_tpu.ops.star_pallas.star_ctc_loss_pallas``: the star
vocabulary (``ops.star.intersperse_stars``, differentiable torch ops) and
then the lattice on the (T, N, 2V) star-vocabulary log-probs, with its
analytic backward. ``star_ctc_loss`` picks the path:
  * under autograd (grad enabled and log_probs requires it), the
    ``StarCTCLoss`` Function: K8a with its alpha history forward, K8b
    backward; autograd chains through ``intersperse_stars`` to the raw
    log-probs;
  * otherwise (serving) K8a alone.
A CPU tensor takes the plain versions in ``ops.star`` (through the same
Function under autograd); a CUDA tensor launches the kernels or raises.
Both run on the warp-specialized lattice skeleton of ``csrc/lattice.cuh``:
K8a sweeps the frames with K states a lane in registers while loader warps
gather the emissions into a ring (the launch ``fwd_plan`` gives), K8b is
its backward mirror (``csrc/lattice_bwd.cuh``, the launch ``plan``
gives).
"""

import torch

from haloop_tpu_torch import kernels
from haloop_tpu_torch.ops import lattice_cuda
from haloop_tpu_torch.ops import star as _star

MAX_STATES = 4091     # S = 4U+3 with U <= 1022: the kernels' range
launches = 0          # K8a calls without the alpha history (serving)
history_launches = 0  # K8a calls that write the history (under autograd)
bwd_launches = 0      # K8b calls


def plan(S, C2):
    """K8b's launch for S = 4U+3 states and C2 = 2V classes
    (``lattice_cuda.plan``; K a multiple of 4, so that a state's type is
    its register's index mod 4), refused past MAX_STATES."""
    _check_states("star_grad", S)
    return lattice_cuda.plan(S, C2, 4, "star_grad")


def fwd_plan(S, C2):
    """K8a's launch for S = 4U+3 states and C2 = 2V classes
    (``lattice_cuda.forward_plan``; K a multiple of 4, as ``plan``),
    refused past MAX_STATES."""
    _check_states("star_ctc_loss", S)
    return lattice_cuda.forward_plan(S, C2, 4, "star_ctc_loss")


def _check_states(name, S):
    if S > MAX_STATES:
        raise ValueError(f"{name}: {S} lattice states exceed the kernel's "
                         f"{MAX_STATES}")


def star_ctc_loss(log_probs, targets, input_lengths, target_lengths,
                  star_penalty=-0.5):
    """(T, N, V) log-probs -> (N,) fp32 star-CTC NLL."""
    if log_probs.device.type == "cpu" and not (
            torch.is_grad_enabled() and log_probs.requires_grad):
        return _star.star_ctc_forward_score(log_probs, targets, input_lengths,
                                            target_lengths, star_penalty)
    star_lp, star_targets = _star.intersperse_stars(log_probs, targets)
    if torch.is_grad_enabled() and star_lp.requires_grad:
        return StarCTCLoss.apply(star_lp, star_targets, input_lengths,
                                 target_lengths, float(star_penalty))
    return star_fwd_cuda(star_lp, star_targets, input_lengths,
                         target_lengths, star_penalty)


class StarCTCLoss(torch.autograd.Function):
    """K8a with its alpha history forward, K8b backward, on the
    star-vocabulary log-probs (haloop_tpu/ops/star_pallas.py
    _lattice_fwd / _lattice_bwd)."""

    @staticmethod
    def forward(ctx, star_lp, star_targets, input_lengths, target_lengths,
                penalty):
        if star_lp.device.type == "cpu":
            loss, hist = _star.star_forward_history(
                star_lp, star_targets, input_lengths, target_lengths,
                penalty)
        else:
            T, N = star_lp.shape[:2]
            hist = torch.empty((N, T, 2 * star_targets.shape[1] + 1),
                               dtype=torch.float32, device=star_lp.device)
            loss = star_fwd_cuda(star_lp, star_targets, input_lengths,
                                 target_lengths, penalty, hist)
        ctx.save_for_backward(star_lp, hist, loss)
        ctx.lattice = (star_targets, input_lengths, target_lengths)
        ctx.penalty = penalty
        return loss

    @staticmethod
    def backward(ctx, g):
        star_lp, hist, loss = ctx.saved_tensors
        args = (star_lp, *ctx.lattice, hist, loss, g, ctx.penalty)
        if star_lp.device.type == "cpu":
            dlp = _star.star_grad(*args)
        else:
            dlp = star_bwd_cuda(*args)
        return dlp.to(star_lp.dtype), None, None, None, None


def _lattice_args(name, star_lp, star_targets, input_lengths,
                  target_lengths):
    """Checks the lattice's arguments and puts them on the card as the
    kernels take them: star_lp fp32 contiguous, the rest int32."""
    T, N, C2 = star_lp.shape
    if star_targets.shape[1] % 2 != 1:
        raise ValueError(f"{name}: star targets must be (N, 2U+1), got "
                         f"{tuple(star_targets.shape)}")
    if star_lp.dtype != torch.float32:
        raise TypeError(f"{name}: star log-probs must be float32, got "
                        f"{star_lp.dtype}")
    dev = star_lp.device
    star_lp = star_lp.contiguous()
    star_targets = star_targets.to(device=dev, dtype=torch.int32).contiguous()
    input_lengths = torch.as_tensor(input_lengths).to(
        device=dev, dtype=torch.int32).contiguous()
    target_lengths = torch.as_tensor(target_lengths).to(
        device=dev, dtype=torch.int32).contiguous()
    if input_lengths.shape != (N,) or target_lengths.shape != (N,) \
            or star_targets.shape[0] != N:
        raise ValueError(f"{name}: batch sizes of the arguments disagree")
    return star_lp, star_targets, input_lengths, target_lengths


def star_fwd_cuda(star_lp, star_targets, input_lengths, target_lengths,
                  penalty, history=None):
    """K8a: (N,) NLL; with ``history`` (N, T, 4U+3) fp32 also the alpha
    lattice."""
    global launches, history_launches
    T, N, C2 = star_lp.shape
    U = (star_targets.shape[1] - 1) // 2
    star_lp, star_targets, input_lengths, target_lengths = _lattice_args(
        "star_ctc_loss", star_lp, star_targets, input_lengths,
        target_lengths)
    loss = torch.empty(N, dtype=torch.float32, device=star_lp.device)
    if N == 0:
        return loss
    tensors = [star_lp, star_targets, input_lengths, target_lengths, loss]
    if history is not None:
        if history.shape != (N, T, 4 * U + 3) or \
                history.dtype != torch.float32:
            raise ValueError(f"star_ctc_loss: history must be float32 of "
                             f"shape {(N, T, 4 * U + 3)}")
        tensors.append(history)
    kernels.require_cuda("star_ctc_loss", *tensors)
    p = fwd_plan(4 * U + 3, C2)
    err = kernels.library().hl_star_fwd(
        star_lp.data_ptr(), star_targets.data_ptr(),
        input_lengths.data_ptr(), target_lengths.data_ptr(), loss.data_ptr(),
        history.data_ptr() if history is not None else None, float(penalty),
        T, N, C2, U, p.per_lane, p.sweep_warps, p.loader_warps, p.frames,
        p.depth, p.smem, kernels.stream_of(star_lp))
    kernels.check(err, "hl_star_fwd")
    if history is None:
        launches += 1
    else:
        history_launches += 1
    return loss


def star_bwd_cuda(star_lp, star_targets, input_lengths, target_lengths,
                  hist, loss, g, penalty):
    """K8b: the arguments of ``ops.star.star_grad`` -> d star_lp
    (T, N, 2V) fp32."""
    global bwd_launches
    T, N, C2 = star_lp.shape
    U = (star_targets.shape[1] - 1) // 2
    S = 4 * U + 3
    star_lp, star_targets, input_lengths, target_lengths = _lattice_args(
        "star_grad", star_lp, star_targets, input_lengths, target_lengths)
    p = plan(S, C2)
    if hist.shape != (N, T, S) or loss.shape != (N,) or g.shape != (N,):
        raise ValueError(f"star_grad: hist, loss and g must be {(N, T, S)}, "
                         f"{(N,)} and {(N,)}")
    g = g.float().contiguous()
    kernels.require_cuda("star_grad", star_lp, hist, loss, g,
                         dtypes=(torch.float32,))
    dlp = torch.empty((T, N, C2), dtype=torch.float32, device=star_lp.device)
    if N == 0:
        return dlp
    kernels.require_cuda("star_grad", star_lp, star_targets, input_lengths,
                         target_lengths, dlp)
    err = kernels.library().hl_star_bwd(
        star_lp.data_ptr(), star_targets.data_ptr(),
        input_lengths.data_ptr(), target_lengths.data_ptr(), hist.data_ptr(),
        loss.data_ptr(), g.data_ptr(), dlp.data_ptr(), float(penalty), T, N,
        C2, U, p.per_lane, p.sweep_warps, p.scatter_warps, p.frames, p.depth,
        int(p.dense), p.smem,
        kernels.stream_of(star_lp))
    kernels.check(err, "hl_star_bwd")
    bwd_launches += 1
    return dlp
