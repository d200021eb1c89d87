"""The port's CUDA kernels (K1 and K2 ``nn/lstm_cuda``, and their int8
modes K1-q8 and K2-q8, K3 and K4
``ops/ctc_cuda``, K8a and K8b ``ops/star_cuda``, K9a and K9b
``ops/joint_cuda``, K5, K6a/K6b and K7 ``ops/flash_cuda``, K10
``ops/fused_ce_cuda``, K11 and K12 ``ops/decode_attn_cuda``, K13
``ops/q8_matmul_cuda``) against their plain PyTorch versions on the card,
and the wrappers' device rule everywhere.

Tests marked ``cuda`` need an NVIDIA GPU and skip where torch sees none.
This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py -m cuda

Tolerances: K1 in fp32 1e-5 (the same fp32 products summed in another
order); in bf16 atol=rtol=2e-2 with mean |d| < 2e-3 (the JAX package's
bound for its kernel, tests/test_lstm_pallas.py), since an fp32 sum that
lands on the other side of a bf16 rounding boundary moves h by one bf16
step; K3 rel 1e-5 on feasible items (one fp32 lattice each); K8a the
same, with its history; K4 and K8b rel/abs 1e-3 (the JAX package's bound
for its lattice kernels' grads); K9a/K9b 1e-5 (one fp32 logsumexp, or
one sum of exps, in another order; K9b's dg atol 1e-4, a sum over up to
301 frames). K5/K7 in fp32 2e-5 (the JAX
package's bound for its flash kernel, tests/test_flash.py); in bf16
atol=rtol=2e-2 with mean |d| < 2e-3: the kernel rounds the unnormalized
probabilities to bf16 for P V where the plain version rounds the
normalized ones. K6a/K6b (dq, dk, dv) in fp32 max |d| <= 2e-5 of the
largest gradient (fp32 products summed in another order); in bf16 max
|d| <= 2e-2 of the largest and mean |d| <= 1e-2 of the mean gradient:
the kernels round p and ds to bf16 where the plain version does, but an
fp32 value that lands on the other side of a rounding boundary moves a
term by one bf16 step, and the outputs are bf16 (the same criterion
holds the CE backward with bf16 operands against fp32 products). K10
atol 1e-3, rtol 1e-4: a logsumexp over up to 50k fp32 logits summed in
another order, with the fast exp; a target outside [0, V) adds a target
term of 0. K11 and K12: the caches
bit for bit; y 1e-5 in fp32, 2e-2 in bf16 (the JAX package's bounds,
tests/test_decode_attn.py); in bf16 also max |d| <= 1e-2 of the largest
|y| (``chip_smoke.K11_REL``, ``K12_REL``), since over thousands of rows
|y| falls far below 2e-2 (one bf16 step of the largest |y| is at most
2^-7 of it; the plain version rounds p to bf16 as K11 does and K12 does
not). K13: fp32 1e-5 of the largest output (the
same fp32 products summed in another order); bf16 2e-2 (one bf16
rounding of each output). K1-q8 and K2-q8: rel L2 limits placed between
the kernel against its plain version and two planted faults
(``chip_smoke.K1Q8_REL``, ``K2Q8_REL``). K1 (both modes) and K2 in bf16,
K1-q8, K2-q8, K4, K6, K8a, K8b, K9a, K9b, K11, K12 and K13 give the same
bits on every run; so do K1 and K2 in fp32 on their persistent route,
held to ``chip_smoke.LSTM_TOL["float32"]`` there.
"""

import copy
import ctypes

import pytest
import torch

import chip_smoke
from haloop_tpu_torch import kernels
from haloop_tpu_torch.nn import lstm, lstm_cuda
from haloop_tpu_torch import quant
from haloop_tpu_torch.nn import core
from haloop_tpu_torch.ops import ctc, ctc_cuda, decode_attn, \
    decode_attn_cuda, flash, flash_cuda, fused_ce, fused_ce_cuda, joint, \
    joint_cuda, q8_matmul, q8_matmul_cuda, star, star_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _lstm_inputs(T, B, H, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = (torch.rand((4 * H, H), generator=g) * 2 - 1) * 2 / H ** 0.5
    xp = torch.randn((T, B, 4 * H), generator=g)
    h0 = torch.randn((B, H), generator=g) * 0.1
    c0 = torch.randn((B, H), generator=g) * 0.1
    return (w.to(device, dtype), xp.to(device, dtype), h0.to(device),
            c0.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", [
    (7, 5, 40, torch.float32),
    (15, 4, 128, torch.bfloat16),
    (9, 37, 200, torch.bfloat16),       # B and H off every tile size
    (5, 3, 36, torch.bfloat16),         # H % 8 != 0: the FMA path in bf16
    (1, 1, 1, torch.float32),
    (20, 48, 1536, torch.bfloat16),     # lstm:512's width and eval batch
    (25, 16, 512, torch.bfloat16),      # the transducer's prediction net
    (301, 16, 1024, torch.bfloat16),    # rnn-transducer:lstm's encoder
])
def test_lstm_kernel_matches_plain(cuda, T, B, H, dtype):
    args = _lstm_inputs(T, B, H, dtype, cuda, seed=T + B + H)
    before = lstm_cuda.launches
    ys, h, c = lstm_cuda.lstm_scan(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.launches == before + 1
    ye, he, ce = lstm.lstm_scan(*args)
    assert ys.dtype == dtype and h.dtype == c.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ys.float(), ye.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, he, atol=tol, rtol=tol)
    torch.testing.assert_close(c, ce, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert (ys.float() - ye.float()).abs().mean().item() < 2e-3


LSTM_SHAPES = [
    (7, 5, 40, torch.float32),
    (15, 4, 128, torch.bfloat16),
    (9, 37, 200, torch.bfloat16),       # B and H off every tile size
    (5, 3, 36, torch.bfloat16),         # H % 8 != 0: the FMA path in bf16
    (6, 70, 64, torch.float32),         # two batch tiles
    (20, 48, 1536, torch.bfloat16),     # lstm:512's width and eval batch
    (25, 16, 512, torch.bfloat16),      # the transducer's prediction net
    (301, 16, 1024, torch.bfloat16),    # rnn-transducer:lstm's encoder
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", LSTM_SHAPES)
def test_lstm_kernel_residual_mode(cuda, T, B, H, dtype):
    """K1 with residuals: ys, h and c bit for bit those of K1 without;
    acts and cs against the plain residuals at K1's tolerance."""
    args = _lstm_inputs(T, B, H, dtype, cuda, seed=T * B + H)
    before = lstm_cuda.residual_launches
    ys, h, c, acts, cs = lstm_cuda.lstm_fwd_cuda(*args, residuals=True)
    torch.cuda.synchronize()
    assert lstm_cuda.residual_launches == before + 1
    ys0, h0, c0 = lstm_cuda.lstm_fwd_cuda(*args)
    assert torch.equal(ys, ys0) and torch.equal(h, h0) and torch.equal(c, c0)
    _, _, _, acts_e, cs_e = lstm.lstm_scan(*args, residuals=True)
    assert acts.dtype == cs.dtype == lstm.residual_dtype(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(acts.float(), acts_e.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(cs.float(), cs_e.float(), atol=tol, rtol=tol)


def _lstm_bwd_inputs(T, B, H, dtype, device, seed=0):
    """The forward's residuals on the card (plain version) and random
    upstream grads, as K2 and lstm_scan_bwd take them."""
    w, xp, h0, c0 = _lstm_inputs(T, B, H, dtype, device, seed)
    _, _, _, acts, cs = lstm.lstm_scan(w, xp, h0, c0, residuals=True)
    g = torch.Generator().manual_seed(seed + 1)
    dys = torch.randn((T, B, H), generator=g).to(device, acts.dtype)
    dh = torch.randn((B, H), generator=g).to(device) * 0.1
    dc = torch.randn((B, H), generator=g).to(device) * 0.1
    return w, acts, cs, c0.to(acts.dtype), dys, dh, dc


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", LSTM_SHAPES)
def test_lstm_bwd_kernel_matches_plain(cuda, T, B, H, dtype):
    """K2 against lstm_scan_bwd on the same residuals: fp32 1e-4 (the
    4H-deep products summed in another order, then carried through T
    steps); bf16 at K1's tolerance, mean |d| < 2e-3 (dgates that land
    on the other side of a bf16 rounding boundary feed the next step)."""
    w, acts, cs, c0, dys, dh, dc = _lstm_bwd_inputs(T, B, H, dtype, cuda,
                                                    seed=T + H)
    before = lstm_cuda.bwd_launches
    dg, dh0, dc0 = lstm_cuda.lstm_bwd_cuda(dys, acts, cs, c0, w, dh, dc)
    torch.cuda.synchronize()
    assert lstm_cuda.bwd_launches == before + 1
    c_prev = torch.cat([c0[None], cs[:-1]])
    dg_e, dh0_e, dc0_e = lstm.lstm_scan_bwd(dys, acts, c_prev, cs, w, dh, dc)
    assert dg.dtype == acts.dtype and dh0.dtype == dc0.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((dg, dg_e), (dh0, dh0_e), (dc0, dc0_e)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    if dtype == torch.bfloat16:
        assert (dg.float() - dg_e.float()).abs().mean().item() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_autograd_launches_k1_residual_and_k2(cuda, dtype):
    """Under autograd lstm_scan runs the LSTMScan Function: K1 with
    residuals forward, K2 backward; grads against the same Function on
    CPU tensors (its plain versions); under inference_mode K1 alone."""
    w, xp, h0, c0 = _lstm_inputs(11, 6, 64, dtype, cuda, seed=4)
    w.requires_grad_(True)
    xp.requires_grad_(True)
    r0, b0, f0 = (lstm_cuda.residual_launches, lstm_cuda.bwd_launches,
                  lstm_cuda.launches)
    ys, h, c = lstm_cuda.lstm_scan(w, xp, h0, c0)
    (ys.float().square().sum() + h.sum()).backward()
    assert (lstm_cuda.residual_launches, lstm_cuda.bwd_launches,
            lstm_cuda.launches) == (r0 + 1, b0 + 1, f0)
    wc, xc = (t.detach().cpu().requires_grad_(True) for t in (w, xp))
    ys_c, h_c, _ = lstm_cuda.lstm_scan(wc, xc, h0.cpu(), c0.cpu())
    (ys_c.float().square().sum() + h_c.sum()).backward()
    for got, want in ((w.grad, wc.grad), (xp.grad, xc.grad)):
        a, b = got.float().cpu().ravel(), want.float().ravel()
        assert (a @ b / (a.norm() * b.norm())).item() > 0.9995
    with torch.inference_mode():
        lstm_cuda.lstm_scan(w, xp, h0, c0)
    assert lstm_cuda.launches == f0 + 1
    assert lstm_cuda.bwd_launches == b0 + 1


@pytest.mark.cuda
def test_lstm_kernel_empty_sequence_returns_the_state(cuda):
    w, xp, h0, c0 = _lstm_inputs(0, 3, 16, torch.float32, cuda)
    ys, h, c = lstm_cuda.lstm_scan(w, xp, h0, c0)
    assert ys.shape == (0, 3, 16)
    assert torch.equal(h, h0) and torch.equal(c, c0)


@pytest.mark.cuda
def test_lstm_kernel_rejects_what_it_does_not_take(cuda):
    w, xp, h0, c0 = _lstm_inputs(4, 2, 32, torch.float32, cuda)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_scan(w.bfloat16(), xp, h0, c0)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan(w.T.contiguous().T, xp, h0, c0)   # strided
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan(w, xp, h0.cpu(), c0)


# ------------------------ the persistent bf16 kernels (K1, K2) and routes


def _route_taken(fn):
    """fn's result and the K1/K2 calls it made by route."""
    before = dict(lstm_cuda.route_launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                 if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,name,timed", chip_smoke.LSTM_SHAPES)
def test_lstm_route_and_counter_at_smoke_shapes(cuda, T, B, H, name, timed):
    """K1 (both modes) and K2 take the route ``lstm_cuda.route`` gives for
    this card, one count each on that route's counter and on the
    kernel's; the main paths' widths (1536, 1024, 512) in bf16 take the
    persistent kernels."""
    dtype = getattr(torch, name)
    sms, smem, ncl = lstm_cuda.card(cuda)
    routes = {k: lstm_cuda.route(k, dtype, H, B, sms, smem, ncl[k])[0]
              for k in ("fwd", "bwd")}
    if dtype == torch.bfloat16 and H in (1536, 1024, 512):
        assert routes == {"fwd": "persist", "bwd": "persist"}
    args = _lstm_inputs(T, B, H, dtype, cuda, seed=T + H)
    l0, r0, b0 = (lstm_cuda.launches, lstm_cuda.residual_launches,
                  lstm_cuda.bwd_launches)
    _, took = _route_taken(lambda: lstm_cuda.lstm_fwd_cuda(*args))
    assert took == {f"fwd_{routes['fwd']}": 1}
    (_, _, _, acts, cs), took = _route_taken(
        lambda: lstm_cuda.lstm_fwd_cuda(*args, residuals=True))
    assert took == {f"fwd_{routes['fwd']}": 1}
    w, _, h0, c0 = args
    dys = torch.randn((T, B, H), generator=torch.Generator().manual_seed(1)
                      ).to(cuda, acts.dtype)
    _, took = _route_taken(lambda: lstm_cuda.lstm_bwd_cuda(
        dys, acts, cs, c0.to(acts.dtype), w, h0, c0))
    assert took == {f"bwd_{routes['bwd']}": 1}
    assert (lstm_cuda.launches, lstm_cuda.residual_launches,
            lstm_cuda.bwd_launches) == (l0 + 1, r0 + 1, b0 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(20, 48, 1536), (25, 16, 512),
                                   (9, 37, 200)])
def test_lstm_kernels_give_the_same_bits_twice(cuda, T, B, H):
    """K1, K1 with residuals and K2: no sum depends on timing (the
    persistent kernels sum each product in a fixed order; the grid
    barrier's counter sums no data)."""
    args = _lstm_inputs(T, B, H, torch.bfloat16, cuda, seed=T * H)
    w, acts, cs, c0, dys, dh, dc = _lstm_bwd_inputs(T, B, H, torch.bfloat16,
                                                    cuda, seed=T * H)
    for fn in (lambda: lstm_cuda.lstm_fwd_cuda(*args),
               lambda: lstm_cuda.lstm_fwd_cuda(*args, residuals=True),
               lambda: lstm_cuda.lstm_bwd_cuda(dys, acts, cs, c0, w, dh, dc)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(1, 5, 1000), (1, 48, 1000),
                                   (1, 100, 1000), (4, 100, 1000),
                                   (6, 48, 2048)])
def test_lstm_persistent_edges_and_the_step_route(cuda, T, B, H):
    """The persistent kernels at T = 1, at batches of one partial tile, one
    whole 48-row tile and three tiles, and at H = 1000, whose units and
    columns divide neither the blocks nor the clusters; and a bf16 width
    whose W slices do not fit (2048, the per-step route): K1, its
    residuals and K2 against the plain versions at K1's tolerance."""
    sms, smem, ncl = lstm_cuda.card(cuda)
    want = "tc_step" if H == 2048 else "persist"
    for k in ("fwd", "bwd"):
        assert lstm_cuda.route(k, torch.bfloat16, H, B, sms, smem,
                               ncl[k])[0] == want
    args = _lstm_inputs(T, B, H, torch.bfloat16, cuda, seed=T + B + H)
    tol = chip_smoke.LSTM_TOL["bfloat16"]
    (ys, h, c, acts, cs), took = _route_taken(
        lambda: lstm_cuda.lstm_fwd_cuda(*args, residuals=True))
    assert took == {f"fwd_{want}": 1}
    ye, he, ce, acts_e, cs_e = lstm.lstm_scan(*args, residuals=True)
    for got, ref in ((ys, ye), (h, he), (c, ce), (acts, acts_e), (cs, cs_e)):
        assert chip_smoke.within(torch, got, ref, tol)[0]
    w, acts, cs, c0, dys, dh, dc = _lstm_bwd_inputs(T, B, H, torch.bfloat16,
                                                    cuda, seed=T + B + H)
    got, took = _route_taken(
        lambda: lstm_cuda.lstm_bwd_cuda(dys, acts, cs, c0, w, dh, dc))
    assert took == {f"bwd_{want}": 1}
    c_prev = torch.cat([c0[None], cs[:-1]])
    ref = lstm.lstm_scan_bwd(dys, acts, c_prev, cs, w, dh, dc)
    for g, r in zip(got, ref):
        assert chip_smoke.within(torch, g, r, tol)[0]


# ------------------------ the persistent fp32 kernels (K1, K2; persist_f32)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [
    (1, 1, 2048),                       # a hal completion token
    (3, 5, 200),                        # an 8-row tile, partial slices
    (9, 37, 200),
    (4, 70, 512),                       # two 64-row tiles
    (5, 48, 1536),                      # hac lstm:512's fp32 parity width
    (6, 64, 2048),                      # hal's width and batch
    (5, 3, 30),                         # H % 4 != 0: K1 per step, K2 not
])
def test_lstm_fp32_persistent_kernels_match_plain(cuda, T, B, H):
    """K1 (both modes) and K2 in fp32 on the route ``lstm_cuda.route``
    gives (persist_f32 wherever the fp32 plan fits): against the plain
    versions within chip_smoke.LSTM_TOL["float32"], the same bits twice,
    and the same bits with every slice of W streamed (the plan's resident
    split changes no sum)."""
    sms, smem, ncl = lstm_cuda.card(cuda)
    routes = {k: lstm_cuda.route(k, torch.float32, H, B, sms, smem,
                                 ncl[k])[0] for k in ("fwd", "bwd")}
    assert routes == {"fwd": "fma_step" if H % 4 else "persist_f32",
                      "bwd": "persist_f32"}
    tol = chip_smoke.LSTM_TOL["float32"]
    args = _lstm_inputs(T, B, H, torch.float32, cuda, seed=T + B + H)
    out, took = _route_taken(
        lambda: lstm_cuda.lstm_fwd_cuda(*args, residuals=True))
    assert took == {f"fwd_{routes['fwd']}": 1}
    assert all(torch.equal(a, b) for a, b in zip(
        out, lstm_cuda.lstm_fwd_cuda(*args, residuals=True)))
    with chip_smoke.all_streamed():
        streamed = lstm_cuda.lstm_fwd_cuda(*args, residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(out, streamed))
    for got, ref in zip(out, lstm.lstm_scan(*args, residuals=True)):
        assert chip_smoke.within(torch, got, ref, tol)[0]
    w, acts, cs, c0, dys, dh, dc = _lstm_bwd_inputs(T, B, H, torch.float32,
                                                    cuda, seed=T + B + H)
    bargs = (dys, acts, cs, c0, w, dh, dc)
    got, took = _route_taken(lambda: lstm_cuda.lstm_bwd_cuda(*bargs))
    assert took == {"bwd_persist_f32": 1}
    assert all(torch.equal(a, b) for a, b in
               zip(got, lstm_cuda.lstm_bwd_cuda(*bargs)))
    with chip_smoke.all_streamed():
        streamed = lstm_cuda.lstm_bwd_cuda(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(got, streamed))
    c_prev = torch.cat([c0[None], cs[:-1]])
    for g, r in zip(got, lstm.lstm_scan_bwd(dys, acts, c_prev, cs, w, dh,
                                            dc)):
        assert chip_smoke.within(torch, g, r, tol)[0]


# --------------------------------------------- the int8 mode (K1-q8, K2-q8)

Q8_SHAPES = [
    (385, 48, 1536, torch.bfloat16),    # lstm:512 (CTC, Star-CTC)
    (301, 16, 1024, torch.bfloat16),    # rnn-transducer:lstm's encoder
    (25, 16, 512, torch.bfloat16),      # its prediction net
    (7, 5, 40, torch.bfloat16),         # H % 32 != 0: the CUDA-core path
    (7, 5, 40, torch.float32),
    (15, 4, 128, torch.bfloat16),
    (15, 4, 128, torch.float32),        # fp32 x_proj (--dtype float32)
    (20, 70, 96, torch.bfloat16),       # two batch tiles, H off the slice
]


def _lstm_q8_inputs(T, B, H, dtype, device, seed):
    w, xp, h0, c0 = _lstm_inputs(T, B, H, dtype, device, seed)
    return (w, *lstm.quantize_rows(w), xp, h0, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", Q8_SHAPES)
def test_lstm_q8_kernel_matches_plain(cuda, T, B, H, dtype):
    """K1-q8 with and without residuals against lstm_scan_q8: each output
    within chip_smoke.K1Q8_REL (rel L2), which the exact mode's answer (a
    planted fault: no quantization) must exceed; the residual mode
    changes nothing else; the same bits on a second run."""
    w, wq, s, xp, h0, c0 = _lstm_q8_inputs(T, B, H, dtype, cuda,
                                           seed=T + H)
    before = (lstm_cuda.q8_launches, lstm_cuda.q8_residual_launches)
    ys, h, c = lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp, h0, c0)
    ys_r, h_r, c_r, acts, cs = lstm_cuda.lstm_fwd_q8_cuda(
        wq, s, xp, h0, c0, residuals=True)
    torch.cuda.synchronize()
    assert (lstm_cuda.q8_launches, lstm_cuda.q8_residual_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(ys, ys_r) and torch.equal(h, h_r) and \
        torch.equal(c, c_r)
    assert ys.dtype == dtype and acts.dtype == cs.dtype == torch.bfloat16
    want = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
    errs = [chip_smoke.rel_err(a, b)
            for a, b in zip((ys, h, c, acts, cs), want)]
    assert max(errs) <= chip_smoke.K1Q8_REL, errs
    again = lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp, h0, c0)
    assert all(torch.equal(a, b) for a, b in zip(again, (ys, h, c)))
    exact = lstm.lstm_scan(w, xp, h0, c0)
    assert min(chip_smoke.rel_err(a, b) for a, b in zip(exact, want)) > \
        chip_smoke.K1Q8_REL


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", Q8_SHAPES)
def test_lstm_q8_bwd_kernel_matches_plain(cuda, T, B, H, dtype):
    """K2-q8 against lstm_scan_bwd_q8 on the same (plain) residuals:
    dgates, dh0 and dc0 within chip_smoke.K2Q8_REL (rel L2), and the same
    bits on a second run. Two planted faults must exceed the limits: the
    exact mode's answer (K2 on bf16 W_hh, no quantization), and m taken
    over each block's own 64 columns instead of the row's 4H
    (chip_smoke.k2_q8_block_max)."""
    w, wq, s, xp, h0, c0 = _lstm_q8_inputs(T, B, H, dtype, cuda,
                                           seed=T * H)
    _, _, _, acts, cs = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
    g = torch.Generator().manual_seed(T + 1)
    dys = torch.randn((T, B, H), generator=g).to(cuda, torch.bfloat16)
    dh = torch.randn((B, H), generator=g).to(cuda) * 0.1
    dc = torch.randn((B, H), generator=g).to(cuda) * 0.1
    c0 = c0.to(torch.bfloat16)
    before = lstm_cuda.q8_bwd_launches
    got = lstm_cuda.lstm_bwd_q8_cuda(dys, acts, cs, c0, wq, s, dh, dc)
    torch.cuda.synchronize()
    assert lstm_cuda.q8_bwd_launches == before + 1
    assert got[0].dtype == torch.bfloat16
    c_prev = torch.cat([c0[None], cs[:-1]])
    args = (dys, acts, c_prev, cs)
    want = lstm.lstm_scan_bwd_q8(*args, wq, s, dh, dc)
    limits = [chip_smoke.K2Q8_REL[k] for k in ("dgates", "dh0", "dc0")]
    errs = [chip_smoke.rel_err(a, b) for a, b in zip(got, want)]
    assert all(e <= lim for e, lim in zip(errs, limits)), (errs, limits)
    again = lstm_cuda.lstm_bwd_q8_cuda(dys, acts, cs, c0, wq, s, dh, dc)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    for fault in (lstm.lstm_scan_bwd(*args, w.to(torch.bfloat16), dh, dc),
                  chip_smoke.k2_q8_block_max(*args, wq, s, dh, dc)):
        assert chip_smoke.rel_err(fault[0], want[0]) > limits[0]
        assert chip_smoke.rel_err(fault[1], want[1]) > limits[1]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", Q8_SHAPES + [
    (6, 48, 2048, torch.bfloat16),      # the plan does not fit: per-step
    (9, 37, 200, torch.bfloat16),       # H % 16 != 0: the CUDA-core path
    (1, 100, 1024, torch.bfloat16),     # T = 1, three batch tiles
    (20, 48, 80, torch.bfloat16)])      # persistent, H % 32 != 0
def test_lstm_q8_routes_give_the_per_step_kernels_bits(cuda, T, B, H, dtype):
    """K1-q8 (both modes) and K2-q8 take the route ``lstm_cuda.route``
    gives for this card and shape, one count on it per call (the
    persistent kernels at the main paths' widths in bf16, K1-q8 from
    Q8_FWD_MIN_H); the route's outputs are bit for bit those of the
    per-step kernels (``per_step=True``): the integer sums are exact in
    any order, and the elementwise code is the same."""
    w, wq, s, xp, h0, c0 = _lstm_q8_inputs(T, B, H, dtype, cuda,
                                           seed=T + B + H)
    sms, smem, ncl = lstm_cuda.card(cuda)
    routes = {k: lstm_cuda.route(k, dtype if k == "fwd_q8" else
                                 torch.bfloat16, H, B, sms, smem,
                                 ncl[k])[0] for k in ("fwd_q8", "bwd_q8")}
    if dtype == torch.bfloat16 and H in (1536, 1024, 512):
        assert routes["bwd_q8"] == "persist"
        assert routes["fwd_q8"] == ("persist" if H >= lstm_cuda.Q8_FWD_MIN_H
                                    else "tc_step")
    fwd, took = _route_taken(lambda: lstm_cuda.lstm_fwd_q8_cuda(
        wq, s, xp, h0, c0, residuals=True))
    assert took == {f"fwd_q8_{routes['fwd_q8']}": 1}
    step = lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp, h0, c0, residuals=True,
                                      per_step=True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, step))
    plain, took = _route_taken(lambda: lstm_cuda.lstm_fwd_q8_cuda(
        wq, s, xp, h0, c0))
    assert took == {f"fwd_q8_{routes['fwd_q8']}": 1}
    assert all(torch.equal(a, b) for a, b in zip(plain, fwd))
    acts, cs = fwd[3], fwd[4]
    g = torch.Generator().manual_seed(T + 2)
    dys = torch.randn((T, B, H), generator=g).to(cuda, torch.bfloat16)
    dh = torch.randn((B, H), generator=g).to(cuda) * 0.1
    dc = torch.randn((B, H), generator=g).to(cuda) * 0.1
    bargs = (dys, acts, cs, c0.to(torch.bfloat16), wq, s, dh, dc)
    bwd, took = _route_taken(lambda: lstm_cuda.lstm_bwd_q8_cuda(*bargs))
    assert took == {f"bwd_q8_{routes['bwd_q8']}": 1}
    step = lstm_cuda.lstm_bwd_q8_cuda(*bargs, per_step=True)
    assert all(torch.equal(a, b) for a, b in zip(bwd, step))


@pytest.mark.cuda
def test_lstm_q8_autograd_launches_k1q8_residual_and_k2q8(cuda):
    """lstm_scan(q8=True) under autograd runs the LSTMScanQ8 Function:
    K1-q8 with residuals and K2-q8, no exact-mode kernel; its grads
    against the same Function on CPU tensors (the plain versions): cosine
    > 0.9999; under inference_mode K1-q8 alone."""
    w, xp, h0, c0 = _lstm_inputs(11, 6, 64, torch.bfloat16, cuda, seed=4)
    w.requires_grad_(True)
    xp.requires_grad_(True)

    def launched():
        return (lstm_cuda.q8_residual_launches, lstm_cuda.q8_bwd_launches,
                lstm_cuda.q8_launches, lstm_cuda.residual_launches,
                lstm_cuda.bwd_launches, lstm_cuda.launches)
    n = launched()
    ys, h, c = lstm_cuda.lstm_scan(w, xp, h0, c0, q8=True)
    (ys.float().square().sum() + h.sum()).backward()
    assert launched() == (n[0] + 1, n[1] + 1, *n[2:])
    wc, xc = (t.detach().cpu().requires_grad_(True) for t in (w, xp))
    ys_c, h_c, _ = lstm_cuda.lstm_scan(wc, xc, h0.cpu(), c0.cpu(), q8=True)
    (ys_c.float().square().sum() + h_c.sum()).backward()
    for got, want in ((w.grad, wc.grad), (xp.grad, xc.grad)):
        assert got.dtype == torch.bfloat16
        a, b = got.float().cpu().ravel(), want.float().ravel()
        assert (a @ b / (a.norm() * b.norm())).item() > 0.9999
    with torch.inference_mode():
        lstm_cuda.lstm_scan(w, xp, h0, c0, q8=True)
    assert launched() == (n[0] + 1, n[1] + 1, n[2] + 1, *n[3:])


@pytest.mark.cuda
def test_lstm_q8_kernels_reject_what_they_do_not_take(cuda):
    w, wq, s, xp, h0, c0 = _lstm_q8_inputs(4, 2, 32, torch.float32, cuda,
                                           0)
    with pytest.raises(TypeError):                  # W not quantized
        lstm_cuda.lstm_fwd_q8_cuda(w, s, xp, h0, c0)
    with pytest.raises(TypeError):                  # fp16 x_proj
        lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp.half(), h0, c0)
    with pytest.raises(ValueError):                 # wrong shape
        lstm_cuda.lstm_fwd_q8_cuda(wq[:-1], s, xp, h0, c0)
    with pytest.raises(ValueError, match="expected CUDA"):
        lstm_cuda.lstm_fwd_q8_cuda(wq, s.cpu(), xp, h0, c0)
    with pytest.raises(ValueError):                 # strided x_proj
        lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp.transpose(0, 1).contiguous()
                                   .transpose(0, 1), h0, c0)
    _, _, _, acts, cs = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
    dys = torch.zeros((4, 2, 32), device=cuda, dtype=torch.bfloat16)
    c0r = c0.bfloat16()
    with pytest.raises(TypeError):                  # fp32 dys
        lstm_cuda.lstm_bwd_q8_cuda(dys.float(), acts, cs, c0r, wq, s, h0,
                                   c0)
    with pytest.raises(TypeError):                  # fp32 scales only
        lstm_cuda.lstm_bwd_q8_cuda(dys, acts, cs, c0r, wq, s.double(), h0,
                                   c0)
    with pytest.raises(ValueError):                 # wrong shape
        lstm_cuda.lstm_bwd_q8_cuda(dys[:, :1], acts, cs, c0r, wq, s, h0, c0)
    with pytest.raises(ValueError, match="expected CUDA"):
        lstm_cuda.lstm_bwd_q8_cuda(dys, acts, cs, c0r, wq.cpu(), s, h0, c0)


def _ctc_inputs(device, T=60, N=6, C=20, U=12, seed=0):
    g = torch.Generator().manual_seed(seed)
    log_probs = torch.log_softmax(torch.randn((T, N, C), generator=g) * 2,
                                  -1)
    targets = torch.randint(1, C, (N, U), generator=g)
    input_lengths = torch.randint(2 * U + 1, T + 1, (N,), generator=g)
    target_lengths = torch.randint(1, U + 1, (N,), generator=g)
    target_lengths[0] = 0                      # empty target
    targets[1] = 5                             # one label repeated
    target_lengths[1] = U
    return [t.to(device) for t in (log_probs, targets, input_lengths,
                                   target_lengths)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_kernel_matches_plain(cuda, seed):
    args = _ctc_inputs(cuda, seed=seed)
    before = ctc_cuda.launches
    loss = ctc_cuda.ctc_loss(*args)
    torch.cuda.synchronize()
    assert ctc_cuda.launches == before + 1
    torch.testing.assert_close(loss, ctc.ctc_forward_score(*args),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_ctc_kernel_infeasible_and_empty_items(cuda):
    """Too few frames for the labels: 1e9 (the kernel's -NEG, as in the
    Pallas kernel), finite; no frames at all: exactly 1e9."""
    log_probs, targets, input_lengths, target_lengths = _ctc_inputs(cuda)
    input_lengths[2], target_lengths[2] = 5, 12
    input_lengths[3] = 0
    loss = ctc_cuda.ctc_loss(log_probs, targets, input_lengths,
                             target_lengths)
    assert torch.isfinite(loss).all()
    assert 1e8 < loss[2].item() < 1e10
    assert loss[3].item() == 1e9


@pytest.mark.cuda
def test_ctc_kernel_history(cuda):
    """The alpha history, when asked for, holds the lattice whose final
    states give the loss; asking for it does not change the loss."""
    args = _ctc_inputs(cuda, seed=2)
    T, N = args[0].shape[:2]
    U = args[1].shape[1]
    hist = torch.full((N, T, 2 * U + 1), float("nan"), device=cuda)
    loss_h = ctc_cuda.ctc_loss(*args, history=hist)
    assert torch.equal(loss_h, ctc_cuda.ctc_loss(*args))
    assert torch.isfinite(hist).all()
    for n in range(N):
        t, s = int(args[2][n]) - 1, 2 * int(args[3][n])
        final = hist[n, t, s]
        if s > 0:
            final = torch.logaddexp(final, hist[n, t, s - 1])
        torch.testing.assert_close(-final, loss_h[n], rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_bwd_kernel_matches_plain(cuda, seed):
    """K4 against ctc_grad on K3's history, empty, repeated, infeasible
    and frameless items included: rel/abs 1e-3, the JAX package's bound
    for its kernel (tests/test_lattice_kernels.py); each class's states
    are summed in another (fixed) order. A second run gives the same
    bits."""
    log_probs, targets, input_lengths, target_lengths = _ctc_inputs(
        cuda, seed=seed)
    input_lengths[2], target_lengths[2] = 5, 12     # infeasible
    input_lengths[3] = 0                            # no frames
    args = (log_probs, targets, input_lengths, target_lengths)
    T, N = log_probs.shape[:2]
    hist = torch.empty((N, T, 2 * targets.shape[1] + 1), device=cuda)
    loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    g = torch.rand(N, device=cuda) + 0.5
    before = ctc_cuda.bwd_launches
    got = ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g)
    torch.cuda.synchronize()
    assert ctc_cuda.bwd_launches == before + 1
    want = ctc.ctc_grad(*args, hist, loss, g)
    assert got.shape == log_probs.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g))
    # and the plain history gives the kernel's: K3 == ctc_forward_history
    loss_e, hist_e = ctc.ctc_forward_history(*args)
    torch.testing.assert_close(loss, loss_e, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hist, hist_e, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("per_lane", [2, 4])
def test_ctc_fwd_kernel_with_each_plan(cuda, per_lane, monkeypatch):
    """K3 at lstm:512's lattice (48 x 385 frames, 512 classes, S' = 193)
    with its plan's 2 states a lane over a warpgroup and with 4 over two
    warps forced, frames past len, empty, repeated, infeasible and
    frameless items included: against ctc_forward_history (loss rel
    1e-5, history atol 1e-3), the loss without the history equal to the
    loss with it, loss and history the same bits on a second run."""
    monkeypatch.setattr(ctc_cuda, "FWD_MIN_PER_LANE", per_lane)
    assert ctc_cuda.fwd_plan(193, 512).per_lane == per_lane
    args = _ctc_inputs(cuda, T=385, N=48, C=512, U=96, seed=8)
    _edge_items(args[2], args[3], args[1], 385, 96)
    hists = [torch.full((48, 385, 193), float("nan"), device=cuda)
             for _ in range(2)]
    before = ctc_cuda.launches, ctc_cuda.history_launches
    loss = ctc_cuda.ctc_fwd_cuda(*args)
    losses = [ctc_cuda.ctc_fwd_cuda(*args, history=h) for h in hists]
    torch.cuda.synchronize()
    assert (ctc_cuda.launches, ctc_cuda.history_launches) == \
        (before[0] + 1, before[1] + 2)
    loss_e, hist_e = ctc.ctc_forward_history(*args)
    torch.testing.assert_close(loss, loss_e, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hists[0], hist_e, rtol=1e-5, atol=1e-3)
    assert torch.equal(loss, losses[0]) and torch.equal(*losses)
    assert torch.equal(*hists)


@pytest.mark.cuda
def test_ctc_fwd_planted_edge_faults(cuda):
    """K3's faults at lstm:512's lattice, computed from its plain version
    with the skips s-2 -> s dropped where the sweep reads s-2 from another
    lane (chip_smoke.ctc_fwd_faults): across the warps' edges and at a
    lane edge inside each warp; each reads past CTC_TOL or CTC_HIST_TOL,
    which the kernel reads under."""
    args = _ctc_inputs(cuda, T=385, N=48, C=512, U=96, seed=99)
    hist = torch.empty((48, 385, 193), device=cuda)
    loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    loss_e, hist_e = ctc.ctc_forward_history(*args)
    assert chip_smoke.close(loss, loss_e, chip_smoke.CTC_TOL)[0]
    assert chip_smoke.close(hist, hist_e, chip_smoke.CTC_HIST_TOL)[0]
    faults = chip_smoke.ctc_fwd_faults(torch, ctc, ctc_cuda.fwd_plan(193, 512),
                                       args, loss_e, hist_e)
    assert len(faults) == 2


@pytest.mark.cuda
def test_ctc_autograd_launches_k3_and_k4(cuda):
    """Under autograd ctc_loss runs the CTCLoss Function (K3 with its
    history, then K4); its grads agree with the same Function on CPU
    tensors (the plain pair)."""
    log_probs, targets, input_lengths, target_lengths = _ctc_inputs(
        cuda, seed=3)
    lp = log_probs.clone().requires_grad_(True)
    f0, h0, b0 = (ctc_cuda.launches, ctc_cuda.history_launches,
                  ctc_cuda.bwd_launches)
    ctc_cuda.ctc_loss(lp, targets, input_lengths, target_lengths).mean() \
        .backward()
    assert (ctc_cuda.launches, ctc_cuda.history_launches,
            ctc_cuda.bwd_launches) == (f0, h0 + 1, b0 + 1)
    lc = log_probs.cpu().requires_grad_(True)
    ctc_cuda.ctc_loss(lc, targets.cpu(), input_lengths.cpu(),
                      target_lengths.cpu()).mean().backward()
    torch.testing.assert_close(lp.grad.cpu(), lc.grad, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_backward_kernels_reject_what_they_do_not_take(cuda):
    w, acts, cs, c0, dys, dh, dc = _lstm_bwd_inputs(4, 2, 32, torch.float32,
                                                    cuda)
    with pytest.raises(TypeError):                  # mixed dtypes
        lstm_cuda.lstm_bwd_cuda(dys.bfloat16(), acts, cs, c0, w, dh, dc)
    with pytest.raises(ValueError, match="expected CUDA"):   # CPU + CUDA
        lstm_cuda.lstm_bwd_cuda(dys, acts.cpu(), cs, c0, w, dh, dc)
    with pytest.raises(ValueError):                 # wrong shape
        lstm_cuda.lstm_bwd_cuda(dys[:, :1], acts, cs, c0, w, dh, dc)
    w, xp, h0, c0 = _lstm_inputs(4, 2, 32, torch.float32, cuda)
    with pytest.raises(TypeError):                  # fp16
        lstm_cuda.lstm_fwd_cuda(w.half(), xp.half(), h0, c0, residuals=True)
    args = _ctc_inputs(cuda, seed=1)
    T, N = args[0].shape[:2]
    S = 2 * args[1].shape[1] + 1
    hist = torch.empty((N, T, S), device=cuda)
    loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    g = torch.ones(N, device=cuda)
    with pytest.raises(TypeError):                  # fp64 log-probs
        ctc_cuda.ctc_bwd_cuda(args[0].double(), *args[1:], hist, loss, g)
    with pytest.raises(ValueError, match="expected CUDA"):
        ctc_cuda.ctc_bwd_cuda(*args, hist.cpu(), loss, g)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_bwd_cuda(*args, hist[:, :-1], loss, g)


@pytest.mark.cuda
def test_ctc_kernel_rejects_too_many_states(cuda):
    """1025 states (U=512), past the old one-thread-a-state limit, now
    run; 4097 (U=2048), one past K3's and K4's 4096, raise."""
    log_probs = torch.log_softmax(torch.randn((8, 1, 5), device=cuda), -1)
    targets = torch.ones((1, 512), dtype=torch.long, device=cuda)
    args = (log_probs, targets, torch.tensor([8]), torch.tensor([512]))
    assert ctc_cuda.ctc_loss(*args).item() > 1e8       # infeasible: 1e9
    lp = log_probs.clone().requires_grad_(True)
    ctc_cuda.ctc_loss(lp, *args[1:]).sum().backward()
    assert torch.isfinite(lp.grad).all()
    targets = torch.ones((1, 2048), dtype=torch.long, device=cuda)
    args = (log_probs, targets, torch.tensor([8]), torch.tensor([2048]))
    with pytest.raises(ValueError, match="4097 lattice states"):
        ctc_cuda.ctc_loss(*args)
    hist = torch.empty((1, 8, 4097), device=cuda)
    with pytest.raises(ValueError, match="4097 lattice states"):
        ctc_cuda.ctc_bwd_cuda(*args, hist, torch.ones(1, device=cuda),
                              torch.ones(1, device=cuda))


@pytest.mark.cuda
def test_star_kernel_rejects_too_many_states(cuda):
    """Star-CTC takes U <= 1022 (PAD + 4U+3 + 1 <= 4096 lanes of K8a; K8b
    the same states); U = 1023 raises in both kernels."""
    log_probs = torch.log_softmax(torch.randn((8, 1, 5), device=cuda), -1)
    for U, ok in ((1022, True), (1023, False)):
        targets = torch.ones((1, U), dtype=torch.long, device=cuda)
        star_lp, star_targets = star.intersperse_stars(log_probs, targets)
        args = (star_lp, star_targets, torch.tensor([8]), torch.tensor([U]))
        if ok:
            assert star_cuda.star_fwd_cuda(*args, -0.5).item() > 1e8
            continue
        with pytest.raises(ValueError, match="4095 lattice states"):
            star_cuda.star_fwd_cuda(*args, -0.5)
        hist = torch.empty((1, 8, 4 * U + 3), device=cuda)
        with pytest.raises(ValueError, match="4095 lattice states"):
            star_cuda.star_bwd_cuda(*args, hist, torch.ones(1, device=cuda),
                                    torch.ones(1, device=cuda), -0.5)


def _edge_items(input_lengths, target_lengths, targets, T, U):
    """The lattices' special items in place: 0 an empty target, 1 one
    label repeated U times, 2 infeasible (5 frames), 3 no frames, 4 every
    frame and every label; the rest end before T (frames past len)."""
    target_lengths[0] = 0
    targets[1] = 5
    target_lengths[1] = U
    input_lengths[2], target_lengths[2] = 5, U
    input_lengths[3] = 0
    input_lengths[4], target_lengths[4] = T, U


# (T, N, C, U): S = 2U+1 at K4's lane (K = 2 states) and warp (64, 128
# states) edges, lstm:512's 48 x 385 frames (U = 96), and long targets:
# S = 1025 (K = 16 over 3 warps) and 4095 (K = 32 over a warpgroup)
CTC_EDGE_SHAPES = [(70, 6, 20, 15), (70, 6, 20, 16), (140, 6, 20, 31),
                   (140, 6, 20, 32), (300, 6, 20, 63), (300, 6, 20, 64),
                   (385, 48, 512, 96), (1100, 5, 40, 512),
                   (4200, 5, 40, 2047)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,C,U", CTC_EDGE_SHAPES)
def test_ctc_lattice_kernels_at_layout_edges(cuda, T, N, C, U):
    """K3 against ctc_forward_history (loss rel 1e-5, history atol 1e-3)
    and K4 against ctc_grad (rel/abs 1e-3) at the backward layout's edges,
    with frames past len, empty, repeated, infeasible and frameless items;
    K4 gives the same bits twice and counts one launch."""
    g = torch.Generator().manual_seed(U)
    log_probs = torch.log_softmax(torch.randn((T, N, C), generator=g) * 2,
                                  -1)
    targets = torch.randint(1, C, (N, U), generator=g)
    input_lengths = torch.randint(2 * U + 1, T + 1, (N,), generator=g)
    target_lengths = torch.randint(1, U + 1, (N,), generator=g)
    _edge_items(input_lengths, target_lengths, targets, T, U)
    args = [t.to(cuda) for t in (log_probs, targets, input_lengths,
                                 target_lengths)]
    hist = torch.empty((N, T, 2 * U + 1), device=cuda)
    loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    loss_e, hist_e = ctc.ctc_forward_history(*args)
    torch.testing.assert_close(loss, loss_e, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hist, hist_e, rtol=1e-5, atol=1e-3)
    gn = torch.rand(N, generator=g).to(cuda) + 0.5
    before = ctc_cuda.bwd_launches
    got = ctc_cuda.ctc_bwd_cuda(*args, hist, loss, gn)
    torch.cuda.synchronize()
    assert ctc_cuda.bwd_launches == before + 1
    want = ctc.ctc_grad(*args, hist, loss, gn)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, ctc_cuda.ctc_bwd_cuda(*args, hist, loss, gn))


# ------------------------------------------------------- RNN-T joint (K9)

def _joint_inputs(device, N, T, U1, V, seed=0):
    g = torch.Generator().manual_seed(seed)
    f = torch.randn((N, T, V), generator=g) * 3
    gg = torch.randn((N, U1, V), generator=g) * 3
    dlse = torch.randn((N, T, U1), generator=g)
    dlse[0, T // 2:] = 0.0                 # frames past an item's length
    return f.to(device), gg.to(device), dlse.to(device)


JOINT_SHAPES = [
    (2, 9, 5, 19),                     # V % 4 != 0: 4-byte copies
    (3, 40, 7, 64),
    (1, 1, 1, 1),
    (2, 33, 9, 4096),
    (3, 70, 40, 130),                  # two chunks of U+1, a tail stage
    (16, 301, 25, 512),                # rnn-transducer:lstm:512's joint
    (2, 33, 9, 16384),                 # a 16k vocabulary
    chip_smoke.JOINT_V16K,             # its joint at rnn-transducer's
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,U1,V", JOINT_SHAPES)
def test_joint_lse_kernel_matches_plain(cuda, N, T, U1, V):
    """K9a against the plain factored pairwise_lse and the materialized
    joint (atol 1e-5, rtol 1e-5), one launch a call, the same bits
    twice."""
    f, g, _ = _joint_inputs(cuda, N, T, U1, V, seed=N + T + V)
    before = joint_cuda.launches
    lse = joint_cuda.pairwise_lse(f, g)
    torch.cuda.synchronize()
    assert joint_cuda.launches == before + 1
    torch.testing.assert_close(lse, joint.pairwise_lse(f, g)[0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(lse, joint.pairwise_lse_reference(f, g),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(lse, joint_cuda.pairwise_lse(f, g))
    # the row maxima for K9b: the same launch, lse's bits unchanged
    lse2, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
    assert torch.equal(lse2, lse)
    assert torch.equal(mf, f.amax(-1)) and torch.equal(mg, g.amax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("peaks", ["disjoint", "every"])
def test_joint_lse_kernel_fixup(cuda, peaks):
    """Where f and g peak at different v the factored sum underflows: the
    cells (n, 7, 2) of the disjoint peaks, or every cell; K9a recomputes
    them exactly and matches the plain version and the materialized joint
    (atol 1e-5, rtol 1e-5), the same bits twice."""
    f, g, _ = chip_smoke.joint_inputs(torch, cuda, 3, 40, 6, 300, 3, peaks)
    marks = joint.marks(f, g)
    if peaks == "every":
        assert marks.all()
    else:
        assert marks[:, 7, 2].all() and int(marks.sum()) == 3
    lse = joint_cuda.pairwise_lse(f, g)
    torch.testing.assert_close(lse, joint.pairwise_lse(f, g)[0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(lse, joint.pairwise_lse_reference(f, g),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(lse, joint_cuda.pairwise_lse(f, g))


@pytest.mark.cuda
def test_joint_lse_planted_faults(cuda):
    """K9a's faults on the disjoint peaks at rnn-transducer:lstm:512's
    joint, emulated from the plain version (chip_smoke.joint_faults): the
    fix-up skipped, one stage of V left out; each reads past JOINT_TOL,
    which the kernel reads under."""
    f, g, _ = chip_smoke.joint_inputs(torch, cuda, 16, 301, 25, 512, 11,
                                      "disjoint")
    want = joint.pairwise_lse(f, g)[0]
    assert chip_smoke.close(joint_cuda.pairwise_lse(f, g), want,
                            chip_smoke.JOINT_TOL)[0]
    assert len(chip_smoke.joint_faults(torch, joint, f, g, want)) == 2


# K9b's shapes: K9a's, and U+1 = 2049 (the parent kernel refused past
# 1,816): 65 chunks of U+1's rows and 10 of T's, a block each
JOINT_BWD_SHAPES = JOINT_SHAPES + [chip_smoke.JOINT_U2049]


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,U1,V", JOINT_BWD_SHAPES)
def test_joint_lse_bwd_kernel_matches_plain(cuda, N, T, U1, V):
    """K9b against the plain factored pairwise_lse_grad (chip_smoke.k9b_tols:
    df atol 1e-5, dg atol 1e-4, rtol 1e-5, for sums of up to 301 rows) and
    against its fp64 evaluation (chip_smoke.k9b_exact: (n + 64) 2^-24
    sum|p|, n the rows summed; the only check of df at U+1 = 2049); rows
    with dlse = 0 give exactly 0 in df; the same bits twice for df and dg
    (every sum in a fixed order)."""
    f, g, dlse = _joint_inputs(cuda, N, T, U1, V, seed=N * T + V)
    lse, mf, mg = joint.pairwise_lse(f, g)
    before = joint_cuda.bwd_launches
    df, dg = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
    torch.cuda.synchronize()
    assert joint_cuda.bwd_launches == before + 1
    df_e, dg_e = joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg)
    tol_f, tol_g = chip_smoke.k9b_tols(T, U1)
    assert tol_f is None or chip_smoke.close(df, df_e, tol_f)[0]
    assert tol_g is None or chip_smoke.close(dg, dg_e, tol_g)[0]
    exact, limits, marked = chip_smoke.k9b_exact(joint, f, g, lse, dlse, mf,
                                                 mg)
    assert marked == 0
    assert chip_smoke.within_limit(df, exact[0], limits[0])[0]
    assert chip_smoke.within_limit(dg, exact[1], limits[1])[0]
    if T > 1:
        assert not df[0, T // 2:].any()
    df2, dg2 = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
    assert torch.equal(df, df2) and torch.equal(dg, dg2)


@pytest.mark.cuda
@pytest.mark.parametrize("peaks", ["disjoint", "every"])
def test_joint_lse_bwd_kernel_fixup(cuda, peaks):
    """Where f and g peak at different v the factored weight would pass
    2^64 dlse: K9b adds the marked cells' exact terms (the disjoint peaks'
    cells (n, 7, 2) with dlse != 0, or every cell) and matches the plain
    version and the direct oracle (df atol 1e-5, dg atol 1e-4, rtol
    1e-5), the same bits twice."""
    f, g, dlse = chip_smoke.joint_inputs(torch, cuda, 3, 40, 6, 300, 3,
                                         peaks)
    lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
    marks = joint.grad_marks(lse, dlse, mf, mg)
    if peaks == "every":
        assert torch.equal(marks, dlse != 0)
    else:
        assert torch.equal(marks[:, 7, 2], dlse[:, 7, 2] != 0)
        assert int(marks.sum()) == int((dlse[:, 7, 2] != 0).sum()) > 0
    df, dg = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
    for want in (joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg),
                 joint.pairwise_lse_grad_reference(f, g, lse, dlse)):
        torch.testing.assert_close(df, want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dg, want[1], rtol=1e-5, atol=1e-4)
    df2, dg2 = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
    assert torch.equal(df, df2) and torch.equal(dg, dg2)


@pytest.mark.cuda
def test_joint_lse_bwd_planted_faults(cuda):
    """K9b's faults on the disjoint peaks at rnn-transducer:lstm:512's
    joint, emulated from the plain version (chip_smoke.joint_bwd_faults):
    the marked cells' exact terms left out, one frame group left out of
    dg; each reads past JOINT_TOL / JOINT_DG_TOL, which the kernel reads
    under. At U+1 = 2049 (chip_smoke.joint_bwd_long_faults): one chunk of
    U+1's rows left out of df reads past the fp64 bound, which the kernel
    reads under."""
    f, g, dlse = chip_smoke.joint_inputs(torch, cuda, 16, 301, 25, 512, 11,
                                         "disjoint")
    lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
    df, dg = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
    want = joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg)
    assert chip_smoke.close(df, want[0], chip_smoke.JOINT_TOL)[0]
    assert chip_smoke.close(dg, want[1], chip_smoke.JOINT_DG_TOL)[0]
    assert len(chip_smoke.joint_bwd_faults(torch, joint, f, g, lse, dlse,
                                           mf, mg, want)) == 2
    f, g, dlse = chip_smoke.joint_inputs(torch, cuda, *chip_smoke.JOINT_U2049,
                                         13)
    lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
    df = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)[0]
    exact, limits, _ = chip_smoke.k9b_exact(joint, f, g, lse, dlse, mf, mg)
    assert chip_smoke.within_limit(df, exact[0], limits[0])[0]
    assert len(chip_smoke.joint_bwd_long_faults(joint, f, g, lse, dlse, mf,
                                                mg, exact, limits)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,U1,V", [(16, 301, 25, 512),
                                      chip_smoke.JOINT_U2049])
def test_joint_lse_bwd_allocates_no_scratch(cuda, N, T, U1, V):
    """One K9b call allocates df and dg and nothing more: no (N, tiles,
    U+1, V) partial sums (15.6 MB at the first shape, against df's 9.9
    MB), and at U+1 = 2049 no partial sums of df across the chunks."""
    f, g, dlse = _joint_inputs(cuda, N, T, U1, V, seed=5)
    lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
    joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)      # built, warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    # df and dg, with 2 MiB for the allocator's rounding of its blocks
    assert grown <= 4 * (N * T * V + N * U1 * V) + 2 ** 21, grown
    del out


@pytest.mark.cuda
def test_joint_autograd_launches_k9a_and_k9b(cuda):
    f, g, dlse = _joint_inputs(cuda, 3, 17, 6, 40, seed=7)
    f.requires_grad_(True)
    g.requires_grad_(True)
    f0, b0 = joint_cuda.launches, joint_cuda.bwd_launches
    (joint_cuda.pairwise_lse(f, g) * dlse).sum().backward()
    torch.cuda.synchronize()
    assert (joint_cuda.launches, joint_cuda.bwd_launches) == (f0 + 1, b0 + 1)
    fc, gc = (t.detach().cpu().requires_grad_(True) for t in (f, g))
    (joint_cuda.pairwise_lse(fc, gc) * dlse.cpu()).sum().backward()
    torch.testing.assert_close(f.grad.cpu(), fc.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g.grad.cpu(), gc.grad, rtol=1e-5, atol=1e-4)
    with torch.inference_mode():
        joint_cuda.pairwise_lse(f, g)
    assert (joint_cuda.launches, joint_cuda.bwd_launches) == (f0 + 2, b0 + 1)


# ------------------------------------------------------- Star-CTC (K8)

def _star_inputs(device, T=40, N=6, V=12, U=5, seed=0):
    """Star-vocabulary log-probs (T, N, 2V) and star targets (N, 2U+1)
    from random log-probs: a full-length item, an empty target, repeated
    labels, an infeasible item and one with no frames."""
    g = torch.Generator().manual_seed(seed)
    log_probs = torch.log_softmax(torch.randn((T, N, V), generator=g) * 2,
                                  -1)
    targets = torch.randint(1, V, (N, U), generator=g)
    input_lengths = torch.randint(min(4 * U + 3, T - T // 4), T + 1, (N,),
                                  generator=g)
    target_lengths = torch.randint(1, U + 1, (N,), generator=g)
    input_lengths[0], target_lengths[0] = T, U      # full length
    target_lengths[1] = 0                           # empty target
    targets[2] = 3                                  # one label repeated
    target_lengths[2] = U
    input_lengths[3], target_lengths[3] = U - 1, U  # infeasible
    if N > 4:
        input_lengths[4] = 0                        # no frames
    star_lp, star_targets = star.intersperse_stars(log_probs, targets)
    return [t.to(device) for t in (star_lp, star_targets, input_lengths,
                                   target_lengths)]


STAR_SHAPES = [
    (40, 6, 12, 5),
    (9, 5, 3, 1),
    (385, 48, 512, 96),                # lstm:512 --star-penalty's lattice
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,V,U", STAR_SHAPES)
@pytest.mark.parametrize("penalty", [0.0, -0.5, -2.0])
def test_star_kernel_matches_plain(cuda, T, N, V, U, penalty):
    """K8a against star_forward_history (loss and alpha history, the
    infeasible and frameless items included) and, on the feasible items,
    against the JAX package's plain lattice star_ctc_forward_score."""
    args = _star_inputs(cuda, T, N, V, U, seed=T + U)
    S = 4 * U + 3
    hist = torch.full((N, T, S), float("nan"), device=cuda)
    f0, h0 = star_cuda.launches, star_cuda.history_launches
    loss = star_cuda.star_fwd_cuda(*args, penalty)
    loss_h = star_cuda.star_fwd_cuda(*args, penalty, history=hist)
    torch.cuda.synchronize()
    assert (star_cuda.launches, star_cuda.history_launches) == (f0 + 1,
                                                                h0 + 1)
    assert torch.equal(loss, loss_h) and torch.isfinite(hist).all()
    loss_e, hist_e = star.star_forward_history(*args, penalty)
    torch.testing.assert_close(loss, loss_e, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hist, hist_e, rtol=1e-5, atol=1e-3)
    assert 1e8 < loss[3].item() < 1e10
    if N > 4:
        assert loss[4].item() == 1e9


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,V,U", STAR_SHAPES)
@pytest.mark.parametrize("penalty", [0.0, -0.5, -2.0])
def test_star_bwd_kernel_matches_plain(cuda, T, N, V, U, penalty):
    """K8b against star_grad on K8a's history: rel/abs 1e-3; several
    states map to one class, summed in another (fixed) order. A second
    run gives the same bits."""
    args = _star_inputs(cuda, T, N, V, U, seed=T * U)
    hist = torch.empty((N, T, 4 * U + 3), device=cuda)
    loss = star_cuda.star_fwd_cuda(*args, penalty, history=hist)
    g = torch.rand(N, generator=torch.Generator().manual_seed(1)).to(cuda) \
        + 0.5
    before = star_cuda.bwd_launches
    got = star_cuda.star_bwd_cuda(*args, hist, loss, g, penalty)
    torch.cuda.synchronize()
    assert star_cuda.bwd_launches == before + 1
    want = star.star_grad(*args, hist, loss, g, penalty)
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, star_cuda.star_bwd_cuda(*args, hist, loss, g,
                                                    penalty))


# (T, N, V, U): S = 4U+3 at K8b's lane (K = 4) and warp (128 states)
# edges, lstm:512 --star-penalty's lattice, and long targets: S = 1027
# (K = 16) and 4091, the longest K8a takes (K = 32 over a warpgroup)
STAR_EDGE_SHAPES = [(60, 6, 12, 7), (60, 6, 12, 8), (140, 6, 12, 31),
                    (140, 6, 12, 32), (385, 48, 512, 96),
                    (700, 5, 20, 256), (2300, 5, 20, 1022)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,V,U", STAR_EDGE_SHAPES)
def test_star_lattice_kernels_at_layout_edges(cuda, T, N, V, U):
    """K8a against star_forward_history and K8b against star_grad at the
    backward layout's edges (the tolerances of the tests above), with
    frames past len, empty, repeated, infeasible and frameless items; K8b
    gives the same bits twice and counts one launch."""
    args = _star_inputs(cuda, T, N, V, U, seed=U + 7)
    S = 4 * U + 3
    hist = torch.empty((N, T, S), device=cuda)
    loss = star_cuda.star_fwd_cuda(*args, -0.5, history=hist)
    loss_e, hist_e = star.star_forward_history(*args, -0.5)
    torch.testing.assert_close(loss, loss_e, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hist, hist_e, rtol=1e-5, atol=1e-3)
    gn = torch.rand(N, generator=torch.Generator().manual_seed(U)).to(
        cuda) + 0.5
    before = star_cuda.bwd_launches
    got = star_cuda.star_bwd_cuda(*args, hist, loss, gn, -0.5)
    torch.cuda.synchronize()
    assert star_cuda.bwd_launches == before + 1
    want = star.star_grad(*args, hist, loss, gn, -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, star_cuda.star_bwd_cuda(*args, hist, loss, gn,
                                                    -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,V,U", [(385, 48, 512, 96), (700, 5, 20, 256),
                                     (2300, 5, 20, 1022)])
def test_star_fwd_kernel_with_and_without_history(cuda, T, N, V, U):
    """K8a at lstm:512's lattice (S = 387: 4 states a lane over a
    warpgroup), S = 1027 and 4091 (8 states a lane over 5 and 16 warps):
    against star_forward_history within the module's tolerances; the loss
    without the history equal to the loss with it; loss and history the
    same bits on a second run."""
    args = _star_inputs(cuda, T, N, V, U, seed=U + 3)
    S = 4 * U + 3
    assert star_cuda.fwd_plan(S, 2 * V).per_lane == (4 if S <= 1024 else 8)
    hists = [torch.full((N, T, S), float("nan"), device=cuda)
             for _ in range(2)]
    loss = star_cuda.star_fwd_cuda(*args, -0.5)
    losses = [star_cuda.star_fwd_cuda(*args, -0.5, history=h)
              for h in hists]
    torch.cuda.synchronize()
    loss_e, hist_e = star.star_forward_history(*args, -0.5)
    torch.testing.assert_close(loss, loss_e, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hists[0], hist_e, rtol=1e-5, atol=1e-3)
    assert torch.equal(loss, losses[0]) and torch.equal(*losses)
    assert torch.equal(*hists)


@pytest.mark.cuda
def test_star_fwd_planted_edge_faults(cuda):
    """K8a's faults at lstm:512's lattice, computed from its plain version
    with the label edges s-4 -> s dropped where the sweep reads s-4 from
    another lane (chip_smoke.star_fwd_faults): across the warps' edges
    and at a lane edge inside each warp; each reads past STAR_TOL or the
    history's limit, which the kernel reads under."""
    args = _star_inputs(cuda, 385, 48, 512, 96, seed=99)
    hist = torch.empty((48, 385, 387), device=cuda)
    loss = star_cuda.star_fwd_cuda(*args, chip_smoke.STAR_PENALTY,
                                   history=hist)
    loss_e, hist_e = star.star_forward_history(*args,
                                               chip_smoke.STAR_PENALTY)
    assert chip_smoke.close(loss, loss_e, chip_smoke.STAR_TOL)[0]
    assert chip_smoke.close(hist, hist_e, chip_smoke.STAR_HIST_TOL)[0]
    faults = chip_smoke.star_fwd_faults(torch, star,
                                        star_cuda.fwd_plan(387, 1024), args,
                                        loss_e, hist_e)
    assert len(faults) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K8b"])
def test_lattice_bwd_kernels_with_rows_too_wide_to_stage(cuda, kernel):
    """30,000 classes: the plan writes the class sums straight to the
    gradient and zeros the empty columns (no staged rows); against the
    plain versions within rel/abs 1e-3, the same bits twice."""
    if kernel == "K4":
        args = _ctc_inputs(cuda, T=40, N=5, C=30000, U=12, seed=6)
        S, C = 25, 30000
        assert not ctc_cuda.plan(S, C).dense
        hist = torch.empty((5, 40, S), device=cuda)
        loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
        g = torch.rand(5, device=cuda) + 0.5
        run = lambda: ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g)
        want = ctc.ctc_grad(*args, hist, loss, g)
    else:
        args = _star_inputs(cuda, 40, 5, 15000, 5, seed=6)
        assert not star_cuda.plan(23, 30000).dense
        hist = torch.empty((5, 40, 23), device=cuda)
        loss = star_cuda.star_fwd_cuda(*args, -0.5, history=hist)
        g = torch.rand(5, device=cuda) + 0.5
        run = lambda: star_cuda.star_bwd_cuda(*args, hist, loss, g, -0.5)
        want = star.star_grad(*args, hist, loss, g, -0.5)
    got = run()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, run())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K8b"])
def test_lattice_bwd_kernels_give_the_same_bits_every_run(cuda, kernel):
    """K4 and K8b at lstm:512's train shapes (48 x 385 frames, 512
    classes, 96 labels; padded targets put many states in one class):
    three runs, one set of bits (each class's states summed in a fixed
    order, no atomics)."""
    g = torch.rand(48, generator=torch.Generator().manual_seed(2)).to(cuda) \
        + 0.5
    if kernel == "K4":
        args = _ctc_inputs(cuda, T=385, N=48, C=512, U=96, seed=4)
        hist = torch.empty((48, 385, 193), device=cuda)
        loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
        run = lambda: ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g)
    else:
        args = _star_inputs(cuda, 385, 48, 512, 96, seed=4)
        hist = torch.empty((48, 385, 387), device=cuda)
        loss = star_cuda.star_fwd_cuda(*args, -0.5, history=hist)
        run = lambda: star_cuda.star_bwd_cuda(*args, hist, loss, g, -0.5)
    first = run()
    for _ in range(2):
        assert torch.equal(run(), first)


@pytest.mark.cuda
def test_star_autograd_launches_k8a_and_k8b(cuda):
    """Under autograd star_ctc_loss runs the StarCTCLoss Function (K8a
    with its history, K8b) on the star vocabulary and chains through
    intersperse_stars; grads against the same Function on CPU tensors.
    K3 and K4 are not launched."""
    g = torch.Generator().manual_seed(2)
    T, N, V, U = 30, 4, 10, 4
    log_probs = torch.log_softmax(torch.randn((T, N, V), generator=g), -1)
    targets = torch.randint(1, V, (N, U), generator=g)
    lengths = (torch.tensor([30, 25, 22, 30]), torch.tensor([4, 2, 3, 1]))
    lp = log_probs.to(cuda).requires_grad_(True)
    before = (star_cuda.launches, star_cuda.history_launches,
              star_cuda.bwd_launches, ctc_cuda.history_launches,
              ctc_cuda.bwd_launches)
    star_cuda.star_ctc_loss(lp, targets.to(cuda), *lengths,
                            star_penalty=-0.5).mean().backward()
    after = (star_cuda.launches, star_cuda.history_launches,
             star_cuda.bwd_launches, ctc_cuda.history_launches,
             ctc_cuda.bwd_launches)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 0, 0]
    lc = log_probs.clone().requires_grad_(True)
    star_cuda.star_ctc_loss(lc, targets, *lengths,
                            star_penalty=-0.5).mean().backward()
    torch.testing.assert_close(lp.grad.cpu(), lc.grad, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_star_and_joint_kernels_reject_what_they_do_not_take(cuda):
    args = _star_inputs(cuda, seed=4)
    with pytest.raises(TypeError):                  # fp64 log-probs
        star_cuda.star_fwd_cuda(args[0].double(), *args[1:], -0.5)
    with pytest.raises(ValueError, match="expected CUDA"):
        star_cuda.star_fwd_cuda(*args[:3], args[3], -0.5,
                                history=torch.empty(
                                    (6, 40, 23)).float())
    f, g, dlse = _joint_inputs(cuda, 2, 5, 3, 7)
    with pytest.raises(TypeError):
        joint_cuda.pairwise_lse(f.double(), g.double())
    with pytest.raises(ValueError):                  # V differs
        joint_cuda.pairwise_lse(f, g[..., :-1])
    lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
    with pytest.raises(ValueError, match="expected CUDA"):
        joint_cuda.lse_bwd_cuda(f, g, lse.cpu(), dlse, mf, mg)
    with pytest.raises(ValueError, match="expected CUDA"):
        joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf.cpu(), mg)
    with pytest.raises(ValueError):                  # mg of another U+1
        joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg[:, :-1])


# ------------------------------------------- flash attention (K5, K7)

def _qkv(device, N, H, T, S, D, dtype, seed=0, fused=False):
    """q (N, H, T, D), k, v (N, H, S, D); with ``fused`` (T == S) they are
    strided views of one (N, T, 3 H D) projection, as the GPT makes them."""
    g = torch.Generator().manual_seed(seed)
    if fused:
        qkv = torch.randn((N, T, 3 * H * D), generator=g).to(device, dtype)
        q, k, v = qkv.split(H * D, dim=-1)
        return [t.reshape(N, T, H, D).transpose(1, 2) for t in (q, k, v)]
    return [torch.randn(shape, generator=g).to(device, dtype)
            for shape in ((N, H, T, D), (N, H, S, D), (N, H, S, D))]


def _close_attn(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert (got.float() - want.float()).abs().mean().item() < 2e-3


FLASH_CASES = [
    (2, 2, 160, 160, False, 0, 64),
    (2, 2, 300, 300, True, 0, 64),
    (2, 2, 160, 288, True, 5, 64),
    (3, 4, 70, 70, True, 0, 32),         # gpt-nano's head width
    (32, 12, 512, 512, True, 0, 64),     # hap --no-pack at GPT-2 small
    # the bf16 kernel's 128-row tiles: edges, t0 > 0 with T < S
    (2, 2, 1, 1, True, 0, 64),
    (2, 2, 127, 127, True, 0, 64),
    (2, 2, 128, 128, True, 0, 32),
    (2, 2, 129, 129, True, 0, 64),
    (2, 2, 129, 300, True, 7, 64),
    (2, 2, 127, 300, True, 7, 32),
    (2, 2, 1, 300, True, 7, 64),
    (8, 12, 1024, 1024, True, 0, 64),    # hala at GPT-2 small (with lse)
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,T,S,causal,t0,D", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, N, H, T, S, causal, t0, D, dtype):
    q, k, v = _qkv(cuda, N, H, T, S, D, dtype, seed=T + S + D,
                   fused=T == S)
    kvl = torch.full((N,), S, dtype=torch.int32)
    kvl[1] = max(S // 2, 1)
    kvl = kvl.to(cuda)
    before = flash_cuda.launches
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, causal, t0,
                                       with_lse=True)
    o2 = flash_cuda.flash_attention(q, k, v, kvl, causal, t0)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 2
    assert torch.equal(o, o2) and o.dtype == dtype
    want, lse_e = flash._reference(q, k, v, kvl, causal, t0, with_lse=True)
    _close_attn(o, want, dtype)
    torch.testing.assert_close(lse, lse_e, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_fully_masked_rows_average_v(cuda, dtype):
    """kv_lengths 0: every column masked; the kernel gives the plain
    version's mean of v over the S real columns, causal or not, with t0."""
    for causal, t0 in ((True, 7), (False, 0)):
        q, k, v = _qkv(cuda, 2, 2, 70, 130, 64, dtype, seed=3)
        kvl = torch.tensor([0, 90], dtype=torch.int32, device=cuda)
        o = flash_cuda.flash_fwd_cuda(q, k, v, kvl, causal, t0)
        want = flash._reference(q, k, v, kvl, causal, t0)
        _close_attn(o, want, dtype)
        mean_v = v[0].float().mean(dim=1, keepdim=True).expand(2, 70, 64)
        torch.testing.assert_close(o[0].float(), mean_v, atol=2e-2 if
                                   dtype == torch.bfloat16 else 1e-5,
                                   rtol=0)


def _segments(N, T, rng_seed, lengths=None):
    """pack_segments-style ids: consecutive runs 1, 2, ... of random (or
    given) lengths, then a 0-padded tail."""
    g = torch.Generator().manual_seed(rng_seed)
    seg = torch.zeros((N, T), dtype=torch.int32)
    for r in range(N):
        fill, s = 0, 1
        while fill < T - 16:
            n = lengths or int(torch.randint(8, 90, (1,), generator=g))
            n = min(n, T - 16 - fill) if lengths is None else min(n, T - fill)
            seg[r, fill:fill + n] = s
            fill, s = fill + n, s + 1
    return seg


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,T,seg_len", [(2, 2, 256, None),
                                           (2, 3, 300, None),
                                           (16, 12, 1024, 64),
                                           (2, 2, 129, None),
                                           (4, 12, 1024, None)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_packed_kernel_matches_plain(cuda, N, H, T, seg_len, causal,
                                           dtype):
    q, k, v = _qkv(cuda, N, H, T, T, 64, dtype, seed=T + H, fused=True)
    seg = _segments(N, T, T, seg_len).to(cuda)
    before = flash_cuda.packed_launches
    o = flash_cuda.flash_attention_packed(q, k, v, seg, causal)
    torch.cuda.synchronize()
    assert flash_cuda.packed_launches == before + 1
    assert torch.isfinite(o.float()).all()
    _close_attn(o, flash._packed_reference(q, k, v, seg, causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_flash_reads_the_fused_projection_in_place(cuda, packed):
    """q, k, v as the GPT makes them, strided views of one (N, T, 3 H D)
    projection: the kernel reads them where they lie (its TMA maps take
    the views' strides), so the call allocates o and nothing else."""
    N, H, T, D = 4, 12, 256, 64
    q, k, v = _qkv(cuda, N, H, T, T, D, torch.bfloat16, seed=7, fused=True)
    assert not q.is_contiguous()
    kvl = torch.full((N,), T, dtype=torch.int32, device=cuda)
    seg = _segments(N, T, 1).to(cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    o = flash_cuda.flash_packed_cuda(q, k, v, seg) if packed else \
        flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0)
    torch.cuda.synchronize()
    o_bytes = -(-o.numel() * o.element_size() // 512) * 512
    assert torch.cuda.max_memory_allocated() - base <= o_bytes
    want = flash._packed_reference(q, k, v, seg, True) if packed else \
        flash._reference(q, k, v, kvl, True, 0)
    _close_attn(o, want, torch.bfloat16)


@pytest.mark.cuda
def test_flash_rejects_views_tma_cannot_take(cuda):
    """A row stride that is not a multiple of 16 bytes, or a byte stride
    of 2^40 or more, is refused before any launch (TMA's rule for the
    maps of q, k and v)."""
    N, H, T, D = 2, 2, 64, 64
    q, k, v = _qkv(cuda, N, H, T, T, D, torch.bfloat16, seed=9)
    kvl = torch.full((N,), T, dtype=torch.int32, device=cuda)
    wide = torch.zeros((N, T, H * D + 4), dtype=torch.bfloat16, device=cuda)
    odd = wide[..., :H * D].unflatten(-1, (H, D)).transpose(1, 2)
    far = torch.zeros((H, T, D), dtype=torch.bfloat16, device=cuda) \
        .as_strided((1, H, T, D), (1 << 39, T * D, D, 1))
    before = flash_cuda.launches, flash_cuda.packed_launches
    for bad in (odd, far):
        n = bad.shape[0]
        with pytest.raises(ValueError, match="16 bytes"):
            flash_cuda.flash_fwd_cuda(bad, k[:n], v[:n], kvl[:n], True, 0)
        with pytest.raises(ValueError, match="16 bytes"):
            flash_cuda.flash_fwd_cuda(q[:n], k[:n], bad, kvl[:n], True, 0)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_cuda.flash_packed_cuda(odd, odd, odd,
                                     torch.ones((N, T), dtype=torch.int32,
                                                device=cuda))
    assert (flash_cuda.launches, flash_cuda.packed_launches) == before


K6_CASES = [
    (8, 12, 1024, 1024, True, 0, 64),    # hala: GPT-2 small, B=8
    (2, 2, 160, 160, False, 0, 64),
    (2, 2, 300, 300, True, 0, 64),
    (2, 2, 160, 288, True, 5, 64),       # T != S, t0 > 0
    (3, 4, 70, 70, True, 0, 32),         # gpt-nano's head width
    (2, 3, 100, 140, True, 7, 32),
    # tile edges of the bf16 kernels (128-row items, K6b's 64-row query
    # tiles): one query row; 127 and 129; T = 70, whose lse and delta
    # rows are not 16-byte multiples (the scratch pads them to 72); t0 =
    # 126, and 65, where the diagonal meets a tile's last row exactly
    (2, 2, 1, 300, True, 126, 64),
    (2, 2, 127, 127, True, 0, 64),
    (2, 2, 129, 129, True, 0, 32),
    (2, 3, 70, 300, True, 126, 32),
    (2, 2, 129, 300, True, 65, 64),
    (2, 2, 300, 129, False, 0, 64),
]


def _close_grad(got, want, dtype):
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5 * top, (err.max().item(), top)
    else:
        assert err.max().item() <= 2e-2 * top, (err.max().item(), top)
        assert err.mean().item() <= 1e-2 * want.float().abs().mean().item()


def _k6_case(cuda, N, H, T, S, causal, t0, D, dtype, kvl):
    """q, k, v (strided views of one projection when T == S), K5's o and
    lse, and do as the GPT's: a head-split view of an (N, T, H D)
    gradient."""
    q, k, v = _qkv(cuda, N, H, T, S, D, dtype, seed=T + S + D,
                   fused=T == S)
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, causal, t0,
                                       with_lse=True)
    g = torch.Generator().manual_seed(N + T)
    do = torch.randn((N, T, H * D), generator=g).to(cuda, dtype) \
        .reshape(N, T, H, D).transpose(1, 2)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,T,S,causal,t0,D", K6_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(cuda, N, H, T, S, causal, t0, D,
                                       dtype):
    """K6a/K6b against _backward_reference on K5's o and lse, ragged key
    lengths; two runs give the same bits (no atomics)."""
    kvl = torch.full((N,), S, dtype=torch.int32)
    kvl[1] = max(S // 2 + 3, 1)
    kvl = kvl.to(cuda)
    q, k, v, o, lse, do = _k6_case(cuda, N, H, T, S, causal, t0, D, dtype,
                                   kvl)
    before = (flash_cuda.bwd_dq_launches, flash_cuda.bwd_dkv_launches)
    got = flash_cuda.flash_bwd_cuda(q, k, v, kvl, causal, t0, o, lse, do)
    torch.cuda.synchronize()
    assert (flash_cuda.bwd_dq_launches, flash_cuda.bwd_dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash._backward_reference(q, k, v, kvl, causal, t0, o, lse, do)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close_grad(a, b, dtype)
    again = flash_cuda.flash_bwd_cuda(q, k, v, kvl, causal, t0, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_fully_masked_rows(cuda, dtype):
    """kv_lengths 0: every column masked, zero gradients, as the TPU
    kernels give them; the other item against the plain version."""
    for causal, t0 in ((True, 7), (False, 0)):
        kvl = torch.tensor([0, 90], dtype=torch.int32, device=cuda)
        q, k, v, o, lse, do = _k6_case(cuda, 2, 2, 70, 130, causal, t0, 64,
                                       dtype, kvl)
        got = flash_cuda.flash_bwd_cuda(q, k, v, kvl, causal, t0, o, lse, do)
        want = flash._backward_reference(q, k, v, kvl, causal, t0, o, lse,
                                         do)
        for a, b in zip(got, want):
            assert not a[0].any() and not b[0].any()
            _close_grad(a[1], b[1], dtype)


@pytest.mark.cuda
def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 2, 64, 64, 32, torch.float32, seed=1)
    kvl = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0, with_lse=True)
    do = torch.ones_like(o)
    with pytest.raises(TypeError, match="dtype"):
        flash_cuda.flash_bwd_cuda(q, k, v, kvl, True, 0, o, lse,
                                  do.bfloat16())
    with pytest.raises(ValueError, match="lse"):
        flash_cuda.flash_bwd_cuda(q, k, v, kvl, True, 0, o, lse.double(), do)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cuda.flash_bwd_cuda(q, k, v, kvl, True, 0, o, lse.cpu(), do)
    q48 = torch.zeros((1, 2, 64, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_cuda.flash_bwd_cuda(q48, q48, q48, kvl, True, 0, q48, lse,
                                  q48)
    # o and do whose strides TMA cannot take (bf16: a row stride that is
    # not a multiple of 16 bytes, a byte stride of 2^40 or more): o is
    # refused before any launch; such a do, like autograd's expanded
    # gradient of o.sum(), is copied first and gives the same bits
    N, H, T, D = 2, 2, 64, 64
    q, k, v = _qkv(cuda, N, H, T, T, D, torch.bfloat16, seed=9)
    kvl = torch.full((N,), T, dtype=torch.int32, device=cuda)
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0, with_lse=True)
    g = torch.Generator().manual_seed(3)
    do = torch.randn((N, H, T, D), generator=g).to(cuda, torch.bfloat16)
    wide = torch.zeros((N, T, H * D + 4), dtype=torch.bfloat16, device=cuda)
    odd_o = wide[..., :H * D].unflatten(-1, (H, D)).transpose(1, 2)
    odd_o.copy_(o)
    far = torch.zeros((H, T, D), dtype=torch.bfloat16, device=cuda) \
        .as_strided((1, H, T, D), (1 << 39, T * D, D, 1))
    before = flash_cuda.bwd_dq_launches, flash_cuda.bwd_dkv_launches
    with pytest.raises(ValueError, match="16 bytes"):
        flash_cuda.flash_bwd_cuda(q, k, v, kvl, True, 0, odd_o, lse, do)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_cuda.flash_bwd_cuda(q[:1], k[:1], v[:1], kvl[:1], True, 0,
                                  far, lse[:1], do[:1])
    assert (flash_cuda.bwd_dq_launches, flash_cuda.bwd_dkv_launches) == \
        before
    want = flash_cuda.flash_bwd_cuda(q, k, v, kvl, True, 0, o, lse, do)
    odd_do = torch.zeros_like(wide)[..., :H * D].unflatten(
        -1, (H, D)).transpose(1, 2)
    odd_do.copy_(do)
    assert not flash_cuda._rows_ok(odd_do)
    got = flash_cuda.flash_bwd_cuda(q, k, v, kvl, True, 0, o, lse, odd_do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_flash_bwd_reads_the_fused_projection_in_place(cuda):
    """q, k, v as the GPT makes them, strided views of one (N, T, 3 H D)
    projection, and do a head-split view of an (N, T, H D) gradient: the
    bf16 kernels read them where they lie (their TMA maps take the views'
    strides), so the backward allocates dq, dk, dv and the (N*H, 2, Tp)
    scratch of lse and delta, and nothing else."""
    N, H, T, D = 4, 12, 250, 64
    q, k, v = _qkv(cuda, N, H, T, T, D, torch.bfloat16, seed=7, fused=True)
    kvl = torch.full((N,), T, dtype=torch.int32, device=cuda)
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0, with_lse=True)
    g = torch.Generator().manual_seed(8)
    do = torch.randn((N, T, H * D), generator=g).to(cuda, torch.bfloat16) \
        .reshape(N, T, H, D).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = flash_cuda.flash_bwd_cuda(q, k, v, kvl, True, 0, o, lse, do)
    torch.cuda.synchronize()

    def blocks(nbytes):
        return -(-nbytes // 512) * 512
    grads = sum(blocks(t.numel() * t.element_size()) for t in got)
    scratch = blocks(N * H * 2 * (-(-T // 4) * 4) * 4)
    assert torch.cuda.max_memory_allocated() - base <= grads + scratch
    want = flash._backward_reference(q, k, v, kvl, True, 0, o, lse, do)
    for a, b in zip(got, want):
        _close_grad(a, b, torch.bfloat16)


@pytest.mark.cuda
def test_flash_autograd_functions(cuda):
    """Under autograd: FlashAttention runs K5 with its lse, and its
    backward K6a and K6b once each (the expanded gradient of o.sum()
    copied first), equal to the CPU's plain backward; FlashAttentionPacked
    runs K7 and its backward equals the plain version's gradients."""
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(cuda, 1, 2, 64, 64, 32, torch.float32, seed=5))
    kvl = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    before = (flash_cuda.lse_launches, flash_cuda.bwd_dq_launches,
              flash_cuda.bwd_dkv_launches)
    flash_cuda.flash_attention(q, k, v, kvl, True, 0).sum().backward()
    torch.cuda.synchronize()
    assert (flash_cuda.lse_launches, flash_cuda.bwd_dq_launches,
            flash_cuda.bwd_dkv_launches) == tuple(b + 1 for b in before)
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    flash_cuda.flash_attention(qc, kc, vc, kvl.cpu(), True, 0).sum() \
        .backward()
    for a, b in ((q, qc), (k, kc), (v, vc)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-5,
                                   rtol=1e-4)
    for t in (q, k, v):
        t.grad = None
    seg = _segments(1, 64, 0, 16).to(cuda)
    before = flash_cuda.packed_launches
    flash_cuda.flash_attention_packed(q, k, v, seg, True).square().sum() \
        .backward()
    assert flash_cuda.packed_launches == before + 1
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    flash._packed_reference(qc, kc, vc, seg.cpu(), True).square().sum() \
        .backward()
    for a, b in ((q, qc), (k, kc), (v, vc)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-5,
                                   rtol=1e-4)


# -------------------------------------------- fused lm_head + CE (K10)

# the bf16 kernel's tile edges: 128 rows (64 a consumer warpgroup), 256
# vocab columns, 64-column k slices; GPT-2's vocabularies; hala's rows
CE_CASES = [(N, V, D) for D in (64, 768) for V in (255, 256, 257, 4099)
            for N in (1, 63, 64, 65, 127, 129)]
CE_CASES += [(N, V, 768) for V in (50257, 50304) for N in (1, 129, 8192)]
CE_CASES += [(300, 5000, 64), (2048, 50304, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,D", CE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_kernel_matches_plain(cuda, N, V, D, dtype):
    """Targets at column 0, at V - 1 (inside a partial last tile where V
    is not a multiple of 256) and at V and beyond (a target term of 0);
    the same bits on a second call; one launch of the route a call."""
    g = torch.Generator().manual_seed(N + V)
    x = torch.randn((N, D), generator=g).to(cuda, dtype)
    w = (torch.randn((V, D), generator=g) * 0.1).to(cuda, dtype)
    t = torch.randint(0, V, (N,), generator=g).to(cuda)
    t[0] = V - 1
    if N > 3:
        t[1], t[2], t[3] = 0, V, V + 1000
    before = fused_ce_cuda.launches, fused_ce_cuda.wg_launches
    nll, lse = fused_ce_cuda.ce_fwd_cuda(x, w, t)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (fused_ce_cuda.launches, fused_ce_cuda.wg_launches) == \
        (before[0] + 1, before[1] + bf16)
    valid = (t >= 0) & (t < V)
    nll_e, lse_e = fused_ce.ce_nll_lse(x, w, t.clamp(0, V - 1))
    nll_e = torch.where(valid, nll_e, lse_e)
    torch.testing.assert_close(lse, lse_e, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(nll, nll_e, atol=1e-3, rtol=1e-4)
    # the chunks are merged in a fixed order
    assert torch.equal(nll, fused_ce_cuda.ce_fwd_cuda(x, w, t)[0])


@pytest.mark.cuda
def test_fused_ce_autograd(cuda):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((70, 64), generator=g)
    w = torch.randn((4100, 64), generator=g) * 0.1
    t = torch.randint(0, 4100, (70,), generator=g)
    xs = [x.clone().requires_grad_(True), x.to(cuda).requires_grad_(True)]
    ws = [w.clone().requires_grad_(True), w.to(cuda).requires_grad_(True)]
    before = fused_ce_cuda.launches
    for xi, wi in zip(xs, ws):
        fused_ce_cuda.fused_ce_nll(xi, wi, t.to(xi.device)).sum().backward()
    assert fused_ce_cuda.launches == before + 1
    torch.testing.assert_close(xs[1].grad.cpu(), xs[0].grad, atol=1e-5,
                               rtol=1e-4)
    torch.testing.assert_close(ws[1].grad.cpu(), ws[0].grad, atol=1e-5,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,D", [(300, 5000, 64), (8192, 50304, 768)])
def test_ce_grad_bf16_products_match_fp32(cuda, N, V, D):
    """The CE backward on the card with bf16 operands (fp32 sums and
    logits) against the same backward with its products in fp32, on the
    same bf16 inputs: the same values summed in another order, the
    outputs bf16 (the K6 bf16 criterion)."""
    g = torch.Generator().manual_seed(N)
    x = torch.randn((N, D), generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn((V, D), generator=g) * 0.02).to(cuda, torch.bfloat16)
    t = torch.randint(1, V, (N,), generator=g).to(cuda)
    gr = (torch.rand((N,), generator=g) / N).to(cuda)
    _, lse = fused_ce.ce_nll_lse(x, w, t)
    got = fused_ce.ce_nll_grad(x, w, t, lse, gr)
    want = fused_ce._grad_fp32(x, w, t, lse, gr)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _close_grad(a, b, torch.bfloat16)
    dw32 = fused_ce.ce_nll_grad(x, w.float(), t, lse, gr)[1]
    assert dw32.dtype == torch.float32
    _close_grad(dw32, want[1], torch.bfloat16)


# --------------------------------------------- decode attention (K11)

@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", [(2, 128, 2, 16), (3, 256, 12, 64),
                                     (1, 128, 4, 32), (32, 256, 12, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_starts", [False, True])
def test_decode_kernel_matches_plain(cuda, B, S, H, D, dtype, with_starts):
    E = H * D
    g = torch.Generator().manual_seed(B * S + H)
    qkv = torch.randn((B, 3 * E), generator=g).to(cuda, dtype)
    q, kn, vn = qkv.split(E, dim=-1)              # strided rows
    kc = torch.randn((B, S, E), generator=g).to(cuda, dtype)
    vc = torch.randn((B, S, E), generator=g).to(cuda, dtype)
    starts = torch.randint(0, 5, (B,), generator=g).to(cuda) \
        if with_starts else None
    for L in (0 if not with_starts else 5, S // 2 + 3, S - 1):
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        before = decode_attn_cuda.launches
        y = decode_attn_cuda.decode_attend_update(q, kn, vn, k1, v1, L,
                                                  starts, n_head=H)
        torch.cuda.synchronize()
        assert decode_attn_cuda.launches == before + 1
        y_e = decode_attn.decode_attend(q, kn, vn, k2, v2, L, starts,
                                        n_head=H)
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), y_e.float(), atol=tol,
                                   rtol=tol)


def _k11_inputs(device, B, S, E, dtype, starts, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, 3 * E), generator=g).to(device, dtype)
    q, kn, vn = qkv.split(E, dim=-1)              # strided rows
    kc = torch.randn((B, S, E), generator=g).to(device, dtype)
    vc = torch.randn((B, S, E), generator=g).to(device, dtype)
    st = torch.randint(0, 16, (B,), generator=g).to(device) if starts \
        else None
    return q, kn, vn, kc, vc, st


@pytest.mark.cuda
@pytest.mark.parametrize("L", [0, 96, 159, 1000, 3000])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3])
def test_decode_kernel_at_the_fill_levels(cuda, L, D, dtype, B):
    """K11 at hat's fill levels (96, 159), GPT-2 small's longest (1000)
    and K11's 10 MiB edge (3000 of 3412 rows), the first token (0): B=3
    with left-pad starts, B=1 without (where the plan takes a cluster);
    the caches bit for bit, y within the module's tolerances (bf16: also
    K11_REL of the largest |y|), the same bits on a second call, one
    kernel a call."""
    E = 768 if dtype == torch.bfloat16 else 384    # the 10 MiB at S=3412
    H = E // D
    S = 3412 if L == 3000 else 1024 if L == 1000 else 256
    q, kn, vn, kc, vc, starts = _k11_inputs(cuda, B, S, E, dtype,
                                            B > 1 and L > 0, B + L + D)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    n0 = decode_attn_cuda.k11_kernel_launches()
    y = decode_attn_cuda.decode_attn_cuda(q, kn, vn, k1, v1, L, starts,
                                          n_head=H)
    torch.cuda.synchronize()
    assert decode_attn_cuda.k11_kernel_launches() == n0 + 1
    y_e = decode_attn.decode_attend(q, kn, vn, k2, v2, L, starts, n_head=H)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_e, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(y.float(), y_e.float(),
                                   **chip_smoke.DECODE_TOL)
        assert chip_smoke.k11_rel(y, y_e) <= chip_smoke.K11_REL
    assert torch.equal(y, decode_attn_cuda.decode_attn_cuda(
        q, kn, vn, k1, v1, L, starts, n_head=H))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 1000), (1, 3000), (32, 96)])
def test_decode_kernel_planted_faults(cuda, B, L):
    """Each row's first step of rows left out (K11 itself, starts raised
    by a step) and, where the plan takes a cluster, the peers' (max, sum)
    ignored (chip_smoke.k11_emulate on the same inputs): each reads past
    K11_REL, which the sound kernel reads under."""
    E, H = 768, 12
    S = 3412 if L == 3000 else 1024 if L == 1000 else 256
    q, kn, vn, kc, vc, starts = _k11_inputs(cuda, B, S, E, torch.bfloat16,
                                            B > 1, B + L)
    y_e = decode_attn.decode_attend(q, kn, vn, kc.clone(), vc.clone(), L,
                                    starts, n_head=H)
    k1, v1 = kc.clone(), vc.clone()
    y = decode_attn_cuda.decode_attn_cuda(q, kn, vn, k1, v1, L, starts,
                                          n_head=H)
    assert chip_smoke.k11_rel(y, y_e) <= chip_smoke.K11_REL
    step = decode_attn_cuda.step_rows(64, 2)
    first = starts.long() if starts is not None else \
        torch.zeros(B, dtype=torch.long, device=cuda)
    skipped = decode_attn_cuda.decode_attn_cuda(q, kn, vn, k1, v1, L,
                                                first + step, n_head=H)
    assert chip_smoke.k11_rel(skipped, y_e) > chip_smoke.K11_REL
    plan = decode_attn_cuda.plan(B, H, L, 64, 2,
                                 decode_attn_cuda.multiprocessors(cuda))
    assert (plan.cluster > 1) == (B == 1)
    if plan.cluster > 1:
        bad = chip_smoke.k11_emulate(q, kn, vn, kc.clone(), vc.clone(), L,
                                     starts, H, plan.cluster, step,
                                     "peers ignored")
        assert chip_smoke.k11_rel(bad, y_e) > chip_smoke.K11_REL


@pytest.mark.cuda
def test_decode_kernel_refuses_a_k12_sized_cache(cuda):
    """A 12 MiB (bf16 k and v) row: K11 raises and names K12, the route
    sends the step to K12, and K12 takes it."""
    B, S, E, H = 1, 4096, 768, 12
    g = torch.Generator().manual_seed(0)
    kc = torch.randn((B, S, E), generator=g).to(cuda, torch.bfloat16)
    q = torch.randn((B, E), generator=g).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="K12"):
        decode_attn_cuda.decode_attend_update(q, q, q, kc, kc.clone(), 3,
                                              n_head=H)
    assert decode_attn_cuda.route(S, E, 2) is \
        decode_attn_cuda.decode_attend_update_gridded
    before = decode_attn_cuda.split_launches
    k1, v1, k2, v2 = kc.clone(), kc.clone(), kc.clone(), kc.clone()
    y = decode_attn_cuda.decode_attend_update_gridded(q, q, q, k1, v1, 3,
                                                      n_head=H)
    torch.cuda.synchronize()
    assert decode_attn_cuda.split_launches == before + 1
    y_e = decode_attn.decode_attend(q, q, q, k2, v2, 3, n_head=H)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    torch.testing.assert_close(y.float(), y_e.float(), atol=2e-2, rtol=2e-2)


# ---------------------------- decode attention over a long cache (K12)

def _within_k12_scale(y, want):
    """bf16 y within 1e-2 of the largest |want| (the module docstring)."""
    if y.dtype == torch.bfloat16:
        err = (y.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", [(2, 128, 2, 16), (3, 1024, 12, 64),
                                     (1, 4096, 12, 64), (8, 3584, 12, 64),
                                     (1, 640, 4, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_starts", [False, True])
def test_decode_split_kernel_matches_plain(cuda, B, S, H, D, dtype,
                                           with_starts):
    """K12 against decode_attend: the new row in the first split, mid
    and last; left-pad starts; the same bits on a second run."""
    E = H * D
    g = torch.Generator().manual_seed(B * S + H)
    qkv = torch.randn((B, 3 * E), generator=g).to(cuda, dtype)
    q, kn, vn = qkv.split(E, dim=-1)              # strided rows
    kc = torch.randn((B, S, E), generator=g).to(cuda, dtype)
    vc = torch.randn((B, S, E), generator=g).to(cuda, dtype)
    starts = torch.randint(0, 5, (B,), generator=g).to(cuda) \
        if with_starts else None
    for L in (0 if not with_starts else 5, S // 2 + 3, S - 1):
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        before = decode_attn_cuda.split_launches
        y = decode_attn_cuda.decode_attend_update_gridded(
            q, kn, vn, k1, v1, L, starts, n_head=H)
        torch.cuda.synchronize()
        assert decode_attn_cuda.split_launches == before + 1
        y_e = decode_attn.decode_attend(q, kn, vn, k2, v2, L, starts,
                                        n_head=H)
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), y_e.float(), atol=tol,
                                   rtol=tol)
        _within_k12_scale(y, y_e)
        again = decode_attn_cuda.decode_attend_update_gridded(
            q, kn, vn, k1, v1, L, starts, n_head=H)
        assert torch.equal(y, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernel_masked_splits(cuda, dtype):
    """starts past the first splits (splits with no attended row), and a
    row whose start is the new row itself; against decode_attend and
    against K11 on the same cache (6 MiB a row in fp32)."""
    B, S, H, D = 3, 1024, 12, 64
    E = H * D
    g = torch.Generator().manual_seed(9)
    q, kn, vn = (torch.randn((B, E), generator=g).to(cuda, dtype)
                 for _ in range(3))
    kc = torch.randn((B, S, E), generator=g).to(cuda, dtype)
    vc = torch.randn((B, S, E), generator=g).to(cuda, dtype)
    L = S - 2
    rows = decode_attn_cuda.split_rows(
        B, H, L + 1, D, kc.element_size(),
        decode_attn_cuda.multiprocessors(cuda))
    starts = torch.tensor([3 * rows + 1, 2 * rows, L], device=cuda)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    y = decode_attn_cuda.decode_attend_update_gridded(q, kn, vn, k1, v1, L,
                                                      starts, n_head=H)
    y_e = decode_attn.decode_attend(q, kn, vn, k2, v2, L, starts, n_head=H)
    y_11 = decode_attn_cuda.decode_attend_update(q, kn, vn, kc, vc, L,
                                                 starts, n_head=H)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    assert torch.equal(k1, k2) and torch.equal(k1, kc)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for want in (y_e, y_11):
        torch.testing.assert_close(y.float(), want.float(), atol=tol,
                                   rtol=tol)
        _within_k12_scale(y, want)
    # row 2 attends the new row alone: y is its v
    torch.testing.assert_close(y[2].float(), vn[2].float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_decode_split_kernel_is_one_launch(cuda):
    """One K12 call is one kernel launch (the merge runs in the split that
    finishes last), counted once."""
    B, S, H, D, L = 4, 4096, 12, 64, 4000
    g = torch.Generator().manual_seed(5)
    q, kn, vn = (torch.randn((B, H * D), generator=g).to(cuda, torch.bfloat16)
                 for _ in range(3))
    kc = torch.randn((B, S, H * D), generator=g).to(cuda, torch.bfloat16)
    vc = torch.randn((B, S, H * D), generator=g).to(cuda, torch.bfloat16)
    starts = torch.arange(B, dtype=torch.int32, device=cuda)
    decode_attn_cuda.decode_attend_update_gridded(q, kn, vn, kc, vc, L,
                                                  starts, n_head=H)
    before = (decode_attn_cuda.split_launches,
              decode_attn_cuda.kernel_launches())
    for _ in range(3):
        decode_attn_cuda.decode_attend_update_gridded(q, kn, vn, kc, vc, L,
                                                      starts, n_head=H)
    torch.cuda.synchronize()
    assert decode_attn_cuda.split_launches - before[0] == 3
    assert decode_attn_cuda.kernel_launches() - before[1] == 3


@pytest.mark.cuda
def test_decode_split_kernel_on_two_streams(cuda):
    """K12 calls in flight on two streams at once, each with the counters
    of its own stream, give the bits of the same calls on one stream."""
    B, S, H, D, L = 4, 4096, 12, 64, 4000
    g = torch.Generator().manual_seed(6)
    args = []
    for _ in range(2):
        q, kn, vn = (torch.randn((B, H * D), generator=g)
                     .to(cuda, torch.bfloat16) for _ in range(3))
        kc = torch.randn((B, S, H * D), generator=g).to(cuda, torch.bfloat16)
        vc = torch.randn((B, S, H * D), generator=g).to(cuda, torch.bfloat16)
        args.append((q, kn, vn, kc, vc))
    want = [decode_attn_cuda.decode_attend_update_gridded(*a, L, n_head=H)
            for a in args]
    torch.cuda.synchronize()
    side = [torch.cuda.Stream(cuda) for _ in range(2)]
    got = [None, None]
    for _ in range(3):
        for i in range(2):
            side[i].wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(side[i]):
                got[i] = decode_attn_cuda.decode_attend_update_gridded(
                    *args[i], L, n_head=H)
        torch.cuda.synchronize()
        assert all(torch.equal(w, y) for w, y in zip(want, got))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_decode_split_kernel_planted_faults(cuda, B):
    """The design's faults, run through K12 itself, read beyond 1e-2 of
    the largest |y|: the new row read from the stale cache (K12 fed the
    cache's old row) and the merge dropping the last split (K12 at the row
    before it, fed that row)."""
    S, H, D, L = 2048, 12, 64, 1500
    E = H * D
    g = torch.Generator().manual_seed(B)
    q, kn, vn = (torch.randn((B, E), generator=g).to(cuda, torch.bfloat16)
                 for _ in range(3))
    kc = torch.randn((B, S, E), generator=g).to(cuda, torch.bfloat16)
    vc = torch.randn((B, S, E), generator=g).to(cuda, torch.bfloat16)
    rows = decode_attn_cuda.split_rows(
        B, H, L + 1, D, 2, decode_attn_cuda.multiprocessors(cuda))
    k12 = decode_attn_cuda.decode_attend_update_gridded
    want = decode_attn.decode_attend(q, kn, vn, kc.clone(), vc.clone(), L,
                                     n_head=H)
    y = k12(q, kn, vn, kc.clone(), vc.clone(), L, n_head=H)
    last = L // rows * rows - 1
    faults = (k12(q, kc[:, L], vc[:, L], kc.clone(), vc.clone(), L,
                  n_head=H),
              k12(q, kc[:, last], vc[:, last], kc.clone(), vc.clone(), last,
                  n_head=H))
    top = want.float().abs().max().item()
    assert (y.float() - want.float()).abs().max().item() <= 1e-2 * top
    for bad in faults:
        assert (bad.float() - want.float()).abs().max().item() > 1e-2 * top


def test_decode_split_rows_fill_the_card():
    """At the H100 SXM's 132 multiprocessors, over the rows up to the new
    one, in whole tiles (64 rows at D=64 in bf16): eight rounds of four
    blocks an SM where the rows allow; a card with fewer SMs takes longer
    splits."""
    rows = decode_attn_cuda.split_rows
    assert rows(32, 12, 4001, 64, 2, 132) == 256
    assert rows(32, 12, 4001, 64, 2, 66) == 512
    assert rows(64, 12, 4001, 64, 2, 132) == 512
    assert rows(8, 12, 3584, 64, 2, 132) == 64
    assert rows(1, 12, 4001, 64, 2, 132) == 64
    assert rows(1, 2, 128, 16, 2, 132) == 256
    assert rows(32, 12, 4001, 64, 4, 132) == 256
    assert decode_attn_cuda.tile_rows(64, 2) == 64


# ------------------------------------------- int8-weight product (K13)

Q8_SHAPES = [(2304, 768), (768, 768), (3072, 768), (768, 3072),
             (50304, 768), (1000, 777), (24, 40)]


def _q8_inputs(device, M, N, K, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((N, K), generator=g) * 0.02
    w[min(3, N - 1)] = 0
    w_q, scale = quant.quantize_weight(w)
    x = torch.randn((M, K), generator=g)
    return x.to(device, dtype), w_q.to(device), scale.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", Q8_SHAPES)
@pytest.mark.parametrize("M", [1, 32, 17, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_kernel_matches_plain(cuda, N, K, M, dtype):
    """K13 against q8_matmul on GPT-2 small's weights, a ragged one and
    a small one, with fp32 and bf16 scales; the same bits twice."""
    x, w_q, scale = _q8_inputs(cuda, M, N, K, dtype, N + K + M)
    for s in (scale, scale.to(torch.bfloat16)):
        before = q8_matmul_cuda.launches
        y = q8_matmul_cuda.q8_matmul(x, w_q, s)
        torch.cuda.synchronize()
        assert q8_matmul_cuda.launches == before + 1
        assert y.shape == (M, N) and y.dtype == dtype
        want = q8_matmul.q8_matmul(x, w_q, s)
        if dtype == torch.float32:
            err = (y - want).abs().max() / want.abs().max()
            assert err <= 1e-5, err
        else:
            torch.testing.assert_close(y.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
        assert torch.equal(y, q8_matmul_cuda.q8_matmul(x, w_q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", Q8_SHAPES[:-1])
@pytest.mark.parametrize("M", [1, 32])
def test_q8_kernel_planted_fault(cuda, N, K, M):
    """The design's fault, run through K13 itself: the plan's last k slice
    (a cluster rank's range, or the last stage) dropped fails the bf16
    tolerance."""
    x, w_q, scale = _q8_inputs(cuda, M, N, K, torch.bfloat16, N + K + M)
    want = q8_matmul.q8_matmul(x, w_q, scale)
    bad, _ = chip_smoke.k13_dropped_slice(
        torch, x, w_q, decode_attn_cuda.multiprocessors(cuda))
    y = q8_matmul_cuda.q8_matmul(bad, w_q, scale)
    assert not torch.isclose(y.float(), want.float(), atol=2e-2,
                             rtol=2e-2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(2304, 768), (768, 768), (1000, 784)])
@pytest.mark.parametrize("M", [1, 17, 32])
def test_q8_bulk_gives_the_bits_of_the_stripes(cuda, N, K, M):
    """q8_bulk, the stripes fed by cp.async.bulk that the probe times
    against K13, gives K13's bits where K13 plans stripes without a
    cluster."""
    x, w_q, scale = _q8_inputs(cuda, M, N, K, torch.bfloat16, N + K + M)
    assert q8_matmul_cuda.plan(M, N, K, True, kernels.multiprocessors(
        cuda))[::2] == (0, 1)
    assert torch.equal(q8_matmul_cuda.q8_bulk_cuda(x, w_q, scale),
                       q8_matmul_cuda.q8_matmul(x, w_q, scale))


@pytest.mark.cuda
def test_q8_kernel_rejects_what_it_does_not_take(cuda):
    x, w_q, scale = _q8_inputs(cuda, 8, 64, 32, torch.bfloat16, 0)
    with pytest.raises(TypeError, match="int8"):
        q8_matmul_cuda.q8_matmul(x, w_q.to(torch.bfloat16), scale)
    big = torch.zeros((65, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="at most 64"):
        q8_matmul_cuda.q8_matmul(big, w_q, scale)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        q8_matmul_cuda.q8_matmul_cuda(x.cpu(), w_q.cpu(), scale.cpu())
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        q8_matmul_cuda.q8_matmul(x, w_q.cpu(), scale)
    with pytest.raises(ValueError, match="shapes"):
        q8_matmul_cuda.q8_matmul(x, w_q[:, :16].contiguous(), scale)


@pytest.mark.cuda
def test_linear_routes_int8_rows_to_k13(cuda):
    """nn.core.linear with a qscale: 64 rows launch K13, 65 take the
    dequantized product; both against the plain versions."""
    x, w_q, scale = _q8_inputs(cuda, 65, 256, 128, torch.bfloat16, 1)
    p = {"weight": w_q, "qscale": scale.to(torch.bfloat16)}
    before = q8_matmul_cuda.launches
    y64 = core.linear(p, x[:64].view(8, 8, 128))
    assert q8_matmul_cuda.launches == before + 1
    y65 = core.linear(p, x)
    assert q8_matmul_cuda.launches == before + 1
    want = q8_matmul.q8_matmul(x, w_q, p["qscale"])
    torch.testing.assert_close(y64.reshape(64, 256).float(),
                               want[:64].float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(y65.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------- the device rule

def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never takes the plain version (here: 'meta' tensors, no card)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        lstm_cuda.lstm_scan(torch.empty((8, 2), device=meta),
                            torch.empty((3, 1, 8), device=meta),
                            torch.empty((1, 2), device=meta),
                            torch.empty((1, 2), device=meta))
    for q8_args in ((torch.empty((8, 2), device=meta),
                     torch.empty((3, 1, 8), device=meta)),
                    (torch.empty((8, 2), requires_grad=True, device=meta),
                     torch.empty((3, 1, 8), device=meta))):
        with pytest.raises(ValueError, match="expected CUDA tensors"):
            lstm_cuda.lstm_scan(*q8_args, torch.empty((1, 2), device=meta),
                                torch.empty((1, 2), device=meta), q8=True)
    bf = dict(device=meta, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        lstm_cuda.lstm_bwd_q8_cuda(
            torch.empty((3, 1, 2), **bf), torch.empty((3, 1, 8), **bf),
            torch.empty((3, 1, 2), **bf), torch.empty((1, 2), **bf),
            torch.empty((8, 2), dtype=torch.int8, device=meta),
            torch.empty((8,), device=meta), torch.empty((1, 2), device=meta),
            torch.empty((1, 2), device=meta))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        ctc_cuda.ctc_loss(torch.empty((4, 2, 5), device=meta),
                          torch.ones((2, 2), dtype=torch.long, device=meta),
                          torch.full((2,), 4, device=meta),
                          torch.full((2,), 2, device=meta))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        joint_cuda.pairwise_lse(torch.empty((2, 3, 5), device=meta),
                                torch.empty((2, 4, 5), device=meta))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        star_cuda.star_ctc_loss(torch.empty((4, 2, 5), device=meta),
                                torch.ones((2, 2), dtype=torch.long,
                                           device=meta),
                                torch.full((2,), 4), torch.full((2,), 2))
    qkv = torch.empty((1, 2, 300, 64), device=meta)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        flash_cuda.flash_attention(qkv, qkv, qkv, torch.full((1,), 300,
                                                             device=meta))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        flash_cuda.flash_attention_packed(qkv, qkv, qkv,
                                          torch.ones((1, 300), device=meta))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        fused_ce_cuda.fused_ce_nll(torch.empty((4, 64), device=meta),
                                   torch.empty((5000, 64), device=meta),
                                   torch.ones(4, dtype=torch.long,
                                              device=meta))
    cache = torch.empty((2, 16, 64), device=meta)
    row = torch.empty((2, 64), device=meta)
    for step in (decode_attn_cuda.decode_attend_update,
                 decode_attn_cuda.decode_attend_update_gridded):
        with pytest.raises(ValueError, match="expected CUDA tensors"):
            step(row, row, row, cache, cache, 3, n_head=2)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        q8_matmul_cuda.q8_matmul(row, torch.empty((5, 64), dtype=torch.int8,
                                                  device=meta),
                                 torch.empty((5,), device=meta))


def test_cpu_tensors_do_not_build_the_kernels():
    w, xp, h0, c0 = _lstm_inputs(3, 2, 8, torch.float32, "cpu")
    lstm_cuda.lstm_scan(w, xp, h0, c0)
    ctc_cuda.ctc_loss(*_ctc_inputs("cpu", T=30, N=2, C=6, U=3))
    f, g, _ = _joint_inputs("cpu", 2, 5, 3, 7)
    joint_cuda.pairwise_lse(f, g)
    star_cuda.star_ctc_loss(*_ctc_inputs("cpu", T=30, N=2, C=6, U=3))
    if not torch.cuda.is_available():
        assert kernels._lib is None


def test_kernel_sources_hash_tracks_every_source():
    names = {p.name for p in kernels._sources()}
    assert {"lstm_fwd.cu", "lstm_bwd.cu", "lstm_q8.cu", "ctc_fwd.cu",
            "ctc_bwd.cu",
            "star_fwd.cu", "star_bwd.cu", "joint_lse.cu",
            "joint_lse_bwd.cu", "flash_fwd.cu", "flash_bwd.cu",
            "fused_ce.cu", "decode_attn.cu", "q8_matmul.cu", "mma.cuh",
            "lattice.cuh", "lattice_bwd.cuh", "sm90.cuh"} <= names
    assert len(kernels.sources_hash()) == 64


def test_trace_phases_builds_a_library_of_its_own(monkeypatch):
    """kernels.trace_phases: -DHL_PHASES in the flags (and so in the
    sources hash), a build directory beside the plain one, and the entry
    points that copy the stamps out bound, each defined in csrc only under
    HL_PHASES; refused once the plain library is loaded."""
    for name in ("NVCC_FLAGS", "_SIGNATURES"):
        monkeypatch.setattr(kernels, name, copy.copy(getattr(kernels, name)))
    for name in ("BUILD", "LIB", "_lib"):
        monkeypatch.setattr(kernels, name, getattr(kernels, name))
    monkeypatch.setattr(kernels, "_lib", None)
    plain = kernels.sources_hash()
    kernels.trace_phases()
    kernels.trace_phases()
    assert kernels.NVCC_FLAGS.count("-DHL_PHASES") == 1
    assert kernels.BUILD.name == "haloop_tpu_torch_phases"
    assert kernels.LIB.parent == kernels.BUILD
    assert kernels.sources_hash() != plain
    src = "".join(p.read_text() for p in kernels._sources())
    for name in kernels.PHASE_ENTRIES:
        assert kernels._SIGNATURES[name] == [ctypes.c_void_p]
        at = src.index(f'extern "C" int {name}(void* out)')
        assert src.rindex("#ifdef HL_PHASES", 0, at) > \
            src.rfind("#endif", 0, at)
    monkeypatch.setattr(kernels, "_lib", object())
    with pytest.raises(RuntimeError, match="plain library"):
        kernels.trace_phases()


@pytest.mark.parametrize("ablation", kernels.ABLATIONS)
def test_trace_phases_compiles_an_ablation_in(monkeypatch, ablation):
    """kernels.trace_phases(ablation): the macro beside -DHL_PHASES in the
    flags, a build directory of its own, and the macro read by a kernel
    source; a name outside kernels.ABLATIONS is refused."""
    for name in ("NVCC_FLAGS", "_SIGNATURES"):
        monkeypatch.setattr(kernels, name, copy.copy(getattr(kernels, name)))
    for name in ("BUILD", "LIB", "_lib"):
        monkeypatch.setattr(kernels, name, getattr(kernels, name))
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(ValueError, match="no ablation"):
        kernels.trace_phases("HL_ABLATE_NOTHING")
    kernels.trace_phases(ablation)
    assert kernels.NVCC_FLAGS[-2:] == ["-DHL_PHASES", f"-D{ablation}"]
    assert kernels.BUILD.name == \
        f"haloop_tpu_torch_phases_{ablation.lower()}"
    src = "".join(p.read_text() for p in kernels._sources())
    assert f"#ifdef {ablation}" in src or f"#ifndef {ablation}" in src
