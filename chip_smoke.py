#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (haloop_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card
    python3 chip_smoke.py --hala-curve   # only phase 1 and hala's loss
                                         # curves (where the limits of
                                         # phase 21's check come from)

Phases (any failure raises and exits non-zero; nothing is caught):
  0. the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  1. build the hand-written kernels from haloop_tpu_torch/csrc with nvcc;
     then start hai (``python -m haloop_tpu_torch.init``) for decoder,
     decoder:50304:4096 and gpt-nano:300:64 in subprocesses, which write
     the GPT phases' random checkpoints while the kernel phases run
  2. kernel K1 (LSTM recurrence) against the plain lstm_scan on the card
  3. kernel K3 (CTC forward lattice) against the plain ctc_forward_score
     and ctc_forward_history: its plan, the same bits twice, cycles a
     frame, and two planted faults that must read beyond CTC_TOL /
     CTC_HIST_TOL (the skips dropped that cross the sweep's warp edges
     and lane edges)
  4. the serving slice through its entry point: a random lstm:512
     checkpoint, ``hac --init ckpt --arch lstm:512 --vocab 512 --test
     head:sinusoids0`` (kernel launch counts reset just before, read just
     after), then one eval batch of 48 twelve-second utterances: loss
     against the plain path, and eval utt/s.
  5. K1's residual mode against K1 and the plain residuals, and kernel K2
     (LSTM backward sweep) against the plain lstm_scan_bwd
 5b. the int8 mode (hac --rnn-q8): K1-q8 (with and without residuals)
     and K2-q8 against the plain lstm_scan_q8 / lstm_scan_bwd_q8 at the
     same shapes, the route each call took (persistent at the main
     paths' widths), the same bits twice and the same bits as the
     per-step kernels, each limit between the reading and planted
     faults (the exact mode's answer; K2-q8's row scale taken over a
     block's own columns; K1-q8's, one persistent block on a step-old
     hq), times beside the bound (no PyTorch call computes an int8 LSTM;
     the exact mode's cuDNN times beside)
  6. kernel K4 (CTC backward lattice) against the plain ctc_grad, its
     plan and one launch, the same bits on two more runs, and three
     planted faults that must read beyond CTC_GRAD_TOL: the d em rows
     one frame off, and the skips dropped that cross the sweep's warp
     edges and lane edges (K8b's likewise in 9, its label edges)
  7. the training slice through its entry point: ``hac --arch lstm:512
     --train head:sinusoids0 --eval head:sinusoids0 --save last+best``
     (counts reset just before, read just after), ``--init last.pt
     --test``, one train step at batch 48 x 12 s (kernel path against
     the plain path, train utt/s, a profiler breakdown), and lstm-tiny's
     loss falling below a third in 30 steps.
  8. kernels K9a/K9b (RNN-T joint logsumexp, forward and backward)
     against the plain pairwise_lse / pairwise_lse_grad (K9a also against
     the materialized joint) at rnn-transducer:lstm:512's joint (16, 301,
     25, 512), with a 16k vocabulary (V = 16384), on disjoint peaks that
     take K9a's fix-up and K9b's exact terms, with every cell marked, and
     with U+1 = 2049 (4, 301, 2049, 512): each kernel's plan, one launch a
     call, the same bits twice (lse, df, dg), K9a's row maxima exact, K9a's
     two planted faults (the fix-up skipped, one stage of V left out)
     beyond JOINT_TOL and K9b's two (the marked cells' exact terms left
     out, one frame group left out of dg) beyond JOINT_TOL / JOINT_DG_TOL;
     on the inputs without marked cells K9b also against the fp64
     factored form within (n + 64) 2^-24 sum|p| (n the rows a sum takes;
     at U+1 = 2049 df's only check), and at U+1 = 2049 a third fault (one
     chunk of rows left out of df) beyond that bound;
     K1 and K2 at its widths (phases 2 and 5: H=1024 encoder, H=512
     prediction net)
  9. kernels K8a/K8b (Star-CTC lattice, forward and backward) against the
     plain star_forward_history / star_grad at lstm:512's train shapes;
     each one's same bits on more runs and its planted faults (K8a: the
     label edges across the sweep's warp and lane edges dropped), the
     masked back edge K8b leaves out adding nothing to star_grad; K8a
     with its history at S = 1027 and 4091 (times too); then K3, K4, K8a
     and K8b on long lattices (S = 2049 and 2051) against their plain
     versions
 10. rnn-transducer:lstm:512 at full width, batch 16 x 1200 frames, U=24:
     one train step and one transcription batch through ``loop.System``
     (counts reset just before each, read just after), kernel path
     against the plain path, train and eval utt/s, peak memory, a profile
     of the train step; then one train step of rnn-transducer:lstm:16384
     at batch 4 (K9a and K9b once each, the kernel path against the
     plain path, peak memory)
 11. lstm:512 ``--star-penalty -0.5``: one train step at batch 48 x 12 s,
     the same checks (and K8a's and K8b's plans), train utt/s
 11b. --rnn-q8 on every acoustic path (counts reset just before each,
     read just after: K1-q8/K2-q8 only, no exact-mode K1/K2, each on the
     persistent kernels but K1-q8 below H = 1024): ``hac
     --arch lstm:512 --rnn-q8 --train --eval --save`` and ``--init
     last.pt --test`` through loop.main; a 48 x 12 s train step and
     transcription batch (kernel path against the plain path, the int8
     loss against the exact one, utt/s, a profile with no quant_rows
     launch); an
     rnn-transducer:lstm:512 train step and transcription batch; an
     lstm:512 --star-penalty -0.5 train step
 12. entry-point runs: ``hac --arch rnn-transducer-tiny:512 --train
     --eval`` until its loss falls, then ``--init last.pt --test``; and
     ``hac --arch lstm-tiny:512 --star-penalty -0.5 --train --eval``
 13. kernels K5 and K7 (flash attention, unpacked and packed) against the
     plain _reference / _packed_reference at GPT-2 small's hap shapes:
     (32, 12, 512, 64) causal with ragged key lengths, (16, 12, 1024, 64)
     with 64-token and with ragged pack_segments segments, and small
     cases (t0 > 0, a zero key length, fp32); in bf16 two planted faults
     (the causal diagonal off by one, the last partial key tile dropped)
     that must exceed the limit
 14. kernel K10 (fused lm_head + cross-entropy) against the plain
     ce_nll_lse at hap's (N=16384, V=50304, D=768) and at (4000, 4099, 768)
     in bf16 (the route each call took: the warp-specialized kernel; two
     planted faults emulated through K10 that must exceed the limit: the
     last vocab tile's mask dropped, one chunk left out of the merge), and
     fp32 at N=2048; the cuBLAS product torch.mm(x, w.T) timed alone beside
 15. kernel K11 (decode attention) against the plain decode_attend at
     K11_CASES: hat --batch's steps (B=32, S=256, E=768, H=12, fill levels
     96 and 159) with starts and at B=1, GPT-2 small's longest fill (1000
     of 1024 rows) and K11's 10 MiB edge (B=1, 3000 of 3412), and
     gpt-nano's hat steps (E=64, H=2: heads of 32; B=3 with starts, B=1,
     S=64) that phase 18 drives; the same
     bits twice, one kernel a call, planted faults (the first step of
     rows left out; a cluster's peers' max and sum ignored); times beside
     plain, SDPA and the bound
 16. GPT-2 small (``decoder``) scoring: a random checkpoint written by
     ``python -m haloop_tpu_torch.init --seed 0 decoder``, then
     forward_all on 16 x 1024 packed rows of 64-token segments and on 32 x
     512 unpacked rows (counts reset just before each, read just after):
     exact launches (every K10 call on its warp-specialized route), kernel
     path against the plain path (beside plain
     bf16 against plain fp32, and a planted fault the gate must catch:
     the segment mask dropped), real tokens/s, peak memory, profiles
 17. GPT-2 small generation: generate at B=32 (left-padded 17-32-token
     prompts) and at B=1, 128 greedy tokens: exact K11 launches, tokens/s,
     a profile of one call (device busy share, K11's share of it),
     and the kernel path against the plain path under teacher forcing of
     the kernel path's tokens (beside plain bf16 against plain fp32, and
     at B=32 a planted fault the gate must catch: the left padding
     attended)
 18. entry points on gpt-nano:300:64 and on decoder: hap --bytes with
     and without --pack and with --q8, hat --bytes --batch (also --q8),
     and the interactive hat on two piped prompts, each with the counts
     reset just before it
 19. kernels K6a/K6b (flash attention backward: dq, then dk and dv)
     against the plain _backward_reference at hala's (8, 12, 1024, 64)
     causal bf16, with full and with ragged key lengths, and fp32 at N=2;
     in bf16 two planted faults (the diagonal off by one, the last
     partial key tile dropped); K5 with its lse at the same shape (in
     bf16 with the planted fault of the diagonal off by one)
 20. GPT-2 small (``decoder``) training, one hala update at batch 8 x 1024
     (accumulation 1; counts reset just before, read just after): exact
     launches K5-lse 12, K6a 12, K6b 12, K10 1 (on its warp-specialized
     route); the kernel path's loss and
     gradients against the plain path's (beside plain bf16 against plain
     fp32, and two planted faults the gate must catch: K6b without the
     causal mask, dq without its scale), train tokens/s and the model-FLOP
     share, peak memory, the CE backward at N=8192 with fp32 and with
     bf16 operands (alone and in the update), a profile
 21. hala's entry point, ``attention_loop.main``, at full width on the
     repository's own text as byte ids (90/10 split): the train loss
     falls, the eval line appears, the val loss after 100 updates is
     under the eval set's byte unigram entropy by a margin that the same
     run with K6a/K6b zeroed (a planted fault) must miss, best.pt is
     written and scored by the port's hap; and gpt-nano:256:256 for a few
     updates
 22. kernel K12 (decode attention, S split across blocks, one launch a
     call) against the plain decode_attend at decoder:50304:4096's step
     (S=4096, E=768, H=12, bf16, fill level 4000) at B=32 with left-pad
     starts and at B=1; then starts past the first splits, and the new
     row in the first split: caches exact, y within K12_REL of the
     largest |y|, the same bits twice, one kernel launched a call; at
     B=32 and B=1 four planted faults (the new row
     left out, the first attended split skipped, the new row read from
     the stale cache, the merge dropping the last split) that must exceed
     it
 23. kernel K13 (int8-weight product) against the plain q8_matmul on
     GPT-2 small's five weights at M=32 and M=1, a ragged (1000, 777) one,
     and fp32 x at one shape; the same bits twice; at each bf16 shape a
     planted fault (the plan's last k slice dropped) that must fail the
     tolerance; a decode step's sum; the floor of a launch (an empty
     kernel, and K13 on a (16, 768) weight)
 24. decoder:50304:4096 (random weights from hai, bf16): generate 128
     greedy tokens after 3456-token prompts at B=8 (left-padded) and B=1,
     a 3,584-row cache (10.5 MiB a row): exactly 12 K12 launches a step and
     no K11, teacher-forced logits against the plain path under
     LONG_LOGIT_TOL, layer 0's caches exact, tokens/s; at B=8 two planted
     K12 faults (the first attended split of K12's plan skipped, the left
     padding attended) that must exceed that limit; then hat --bytes --batch
     through its entry point on two 3456-byte prompts
 25. --q8 serving of GPT-2 small (quantize_gpt_params, then the bf16
     cast): hap on 16 x 1024 packed rows (K7, K10 once on its
     warp-specialized route, no K13) and
     generate at B=32 and B=1, 128 tokens (exactly 49 K13 launches a
     decode step), each with the counts reset just before; the kernel
     path against the plain path, and the q8 path against the bf16 path
     under limits between the quantization error and a planted fault
     (every qscale doubled), both read every run; tokens/s; a profile
 26. kernels K5, K5-lse, K6a and K6b at the e6ctc-d4:512 encoder's
     attention, (24, 8, 300, 64) bf16 non-causal with full key lengths
     (T = S = 300, no tile multiple), and K3/K4 at its CTC head's (24,
     300, 512, U = 23): each against its plain version, with planted
     faults that must exceed the limit (K5/K6: the partial last query tile
     left unwritten, the keys past S left unmasked; K3/K4: the lane-edge
     skips dropped, K4's rows a frame off), times beside plain, SDPA /
     F.ctc_loss and the bound
 27. hac e6ctc-d4:512 (bench.py's attention workload): a random
     checkpoint from the port's Initializer, ``hac --test`` and ``hac
     --train --eval --save`` on head:sinusoids0 through loop.main (under
     the flash floor: K3/K4 only), then bench.py's batch of 24 x 12 s, U =
     24: evaluate (exactly 6 K5 and 1 K3), a train step (exactly 6 each of
     K5-lse, K6a, K6b; K3 with history and K4 once), the kernel path
     against the plain path (the loss; the whole gradient by cosine,
     beside rounding and two planted faults), the decode against the
     CPU's, eval and train utt/s, profiles
 28. one train step each of rnn-transducer:e6ctc-d4:512 (K9a/K9b beside
     K5/K6) at 24 x 12 s and transformer:512 (hac's default arch) at 8 x
     2,400 frames: exact launches, the kernel path against the plain path,
     utt/s
 29. kernels K1, K1 with residuals and K2 in fp32 at hal's (256, 64,
     2048) (the rnnlm arch, --bptt-len 256, --batch-size 64): the fp32
     persistent route (persist_f32), exactly one kernel a call (counted
     from a profile), the same bits twice and with every slice of W
     streamed (the plan's resident split changes no sum), the plain
     versions within LSTM_TOL["float32"] and three planted faults each
     beyond it (K1: one 32-column ring slice of a step's product left
     out, c not carried into a step, one block's units on h_(t-2); K2: a
     slice of dgates . W left out, dc not carried, one cluster's units on
     a step-old dgates), times beside plain, cuDNN fp32's recurrence alone
     (TF32 off; nn.LSTM on inputs of width 1 with frozen weights, as K1
     gets x projected and K2 stops at dgates; the whole layer printed
     beside) and the bound; K1 at a completion token (T = 1, B = 1)
 30. hal through its entry point (rnnlm.main) at 1 x 2048, B = 64, T =
     256 on seeded synthetic text: 5 steps, --save, --complete (counts
     reset just before, read just after: K1 with residuals and K2 5 each,
     K1 once for each completion's prompt and once a sampled token, all
     on persist_f32); exact stream resume (5 steps straight against 3,
     --init and 2 more: params, moments, state, carried token bit for
     bit); one step's loss and gradient against the plain path (HAL_LOSS_TOL,
     HAL_GRAD_GAP), beside a planted fault (the state not carried) that
     must exceed both; train tokens/s, completion tokens/s at B = 1,
     profiles
 31. hac --beam 4 --lm <phase 30's checkpoint> (shallow fusion, the
     LM's 1 x 2048 geometry) on phase 4's lstm:512 checkpoint through
     loop.main (exactly phase 4's launches), then phase 4's batch of 48 x
     12 s and rnn-transducer:lstm:512 at phase 10's batch of 16: the
     forward's launches, none in the beams (plain fp32 cells), the
     device beam's best hyps those of the same code on the CPU for the
     first items, --beam 1 the greedy decode, utt/s, profiles
Each kernel is timed beside its plain version, the one PyTorch library
call that computes the same function (a yardstick the port never calls),
and its bound on this card (bytes or operations, whichever takes longer);
every such time comes from CUDA events with the host's launch latency
kept out (``cuda_ms``).
The line before the last is a JSON object of the kernels' launches,
errors and times; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX and nothing of the JAX package.
"""

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# K1 (bf16): the TPU kernel's stated parity with the exact scan
# (tests/test_lstm_pallas.py:48-57); fp32 products summed in another order
LSTM_TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2, mean=2e-3),
            "float32": dict(atol=1e-4, rtol=1e-4, mean=1e-4)}
CTC_REL_TOL = 1e-4     # K3, feasible items: fp32 lattice, other exp/log order
# K3 against its plain version with the kernel's numerics
# (ctc_forward_history: loss, history), as K8a's below
CTC_TOL = dict(atol=1e-4, rtol=1e-5)
CTC_HIST_TOL = dict(atol=1e-3, rtol=1e-5)
# K4 (and K8b): the JAX package's bound for its kernel's grads
# (tests/test_lattice_kernels.py:34); the kernels sum each class's states
# in another order than the plain versions (a fixed one: the same bits on
# every run)
CTC_GRAD_TOL = 1e-3
# dW_hh from K2's dgates against the plain ones, cos(dW); the limit sits
# about a decade from both readings this script takes every run, in 1 -
# cos: the sound kernel at every LSTM_SHAPES case (1 - cos <= 8e-7 at
# lstm:512, NVIDIA H100) and the planted fault of one cluster on a
# step-old dgates (1 - cos 5.7e-4)
DW_COS = 0.99998
# K1-q8 and K2-q8 against their plain versions (the same int8 arithmetic),
# rel L2 ||kernel - plain|| / ||plain|| of each output. Each limit sits
# between two readings this script takes every run: the kernel against its
# plain version, and planted faults against the plain version: the exact
# mode's answer (no quantization; both kernels), and K2-q8 with m taken
# over each block's own 64 columns instead of the row's 4H
# (k2_q8_block_max). Placed from the first readings (NVIDIA H100 80GB
# HBM3): K1-q8 read 0 (the same bits as lstm_scan_q8) against faults of
# 1.6e-3 and more; K2-q8 dgates 4.2e-4 and dh0 1.8e-3 at (385, 48, 1536)
# (an ulp apart somewhere flips a round(), then T steps carry it), 0 to
# 2e-6 elsewhere, against faults of 2.6e-3 (dgates) and 1.2e-2 (dh0) and
# more
K1Q8_REL = 3e-4
K2Q8_REL = dict(dgates=1.2e-3, dh0=6e-3, dc0=1.2e-3)
# --rnn-q8 against the exact mode on the same batch and params, relative
# difference of the loss: the int8 mode ran (above 1e-9) and is close
# (under 0.05), the JAX package's criterion for the mode
# (tests/test_lstm_pallas.py::test_multilayer_dispatch)
RNN_Q8_REL = (1e-9, 0.05)
# slice loss, kernel path vs plain path on the card (bf16 encoder): ys that
# straddle a bf16 rounding boundary round differently in the two paths
SLICE_REL_TOL = 2e-3
# K9a: one fp32 logsumexp in another order; K9b: dg sums 301 frames in
# another order (tests/test_torch_kernels.py)
JOINT_TOL = dict(atol=1e-5, rtol=1e-5)
# K9a's joints beside rnn-transducer:lstm:512's (16, 301, 25, 512): a 16k
# sentencepiece vocabulary (V = 16384, past the parent kernel's 6,456)
JOINT_V16K = (16, 301, 25, 16384)
JOINT_DG_TOL = dict(atol=1e-4, rtol=1e-5)
# K9b's long targets: 2,049 rows of U+1 (the parent kernel refused past
# 1,816); 65 chunks of 32 rows of U+1 and 10 of T, a block each
JOINT_U2049 = (4, 301, 2049, 512)
# JOINT_TOL and JOINT_DG_TOL are stated for K9b's sums of up to 301 rows
# (dg's over rnn-transducer:lstm:512's frames)
K9B_TOL_ROWS = 301


def k9b_tols(T, U1):
    """(df's, dg's) limits for K9b against its fp32 plain version: df sums
    the U+1 rows, dg the T frames; JOINT_TOL for df and JOINT_DG_TOL for
    dg where a sum takes up to K9B_TOL_ROWS rows, else None: that sum is
    held by ``k9b_exact``'s bound alone."""
    return (JOINT_TOL if U1 <= K9B_TOL_ROWS else None,
            JOINT_DG_TOL if T <= K9B_TOL_ROWS else None)


def k9b_exact(joint, f, g, lse, dlse, mf, mg):
    """The plain factored form evaluated in fp64 on K9b's inputs (on an
    input with no marked cell) and each output's limit for K9b, keyed to
    the rows it sums: n fp32 terms summed in any order lie within (n - 1)
    2^-24 S of their exact sum, S the sum of their magnitudes, and each
    term's own roundings (its exponentials, whose arguments reach 44 in W,
    and its products) within 64 2^-24 of it: (n + 64) 2^-24 S, n = U+1
    for df and T for dg, plus 1e-12 for the products that flush to 0
    (each under 2^-62 |dlse|). -> ((df, dg) fp64, (df's, dg's limits),
    the marked cells in fp64)."""
    x = [t.double() for t in (f, g, lse, dlse, mf, mg)]
    df, dg, marked = joint._grad_factored(*x)
    sf, sg, _ = joint._grad_factored(*x[:3], x[3].abs(), *x[4:])
    T, U1 = f.shape[1], g.shape[1]
    return (df, dg), ((U1 + 64) * 2.0 ** -24 * sf + 1e-12,
                      (T + 64) * 2.0 ** -24 * sg + 1e-12), int(marked.sum())


def within_limit(got, want, limit):
    """(all within the elementwise limit, max |got - want| / limit)"""
    ratio = (got.double() - want).abs() / limit
    return bool((ratio <= 1).all()), ratio.max().item()


# K8a against its plain version with the kernel's numerics (loss, history)
STAR_TOL = dict(atol=1e-4, rtol=1e-5)
STAR_HIST_TOL = dict(atol=1e-3, rtol=1e-5)
# K8a's long lattices (T, N, V, U, seed): S = 1027 and 4091 (the longest
# it takes; K = 8 over 5 and 16 warps), as tests/test_torch_kernels.py
# draws them
STAR_LONG = ((700, 5, 20, 256, 1), (2300, 5, 20, 1022, 2))
STAR_PENALTY = -0.5
# the transducer's transcription on the card against the same decode on
# the CPU from the same features: fp32 products summed in another order
# may flip an argmax that is within rounding of a tie
DECODE_MIN_SAME_ROWS = 14

# K5/K7 in bf16 against the plain versions: the kernel rounds the
# unnormalized probabilities to bf16 for P V, the plain version the
# normalized ones (tests/test_torch_kernels.py); fp32 the JAX package's
# bound for its flash kernel (tests/test_flash.py)
ATTN_TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2, mean=2e-3),
            "float32": dict(atol=2e-5, rtol=2e-5, mean=2e-5)}
# K10: a logsumexp over 50304 fp32 logits summed in another order, with
# the fast exp
CE_TOL = dict(atol=1e-3, rtol=1e-4)
# K11's y in bf16: the JAX package's bound (tests/test_decode_attn.py)
DECODE_TOL = dict(atol=2e-2, rtol=2e-2)
# K11's y in bf16, max |d| as a share of the largest |y| (over 1,000 rows
# and more |y| falls under DECODE_TOL's atol, as for K12). Sound: K11 rounds
# the same normalized p to bf16 as the plain version, so only a p within
# rounding of a bf16 boundary (exp2 against exp) and the fp32 sums' order
# move y, by a bf16 step of it: read 0 to 1.9e-3 (NVIDIA H100). Each run
# also reads planted faults that must exceed it: the first step of rows
# left out (through K11, starts raised by a step) and, where the plan
# takes a cluster, the peers' (max, sum) ignored (k11_emulate)
K11_REL = 1e-2
# K11's shapes (label, B, S, fill level, left-pad starts, E, H), bf16: at
# GPT-2 small's widths hat --batch's steps at fill levels 96 and 159
# (32-token prompts, 128 new tokens), its longest fill and K11's 10 MiB
# edge (S = 3412 rows); at gpt-nano:300:64's (heads of 32, a 64-row cache)
# the last step of phase 18's hat --batch (3 prompts of up to 18 tokens, 16
# new) and a step of its interactive hat. No driven path launches K11 in
# fp32 (the card tests hold that mode)
K11_CASES = (("B=32, L=96, starts", 32, 256, 96, True, 768, 12),
             ("B=1, L=96", 1, 256, 96, False, 768, 12),
             ("B=32, L=159, starts", 32, 256, 159, True, 768, 12),
             ("B=1, L=159", 1, 256, 159, False, 768, 12),
             ("B=32, L=1000, starts", 32, 1024, 1000, True, 768, 12),
             ("B=1, L=1000", 1, 1024, 1000, False, 768, 12),
             ("B=1, L=3000", 1, 3412, 3000, False, 768, 12),
             ("gpt-nano B=3, L=33, starts", 3, 64, 33, True, 64, 2),
             ("gpt-nano B=1, L=17", 1, 64, 17, False, 64, 2))
# K12's y in bf16, max |d| as a share of the largest |y|: over 4,000 rows
# of randn |y| is about 0.03, under DECODE_TOL's atol, so the limit scales
# with y. Sound: one bf16 step of the largest |y| (at most 2^-7 of it)
# plus p's rounding, which the plain version does and K12 does not; read
# 2.6e-3 to 6.5e-3 (NVIDIA H100). Each run also reads two planted faults
# that must exceed it: the new row at ``length`` left out (2.1e-2 at B=1,
# 4.5e-2 at B=32, the smaller readings) and the first attended split
# skipped
K12_REL = 1e-2
# GPT-2 small in bf16, kernel path against plain path on the same batch.
# Each limit sits about a decade from both readings that place it (NVIDIA
# H100): above the larger of the kernel path against the plain path and
# the plain path in bf16 against fp32 (rounding alone; hap per-token NLL
# max 2.5e-2, mean 4.4e-3), and below a planted fault that the smoke run
# also reads (the segment mask dropped: max 2.4, mean 0.43)
GPT_NLL_TOL = dict(max=0.25, mean=0.04)
# hat, max |logit difference| under teacher forcing, placed the same way:
# rounding alone 3.6e-2, the left padding attended (starts dropped) 3.7
GPT_LOGIT_TOL = 0.35
# the same gate over decoder:50304:4096's 3,584-row cache (K12). With
# random weights attention over 3,500 rows is near uniform and a fault
# moves the logits less than at short context: the first attended split
# of K12's plan skipped (64 rows at B=8) read 7.2e-2. Placed at the
# geometric mean of that fault and the kernel path against the plain path
# (2.4e-2 to 2.7e-2), 1.6x from each, both read every run (NVIDIA H100);
# the new row left out (2.9e-2) is not separable here and is caught by
# K12_REL in phase 22
LONG_LOGIT_TOL = 0.044
# --q8 against bf16 on the same batch: hap's mean per-token |NLL
# difference| and hat's max |logit difference| under teacher forcing. Each
# limit sits between two readings the smoke run takes every time: the
# quantization error (int8 kernel path against the bf16 kernel path) and
# a planted fault (every qscale doubled) against the bf16 path. Placed from
# the first run (NVIDIA H100): hap 9.5e-3 and 0.65, hat 6.6e-2 and 3.2-3.5
Q8_NLL_TOL = 0.08
Q8_LOGIT_TOL = 0.5
# K6a/K6b against the plain backward: the fp32 bound of
# tests/test_torch_kernels.py (of the largest gradient), and in bf16 max
# |d| 2e-2 of the largest gradient, mean |d| 1e-2 of the mean
K6_TOL = {"float32": dict(max=2e-5),
          "bfloat16": dict(max=2e-2, mean=1e-2)}
# hala's 8 rows with ragged key lengths, drawn as phase 13 draws K5's
# (T/2 .. T, generator seed 2, the first full): the case whose last
# partial key tiles a planted K6 fault drops
K6_RAGGED = [1024, 797, 520, 782, 988, 632, 764, 768]
# one hala update of GPT-2 small in bf16, kernel path against plain path
# on the same batch: the loss (forward: K5, K10), relative; and the whole
# gradient, ||g_kernel - g_plain|| / ||g_plain|| (backward: K6a, K6b, K10's
# backward). Each limit sits between two readings the run takes every
# time: the plain path in bf16 against the plain path in fp32 (rounding),
# and the plain path with a planted fault that the gradient limit must
# catch: K6b without its causal mask, and dq without its 1/sqrt(D)
HALA_LOSS_TOL = 2e-3
HALA_GRAD_TOL = 5e-2
# hala's entry point at full width on byte ids of the repository's text,
# from a random init: the last logged train loss at least HALA_ENTRY_DROP
# nats below the first (gpt-nano's check is only that it falls); and after
# HALA_ENTRY_UPDATES updates the last val loss at least HALA_ENTRY_MARGIN
# nats under the eval set's byte unigram entropy, which the same run with
# K6a/K6b returning zero gradients (a planted fault the run also reads)
# must not reach. Placed from ``chip_smoke.py --hala-curve`` (PERF.md,
# PR 5): at 100 updates the sound run's val loss sits about 0.3 nats
# under the unigram entropy, the zeroed run's about 0.1 above it
HALA_ENTRY_DROP = 3.0
HALA_ENTRY_UPDATES, HALA_ENTRY_MARGIN = 100, 0.1
# decoder's learning rate at the entry point (after 20 warm-up updates)
HALA_ENTRY_LR = ["--lr", "1e-3", "--warmup_iters", "20"]
# bf16 tensor-core operations per score pair and head dim (QK^T and PV, a
# multiply and an add each); fp32 operations per score (scale, mask, max,
# exp, sum) in the flash and decode kernels; per logit in K10 (max, exp,
# sum, compare)
ATTN_ELEM, CE_ELEM = 6, 4
# fp32 operations per score pair in K6a/K6b: scale, mask, exp, the delta
# subtraction, the product with p, the rounding
K6_ELEM = 6

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate
# outside the tensor cores, HBM3 bandwidth; dense int8 tensor-core rate
PEAK_BF16, PEAK_FP32, HBM = 989e12, 67e12, 3.35e12
PEAK_INT8 = 1979e12
# about 1 ms of device spin at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 2_000_000
# fp32 elementwise operations per cell and step, as the kernels count
# them: K1 4 gate sums, 3 sigmoids and 2 tanh (2 each), the c and h
# updates (4); K2 the 5 delta products and sums of each gate (~25); a
# lattice state 3 exp, 1 log and ~8 adds (12), its backward 16; a star
# state's 6-point stencil forward (~20), its backward (six-term logsumexp, the
# clipped exp, ~28). K9a's and K9b's functions need no work per joint cell
# but the factored form's (``k9a_bound``, ``k9b_bound``)
K1_ELEM, K2_ELEM, K3_ELEM, K4_ELEM = 20, 25, 12, 16
# the int8 modes add, per cell and step: K1-q8 h * 127 and its rounding,
# each gate's int32-to-float and scale (10); K2-q8 each gate's product
# with s, |.|, max, division by m, * 127 and rounding, and the
# dequantization of dh (26)
K1Q8_ELEM, K2Q8_ELEM = K1_ELEM + 10, K2_ELEM + 26
K8A_ELEM, K8B_ELEM = 20, 28


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Median time of one call of ``fn`` on the card: CUDA events recorded
    around it, after one warm-up call. A spin kernel queued first keeps
    the card busy while the host queues the events and the call, so the
    host's launch latency stays out of a short call's time; a call whose
    host side takes longer than the spin is charged the excess."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, tensor_flops=0.0, fp32_ops=0.0, int8_ops=0.0):
    """(ms, "bytes" | "operations"): the least time this card could take
    to move ``nbytes`` and do the given operations at its peak rates."""
    t_bytes = nbytes / HBM
    t_ops = tensor_flops / PEAK_BF16 + fp32_ops / PEAK_FP32 + \
        int8_ops / PEAK_INT8
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lstm_products(T, B, H, itemsize, elem):
    """bound()'s keyword operations of an LSTM sweep: the recurrent
    product (2 T B 4H H) on the tensor cores in bf16, on the CUDA cores
    in fp32 (the kernels' fp32 route, TF32 off), beside ``elem`` fp32
    operations a cell and step."""
    products = 2.0 * T * B * 4 * H * H
    if itemsize == 4:
        return dict(fp32_ops=products + elem * T * B * H)
    return dict(tensor_flops=products, fp32_ops=elem * T * B * H)


def k1_bound(T, B, H, itemsize, residuals=False):
    nbytes = itemsize * (T * B * 4 * H + 4 * H * H + T * B * H) \
        + 4 * 4 * B * H                        # h0, c0 in; h, c out (fp32)
    if residuals:
        nbytes += itemsize * T * B * 5 * H     # acts and cs out
    return bound(nbytes, **lstm_products(T, B, H, itemsize, K1_ELEM))


def k2_bound(T, B, H, itemsize):
    # dys, acts, cs, c0 and W in; dgates out; dh_last, dc_last, dh0, dc0
    nbytes = itemsize * (T * B * (H + 4 * H + H + 4 * H) + B * H +
                         4 * H * H) + 4 * 4 * B * H
    return bound(nbytes, **lstm_products(T, B, H, itemsize, K2_ELEM))


def k1q8_bound(T, B, H, itemsize, residuals=False):
    # x_proj in, ys out in x_proj's dtype; wq int8 and s fp32; h0, c0 in
    # and h, c out (fp32); the residuals acts and cs out in bf16
    nbytes = itemsize * (T * B * 4 * H + T * B * H) + 4 * H * H + \
        4 * 4 * H + 4 * 4 * B * H
    if residuals:
        nbytes += 2 * T * B * 5 * H
    return bound(nbytes, fp32_ops=K1Q8_ELEM * T * B * H,
                 int8_ops=2.0 * T * B * 4 * H * H)


def k2q8_bound(T, B, H):
    # dys, acts, cs in and dgates out (bf16); c0 (bf16); wq int8, s fp32;
    # dh_last, dc_last in and dh0, dc0 out (fp32)
    nbytes = 2 * (T * B * (H + 4 * H + H + 4 * H) + B * H) + 4 * H * H + \
        4 * 4 * H + 4 * 4 * B * H
    return bound(nbytes, fp32_ops=K2Q8_ELEM * T * B * H,
                 int8_ops=2.0 * T * B * 4 * H * H)


def lattice_cells(input_lengths, S, T):
    """(item, frame, state) cells of the active frames."""
    return int(input_lengths.clamp(0, T).sum()) * S


def k3_bound(input_lengths, N, T, S, U, history):
    cells = lattice_cells(input_lengths, S, T)
    # gathered emissions of the active frames, targets and lengths in;
    # loss (and the whole history) out
    nbytes = 4 * (cells + N * U + 2 * N + N) + \
        (4 * N * T * S if history else 0)
    return bound(nbytes, 0, K3_ELEM * cells)


def k9b_bound(N, T, U1, V, live):
    """K9b's least time: f, g, lse, dlse, mf and mg read and df and dg
    written once; the factored form's operations, two FMAs (2 each) for
    each of the ``live`` cells (dlse != 0) at each of the V columns, and one
    for each of the N (T + U1) V exponentials."""
    nbytes = 4 * (2 * N * T * V + 2 * N * U1 * V + 2 * N * T * U1 + N * T +
                  N * U1)
    return bound(nbytes, 0, 4.0 * live * V + N * (T + U1) * V)


def k9a_bound(N, T, U1, V):
    """K9a's least time: f and g read and lse written once; the factored
    form's operations, an FMA (2) for each of the N T U1 V products and
    one for each of the N (T + U1) V exponentials."""
    return bound(4 * (N * T * V + N * U1 * V + N * T * U1), 0,
                 2.0 * N * T * U1 * V + N * (T + U1) * V)


def k4_bound(input_lengths, N, T, S, U, C):
    cells = lattice_cells(input_lengths, S, T)
    # history and gathered emissions of the active frames, targets,
    # lengths, loss and g in; the whole (T, N, C) gradient out
    nbytes = 4 * (2 * cells + N * U + 4 * N + T * N * C)
    return bound(nbytes, 0, K4_ELEM * cells)


def cycles_a_frame(ms, input_lengths, T):
    """A lattice kernel's time over its longest item's frames (the serial
    chain every item's sweep is), in cycles at the card's maximum SM
    clock (nvidia-smi): the yardstick of a sweep, beside its bound."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    mhz = float(r.stdout.split()[0])
    frames = int(input_lengths.clamp(0, T).max())
    return ms * 1e3 * mhz / max(frames, 1), mhz


def lattice_faults(torch, name, grad, args, want, faults):
    """Planted faults of a lattice backward (K4 or K8b), each computed from
    its plain version ``grad`` with the fault applied, and their largest
    |fault - plain|: the d em rows one frame off (a ring off by one), and
    ``faults``, {label: (module, attribute, edit)}: ``grad`` run with the
    module's function replaced by ``edit(function)``. Each must read
    beyond CTC_GRAD_TOL."""
    got = {"d em rows one frame off": want.roll(1, 0)}
    for label, (mod, attr, edit) in faults.items():
        fn = getattr(mod, attr)
        setattr(mod, attr, edit(fn))
        try:
            got[label] = grad(*args)
        finally:
            setattr(mod, attr, fn)
    out = {}
    for label, fault in got.items():
        err = (fault - want).abs()
        beyond = not bool((err <= CTC_GRAD_TOL +
                           CTC_GRAD_TOL * want.abs()).all())
        print(f"{name} planted fault, {label}: max|d| {err.max().item():.3e}"
              f", beyond tol {CTC_GRAD_TOL}: {beyond}", flush=True)
        check(beyond, f"{name}'s planted fault ({label}) reads within "
                      f"CTC_GRAD_TOL")
        out[label] = err.max().item()
    return out


def edge_states(plan, j):
    """The states at register ``j`` of a sweep lane whose stencil
    neighbour lies across an edge of the plan's layout: of the first lane
    of each warp but the first (which the previous warp's last lane reads
    through shared memory, behind the sweep's named barrier), and of lane
    16 of each warp (which lane 15 reads by shuffle)."""
    K, S = plan.per_lane, plan.states
    warp = [32 * K * w + j for w in range(1, plan.sweep_warps)]
    lane = [32 * K * w + 16 * K + j for w in range(plan.sweep_warps)]
    return [s for s in warp if s < S], [s for s in lane if s < S]


def ctc_faults(ctc, plan, warp_edges=True):
    """K4's edge faults: the skips s-2 -> s into the label states at
    register 1 of a lane (s-2 is the previous lane's last state) dropped,
    at the warps' edges and at a lane edge inside each warp (only the
    latter without ``warp_edges``, for a plan of one sweep warp)."""
    def drop(states):
        def edit(lattice):
            def dropped(*a):
                emit, skip, lens, final = lattice(*a)
                skip = skip.clone()
                skip[:, states] = -1e9
                return emit, skip, lens, final
            return dropped
        return ctc, "_lattice", edit
    warp, lane = edge_states(plan, 1)
    check(bool(warp) or not warp_edges,
          f"K4's plan {plan} has no warp edge to fault")
    check(bool(lane), f"K4's plan {plan} has no lane edge to fault")
    faults = {f"skips into {warp} dropped (warp edges)": drop(warp)} \
        if warp_edges else {}
    return faults | {f"skips into {lane} dropped (lane edges)": drop(lane)}


def star_faults(star, plan):
    """K8b's edge faults: the label edges s-4 -> s into the label states
    at register 3 of a lane (s-4 is the previous lane's last state)
    dropped, at the warps' edges and at a lane edge inside each warp."""
    def drop(states):
        def edit(lattice):
            def dropped(*a):
                emit, types, same, lens, ulens, ext = lattice(*a)
                same = same.clone()
                same[:, states] = True
                return emit, types, same, lens, ulens, ext
            return dropped
        return star, "_lattice", edit
    warp, lane = edge_states(plan, 3)
    check(bool(warp), f"K8b's plan {plan} has no warp edge to fault")
    return {f"label edges into {warp} dropped (warp edges)": drop(warp),
            f"label edges into {lane} dropped (lane edges)": drop(lane)}


def star_fwd_faults(torch, star, plan, args, loss_e, hist_e):
    """K8a's edge faults, computed from its plain version
    star_forward_history with the label edge s-4 -> s dropped into the
    label states whose s-4 the sweep reads from another lane
    (``edge_states(plan, 3)``: a lane's register 3, whose s-4 is the
    previous lane's last): at the warps' edges (shared memory) and at a
    lane edge inside each warp (a shuffle). -> {label: (max |d loss|,
    max |d hist|)}; each must read beyond STAR_TOL or the history's
    limit."""
    warp, lane = edge_states(plan, 3)
    check(bool(warp), f"K8a's plan {plan} has no warp edge to fault")
    out = {}
    for label, states in ((f"label edges into {warp} dropped (warp edges)",
                           warp),
                          (f"label edges into {lane} dropped (lane edges)",
                           lane)):
        lattice = star._lattice

        def dropped(*a):
            emit, types, same, lens, ulens, ext = lattice(*a)
            same = same.clone()
            same[:, states] = True
            return emit, types, same, lens, ulens, ext
        star._lattice = dropped
        try:
            loss, hist = star.star_forward_history(*args, STAR_PENALTY)
        finally:
            star._lattice = lattice
        ok_l, dl = close(loss, loss_e, STAR_TOL)
        ok_h, dh = close(hist, hist_e, STAR_HIST_TOL)
        print(f"K8a planted fault, {label}: max|dloss| {dl:.3e}, max|dhist| "
              f"{dh:.3e}, beyond the limits: {not (ok_l and ok_h)}",
              flush=True)
        check(not (ok_l and ok_h), f"K8a's planted fault ({label}) reads "
                                   f"within STAR_TOL and STAR_HIST_TOL")
        out[label] = (dl, dh)
    return out


def star_grad_without_first_back_edges(star, args):
    """The plain star_grad with the back-edge term of every state at
    register 0 of a lane (s = 0 mod 4, a blank: the edge is masked) left
    out, as K8b leaves it out."""
    lse = star._lse

    def without(*xs):
        if len(xs) == 6:                # star_grad's stencil: s-1 last
            back = xs[5].clone()
            back[:, 0::4] = star.FILL
            xs = (*xs[:5], back)
        return lse(*xs)
    star._lse = without
    try:
        return star.star_grad(*args)
    finally:
        star._lse = lse


def lstm_inputs(torch, dev, T, B, H, dtype):
    g = torch.Generator().manual_seed(T * 1000 + H)
    w = (torch.rand((4 * H, H), generator=g) * 2 - 1) / H ** 0.5
    xp = torch.randn((T, B, 4 * H), generator=g)
    h0 = torch.randn((B, H), generator=g) * 0.1
    c0 = torch.randn((B, H), generator=g) * 0.1
    return w.to(dev, dtype), xp.to(dev, dtype), h0.to(dev), c0.to(dev)


def within(torch, got, want, tol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    return ok and err.mean().item() < tol["mean"], err.max().item(), \
        err.mean().item()


def lstm_plan(torch, dev, kind, H, dtype):
    """(route, plan) of K1 ("fwd"), K2 ("bwd"), K1-q8 ("fwd_q8") or K2-q8
    ("bwd_q8") at width H on this card (``nn.lstm_cuda.route`` with what
    ``hl_lstm_card`` reports)."""
    from haloop_tpu_torch.nn import lstm_cuda
    sms, smem, ncl = lstm_cuda.card(dev)
    return lstm_cuda.route(kind, dtype, H, 0, sms, smem, ncl[kind])


def fault_units(torch, dev, kind, H):
    """The hidden units of one block (K1, K1-q8) or of one cluster (K2)
    of the persistent kernel's plan at width H: the second cluster's first
    block, or the second cluster."""
    from haloop_tpu_torch.nn import lstm_cuda
    sms, smem, ncl = lstm_cuda.card(dev)
    plan = lstm_cuda.persist_plan(kind, H, sms, smem, ncl[kind])
    cu = plan.c * plan.u
    first = min(cu, H - plan.u)
    return torch.arange(first, min(first + (cu if kind == "bwd" else plan.u),
                                   H), device=dev)


def k1_stale_h(torch, w, xp, h0, c0, units):
    """A planted fault: plain K1 (nn.lstm.lstm_scan) with the gates of
    ``units`` computed from h_{t-2} (h0 at t = 1) from the third step on,
    what one block that passes a missing or early grid barrier computes.
    Returns ys."""
    T, B, H4 = xp.shape
    H = H4 // 4
    rows = torch.cat([g * H + units for g in range(4)])
    wf = w.float()
    c = c0.float()
    hs = [h0.to(w.dtype).float()]            # h_{t-1} in W's dtype
    ys = torch.empty((T, B, H), dtype=xp.dtype, device=xp.device)
    for t in range(T):
        rec = hs[t] @ wf.T
        if t >= 2:
            rec[:, rows] = hs[t - 1] @ wf[rows].T
        i, f, g, o = (xp[t].float() + rec).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        ys[t] = (torch.sigmoid(o) * torch.tanh(c)).to(xp.dtype)
        hs.append(ys[t].float())
    return ys


def k2_stale_share(torch, dys, acts, c_prev, cs, w, dh_last, dc_last, units):
    """A planted fault: plain K2 (nn.lstm.lstm_scan_bwd) with the recurrent
    product of ``units`` (one cluster's) taken from the dgates of the step
    before the right one (dgates[t+2] where dh_t needs dgates[t+1]), what
    a cluster that reads its share of dgates before the grid barrier
    computes. Returns dgates."""
    T, B, H4 = acts.shape
    dh = dh_last.to(acts.dtype).float()
    dc = dc_last.to(acts.dtype).float()
    dgates = torch.empty_like(acts)
    wf = w.float()
    for t in range(T - 1, -1, -1):
        i, f, g, o = acts[t].float().chunk(4, dim=-1)
        tc = torch.tanh(cs[t].float())
        dh = dh + dys[t].float()
        do = dh * tc * o * (1 - o)
        dc = dc + dh * o * (1 - tc * tc)
        d = torch.cat([dc * g * i * (1 - i),
                       dc * c_prev[t].float() * f * (1 - f),
                       dc * i * (1 - g * g), do], dim=-1)
        dgates[t] = d.to(acts.dtype)
        dh = dgates[t].float() @ wf
        if t + 1 < T:
            dh[:, units] = dgates[t + 1].float() @ wf[:, units]
        dc = dc * f
    return dgates


# (T, B, H, dtype, timed): the main paths' shapes are timed, lstm:512's
# first (its numbers stand in the kernels line, the others under by_shape)
LSTM_SHAPES = ((385, 48, 1536, "bfloat16", True), (7, 5, 40, "float32", False),
               (15, 4, 128, "bfloat16", False),
               (301, 16, 1024, "bfloat16", True),   # rnn-transducer encoder
               (25, 16, 512, "bfloat16", True))     # its prediction net


def by_shape(reports):
    """The first (lstm:512) report, with the others under by_shape."""
    (_, main), *rest = reports.items()
    return dict(main, by_shape={k: v for k, v in rest})


def phase_lstm(torch, dev):
    from haloop_tpu_torch.nn import lstm, lstm_cuda
    reports = {}
    sms, smem, ncl = lstm_cuda.card(dev)
    print(f"K1/K2 persistent kernels: {sms} SMs, {smem} B of shared memory "
          f"a block; resident at once " + ", ".join(
              f"{ncl[k]} clusters of {lstm_cuda.CLUSTERS[k]} ({k})"
              for k in ("fwd", "bwd")) +
          "; cooperative cluster launches accepted", flush=True)
    for T, B, H, name, timed in LSTM_SHAPES:
        dtype = getattr(torch, name)
        w, xp, h0, c0 = lstm_inputs(torch, dev, T, B, H, dtype)
        route, plan = lstm_plan(torch, dev, "fwd", H, dtype)
        before = dict(lstm_cuda.route_launches)
        ys, h, c = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0)
        again = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                if v != before[k]}
        same = all(torch.equal(a, b) for a, b in zip((ys, h, c), again))
        grid = (f"grid {plan.blocks} blocks = {plan.clusters} clusters of "
                f"{plan.c}, {plan.u} units a block, {plan.stages}-slot ring, "
                f"{plan.smem} B" if plan else "one launch a step")
        print(f"K1 lstm T={T} B={B} H={H} {name}: route {route} ({grid}); "
              f"launches by route {took}; the same bits twice {same}",
              flush=True)
        check(took == {f"fwd_{route}": 2}, f"K1 took {took}, not {route}")
        check(same, f"K1 gave other bits on a second run at {(T, B, H)}")
        check(route == "persist" or H not in (1536, 1024, 512),
              f"K1 at the main paths' width {H} did not take the "
              f"persistent kernel")
        ye, he, ce = lstm.lstm_scan(w, xp, h0, c0)
        tol = LSTM_TOL[name]
        ok, max_err, mean_err = within(torch, ys, ye, tol)
        hc_err = max((h - he).abs().max().item(), (c - ce).abs().max().item())
        print(f"K1 lstm T={T} B={B} H={H} {name}: max|dys|={max_err:.3e} "
              f"mean|dys|={mean_err:.3e} max|dh,dc|={hc_err:.3e} "
              f"(tol atol={tol['atol']} rtol={tol['rtol']} "
              f"mean<{tol['mean']})", flush=True)
        check(ok, f"K1 disagrees with lstm_scan at {(T, B, H, name)}")
        check(bool(((h - he).abs() <= tol["atol"] + tol["rtol"] * he.abs())
                   .all()), f"K1 last h/c disagree at {(T, B, H, name)}")
        if (T, B, H) == LSTM_SHAPES[0][:3]:
            # one block's units on h_{t-2}: the missing grid barrier
            units = fault_units(torch, dev, "fwd", H)
            bad = k1_stale_h(torch, w, xp, h0, c0, units)
            ok_f, err_f, mean_f = within(torch, ys, bad, tol)
            print(f"K1 planted fault (units {int(units[0])}..{int(units[-1])}"
                  f" read h_(t-2)): max|dys|={err_f:.3e} mean "
                  f"{mean_f:.3e}, beyond the tolerance {not ok_f}",
                  flush=True)
            check(not ok_f, "the stale-h fault reads within LSTM_TOL")
        if timed:               # a main path's shape
            ms = cuda_ms(lambda: lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0))
            plain_ms = cuda_ms(lambda: lstm.lstm_scan(w, xp, h0, c0))
            # cuDNN's LSTM, one layer of the same width, input projection
            # included (x of width H): the library yardstick
            ref = torch.nn.LSTM(H, H).to(dev, dtype)
            x = xp[..., :H].contiguous()
            with torch.inference_mode():
                lib_ms = cuda_ms(lambda: ref(x))
            b_ms, b_by = k1_bound(T, B, H, xp.element_size())
            print(f"K1 lstm T={T} B={B} H={H}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, cuDNN nn.LSTM {lib_ms:.3f} ms, bound "
                  f"{b_ms:.3f} ms ({b_by})", flush=True)
            reports[f"T={T} B={B} H={H}"] = dict(
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return by_shape(reports)


def ctc_inputs(torch, dev):
    T, N, C, U = 385, 48, 512, 96
    g = torch.Generator().manual_seed(3)
    log_probs = torch.log_softmax(torch.randn((T, N, C), generator=g) * 2,
                                  -1)
    targets = torch.randint(1, C, (N, U), generator=g)
    input_lengths = torch.randint(200, T + 1, (N,), generator=g)
    target_lengths = torch.randint(1, U + 1, (N,), generator=g)
    target_lengths[0] = 0                      # empty target
    targets[1] = 7                             # repeated labels
    target_lengths[1] = U
    input_lengths[2], target_lengths[2] = 10, U  # infeasible
    feasible = torch.ones(N, dtype=torch.bool)
    feasible[2] = False
    return [t.to(dev) for t in (log_probs, targets, input_lengths,
                                target_lengths)], feasible.to(dev)


def ctc_fwd_faults(torch, ctc, plan, args, loss_e, hist_e, warp_edges=True):
    """K3's edge faults, computed from its plain version
    ctc_forward_history with the skip s-2 -> s dropped into the label
    states whose s-2 the sweep reads from another lane (``edge_states(plan,
    1)``: a lane's register 1, whose s-2 is the previous lane's last): at
    the warps' edges (shared memory) and at a lane edge inside each warp (a
    shuffle). -> {label: (max |d loss|, max |d hist|)}; each must read
    beyond CTC_TOL or CTC_HIST_TOL."""
    out = {}
    for label, (mod, attr, edit) in ctc_faults(ctc, plan,
                                               warp_edges).items():
        fn = getattr(mod, attr)
        setattr(mod, attr, edit(fn))
        try:
            loss, hist = ctc.ctc_forward_history(*args)
        finally:
            setattr(mod, attr, fn)
        ok_l, dl = close(loss, loss_e, CTC_TOL)
        ok_h, dh = close(hist, hist_e, CTC_HIST_TOL)
        print(f"K3 planted fault, {label}: max|dloss| {dl:.3e}, max|dhist| "
              f"{dh:.3e}, beyond the limits: {not (ok_l and ok_h)}",
              flush=True)
        check(not (ok_l and ok_h), f"K3's planted fault ({label}) reads "
                                   f"within CTC_TOL and CTC_HIST_TOL")
        out[label] = (dl, dh)
    return out


def phase_ctc(torch, dev):
    """K3 (with and without its history) against ctc_forward_score on the
    feasible items and against ctc_forward_history; its plan, the same
    bits twice, the planted edge faults; times and cycles a frame."""
    from haloop_tpu_torch.ops import ctc, ctc_cuda
    args, ok = ctc_inputs(torch, dev)
    log_probs, targets, input_lengths, target_lengths = args
    T, N, C = log_probs.shape
    U = targets.shape[1]
    S = 2 * U + 1
    plan = ctc_cuda.fwd_plan(S, C)
    loss = ctc_cuda.ctc_fwd_cuda(*args)
    hist, hist2 = (torch.empty((N, T, S), device=dev) for _ in range(2))
    loss_h = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    loss_h2 = ctc_cuda.ctc_fwd_cuda(*args, history=hist2)
    torch.cuda.synchronize()
    ref = ctc.ctc_forward_score(*args)
    bad = ~ok
    rel = ((loss - ref).abs() / ref.abs())[ok]
    max_abs = (loss - ref).abs()[ok].max().item()
    loss_e, hist_e = ctc.ctc_forward_history(*args)
    ok_l, err_l = close(loss, loss_e, CTC_TOL)
    ok_h, err_h = close(hist, hist_e, CTC_HIST_TOL)
    same = torch.equal(loss_h, loss_h2) and torch.equal(hist, hist2)
    print(f"K3 ctc N={N} T={T} C={C} S'={S}, plan {tuple(plan)}: max "
          f"rel|dloss|={rel.max().item():.3e} max|dloss|={max_abs:.3e} on "
          f"feasible items (tol rel {CTC_REL_TOL}); against "
          f"ctc_forward_history max|dloss|={err_l:.3e} max|dhist|="
          f"{err_h:.3e} (tol {CTC_TOL}, history {CTC_HIST_TOL}); infeasible "
          f"loss {loss[bad].tolist()} (plain {ref[bad].tolist()}); the same "
          f"bits twice: {same}", flush=True)
    check(bool(torch.isfinite(loss).all()), "K3 loss not finite")
    check(rel.max().item() <= CTC_REL_TOL, "K3 disagrees with the plain CTC")
    check(bool((loss[bad] >= 1e8).all()), "K3 infeasible loss is not large")
    check(torch.equal(loss, loss_h) and bool(torch.isfinite(hist).all()),
          "K3 with the alpha history differs from K3 without")
    check(ok_l and ok_h, "K3 disagrees with the plain ctc_forward_history")
    check(same, "K3 gives other bits on another run")
    faults = ctc_fwd_faults(torch, ctc, plan, args, loss_e, hist_e)
    reports = {}
    for history in (False, True):
        h = hist if history else None
        ms = cuda_ms(lambda: ctc_cuda.ctc_fwd_cuda(*args, history=h))
        plain_ms = cuda_ms(
            (lambda: ctc.ctc_forward_history(*args)) if history else
            (lambda: ctc.ctc_forward_score(*args)))
        lib_ms = cuda_ms(lambda: torch.nn.functional.ctc_loss(
            log_probs, targets, input_lengths, target_lengths,
            reduction="none"))
        b_ms, b_by = k3_bound(input_lengths, N, T, S, U, history)
        cyc, mhz = cycles_a_frame(ms, input_lengths, T)
        print(f"K3 ctc N={N} T={T} history={history}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, F.ctc_loss {lib_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {cyc:.0f} cycles a frame of the "
              f"longest item at {mhz:.0f} MHz", flush=True)
        reports[history] = dict(max_abs_err=max_abs, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms,
                                plan=list(plan), planted_faults=faults)
    return reports


def phase_lstm_train(torch, dev):
    """K1 with residuals against K1 and the plain residuals; K2 against
    lstm_scan_bwd on the same residuals."""
    from haloop_tpu_torch.nn import lstm, lstm_cuda
    rep_res, rep_bwd = {}, {}
    for T, B, H, name, timed in LSTM_SHAPES:
        dtype = getattr(torch, name)
        tol = LSTM_TOL[name]
        w, xp, h0, c0 = lstm_inputs(torch, dev, T, B, H, dtype)
        ys, h, c, acts, cs = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0,
                                                     residuals=True)
        ys0, h_0, c_0 = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0)
        again = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0, residuals=True)
        torch.cuda.synchronize()
        check(torch.equal(ys, ys0) and torch.equal(h, h_0) and
              torch.equal(c, c_0),
              f"K1 with residuals changes ys/h/c at {(T, B, H, name)}")
        check(all(torch.equal(a, b)
                  for a, b in zip((ys, h, c, acts, cs), again)),
              f"K1 with residuals gave other bits on a second run at "
              f"{(T, B, H, name)}")
        _, _, _, acts_e, cs_e = lstm.lstm_scan(w, xp, h0, c0,
                                               residuals=True)
        ok_a, err_a, _ = within(torch, acts, acts_e, tol)
        ok_c, err_c, _ = within(torch, cs, cs_e, tol)
        print(f"K1-residual T={T} B={B} H={H} {name}: ys bit for bit those "
              f"of K1; max|dacts|={err_a:.3e} max|dcs|={err_c:.3e}",
              flush=True)
        check(ok_a and ok_c, f"K1's residuals disagree at {(T, B, H, name)}")

        # K2 on the plain residuals
        g = torch.Generator().manual_seed(T + H)
        dys = torch.randn((T, B, H), generator=g).to(dev, acts.dtype)
        dh = torch.randn((B, H), generator=g).to(dev) * 0.1
        dc = torch.randn((B, H), generator=g).to(dev) * 0.1
        c0r = c0.to(acts.dtype)
        c_prev = torch.cat([c0r[None], cs_e[:-1]])
        route, plan = lstm_plan(torch, dev, "bwd", H, dtype)
        before = dict(lstm_cuda.route_launches)
        dg, dh0, dc0 = lstm_cuda.lstm_bwd_cuda(dys, acts_e, cs_e, c0r, w, dh,
                                               dc)
        again = lstm_cuda.lstm_bwd_cuda(dys, acts_e, cs_e, c0r, w, dh, dc)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                if v != before[k]}
        same = all(torch.equal(a, b) for a, b in zip((dg, dh0, dc0), again))
        grid = (f"grid {plan.blocks} blocks = {plan.clusters} clusters of "
                f"{plan.c}, {plan.u} units a block, {plan.stages}-slot ring, "
                f"{plan.smem} B" if plan else "one launch a step")
        print(f"K2 lstm_bwd T={T} B={B} H={H} {name}: route {route} "
              f"({grid}); launches by route {took}; K1 with residuals and "
              f"K2 the same bits twice {same}", flush=True)
        check(took == {f"bwd_{route}": 2}, f"K2 took {took}, not {route}")
        check(same, f"K2 gave other bits on a second run at {(T, B, H)}")
        check(route == "persist" or H not in (1536, 1024, 512),
              f"K2 at the main paths' width {H} did not take the "
              f"persistent kernel")
        dg_e, dh0_e, dc0_e = lstm.lstm_scan_bwd(dys, acts_e, c_prev, cs_e, w,
                                                dh, dc)
        ok_g, err_g, mean_g = within(torch, dg, dg_e, tol)
        ok_h, err_h, _ = within(torch, dh0, dh0_e, tol)
        ok_cc, err_cc, _ = within(torch, dc0, dc0_e, tol)
        # one bf16 step at the larger magnitude of each pair
        step = torch.maximum(dg.float().abs(), dg_e.float().abs()) * 2 ** -7
        one = ((dg.float() - dg_e.float()).abs() <= step).float().mean()
        dw = lstm.lstm_scan_dw(dg, h0, ys).float().flatten()
        dw_e = lstm.lstm_scan_dw(dg_e, h0, ys).float().flatten()
        cos = (dw @ dw_e / (dw.norm() * dw_e.norm())).item()
        print(f"K2 lstm_bwd T={T} B={B} H={H} {name}: max|ddgates|="
              f"{err_g:.3e} mean {mean_g:.3e}, {one.item():.6f} of dgates "
              f"within one bf16 step, max|ddh0|={err_h:.3e} max|ddc0|="
              f"{err_cc:.3e}, cos(dW_hh)={cos:.7f} (tol atol={tol['atol']} "
              f"rtol={tol['rtol']} mean<{tol['mean']}, cos>{DW_COS})",
              flush=True)
        check(ok_g and ok_h and ok_cc and cos > DW_COS,
              f"K2 disagrees with lstm_scan_bwd at {(T, B, H, name)}")
        if (T, B, H) == LSTM_SHAPES[0][:3]:
            # one cluster's share of dgates from the step before the right
            # one: its blocks read dgates ahead of the grid barrier
            units = fault_units(torch, dev, "bwd", H)
            bad = k2_stale_share(torch, dys, acts_e, c_prev, cs_e, w, dh, dc,
                                 units)
            ok_f, err_f, mean_f = within(torch, dg, bad, tol)
            dw_f = lstm.lstm_scan_dw(bad, h0, ys).float().flatten()
            cos_f = (dw @ dw_f / (dw.norm() * dw_f.norm())).item()
            print(f"K2 planted fault (units {int(units[0])}.."
                  f"{int(units[-1])} from a step-old dgates): "
                  f"max|ddgates|={err_f:.3e} mean {mean_f:.3e}, "
                  f"cos(dW_hh)={cos_f:.7f}; beyond LSTM_TOL {not ok_f}, "
                  f"beyond DW_COS {cos_f <= DW_COS}; 1 - cos: sound "
                  f"{1 - cos:.2e}, limit {1 - DW_COS:.2e}, fault "
                  f"{1 - cos_f:.2e}", flush=True)
            check(not ok_f and cos_f <= DW_COS,
                  "the stale-dgates fault reads within LSTM_TOL or DW_COS")
        if not timed:
            continue
        # a main path's shape: times
        args = (w, xp, h0, c0)
        ms = cuda_ms(lambda: lstm_cuda.lstm_fwd_cuda(*args, residuals=True))
        plain_ms = cuda_ms(lambda: lstm.lstm_scan(*args, residuals=True))
        bargs = (dys, acts_e, cs_e, c0r, w, dh, dc)
        bms = cuda_ms(lambda: lstm_cuda.lstm_bwd_cuda(*bargs))
        bplain = cuda_ms(lambda: lstm.lstm_scan_bwd(
            dys, acts_e, c_prev, cs_e, w, dh, dc))
        # cuDNN's LSTM forward under autograd (it saves its reserve for
        # the backward) and its backward alone
        ref = torch.nn.LSTM(H, H).to(dev, dtype)
        x = xp[..., :H].contiguous().requires_grad_(True)
        lib_ms = cuda_ms(lambda: ref(x))
        out = ref(x)[0]
        grad = torch.randn_like(out)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (x, *ref.parameters()), grad, retain_graph=True))
        lib_both = cuda_ms(lambda: torch.autograd.grad(
            ref(x)[0], (x, *ref.parameters()), grad))
        del out
        b_ms, b_by = k1_bound(T, B, H, xp.element_size(), residuals=True)
        bb_ms, bb_by = k2_bound(T, B, H, xp.element_size())
        print(f"K1-residual T={T} B={B} H={H}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, cuDNN nn.LSTM forward under autograd "
              f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)
        print(f"K2 lstm_bwd T={T} B={B} H={H}: kernel {bms:.3f} ms, plain "
              f"{bplain:.3f} ms, cuDNN nn.LSTM backward {lib_bwd:.3f} ms "
              f"(forward+backward {lib_both:.3f} ms), bound {bb_ms:.3f} ms "
              f"({bb_by})", flush=True)
        key = f"T={T} B={B} H={H}"
        rep_res[key] = dict(max_abs_err=max(err_a, err_c), ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms)
        rep_bwd[key] = dict(max_abs_err=err_g, ms=bms, plain_ms=bplain,
                            bound_ms=bb_ms, bound_by=bb_by,
                            library_ms=lib_bwd)
    return by_shape(rep_res), by_shape(rep_bwd)


def k2_q8_block_max(dys, acts, c_prev, cs, wq, s, dh_last, dc_last, ju=16):
    """A planted fault: plain K2-q8 (nn.lstm.lstm_scan_bwd_q8) with each
    row's scale m taken over one K2-q8 block's own columns (the four gate
    rows of its ju hidden units) instead of over all 4H, the obvious bug
    of a kernel whose blocks each see only their own columns. Returns
    (dgates, dh0, dc0) as lstm_scan_bwd_q8."""
    import torch
    from haloop_tpu_torch.nn import lstm
    T, B, H4 = acts.shape
    H = H4 // 4
    nb = -(-H // ju)
    dh = dh_last.to(acts.dtype).float()
    dc = dc_last.to(acts.dtype).float()
    dgates = torch.empty_like(acts)
    for t in range(T - 1, -1, -1):
        i, f, g, o = acts[t].float().chunk(4, dim=-1)
        tc = torch.tanh(cs[t].float())
        dh = dh + dys[t].float()
        do = dh * tc * o * (1 - o)
        dc = dc + dh * o * (1 - tc * tc)
        d = torch.cat([dc * g * i * (1 - i),
                       dc * c_prev[t].float() * f * (1 - f),
                       dc * i * (1 - g * g), do], dim=-1)
        dgates[t] = d.to(acts.dtype)
        blocks = torch.nn.functional.pad((d * s).view(B, 4, H),
                                         (0, nb * ju - H)).view(B, 4, nb, ju)
        m = blocks.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1e-20)
        deq = (lstm.q8_row(blocks / m) * (m / 127.0)).view(B, 4, nb * ju)
        dh = (deq[..., :H].reshape(B, H4).double() @ wq.double()).float()
        dc = dc * f
    return dgates, dh, dc


def k1_q8_stale_hq(wq, s, xp, h0, c0, units):
    """A planted fault: plain K1-q8 (nn.lstm.lstm_scan_q8) with the gates
    of ``units`` (one persistent block's) computed from the quantized h of
    the step before the right one (h_{t-2}, h0 at t = 1) from the third
    step on, what a block that passes a missing or early grid barrier
    multiplies. Returns ys."""
    import torch
    from haloop_tpu_torch.nn import lstm
    T, B, H4 = xp.shape
    H = H4 // 4
    rows = torch.cat([g * H + units for g in range(4)])
    sdiv = (s / 127.0).float()
    wt = wq.T
    c = c0.float()
    hq = [lstm.q8_row(h0.float())]          # hq of h_{t-1}
    ys = torch.empty((T, B, H), dtype=xp.dtype, device=xp.device)
    for t in range(T):
        acc = lstm.int_matmul(hq[t], wt)
        if t >= 2:
            acc[:, rows] = lstm.int_matmul(hq[t - 1], wt[:, rows])
        i, f, g, o = (xp[t].float() + acc * sdiv).chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[t] = h.to(xp.dtype)
        hq.append(lstm.q8_row(h))
    return ys


def rel_err(got, want):
    """||got - want|| / ||want|| over all elements."""
    return ((got.float() - want.float()).norm() /
            want.float().norm()).item()


def phase_lstm_q8(torch, dev, k1, k1r, k2):
    """K1-q8 (with and without residuals) and K2-q8 against their plain
    versions at LSTM_SHAPES: the route each call took (the persistent
    kernels at the main paths' widths), limits between the readings and
    planted faults (the exact mode's answer; K2-q8's m over a block's own
    columns; one persistent K1-q8 block on a step-old hq), the same bits
    on a second run and as the per-step kernels (the integer sums are
    exact in any order), and times beside the bound. No PyTorch call
    computes an int8 LSTM (library: none); the exact mode's cuDNN times
    of phases 2 and 5 are printed beside, as such."""
    from haloop_tpu_torch.nn import lstm, lstm_cuda
    fwd, res, bwd = {}, {}, {}
    for T, B, H, name, timed in LSTM_SHAPES:
        dtype = getattr(torch, name)
        w, xp, h0, c0 = lstm_inputs(torch, dev, T, B, H, dtype)
        wq, s = lstm.quantize_rows(w)
        route, plan = lstm_plan(torch, dev, "fwd_q8", H, dtype)
        before = dict(lstm_cuda.route_launches)
        out = lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp, h0, c0)
        out_r = lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp, h0, c0, residuals=True)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                if v != before[k]}
        check(took == {f"fwd_q8_{route}": 2},
              f"K1-q8 took {took}, not {route}")
        check(route == "persist" or H not in (1536, 1024, 512) or
              H < lstm_cuda.Q8_FWD_MIN_H,
              f"K1-q8 at the main paths' width {H} did not take the "
              f"persistent kernel")
        check(all(torch.equal(a, b) for a, b in zip(out, out_r)),
              f"K1-q8 with residuals changes ys/h/c at {(T, B, H, name)}")
        step = lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp, h0, c0, residuals=True,
                                          per_step=True)
        as_step = all(torch.equal(a, b) for a, b in zip(out_r, step))
        want = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
        err = max(rel_err(a, b) for a, b in zip(out_r, want))
        faults = {"the exact mode": min(
            rel_err(a, b) for a, b in zip(lstm.lstm_scan(w, xp, h0, c0),
                                          want))}
        if dtype == torch.bfloat16 and H % 16 == 0 and T >= 3:
            # one block's units of the persistent kernel's plan (its route
            # or not)
            units = fault_units(torch, dev, "fwd_q8", H)
            faults[f"units {int(units[0])}..{int(units[-1])} on a step-old "
                   f"hq"] = rel_err(k1_q8_stale_hq(wq, s, xp, h0, c0, units),
                                    want[0])
        same = all(torch.equal(a, b) for a, b in
                   zip(lstm_cuda.lstm_fwd_q8_cuda(wq, s, xp, h0, c0), out))
        max_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(out_r, want))
        grid = (f"grid {plan.blocks} blocks = {plan.clusters} clusters of "
                f"{plan.c}, {plan.u} units a block, {plan.stages}-slot "
                f"ring, {plan.smem} B" if plan else "one launch a step")
        print(f"K1-q8 T={T} B={B} H={H} {name}: route {route} ({grid}); "
              f"launches by route {took}; residual mode the same bits; "
              f"rel err of ys, h, c, acts, cs at most {err:.3e} (max |d| "
              f"{max_err:.3e}; limit {K1Q8_REL}); planted faults "
              + ", ".join(f"{n} {v:.3e}" for n, v in faults.items())
              + f"; the same bits twice: {same}; as the per-step kernels: "
              f"{as_step}", flush=True)
        check(err <= K1Q8_REL and same and as_step,
              f"K1-q8 disagrees with lstm_scan_q8 at {(T, B, H, name)}")
        check(all(v > K1Q8_REL for v in faults.values()),
              f"K1Q8_REL does not catch a planted fault at {(T, B, H)}")

        g = torch.Generator().manual_seed(T + H)
        dys = torch.randn((T, B, H), generator=g).to(dev, torch.bfloat16)
        dh = torch.randn((B, H), generator=g).to(dev) * 0.1
        dc = torch.randn((B, H), generator=g).to(dev) * 0.1
        acts, cs, c0r = want[3], want[4], c0.to(torch.bfloat16)
        c_prev = torch.cat([c0r[None], cs[:-1]])
        bargs = (dys, acts, cs, c0r, wq, s, dh, dc)
        route, plan = lstm_plan(torch, dev, "bwd_q8", H, torch.bfloat16)
        before = dict(lstm_cuda.route_launches)
        got = lstm_cuda.lstm_bwd_q8_cuda(*bargs)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
                if v != before[k]}
        check(took == {f"bwd_q8_{route}": 1},
              f"K2-q8 took {took}, not {route}")
        check(route == "persist" or H not in (1536, 1024, 512),
              f"K2-q8 at the main paths' width {H} did not take the "
              f"persistent kernel")
        as_step = all(torch.equal(a, b) for a, b in zip(
            got, lstm_cuda.lstm_bwd_q8_cuda(*bargs, per_step=True)))
        want_b = lstm.lstm_scan_bwd_q8(dys, acts, c_prev, cs, wq, s, dh, dc)
        errs = {k: rel_err(a, b) for k, a, b in
                zip(("dgates", "dh0", "dc0"), got, want_b)}
        faults = {
            "exact mode": lstm.lstm_scan_bwd(dys, acts, c_prev, cs,
                                             w.to(torch.bfloat16), dh, dc),
            "m over a block's columns": k2_q8_block_max(
                dys, acts, c_prev, cs, wq, s, dh, dc,
                ju=plan.u if plan else 16)}
        read = {n: (rel_err(f[0], want_b[0]), rel_err(f[1], want_b[1]))
                for n, f in faults.items()}
        same = all(torch.equal(a, b) for a, b in
                   zip(lstm_cuda.lstm_bwd_q8_cuda(*bargs), got))
        grid = (f"grid {plan.blocks} blocks = {plan.clusters} clusters of "
                f"{plan.c}, {plan.u} units a block, two grid barriers a "
                f"step, {plan.smem} B" if plan else
                "one launch a step")
        print(f"K2-q8 T={T} B={B} H={H}: route {route} ({grid}); rel err "
              f"dgates {errs['dgates']:.3e} dh0 {errs['dh0']:.3e} dc0 "
              f"{errs['dc0']:.3e} (limits {K2Q8_REL}); planted faults "
              f"(dgates, dh0): "
              + ", ".join(f"{n} {a:.3e} {b:.3e}" for n, (a, b) in
                          read.items())
              + f"; the same bits twice: {same}; as the per-step kernels: "
              f"{as_step}", flush=True)
        check(all(errs[k] <= K2Q8_REL[k] for k in errs) and same and
              as_step,
              f"K2-q8 disagrees with lstm_scan_bwd_q8 at {(T, B, H, name)}")
        check(all(a > K2Q8_REL["dgates"] and b > K2Q8_REL["dh0"]
                  for a, b in read.values()),
              f"K2Q8_REL does not catch a planted fault at {(T, B, H)}")
        if not timed:
            continue
        key = f"T={T} B={B} H={H}"
        fargs = (wq, s, xp, h0, c0)
        for rep, residuals in ((fwd, False), (res, True)):
            ms = cuda_ms(lambda: lstm_cuda.lstm_fwd_q8_cuda(
                *fargs, residuals=residuals))
            plain_ms = cuda_ms(lambda: lstm.lstm_scan_q8(
                *fargs, residuals=residuals), reps=3)
            b_ms, b_by = k1q8_bound(T, B, H, xp.element_size(), residuals)
            exact = (k1r if residuals else k1)
            exact = exact["by_shape"].get(key, exact)
            print(f"K1-q8{'-residual' if residuals else ''} {key}: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, library none "
                  f"(the exact mode: K1 {exact['ms']:.3f} ms, cuDNN "
                  f"nn.LSTM {exact['library_ms']:.3f} ms), bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
            rep[key] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        ms = cuda_ms(lambda: lstm_cuda.lstm_bwd_q8_cuda(*bargs))
        plain_ms = cuda_ms(lambda: lstm.lstm_scan_bwd_q8(
            dys, acts, c_prev, cs, wq, s, dh, dc), reps=3)
        b_ms, b_by = k2q8_bound(T, B, H)
        exact = k2["by_shape"].get(key, k2)
        print(f"K2-q8 {key}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library none (the exact mode: K2 {exact['ms']:.3f} ms, "
              f"cuDNN nn.LSTM backward {exact['library_ms']:.3f} ms), "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        bwd[key] = dict(
            max_abs_err=(got[0].float() - want_b[0].float()).abs().max()
            .item(), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
    return by_shape(fwd), by_shape(res), by_shape(bwd)


def phase_ctc_bwd(torch, dev):
    from haloop_tpu_torch.ops import ctc, ctc_cuda
    args, _ = ctc_inputs(torch, dev)
    log_probs, targets, input_lengths, target_lengths = args
    T, N, C = log_probs.shape
    U = targets.shape[1]
    S = 2 * U + 1
    hist = torch.empty((N, T, S), device=dev)
    loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    g = torch.rand(N, generator=torch.Generator().manual_seed(5)).to(dev) \
        + 0.5
    n0 = ctc_cuda.bwd_launches
    got = ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g)
    torch.cuda.synchronize()
    plan = ctc_cuda.plan(S, C)
    print(f"K4 route: the warp-specialized lattice, "
          f"{ctc_cuda.bwd_launches - n0} launch, plan {plan}", flush=True)
    check(ctc_cuda.bwd_launches == n0 + 1, "K4 did not launch once")
    want = ctc.ctc_grad(*args, hist, loss, g)
    err = (got - want).abs()
    ok = bool((err <= CTC_GRAD_TOL + CTC_GRAD_TOL * want.abs()).all())
    same = all(torch.equal(got, ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g))
               for _ in range(2))
    print(f"K4 ctc_bwd N={N} T={T} C={C} S'={S}: max|ddlogp|="
          f"{err.max().item():.3e} against ctc_grad, within tol rel/abs "
          f"{CTC_GRAD_TOL}: {ok}; empty, repeated and infeasible items "
          f"included; the same bits on two more runs: {same}", flush=True)
    check(bool(torch.isfinite(got).all()) and ok,
          "K4 disagrees with the plain ctc_grad")
    check(same, "K4 gives other bits on another run")
    lattice_faults(torch, "K4", ctc.ctc_grad, (*args, hist, loss, g), want,
                   ctc_faults(ctc, plan))
    ms = cuda_ms(lambda: ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g))
    plain_ms = cuda_ms(lambda: ctc.ctc_grad(*args, hist, loss, g))
    lp = log_probs.clone().requires_grad_(True)
    ref = torch.nn.functional.ctc_loss(lp, targets, input_lengths,
                                       target_lengths, reduction="none")
    lib_ms = cuda_ms(lambda: torch.autograd.grad(ref, lp, g,
                                                 retain_graph=True))
    b_ms, b_by = k4_bound(input_lengths, N, T, S, U, C)
    cyc, mhz = cycles_a_frame(ms, input_lengths, T)
    print(f"K4 ctc_bwd N={N} T={T}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, F.ctc_loss backward {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); {cyc:.0f} cycles a frame of the longest item at "
          f"{mhz:.0f} MHz", flush=True)
    return dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def _counters():
    """kernel name -> (wrapper module, its launch counter)."""
    from haloop_tpu_torch.nn import lstm_cuda
    from haloop_tpu_torch.ops import ctc_cuda, decode_attn_cuda, \
        flash_cuda, fused_ce_cuda, joint_cuda, q8_matmul_cuda, star_cuda
    return {"lstm_fwd": (lstm_cuda, "launches"),
            "lstm_fwd_residual": (lstm_cuda, "residual_launches"),
            "lstm_bwd": (lstm_cuda, "bwd_launches"),
            "lstm_fwd_q8": (lstm_cuda, "q8_launches"),
            "lstm_fwd_q8_residual": (lstm_cuda, "q8_residual_launches"),
            "lstm_bwd_q8": (lstm_cuda, "q8_bwd_launches"),
            "ctc_fwd": (ctc_cuda, "launches"),
            "ctc_fwd_history": (ctc_cuda, "history_launches"),
            "ctc_bwd": (ctc_cuda, "bwd_launches"),
            "joint_lse": (joint_cuda, "launches"),
            "joint_lse_bwd": (joint_cuda, "bwd_launches"),
            "star_fwd": (star_cuda, "launches"),
            "star_fwd_history": (star_cuda, "history_launches"),
            "star_bwd": (star_cuda, "bwd_launches"),
            "flash_fwd": (flash_cuda, "launches"),
            "flash_fwd_lse": (flash_cuda, "lse_launches"),
            "flash_packed": (flash_cuda, "packed_launches"),
            "flash_bwd_dq": (flash_cuda, "bwd_dq_launches"),
            "flash_bwd_dkv": (flash_cuda, "bwd_dkv_launches"),
            "fused_ce": (fused_ce_cuda, "launches"),
            "decode_attn": (decode_attn_cuda, "launches"),
            "decode_attn_split": (decode_attn_cuda, "split_launches"),
            "q8_matmul": (q8_matmul_cuda, "launches")}


def counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def reset_counts():
    from haloop_tpu_torch.nn import lstm_cuda
    from haloop_tpu_torch.ops import fused_ce_cuda
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    fused_ce_cuda.wg_launches = 0
    for key in lstm_cuda.route_launches:
        lstm_cuda.route_launches[key] = 0


def check_persistent(path, also=()):
    """Every K1 and K2 call (and K1-q8 and K2-q8) since reset_counts took
    the persistent kernels (the main paths' widths, 1536, 1024 and 512, in
    bf16; fp32 on persist_f32), or a route named in ``also``."""
    from haloop_tpu_torch.nn import lstm_cuda
    taken = {k: v for k, v in lstm_cuda.route_launches.items() if v}
    print(f"{path}: K1/K2 launches by route {taken}", flush=True)
    check(taken and all(k.endswith(("_persist", "_persist_f32")) or k in also
                        for k in taken),
          f"{path}: K1/K2 did not all take the persistent kernels: {taken}")


def check_counts(path, launches, expect):
    """Exactly ``expect`` launches of the named kernels, none of the
    others."""
    want = {name: expect.get(name, 0) for name in launches}
    check(launches == want, f"{path}: launches {launches}, expected {want}")


def tsv_rows(text, tags=("hyp0", "ref", "ali0", "stat0")):
    rows = [line.split("\t") for line in text.splitlines()
            if line.count("\t") >= 3]
    for tag in ("hyp0", "ref", "ali0", "stat0"):
        n = sum(1 for r in rows if r[2] == tag)
        want = 16 if tag in tags else 0
        check(n == want, f"expected {want} {tag} rows, got {n}")
    check(all(r[3].startswith("log_prob=") for r in rows
              if r[2] == "stat0"), "malformed stat rows")
    return rows


def eval_batch(system):
    """One batch of 48 twelve-second utterances (1200-1216 frames, 81-87
    labels), bucketed to 1536 frames -> T'=385, on the card."""
    from haloop_tpu_torch.data import Subset
    from haloop_tpu_torch.dataloader import Collator, DataLoader
    from haloop_tpu_torch.sinusoids import SyntheticAlignments
    ds = Subset(SyntheticAlignments(examples_per_bin=5000, max=2000),
                [119 + 200 * k for k in range(48)])
    loader = DataLoader(ds, Collator(system.vocab), batch_size=48)
    _, *batch = next(iter(loader))
    return loader, system.to_device(*batch)


def phase_slice(torch, dev, tmp, card):
    from haloop_tpu_torch import loop, params
    from haloop_tpu_torch.checkpoint import save_checkpoint
    from haloop_tpu_torch.init import Initializer

    # 1. a random lstm:512 checkpoint written with the port's Initializer
    init_args = loop.make_parser().parse_args(
        ["--arch", "lstm:512", "--vocab", "512", "--seed", "0",
         "--device", "cpu"])
    (spec, p), _, _ = Initializer()(init_args)
    ckpt = Path(tmp) / "lstm512.pt"
    save_checkpoint(ckpt, {k: params.to_numpy_tree(v) for k, v in p.items()})
    del p

    # 2. the slice through its entry point, counts reset just before
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        system = loop.main(["--init", str(ckpt), "--arch", "lstm:512",
                            "--vocab", "512", "--test", "head:sinusoids0",
                            "--exp", str(Path(tmp) / "exp")])
    torch.cuda.synchronize()
    launches = counts()
    print(f"serving slice hac --test head:sinusoids0: launches {launches}",
          flush=True)
    check(launches["lstm_fwd"] > 0 and launches["ctc_fwd"] > 0,
          f"the serving slice did not run through K1 and K3: {launches}")
    check_counts("serving slice", launches,
                 {k: launches[k] for k in ("lstm_fwd", "ctc_fwd")})
    check_persistent("serving slice")

    # 3. four TSV rows per utterance
    rows = tsv_rows(out.getvalue())
    print(f"slice TSV rows: {len(rows)} (16 utterances x hyp/ref/ali/stat)",
          flush=True)

    # 4. one eval batch of 48 full-width (12 s) utterances
    loader, batch = eval_batch(system)
    with contextlib.redirect_stdout(io.StringIO()):
        loss = system.evaluate(0, loader, tag="smoke")
    check(loss == loss and abs(loss) < 1e6, f"eval loss {loss}")
    print(f"eval batch: inputs {tuple(batch[0].shape)}, targets "
          f"{tuple(batch[1].shape)}; loss {loss:.6f}", flush=True)

    with torch.inference_mode():
        k_loss = system._forward_impl(*batch, train=False)[0].item()
        with plain_kernels():
            p_loss = system._forward_impl(*batch, train=False)[0].item()
        rel = abs(k_loss - p_loss) / abs(p_loss)
        print(f"slice loss: kernel path {k_loss:.6f}, plain path "
              f"{p_loss:.6f}, rel diff {rel:.3e} (tol {SLICE_REL_TOL})",
              flush=True)
        check(rel <= SLICE_REL_TOL, "kernel-path loss differs from plain")
        check(abs(k_loss - loss) <= SLICE_REL_TOL * abs(loss),
              "evaluate's loss differs from the forward's")

        def step():
            _, feats, feat_lens, _ = system._forward_impl(*batch,
                                                          train=False)
            out = system._decode_impl(feats, feat_lens, train=False)
            return [t.cpu() for t in out]
        sec, _ = host_ms(torch, step)
        print(f"slice eval forward+decode, 48 x 12 s utterances: "
              f"{48 / sec * 1e3:.2f} utt/s ({sec:.3f} ms per batch, median "
              f"of 5) on {card}", flush=True)
        profile_step(torch, step, "one serving batch")
    return launches


@contextlib.contextmanager
def plain_kernels():
    """The kernels' wrappers replaced by their plain versions on the same
    (CUDA) tensors, inside the same autograd Functions."""
    from haloop_tpu_torch.nn import lstm, lstm_cuda
    from haloop_tpu_torch.ops import ctc, ctc_cuda, decode_attn, \
        decode_attn_cuda, flash, flash_cuda, fused_ce, fused_ce_cuda, joint, \
        joint_cuda, q8_matmul, q8_matmul_cuda, star, star_cuda
    import torch

    def lstm_bwd(dys, acts, cs, c0, w, dh, dc):
        c_prev = torch.cat([c0[None], cs[:-1]])
        return lstm.lstm_scan_bwd(dys, acts, c_prev, cs, w, dh, dc)

    def lstm_bwd_q8(dys, acts, cs, c0, wq, s, dh, dc):
        c_prev = torch.cat([c0[None], cs[:-1]])
        return lstm.lstm_scan_bwd_q8(dys, acts, c_prev, cs, wq, s, dh, dc)

    def ctc_fwd(log_probs, targets, input_lengths, target_lengths,
                history=None):
        loss, hist = ctc.ctc_forward_history(log_probs, targets,
                                             input_lengths, target_lengths)
        if history is not None:
            history.copy_(hist)
        return loss

    def star_fwd(star_lp, star_targets, input_lengths, target_lengths,
                 penalty, history=None):
        loss, hist = star.star_forward_history(
            star_lp, star_targets, input_lengths, target_lengths, penalty)
        if history is not None:
            history.copy_(hist)
        return loss

    swaps = [(lstm_cuda, "lstm_fwd_cuda", lstm.lstm_scan),
             (lstm_cuda, "lstm_bwd_cuda", lstm_bwd),
             (lstm_cuda, "lstm_fwd_q8_cuda", lstm.lstm_scan_q8),
             (lstm_cuda, "lstm_bwd_q8_cuda", lstm_bwd_q8),
             (ctc_cuda, "ctc_fwd_cuda", ctc_fwd),
             (ctc_cuda, "ctc_bwd_cuda", ctc.ctc_grad),
             (joint_cuda, "lse_fwd_cuda", joint.pairwise_lse),
             (joint_cuda, "lse_bwd_cuda", joint.pairwise_lse_grad),
             (star_cuda, "star_fwd_cuda", star_fwd),
             (star_cuda, "star_bwd_cuda", star.star_grad),
             (flash_cuda, "flash_fwd_cuda", flash._reference),
             (flash_cuda, "flash_packed_cuda", flash._packed_reference),
             (flash_cuda, "flash_bwd_cuda", flash._backward_reference),
             (fused_ce_cuda, "ce_fwd_cuda", fused_ce.ce_nll_lse),
             (decode_attn_cuda, "decode_attn_cuda",
              decode_attn.decode_attend),
             (decode_attn_cuda, "decode_attn_split_cuda",
              decode_attn.decode_attend),
             (q8_matmul_cuda, "q8_matmul_cuda", q8_matmul.q8_matmul)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), kernel in zip(swaps, saved):
            setattr(mod, name, kernel)


def loss_and_enc_norm(torch, system, batch):
    """Loss and the encoder's grad norm with dropout off (train=False,
    under autograd)."""
    from haloop_tpu_torch.optim import global_norm
    loss = system._forward_impl(*batch, train=False)[0]
    grads = torch.autograd.grad(loss, [leaf for _, leaf in system.leaves])
    enc = [g for (path, _), g in zip(system.leaves, grads)
           if path[0] == "encoder"]
    return loss.item(), global_norm(enc).item()


def phase_train(torch, dev, tmp, card):
    from haloop_tpu_torch import loop

    # 1. the training slice through its entry point, counts reset first
    exp = Path(tmp) / "train"
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        system = loop.main(["--arch", "lstm:512", "--vocab", "512",
                            "--train", "head:sinusoids0", "--eval",
                            "head:sinusoids0", "--num-epochs", "1",
                            "--batch-size", "8", "--save", "last+best",
                            "--exp", str(exp), "--log-interval", "1"])
    torch.cuda.synchronize()
    launches = counts()
    print(f"training slice hac --train head:sinusoids0 (2 steps, eval, "
          f"save) in {time.perf_counter() - t0:.1f} s: launches {launches}",
          flush=True)
    for name in ("lstm_fwd_residual", "lstm_bwd", "ctc_fwd_history",
                 "ctc_bwd"):
        check(launches[name] > 0,
              f"the training slice did not launch {name}: {launches}")
    check_persistent("training slice")
    saved = [line for line in out.getvalue().splitlines()
             if line.startswith("saving checkpoint to")]
    check((exp / "last.pt").exists() and (exp / "best.pt").exists() and
          len(saved) == 2, f"last.pt and best.pt not written: {saved}")
    print("\n".join(saved), flush=True)
    del system

    # 2. --init last.pt --test: the TSV rows
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loop.main(["--init", str(exp / "last.pt"), "--arch", "lstm:512",
                   "--vocab", "512", "--test", "head:sinusoids0", "--exp",
                   str(exp)])
    rows = tsv_rows(out.getvalue())
    print(f"--init last.pt --test: {len(rows)} TSV rows", flush=True)

    # 3. one train step at batch 48 x 12 s
    system = make_system(torch, dev, "--arch", "lstm:512")
    _, batch = eval_batch(system)
    reset_counts()
    check_against_plain(torch, system, batch, "train step")

    def step():             # ends in the host read of loss and norm
        check(not system.train_step(*batch)[2], "non-finite train step")
    sec, times = host_ms(torch, step)
    print(f"train step (forward, backward, clip, AdamW), 48 x 12 s "
          f"utterances: {48 / sec * 1e3:.2f} utt/s ({sec:.3f} ms per step, "
          f"median of 5; {[round(t, 3) for t in times]}) peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}",
          flush=True)
    profile_step(torch, step)
    del system

    # 4. lstm-tiny's loss falls below a third in 30 steps
    from haloop_tpu_torch.data import make_dataset
    from haloop_tpu_torch.dataloader import Collator
    system = make_system(torch, dev, "--arch", "lstm-tiny:512", "--lr", "3e-3",
                         "--lr_schedule", "const", "--clip-grad-norm", "10")
    ds = make_dataset("head:sinusoids0")
    b = system.to_device(*Collator(system.vocab)([ds[i]
                                                  for i in range(8)])[1:])
    losses = [system.train_step(*b)[0] for _ in range(30)]
    print(f"lstm-tiny:512, batch 8, lr 3e-3: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} in 30 steps", flush=True)
    check(losses[-1] < losses[0] / 3, "lstm-tiny's loss did not fall")
    return launches


def close(got, want, tol):
    """(all within atol + rtol |want|, max |got - want|)"""
    err = (got - want).abs()
    return bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all()), \
        err.max().item()


def joint_inputs(torch, dev, N, T, U1, V, seed, peaks=None):
    """f (N, T, V), g (N, U1, V) of N(0, 9) and dlse (N, T, U1) with the
    frames past each item's length at 0 (as the transducer loss gives),
    from a seed. ``peaks``: f, g N(0, 1) with "disjoint" peaks, f at +100
    on frame 7's v = 3 and g at +100 on row 2's v = V - 5 in every item
    (the factored form's sum underflows at the cells (n, 7, 2) only), or
    "every" row of f at +200 on v = 0 and of g on v = 1 (every cell)."""
    gen = torch.Generator().manual_seed(seed)
    scale = 3.0 if peaks is None else 1.0
    f = torch.randn((N, T, V), generator=gen) * scale
    g = torch.randn((N, U1, V), generator=gen) * scale
    if peaks == "disjoint":
        f[:, 7, 3], g[:, 2, V - 5] = 100.0, 100.0
    elif peaks == "every":
        f[..., 0], g[..., 1] = 200.0, 200.0
    lens = torch.randint(T // 2, T + 1, (N,), generator=gen)
    dlse = torch.randn((N, T, U1), generator=gen)
    dlse[torch.arange(T)[None, :] >= lens[:, None]] = 0.0
    return f.to(dev), g.to(dev), dlse.to(dev)


def joint_faults(torch, joint, f, g, want):
    """K9a's planted faults, emulated from the plain factored
    pairwise_lse on an input with marked cells: the fix-up skipped (mf +
    mg + log s at every cell), and one stage of V left out (columns 64 ..
    127, the kernel's second stage, at -inf in f). -> {label: max |fault -
    want|}; each must read beyond JOINT_TOL."""
    f, g = f.float(), g.float()
    mf, mg, s = joint._factored(f, g)
    left_out = f.clone()
    left_out[..., 64:128] = -math.inf
    out = {}
    for label, fault in (
            ("the fix-up skipped", mf[..., None] + mg[:, None] +
             torch.log(s)),
            ("columns 64..127 left out",
             joint.pairwise_lse(left_out, g)[0])):
        ok, err = close(fault, want, JOINT_TOL)
        print(f"K9a planted fault, {label}: max|d| {err:.3e}, beyond "
              f"{JOINT_TOL}: {not ok}", flush=True)
        check(not ok, f"K9a's planted fault ({label}) reads within "
                      f"JOINT_TOL")
        out[label] = err
    return out


def joint_bwd_faults(torch, joint, f, g, lse, dlse, mf, mg, want):
    """K9b's planted faults, emulated from the plain factored
    pairwise_lse_grad on an input with marked cells: the marked cells'
    exact terms left out (the factored products alone), and frames 32..63
    (the kernel's second group of frames) left out of dg. -> {label: max
    |d| of df or dg}; each must read beyond JOINT_TOL (df) or JOINT_DG_TOL
    (dg)."""
    bare = joint._grad_factored(f.float(), g.float(), lse, dlse, mf, mg)[:2]
    cut = dlse.clone()
    cut[:, 32:64] = 0.0
    group = (want[0], joint.pairwise_lse_grad(f, g, lse, cut, mf, mg)[1])
    out = {}
    for label, (df, dg) in (("the marked cells' exact terms left out", bare),
                            ("frames 32..63 left out of dg", group)):
        ok_f, err_f = close(df, want[0], JOINT_TOL)
        ok_g, err_g = close(dg, want[1], JOINT_DG_TOL)
        print(f"K9b planted fault, {label}: max|ddf| {err_f:.3e}, max|ddg| "
              f"{err_g:.3e}, beyond JOINT_TOL / JOINT_DG_TOL: "
              f"{not (ok_f and ok_g)}", flush=True)
        check(not (ok_f and ok_g), f"K9b's planted fault ({label}) reads "
                                   f"within JOINT_TOL / JOINT_DG_TOL")
        out[label] = max(err_f, err_g)
    return out


def joint_bwd_long_faults(joint, f, g, lse, dlse, mf, mg, exact, limits):
    """K9b's planted fault on a long target, emulated from the plain
    factored pairwise_lse_grad: rows 32..63 of U+1 (the kernel's second
    chunk, one group of a df block's frames) left out of df. -> {label: max
    |d| / limit}; it must read beyond ``k9b_exact``'s limit."""
    cut = dlse.clone()
    cut[:, :, 32:64] = 0.0
    df = joint.pairwise_lse_grad(f, g, lse, cut, mf, mg)[0]
    label = "rows 32..63 of U+1 left out of df"
    ok, ratio = within_limit(df, exact[0], limits[0])
    print(f"K9b planted fault, {label}: max |d| / limit {ratio:.3e}, beyond "
          f"the fp64 bound: {not ok}", flush=True)
    check(not ok, f"K9b's planted fault ({label}) reads within the fp64 "
                  f"bound")
    return {label: ratio}


def phase_joint(torch, dev):
    """K9a/K9b against pairwise_lse / pairwise_lse_grad and K9a against the
    materialized joint: at rnn-transducer:lstm:512's joint (N=16, T'=301,
    U+1=25, V=512), with a 16k vocabulary (JOINT_V16K), on the disjoint
    peaks (K9a's fix-up and K9b's exact terms taken), with every cell
    marked, and with 2,049 target rows (JOINT_U2049); one launch a call,
    the same bits twice, K9a's row maxima exact, each kernel's planted
    faults; times (every cell marked: the fix-up's cost, kept out of the
    main row)."""
    from haloop_tpu_torch.ops import joint, joint_cuda
    cases = (("V=512", (16, 301, 25, 512), None, 9),
             (f"V={JOINT_V16K[3]}", JOINT_V16K, None, 10),
             ("disjoint peaks", (16, 301, 25, 512), "disjoint", 11),
             ("every cell marked", (16, 301, 25, 512), "every", 12),
             (f"U+1={JOINT_U2049[2]}", JOINT_U2049, None, 13))
    fwd, bwd = {}, {}
    for label, (N, T, U1, V), peaks, seed in cases:
        f, g, dlse = joint_inputs(torch, dev, N, T, U1, V, seed, peaks)
        n0, b0 = joint_cuda.launches, joint_cuda.bwd_launches
        lse, mf, mg = joint_cuda.lse_fwd_cuda(f, g)
        lse2 = joint_cuda.lse_fwd_cuda(f, g)[0]
        df, dg = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
        torch.cuda.synchronize()
        once = (joint_cuda.launches, joint_cuda.bwd_launches) == \
            (n0 + 2, b0 + 1)
        want = joint.pairwise_lse(f, g)[0]
        ok, err = close(lse, want, JOINT_TOL)
        ok_ref, err_ref = close(lse, joint.pairwise_lse_reference(f, g),
                                JOINT_TOL)
        maxima = torch.equal(mf, f.amax(-1)) and torch.equal(mg, g.amax(-1))
        marked = int(joint.marks(f, g).sum())
        bmarked = int(joint.grad_marks(lse, dlse, mf, mg).sum())
        grad_e = joint.pairwise_lse_grad(f, g, lse, dlse, mf, mg)
        tol_f, tol_g = k9b_tols(T, U1)
        ok_f, err_f = close(df, grad_e[0], tol_f or JOINT_TOL)
        ok_g, err_g = close(dg, grad_e[1], tol_g or JOINT_DG_TOL)
        # a sum past K9B_TOL_ROWS rows: read here, held by the fp64 bound
        ok_f, ok_g = ok_f or tol_f is None, ok_g or tol_g is None
        exact = {}
        if peaks is None:       # no marked cell: the fp64 bound
            grad_x, limits, marked_x = k9b_exact(joint, f, g, lse, dlse, mf,
                                                 mg)
            exact = dict(zip(("df", "dg"), (
                within_limit(d, w, lim)
                for d, w, lim in zip((df, dg), grad_x, limits))))
            plain_x = [within_limit(d, w, lim)[1]
                       for d, w, lim in zip(grad_e, grad_x, limits)]
            print(f"K9b {label} against the fp64 factored form: max |d| / "
                  f"limit, df {exact['df'][1]:.3e}, dg {exact['dg'][1]:.3e} "
                  f"((n + 64) 2^-24 sum|p|, n = {U1} and {T} rows); the "
                  f"fp32 plain's {plain_x[0]:.3e}, {plain_x[1]:.3e}",
                  flush=True)
            check(marked_x == 0 and exact["df"][0] and exact["dg"][0],
                  f"K9b disagrees with the fp64 factored form ({label})")
            if U1 > K9B_TOL_ROWS:
                exact["faults"] = joint_bwd_long_faults(
                    joint, f, g, lse, dlse, mf, mg, grad_x, limits)
            del grad_x, limits
        padded = ~dlse.any(dim=2)                  # (N, T) rows past a length
        df2, dg2 = joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)
        same = torch.equal(lse, lse2) and torch.equal(df, df2) and \
            torch.equal(dg, dg2)
        plan = joint_cuda.plan(N, T, U1, V)
        bplan = joint_cuda.bwd_plan(N, T, U1, V,
                                    joint_cuda.kernels.multiprocessors(dev))
        print(f"K9a/K9b joint {label} N={N} T={T} U+1={U1} V={V}, K9a plan "
              f"{tuple(plan)}, K9b bwd_plan {tuple(bplan)}: {marked} cells "
              f"K9a recomputes, {bmarked} K9b takes exactly; "
              f"max|dlse|={err:.3e} (materialized joint {err_ref:.3e}; tol "
              f"{JOINT_TOL}); row maxima exact: {maxima}; K9b "
              f"max|ddf|={err_f:.3e} max|ddg|={err_g:.3e} (tol {tol_f}, "
              f"dg {tol_g}; None: the fp64 bound alone); one launch a call: "
              f"{once}; the same "
              f"bits twice (lse, df, dg): {same}", flush=True)
        check(ok and ok_ref, f"K9a disagrees with the plain pairwise_lse "
                             f"({label})")
        check(maxima, f"K9a's row maxima are not f's and g's ({label})")
        check(ok_f and ok_g, f"K9b disagrees with the plain "
                             f"pairwise_lse_grad ({label})")
        check(not df[padded].any(), "K9b wrote df on frames with dlse = 0")
        check(once, f"K9a or K9b did not launch once a call ({label})")
        check(same, f"K9a or K9b gives other bits on another run ({label})")
        check((marked > 0) == (peaks is not None) and
              (bmarked > 0) == (peaks is not None),
              f"the marked cells of {label}: {marked}, {bmarked}")
        report = dict(max_abs_err=err, ms=cuda_ms(
            lambda: joint_cuda.lse_fwd_cuda(f, g)), marked=marked,
                      plan=list(plan))
        report["bound_ms"], report["bound_by"] = k9a_bound(N, T, U1, V)
        live = int((dlse != 0).sum())              # the cells K9b must weigh
        back = dict(max_abs_err=max(err_f, err_g), ms=cuda_ms(
            lambda: joint_cuda.lse_bwd_cuda(f, g, lse, dlse, mf, mg)),
                    marked=bmarked, plan=list(bplan))
        if exact:
            back["fp64_err_over_limit"] = max(exact["df"][1], exact["dg"][1])
        if "faults" in exact:
            back["planted_faults"] = exact["faults"]
        back["bound_ms"], back["bound_by"] = k9b_bound(N, T, U1, V, live)
        if peaks == "disjoint":
            report["planted_faults"] = joint_faults(torch, joint, f, g, want)
            back["planted_faults"] = joint_bwd_faults(
                torch, joint, f, g, lse, dlse, mf, mg, grad_e)
        if peaks is None:
            report["plain_ms"] = cuda_ms(lambda: joint.pairwise_lse(f, g))
            report["library_ms"] = cuda_ms(
                lambda: torch.logsumexp(f[:, :, None] + g[:, None], -1))
            back["plain_ms"] = cuda_ms(lambda: joint.pairwise_lse_grad(
                f, g, lse, dlse, mf, mg))
            print(f"K9a joint_lse {label}: kernel {report['ms']:.4f} ms, plain "
                  f"{report['plain_ms']:.4f} ms, torch.logsumexp of the "
                  f"materialized joint {report['library_ms']:.4f} ms, bound "
                  f"{report['bound_ms']:.4f} ms ({report['bound_by']})",
                  flush=True)
        print(f"K9a joint_lse {label}: kernel {report['ms']:.4f} ms; K9b "
              f"joint_lse_bwd: kernel {back['ms']:.4f} ms, plain "
              f"{back.get('plain_ms', 'not timed')} ms, bound "
              f"{back['bound_ms']:.4f} ms ({back['bound_by']})", flush=True)
        fwd[label], bwd[label] = report, back
        del f, g, dlse, lse, lse2, mf, mg, df, dg, df2, dg2, want, grad_e
        torch.cuda.empty_cache()

    # the main row, rnn-transducer:lstm:512's joint; the rest by shape
    reports = {"fwd": dict(fwd.pop("V=512"), by_shape=fwd)}
    N, T, U1, V = 16, 301, 25, 512
    f, g, dlse = joint_inputs(torch, dev, N, T, U1, V, 9)
    main = bwd.pop("V=512")
    fr, gr = f.clone().requires_grad_(True), g.clone().requires_grad_(True)
    out = torch.logsumexp(fr[:, :, None] + gr[:, None], -1)
    main["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out, (fr, gr), dlse, retain_graph=True))
    del out
    print(f"K9b joint_lse_bwd: kernel {main['ms']:.4f} ms, plain "
          f"{main['plain_ms']:.4f} ms, the materialized joint's logsumexp "
          f"backward {main['library_ms']:.3f} ms, bound "
          f"{main['bound_ms']:.4f} ms ({main['bound_by']}); by shape "
          f"{bwd}", flush=True)
    reports["bwd"] = dict(main, by_shape=bwd)
    return reports


def star_inputs(torch, dev):
    """lstm:512 --star-penalty's lattice: raw log-probs (T'=385, N=48,
    V=512), U=96; an empty target, repeated labels, an infeasible item
    and a full-length one. -> (star log-probs (T, N, 2V), star targets
    (N, 2U+1), input and target lengths, raw log-probs, targets, the
    feasible items)."""
    from haloop_tpu_torch.ops import star
    T, N, V, U = 385, 48, 512, 96
    g = torch.Generator().manual_seed(8)
    log_probs = torch.log_softmax(torch.randn((T, N, V), generator=g) * 2,
                                  -1)
    targets = torch.randint(1, V, (N, U), generator=g)
    input_lengths = torch.randint(200, T + 1, (N,), generator=g)
    target_lengths = torch.randint(1, U + 1, (N,), generator=g)
    target_lengths[0] = 0                      # empty target
    targets[1] = 7                             # repeated labels
    target_lengths[1] = U
    input_lengths[2], target_lengths[2] = 10, U  # infeasible
    input_lengths[3], target_lengths[3] = T, U   # full length
    feasible = torch.ones(N, dtype=torch.bool)
    feasible[2] = False
    log_probs, targets = log_probs.to(dev), targets.to(dev)
    star_lp, star_targets = star.intersperse_stars(log_probs, targets)
    return (star_lp, star_targets, input_lengths.to(dev),
            target_lengths.to(dev), log_probs, targets, feasible.to(dev))


def phase_star(torch, dev):
    """K8a (with and without its history) against star_forward_history
    and, on the feasible items, against the plain star_ctc_forward_score;
    K8b against star_grad on K8a's history."""
    from haloop_tpu_torch.ops import star, star_cuda
    star_lp, star_targets, il, tl, log_probs, targets, ok = star_inputs(
        torch, dev)
    T, N, C2 = star_lp.shape
    U = (star_targets.shape[1] - 1) // 2
    S = 4 * U + 3
    args = (star_lp, star_targets, il, tl)
    fplan = star_cuda.fwd_plan(S, C2)
    loss = star_cuda.star_fwd_cuda(*args, STAR_PENALTY)
    hist = torch.empty((N, T, S), device=dev)
    loss_h = star_cuda.star_fwd_cuda(*args, STAR_PENALTY, history=hist)
    hist2 = torch.empty_like(hist)
    loss_h2 = star_cuda.star_fwd_cuda(*args, STAR_PENALTY, history=hist2)
    torch.cuda.synchronize()
    loss_e, hist_e = star.star_forward_history(*args, STAR_PENALTY)
    ref = star.star_ctc_forward_score(log_probs, targets, il, tl,
                                      STAR_PENALTY)
    ok_l, err = close(loss, loss_e, STAR_TOL)
    ok_h, err_h = close(hist, hist_e, STAR_HIST_TOL)
    rel = ((loss - ref).abs() / ref.abs())[ok].max().item()
    same = torch.equal(loss_h, loss_h2) and torch.equal(hist, hist2)
    print(f"K8a star_fwd N={N} T={T} 2V={C2} S={S} penalty {STAR_PENALTY}, "
          f"plan {fplan}: max|dloss|={err:.3e} max|dhist|={err_h:.3e} "
          f"against star_forward_history (tol {STAR_TOL}, history "
          f"{STAR_HIST_TOL}); max rel|dloss|={rel:.3e} against "
          f"star_ctc_forward_score on feasible items (tol {CTC_REL_TOL}); "
          f"infeasible loss {loss[~ok].tolist()}; the same bits twice: "
          f"{same}", flush=True)
    check(torch.equal(loss, loss_h) and bool(torch.isfinite(hist).all()),
          "K8a with the alpha history differs from K8a without")
    check(ok_l and ok_h, "K8a disagrees with star_forward_history")
    check(rel <= CTC_REL_TOL, "K8a disagrees with star_ctc_forward_score")
    check(bool((loss[~ok] >= 1e8).all()), "K8a infeasible loss not large")
    check(same, "K8a gives other bits on another run")
    fwd_faults = star_fwd_faults(torch, star, fplan, args, loss_e, hist_e)

    gvec = torch.rand(N, generator=torch.Generator().manual_seed(5)).to(dev) \
        + 0.5
    bargs = (*args, hist, loss, gvec, STAR_PENALTY)
    n0 = star_cuda.bwd_launches
    got = star_cuda.star_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    plan = star_cuda.plan(S, C2)
    print(f"K8b route: the warp-specialized lattice, "
          f"{star_cuda.bwd_launches - n0} launch, plan {plan}", flush=True)
    check(star_cuda.bwd_launches == n0 + 1, "K8b did not launch once")
    want = star.star_grad(*bargs)
    gerr = (got - want).abs()
    ok_g = bool((gerr <= CTC_GRAD_TOL + CTC_GRAD_TOL * want.abs()).all())
    same = all(torch.equal(got, star_cuda.star_bwd_cuda(*bargs))
               for _ in range(2))
    print(f"K8b star_bwd: max|ddlp|={gerr.max().item():.3e} against star_grad"
          f", within tol rel/abs {CTC_GRAD_TOL}: {ok_g}; empty, repeated and "
          f"infeasible items included; the same bits on two more runs: "
          f"{same}", flush=True)
    check(bool(torch.isfinite(got).all()) and ok_g,
          "K8b disagrees with the plain star_grad")
    check(same, "K8b gives other bits on another run")
    lattice_faults(torch, "K8b", star.star_grad, bargs, want,
                   star_faults(star, plan))
    # on the CPU, where the plain version's scatter sums in one order
    host = tuple(a.cpu() if torch.is_tensor(a) else a for a in bargs)
    exact = torch.equal(star_grad_without_first_back_edges(star, host),
                        star.star_grad(*host))
    print(f"K8b leaves out the masked back edge into a lane's first state: "
          f"star_grad without it gives the same bits (on the CPU): {exact}",
          flush=True)
    check(exact, "star_grad reads the masked back edge into a lane's first "
                 "state, which K8b leaves out")

    cells = lattice_cells(il, S, T)
    small = 4 * (N * (2 * U + 1) + 2 * N + N)      # targets, lengths, loss
    reports = {}
    plain_ms = cuda_ms(lambda: star.star_forward_history(*args, STAR_PENALTY))
    for history in (False, True):
        h = hist if history else None
        ms = cuda_ms(lambda: star_cuda.star_fwd_cuda(*args, STAR_PENALTY,
                                                     history=h))
        b_ms, b_by = bound(4 * cells + small +
                           (4 * N * T * S if history else 0), 0,
                           K8A_ELEM * cells)
        cyc, mhz = cycles_a_frame(ms, il, T)
        print(f"K8a star_fwd history={history}: kernel {ms:.3f} ms, plain "
              f"(star_forward_history) {plain_ms:.3f} ms, no library call, "
              f"bound {b_ms:.4f} ms ({b_by}); {cyc:.0f} cycles a frame of "
              f"the longest item at {mhz:.0f} MHz", flush=True)
        reports[history] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                plan=list(fplan), planted_faults=fwd_faults)
    reports[True]["by_shape"] = star_long_fwd(torch, dev)
    ms = cuda_ms(lambda: star_cuda.star_bwd_cuda(*bargs))
    b_plain = cuda_ms(lambda: star.star_grad(*bargs))
    b_ms, b_by = bound(4 * (2 * cells + T * N * C2 + N) + small, 0,
                       K8B_ELEM * cells)
    cyc, mhz = cycles_a_frame(ms, il, T)
    print(f"K8b star_bwd: kernel {ms:.3f} ms, plain {b_plain:.3f} ms, no "
          f"library call, bound {b_ms:.4f} ms ({b_by}); {cyc:.0f} cycles a "
          f"frame of the longest item at {mhz:.0f} MHz", flush=True)
    reports["bwd"] = dict(max_abs_err=gerr.max().item(), ms=ms,
                          plain_ms=b_plain, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None)
    return reports


def star_long_fwd(torch, dev):
    """K8a with its history at STAR_LONG's lattices against
    star_forward_history, the same bits twice; times beside the plain
    version and the bound. -> reports by shape."""
    from haloop_tpu_torch.ops import star, star_cuda
    out = {}
    for T, N, V, U, seed in STAR_LONG:
        raw, targets, il, tl = long_lattice_inputs(torch, dev, T, N, V, U,
                                                   seed)
        args = (*star.intersperse_stars(raw, targets), il, tl)
        S = 4 * U + 3
        hist, hist2 = (torch.empty((N, T, S), device=dev) for _ in range(2))
        loss = star_cuda.star_fwd_cuda(*args, STAR_PENALTY, history=hist)
        loss2 = star_cuda.star_fwd_cuda(*args, STAR_PENALTY, history=hist2)
        loss_e, hist_e = star.star_forward_history(*args, STAR_PENALTY)
        ok_l, err = close(loss, loss_e, STAR_TOL)
        ok_h, err_h = close(hist, hist_e, STAR_HIST_TOL)
        same = torch.equal(loss, loss2) and torch.equal(hist, hist2)
        check(ok_l and ok_h and same, f"K8a at S = {S} disagrees with "
                                      f"star_forward_history, or its bits "
                                      f"differ on another run")
        ms = cuda_ms(lambda: star_cuda.star_fwd_cuda(
            *args, STAR_PENALTY, history=hist))
        plain_ms = cuda_ms(lambda: star.star_forward_history(*args,
                                                             STAR_PENALTY))
        cells = lattice_cells(il, S, T)
        b_ms, b_by = bound(4 * (cells + N * (2 * U + 1) + 3 * N + N * T * S),
                           0, K8A_ELEM * cells)
        cyc, _ = cycles_a_frame(ms, il, T)
        plan = star_cuda.fwd_plan(S, 2 * V)
        print(f"K8a star_fwd with history at N={N} T={T} S={S}, plan "
              f"{tuple(plan)}: max|dloss| {err:.3e}, max|dhist| {err_h:.3e}, "
              f"the same bits twice; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); {cyc:.0f} "
              f"cycles a frame", flush=True)
        out[f"S={S} (T={T}, N={N})"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, plan=list(plan))
    return out


def long_lattice_inputs(torch, dev, T, N, V, U, seed):
    """Raw log-probs (T, N, V) and targets for a long lattice: item 0
    uses every frame and label, 1 has an empty target, the rest random
    lengths (frames past len)."""
    g = torch.Generator().manual_seed(seed)
    log_probs = torch.log_softmax(torch.randn((T, N, V), generator=g) * 2,
                                  -1)
    targets = torch.randint(1, V, (N, U), generator=g)
    input_lengths = torch.randint(T // 2, T + 1, (N,), generator=g)
    target_lengths = torch.randint(1, U + 1, (N,), generator=g)
    input_lengths[0], target_lengths[0] = T, U
    target_lengths[1] = 0
    return [t.to(dev) for t in (log_probs, targets, input_lengths,
                                target_lengths)]


def phase_long_lattice(torch, dev):
    """R3: K3 and K4 at S' = 2049 (U = 1024), K8a and K8b at S = 2051
    (U = 512), past the old 1024-state limit, against their plain
    versions (ctc_forward_history / ctc_grad, star_forward_history /
    star_grad) at a small batch: -> the largest |d| of each."""
    from haloop_tpu_torch.ops import ctc, ctc_cuda, star, star_cuda
    out = {}
    args = long_lattice_inputs(torch, dev, 2100, 3, 40, 1024, 11)
    T, N = 2100, 3
    S = 2 * 1024 + 1
    hist = torch.empty((N, T, S), device=dev)
    loss = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    loss_e, hist_e = ctc.ctc_forward_history(*args)
    g = torch.rand(N, generator=torch.Generator().manual_seed(6)).to(dev) \
        + 0.5
    got = ctc_cuda.ctc_bwd_cuda(*args, hist, loss, g)
    want = ctc.ctc_grad(*args, hist, loss, g)
    out["K3 rel"] = ((loss - loss_e).abs() / loss_e.abs()).max().item()
    out["K4"] = (got - want).abs().max().item()
    check(out["K3 rel"] <= CTC_REL_TOL and
          close(hist, hist_e, CTC_HIST_TOL)[0],
          "K3 at S' = 2049 disagrees with ctc_forward_history")
    check(bool(((got - want).abs() <= CTC_GRAD_TOL +
                CTC_GRAD_TOL * want.abs()).all()),
          "K4 at S' = 2049 disagrees with ctc_grad")

    raw, targets, il, tl = long_lattice_inputs(torch, dev, 1100, 3, 20, 512,
                                               12)
    star_lp, star_targets = star.intersperse_stars(raw, targets)
    sargs = (star_lp, star_targets, il, tl)
    T, S = 1100, 4 * 512 + 3
    hist = torch.empty((N, T, S), device=dev)
    loss = star_cuda.star_fwd_cuda(*sargs, STAR_PENALTY, history=hist)
    loss_e, hist_e = star.star_forward_history(*sargs, STAR_PENALTY)
    bargs = (*sargs, hist, loss, g, STAR_PENALTY)
    got = star_cuda.star_bwd_cuda(*bargs)
    want = star.star_grad(*bargs)
    ok_l, out["K8a"] = close(loss, loss_e, STAR_TOL)
    out["K8b"] = (got - want).abs().max().item()
    check(ok_l and bool(torch.allclose(hist, hist_e, rtol=1e-5, atol=1e-3)),
          "K8a at S = 2051 disagrees with star_forward_history")
    check(bool(((got - want).abs() <= CTC_GRAD_TOL +
                CTC_GRAD_TOL * want.abs()).all()),
          "K8b at S = 2051 disagrees with star_grad")
    print(f"long lattices (R3): K3/K4 at N=3 T=2100 S'=2049 C=40, K8a/K8b at "
          f"N=3 T=1100 S=2051 2V=40: max|d| {out} (K3 rel {CTC_REL_TOL}, "
          f"K8a {STAR_TOL}, K4/K8b rel/abs {CTC_GRAD_TOL})", flush=True)
    return out


def host_ms(torch, fn, reps=5, warm=True):
    """(median, all) host wall times in ms of ``fn`` (which ends in a host
    read), after one warm-up call unless ``warm`` is false (the caller
    has just run ``fn``'s work)."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def make_system(torch, dev, *flags):
    from haloop_tpu_torch import loop
    from haloop_tpu_torch.symbol_tape import make_vocab
    args = loop.make_parser().parse_args(["--vocab", "512", "--seed", "0",
                                          *flags])
    (spec, params), _, _ = loop.Initializer()(args)
    return loop.System(args, spec, params, make_vocab("512"), dev)


def bench_arrays(B, T, U, F, seed=0):
    """The JAX package's bench.py batches (``time_system_step``): B random
    F-dim feature sequences of T/2..T frames and U/2..U labels of 4..511
    in a width of U, from a seed; host arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(B, T, F)).astype(np.float32)
    targets = rng.integers(4, 512, (B, U)).astype(np.int64)
    il = np.clip(rng.integers(T // 2, T + 1, B), 1, T).astype(np.int32)
    tl = rng.integers(U // 2, U + 1, B).astype(np.int32)
    return inputs, targets, il, tl


def transducer_batch(system, B=16):
    """The JAX package's rnn-transducer:lstm:512 train shapes (bench.py):
    B (16) random 13-dim feature sequences of 600-1200 frames (T'=301 at
    most), 12-24 labels of U=24, from a seed."""
    return system.to_device(*bench_arrays(B, 1200, 24, 13))


def check_against_plain(torch, system, batch, what):
    """The kernel path's loss and encoder grad norm against the plain
    path's on the same batch, dropout off."""
    k = loss_and_enc_norm(torch, system, batch)
    with plain_kernels():
        p = loss_and_enc_norm(torch, system, batch)
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    print(f"{what}, dropout off: kernel path loss {k[0]:.6f} encoder grad "
          f"norm {k[1]:.6f}; plain path {p[0]:.6f} {p[1]:.6f}; rel diff "
          f"{rel[0]:.3e} {rel[1]:.3e} (tol {SLICE_REL_TOL})", flush=True)
    check(max(rel) <= SLICE_REL_TOL,
          f"{what}: the kernel path differs from the plain path")


def phase_transducer(torch, dev, card):
    """rnn-transducer:lstm:512 at full width: a train step and a
    transcription batch, each with the counts reset just before it; then
    one train step of rnn-transducer:lstm:16384 (a 16k vocabulary) at
    batch 4."""
    from haloop_tpu_torch.models import recognizer
    from haloop_tpu_torch.params import tree_map
    system = make_system(torch, dev, "--arch", "rnn-transducer:lstm:512")
    n_params = sum(leaf.numel() for _, leaf in system.leaves)
    batch = transducer_batch(system)
    B, U = batch[1].shape
    max_steps = U + 1                  # haloop_tpu/loop.py:711

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, norm, bad = system.train_step(*batch)
    torch.cuda.synchronize()
    train = counts()
    print(f"rnn-transducer:lstm:512 ({n_params} params) train step, batch "
          f"{B}: loss {loss:.4f} encoder grad norm {norm:.4f}; launches "
          f"{train}", flush=True)
    check(not bad and math.isfinite(loss), "non-finite transducer step")
    # 3 encoder layers + 2 prediction-net layers; one joint
    check_counts("transducer train step", train,
                 dict(lstm_fwd_residual=5, lstm_bwd=5, joint_lse=1,
                      joint_lse_bwd=1))
    check_persistent("transducer train step")

    def transcribe():
        _, feats, feat_lens, _ = system._forward_impl(*batch, train=False)
        out = system._decode_impl(feats, feat_lens, max_steps=max_steps,
                                  train=False)
        return feats, feat_lens, [t.cpu() for t in out[:4]], out[4]

    reset_counts()
    with torch.inference_mode():
        feats, feat_lens, (hyps, lens, scores, ents), ali = transcribe()
        torch.cuda.synchronize()
    serve = counts()
    print(f"rnn-transducer:lstm:512 transcription batch {B}: launches "
          f"{serve}; hyp lengths {lens.tolist()}", flush=True)
    check_counts("transducer transcription", serve,
                 dict(lstm_fwd=5, joint_lse=1))
    check_persistent("transducer transcription")
    check(ali is None and hyps.shape == (B, max_steps) and
          bool(((lens >= 0) & (lens <= max_steps)).all()) and
          bool(torch.isfinite(scores).all() & torch.isfinite(ents).all()),
          "malformed transducer decode")
    # the same greedy decode on the CPU from the same features
    p_cpu = tree_map(lambda x: x.detach().cpu(),
                     system.params["recognizer"])
    c_hyps, c_lens, _, c_scores = recognizer.transducer_greedy_decode(
        p_cpu, feats.cpu(), feat_lens.cpu(), max_symbols=max_steps)
    same = [bool(torch.equal(hyps[n, :lens[n]], c_hyps[n, :c_lens[n]]))
            for n in range(B)]
    d_score = max((abs(scores[n] - c_scores[n]).item()
                   for n in range(B) if same[n]), default=0.0)
    print(f"transducer decode on the card against the CPU: {sum(same)} of "
          f"{B} hypotheses identical (at least {DECODE_MIN_SAME_ROWS}), max "
          f"|dscore| on those {d_score:.3e}", flush=True)
    check(sum(same) >= DECODE_MIN_SAME_ROWS and d_score < 1e-2,
          "the transducer decode on the card disagrees with the CPU's")

    check_against_plain(torch, system, batch, "transducer train step")

    def step():
        check(not system.train_step(*batch)[2], "non-finite train step")
    torch.cuda.reset_peak_memory_stats()
    sec, times = host_ms(torch, step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"rnn-transducer:lstm:512 train step (forward, backward, clip, "
          f"AdamW), batch {B} x 1200 frames, U={U}: {B / sec * 1e3:.2f} "
          f"utt/s ({sec:.3f} ms per step, median of 5; "
          f"{[round(t, 3) for t in times]}) peak memory {peak:.2f} GiB on "
          f"{card}", flush=True)
    profile_step(torch, step, "one transducer train step")

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        sec, times = host_ms(torch, transcribe)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"rnn-transducer:lstm:512 eval forward (with the loss) + "
              f"greedy decode, batch {B}: {B / sec * 1e3:.2f} utt/s "
              f"({sec:.3f} ms per batch, median of 5; "
              f"{[round(t, 3) for t in times]}) peak memory {peak:.2f} GiB "
              f"on {card}", flush=True)
    del system, batch
    torch.cuda.empty_cache()
    return train, serve, transducer_16k(torch, dev)


def transducer_16k(torch, dev):
    """One train step of rnn-transducer:lstm:16384 through loop.System at
    batch 4 of the phase's frames (K9a at V = 16384, past the parent
    kernel's vocabulary limit), the counts reset just before it: K9a and
    K9b once each, a finite loss, its peak memory, the kernel path against
    the plain path."""
    system = make_system(torch, dev, "--arch", "rnn-transducer:lstm:16384")
    batch = transducer_batch(system, B=4)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, norm, bad = system.train_step(*batch)
    torch.cuda.synchronize()
    train = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"rnn-transducer:lstm:16384 train step, batch 4: loss {loss:.4f} "
          f"encoder grad norm {norm:.4f}; launches {train}; peak memory "
          f"{peak:.3f} GiB on {card_line()}", flush=True)
    check(not bad and math.isfinite(loss), "non-finite 16k transducer step")
    check_counts("16k transducer train step", train,
                 dict(lstm_fwd_residual=5, lstm_bwd=5, joint_lse=1,
                      joint_lse_bwd=1))
    check_against_plain(torch, system, batch, "16k transducer train step")
    return train


def phase_star_train(torch, dev, card):
    """lstm:512 --star-penalty -0.5: one train step at batch 48 x 12 s
    with the counts reset just before it, the plain path, utt/s."""
    system = make_system(torch, dev, "--arch", "lstm:512", "--star-penalty",
                         str(STAR_PENALTY))
    _, batch = eval_batch(system)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, norm, bad = system.train_step(*batch)
    torch.cuda.synchronize()
    launches = counts()
    print(f"lstm:512 --star-penalty {STAR_PENALTY} train step, batch 48: "
          f"loss {loss:.4f}; launches {launches}", flush=True)
    check(not bad and math.isfinite(loss), "non-finite Star-CTC step")
    check_counts("Star-CTC train step", launches,
                 dict(lstm_fwd_residual=3, lstm_bwd=3, star_fwd_history=1,
                      star_bwd=1))
    from haloop_tpu_torch.ops import star_cuda
    print(f"Star-CTC train step: K8a's plan {star_cuda.fwd_plan(387, 1024)}, "
          f"K8b's {star_cuda.plan(387, 1024)}", flush=True)
    check_persistent("Star-CTC train step")
    check_against_plain(torch, system, batch, "Star-CTC train step")

    def step():
        check(not system.train_step(*batch)[2], "non-finite train step")
    torch.cuda.reset_peak_memory_stats()
    sec, times = host_ms(torch, step)
    print(f"lstm:512 --star-penalty {STAR_PENALTY} train step, 48 x 12 s "
          f"utterances: {48 / sec * 1e3:.2f} utt/s ({sec:.3f} ms per step, "
          f"median of 5; {[round(t, 3) for t in times]}) peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}",
          flush=True)
    profile_step(torch, step, "one Star-CTC train step")
    return launches


def q8_against_exact(torch, system, batch, what):
    """The --rnn-q8 system's loss against the same system's exact mode on
    the same batch (dropout off): RNN_Q8_REL."""
    with torch.inference_mode():
        q8 = system._forward_impl(*batch, train=False)[0].item()
        system.args.rnn_q8 = False
        try:
            exact = system._forward_impl(*batch, train=False)[0].item()
        finally:
            system.args.rnn_q8 = True
    rel = abs(q8 - exact) / abs(exact)
    print(f"{what}: loss --rnn-q8 {q8:.6f}, the exact mode {exact:.6f}, rel "
          f"diff {rel:.3e} (within {RNN_Q8_REL})", flush=True)
    check(RNN_Q8_REL[0] < rel < RNN_Q8_REL[1],
          f"{what}: the int8 mode did not run, or is far from the exact one")


def phase_rnn_q8(torch, dev, tmp, card):
    """hac --rnn-q8 (K1-q8, K2-q8) on every acoustic path, each with the
    counts reset just before and read just after: lstm:512 through
    loop.main (--train 2 steps, eval, save; then --init last.pt --test),
    a 48 x 12 s train step and transcription batch, an
    rnn-transducer:lstm:512 train step and transcription batch, and an
    lstm:512 --star-penalty -0.5 train step; the routes each took, the
    kernel path against the plain path, the int8 loss against the exact
    one, utt/s, and no quant_rows launch in a train step's profile."""
    from haloop_tpu_torch import loop
    from haloop_tpu_torch.nn import lstm_cuda
    paths = {}
    # K1-q8 below Q8_FWD_MIN_H (the RNN-T's prediction net, H = 512) takes
    # the per-step kernel; every other call is persistent
    short = ("fwd_q8_tc_step",) if lstm_cuda.Q8_FWD_MIN_H > 512 else ()

    # 1. the entry point: train, eval, save; then --init last.pt --test
    exp = Path(tmp) / "train-q8"
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        loop.main(["--arch", "lstm:512", "--vocab", "512", "--rnn-q8",
                   "--train", "head:sinusoids0", "--eval",
                   "head:sinusoids0", "--num-epochs", "1", "--batch-size",
                   "8", "--save", "last+best", "--exp", str(exp),
                   "--log-interval", "1"])
    torch.cuda.synchronize()
    paths["q8_train"] = counts()
    print(f"hac --rnn-q8 --train head:sinusoids0 (2 steps, eval, save) in "
          f"{time.perf_counter() - t0:.1f} s: launches {paths['q8_train']}",
          flush=True)
    check_counts("hac --rnn-q8 --train", paths["q8_train"], dict(
        lstm_fwd_q8_residual=6, lstm_bwd_q8=6, lstm_fwd_q8=3,
        ctc_fwd_history=2, ctc_bwd=2, ctc_fwd=1))
    check_persistent("hac --rnn-q8 --train", short)
    check((exp / "last.pt").exists() and (exp / "best.pt").exists(),
          "hac --rnn-q8: last.pt and best.pt not written")
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loop.main(["--init", str(exp / "last.pt"), "--arch", "lstm:512",
                   "--vocab", "512", "--rnn-q8", "--test",
                   "head:sinusoids0", "--exp", str(exp)])
    torch.cuda.synchronize()
    paths["q8_test"] = counts()
    rows = tsv_rows(out.getvalue())
    print(f"hac --rnn-q8 --init last.pt --test: {len(rows)} TSV rows; "
          f"launches {paths['q8_test']}", flush=True)
    check_counts("hac --rnn-q8 --test", paths["q8_test"],
                 dict(lstm_fwd_q8=3, ctc_fwd=1))
    check_persistent("hac --rnn-q8 --test", short)

    # 2. lstm:512 at batch 48 x 12 s: a train step, a transcription batch
    system = make_system(torch, dev, "--arch", "lstm:512", "--rnn-q8")
    _, batch = eval_batch(system)
    reset_counts()
    check(not system.train_step(*batch)[2], "non-finite --rnn-q8 step")
    torch.cuda.synchronize()
    paths["q8_ctc_train_step"] = counts()
    check_counts("--rnn-q8 train step", paths["q8_ctc_train_step"], dict(
        lstm_fwd_q8_residual=3, lstm_bwd_q8=3, ctc_fwd_history=1,
        ctc_bwd=1))
    check_persistent("--rnn-q8 train step")

    def transcribe():
        _, feats, feat_lens, _ = system._forward_impl(*batch, train=False)
        out = system._decode_impl(feats, feat_lens, train=False)
        return [t.cpu() for t in out]
    reset_counts()
    with torch.inference_mode():
        transcribe()
    torch.cuda.synchronize()
    paths["q8_ctc_eval"] = counts()
    check_counts("--rnn-q8 transcription batch", paths["q8_ctc_eval"],
                 dict(lstm_fwd_q8=3, ctc_fwd=1))
    check_persistent("--rnn-q8 transcription batch")
    print(f"lstm:512 --rnn-q8, 48 x 12 s: launches, train step "
          f"{paths['q8_ctc_train_step']}; transcription "
          f"{paths['q8_ctc_eval']}", flush=True)
    check_against_plain(torch, system, batch, "--rnn-q8 train step")
    q8_against_exact(torch, system, batch, "lstm:512 --rnn-q8")

    def step():
        check(not system.train_step(*batch)[2], "non-finite train step")
    sec, times = host_ms(torch, step)
    print(f"lstm:512 --rnn-q8 train step (forward, backward, clip, AdamW), "
          f"48 x 12 s utterances: {48 / sec * 1e3:.2f} utt/s ({sec:.3f} ms "
          f"per step, median of 5; {[round(t, 3) for t in times]}) on "
          f"{card}", flush=True)
    events, by_name = profile_step(torch, step, "one --rnn-q8 train step")
    # K2-q8's row quantization runs inside its persistent launch: no
    # quant_rows launch a step (1,155 a train step on the per-step route;
    # the route counts above show none ran either)
    quant = sum(n for name, (n, _) in by_name.items() if "quant_rows" in name)
    print(f"--rnn-q8 train step: {events} device events, {quant} of them "
          f"quant_rows", flush=True)
    check(quant == 0,
          "--rnn-q8 train step: K2-q8's per-row quantization launched")
    with torch.inference_mode():
        sec, times = host_ms(torch, transcribe)
    print(f"lstm:512 --rnn-q8 eval forward+decode, 48 x 12 s utterances: "
          f"{48 / sec * 1e3:.2f} utt/s ({sec:.3f} ms per batch, median of "
          f"5) on {card}", flush=True)
    del system

    # 3. rnn-transducer:lstm:512: the encoder and the prediction net
    system = make_system(torch, dev, "--arch", "rnn-transducer:lstm:512",
                         "--rnn-q8")
    batch = transducer_batch(system)
    B, U = batch[1].shape
    reset_counts()
    check(not system.train_step(*batch)[2], "non-finite transducer step")
    torch.cuda.synchronize()
    paths["q8_transducer_train"] = counts()
    check_counts("--rnn-q8 transducer train step",
                 paths["q8_transducer_train"],
                 dict(lstm_fwd_q8_residual=5, lstm_bwd_q8=5, joint_lse=1,
                      joint_lse_bwd=1))
    check_persistent("--rnn-q8 transducer train step", short)

    def transcribe():
        _, feats, feat_lens, _ = system._forward_impl(*batch, train=False)
        out = system._decode_impl(feats, feat_lens, max_steps=U + 1,
                                  train=False)
        return [t.cpu() for t in out[:4]]
    reset_counts()
    with torch.inference_mode():
        transcribe()
    torch.cuda.synchronize()
    paths["q8_transducer_serve"] = counts()
    check_counts("--rnn-q8 transducer transcription",
                 paths["q8_transducer_serve"], dict(lstm_fwd_q8=5,
                                                    joint_lse=1))
    check_persistent("--rnn-q8 transducer transcription", short)
    print(f"rnn-transducer:lstm:512 --rnn-q8, batch {B}: launches, train "
          f"step {paths['q8_transducer_train']}; transcription "
          f"{paths['q8_transducer_serve']}", flush=True)
    check_against_plain(torch, system, batch,
                        "--rnn-q8 transducer train step")
    q8_against_exact(torch, system, batch, "rnn-transducer:lstm:512 --rnn-q8")

    def step():
        check(not system.train_step(*batch)[2], "non-finite train step")
    sec, _ = host_ms(torch, step)
    with torch.inference_mode():
        eval_sec, _ = host_ms(torch, transcribe)
    print(f"rnn-transducer:lstm:512 --rnn-q8, batch {B} x 1200 frames: "
          f"train {B / sec * 1e3:.2f} utt/s ({sec:.3f} ms per step), eval "
          f"forward+greedy decode {B / eval_sec * 1e3:.2f} utt/s "
          f"({eval_sec:.3f} ms per batch), medians of 5, on {card}",
          flush=True)
    del system

    # 4. lstm:512 --star-penalty -0.5
    system = make_system(torch, dev, "--arch", "lstm:512", "--star-penalty",
                         str(STAR_PENALTY), "--rnn-q8")
    _, batch = eval_batch(system)
    reset_counts()
    check(not system.train_step(*batch)[2], "non-finite Star-CTC step")
    torch.cuda.synchronize()
    paths["q8_star_train"] = counts()
    print(f"lstm:512 --star-penalty {STAR_PENALTY} --rnn-q8 train step, "
          f"batch 48: launches {paths['q8_star_train']}", flush=True)
    check_counts("--rnn-q8 Star-CTC train step", paths["q8_star_train"],
                 dict(lstm_fwd_q8_residual=3, lstm_bwd_q8=3,
                      star_fwd_history=1, star_bwd=1))
    check_persistent("--rnn-q8 Star-CTC train step")
    check_against_plain(torch, system, batch, "--rnn-q8 Star-CTC train step")

    def step():
        check(not system.train_step(*batch)[2], "non-finite train step")
    sec, _ = host_ms(torch, step)
    print(f"lstm:512 --star-penalty {STAR_PENALTY} --rnn-q8 train step, 48 x "
          f"12 s utterances: {48 / sec * 1e3:.2f} utt/s ({sec:.3f} ms per "
          f"step, median of 5) on {card}", flush=True)
    return paths


def losses_in(log_text):
    """(train losses, valid losses) from hac's log lines."""
    return ([float(x) for x in re.findall(r"\] time: [\d.]+ loss: ([\d.]+)",
                                          log_text)],
            [float(x) for x in re.findall(
                r"valid \[\s*\d+,\s+\d+\] loss: ([\d.]+)", log_text)])


def run_main(main, argv, stdin=""):
    """main(argv) with stdin from a string -> (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
    finally:
        sys.stdin = old
    return out.getvalue(), err.getvalue()


def phase_entry(torch, tmp):
    """rnn-transducer-tiny and lstm-tiny --star-penalty through hac's
    entry point, each with the counts reset just before and read just
    after."""
    from haloop_tpu_torch import loop
    exp = Path(tmp) / "rnnt-tiny"
    common = ["--vocab", "512", "--train", "head:sinusoids0", "--eval",
              "head:sinusoids0", "--batch-size", "8", "--lr", "3e-3",
              "--lr_schedule", "const", "--log-interval", "1"]
    reset_counts()
    t0 = time.perf_counter()
    _, err = run_main(loop.main, [
        "--arch", "rnn-transducer-tiny:512", *common, "--num-epochs", "15",
        "--save", "last+best", "--exp", str(exp)])
    out, _ = run_main(loop.main, [
        "--init", str(exp / "last.pt"), "--arch", "rnn-transducer-tiny:512",
        "--vocab", "512", "--test", "head:sinusoids0", "--exp", str(exp)])
    torch.cuda.synchronize()
    rnnt = counts()
    train, valid = losses_in(err)
    rows = tsv_rows(out, tags=("hyp0", "ref", "stat0"))
    print(f"hac --arch rnn-transducer-tiny:512 --train (15 epochs of 2 "
          f"steps) --eval, then --init last.pt --test, in "
          f"{time.perf_counter() - t0:.1f} s: train loss {train[0]:.3f} -> "
          f"{train[-1]:.3f}, valid loss {valid[0]:.3f} -> {valid[-1]:.3f}; "
          f"{len(rows)} TSV rows (hyp/ref/stat, no ali); launches {rnnt}",
          flush=True)
    check(len(valid) == 15 and valid[-1] < valid[0] / 4,
          "rnn-transducer-tiny's valid loss did not fall below a quarter")
    for name in ("lstm_fwd", "lstm_fwd_residual", "lstm_bwd", "joint_lse",
                 "joint_lse_bwd"):
        check(rnnt[name] > 0, f"the transducer entry path did not launch "
                              f"{name}: {rnnt}")
    check_counts("transducer entry path", rnnt,
                 {k: v for k, v in rnnt.items() if k.startswith(("lstm",
                                                                 "joint"))})

    reset_counts()
    _, err = run_main(loop.main, [
        "--arch", "lstm-tiny:512", *common, "--star-penalty",
        str(STAR_PENALTY), "--num-epochs", "5", "--save", "none", "--exp",
        str(Path(tmp) / "star-tiny")])
    torch.cuda.synchronize()
    star = counts()
    train, valid = losses_in(err)
    print(f"hac --arch lstm-tiny:512 --star-penalty {STAR_PENALTY} --train "
          f"(5 epochs of 2 steps) --eval: train loss {train[0]:.3f} -> "
          f"{train[-1]:.3f}, valid loss {valid[0]:.3f} -> {valid[-1]:.3f}; "
          f"launches {star}", flush=True)
    check(len(valid) == 5 and valid[-1] < valid[0] / 1.5,
          "lstm-tiny's Star-CTC valid loss did not fall below two thirds")
    for name in ("lstm_fwd", "lstm_fwd_residual", "lstm_bwd", "star_fwd",
                 "star_fwd_history", "star_bwd"):
        check(star[name] > 0, f"the Star-CTC entry path did not launch "
                              f"{name}: {star}")
    check_counts("Star-CTC entry path", star,
                 {k: v for k, v in star.items() if k.startswith(("lstm",
                                                                 "star"))})
    return rnnt, star


def attn_bound(q, kv_pairs, itemsize, key_rows=None):
    """(ms, by) of flash attention: q read and o written once, and k and v
    once for each of the ``key_rows`` key rows summed over the batch (all S
    of each item by default); QK^T and PV over the (query, key) pairs the
    masks leave."""
    N, H, T, D = q.shape
    if key_rows is None:
        key_rows = N * T
    nbytes = (2 * N * T + 2 * key_rows) * H * D * itemsize
    flops = 4.0 * kv_pairs * H * D
    if itemsize == 2:
        return bound(nbytes, flops, ATTN_ELEM * kv_pairs * H)
    return bound(nbytes, 0, flops + ATTN_ELEM * kv_pairs * H)


def qkv_views(torch, dev, N, H, T, D, dtype, seed):
    """q, k, v (N, H, T, D) as the GPT makes them: strided views of one
    (N, T, 3 H D) projection."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((N, T, 3 * H * D), generator=g).to(dev, dtype)
    return [t.reshape(N, T, H, D).transpose(1, 2)
            for t in qkv.split(H * D, dim=-1)]


def flash_faults(torch, flash, got, q, k, v, kvl, t0, ragged):
    """The K5 checks' planted faults, emulated from the plain version,
    against the kernel's output ``got`` (causal): the causal diagonal off by
    one (``_reference`` at t0 + 1) and, where the key lengths are
    ``ragged``, the last partial key tile dropped (each length rounded down
    to the bf16 kernel's 128-key tile). Each must read beyond ATTN_TOL:
    the limit sits between rounding and the design's likely errors.
    -> {fault: max |d|}; raises if the check would pass one."""
    faults = {"diagonal off by one": flash._reference(q, k, v, kvl, True,
                                                      t0 + 1)}
    if ragged:
        faults["last partial key tile dropped"] = flash._reference(
            q, k, v, torch.div(kvl, 128, rounding_mode="floor") * 128, True,
            t0)
    out = {}
    for name, want in faults.items():
        ok, err, mean = within(torch, got, want, ATTN_TOL["bfloat16"])
        print(f"  planted fault, {name}: max|do|={err:.3e} mean {mean:.3e} "
              f"(must exceed the limit)", flush=True)
        check(not ok, f"K5's check passes a planted fault: {name}")
        out[name] = err
    return out


def phase_flash(torch, dev):
    """K5 at hap --no-pack's shape with ragged key lengths, small cases
    (t0 > 0 and a zero key length, fp32); K7 at hap's packed shape with
    64-token segments and with pack_segments' ragged segments."""
    import numpy as np
    import torch.nn.functional as F
    from haloop_tpu_torch.ops import flash, flash_cuda
    from haloop_tpu_torch.score import pack_segments
    k5, k7 = {}, {}
    # K5, small: t0 > 0, a zero key length, fp32 and bf16
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        g = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for shape
                   in ((2, 2, 70, 64), (2, 2, 130, 64), (2, 2, 130, 64)))
        kvl = torch.tensor([0, 90], dtype=torch.int32, device=dev)
        got = flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 7)
        torch.cuda.synchronize()
        ok, err, mean = within(torch, got, flash._reference(q, k, v, kvl, True,
                                                       7), ATTN_TOL[name])
        print(f"K5 flash small (2, 2, 70, 130) t0=7 key lengths [0, 90] "
              f"{name}: max|do|={err:.3e} mean {mean:.3e} (tol "
              f"{ATTN_TOL[name]}; the zero-length row is the mean of v)",
              flush=True)
        check(ok, f"K5 disagrees with _reference at the small {name} case")

    # K5 at hap --no-pack: (32, 12, 512, 64) causal, ragged key lengths
    N, H, T, D = 32, 12, 512, 64
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        n = N if name == "bfloat16" else 4
        q, k, v = qkv_views(torch, dev, n, H, T, D, dtype, 11)
        lens = torch.randint(T // 2, T + 1, (n,),
                             generator=torch.Generator().manual_seed(2))
        lens[0] = T
        kvl = lens.to(dev, torch.int32)
        got = flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0)
        torch.cuda.synchronize()
        ok, err, mean = within(torch, got, flash._reference(q, k, v, kvl, True,
                                                       0), ATTN_TOL[name])
        pairs = int(sum(min(int(L), t + 1) for L in lens for t in range(T)))
        kernel = lambda: flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: flash._reference(q, k, v, kvl, True, 0))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        b_ms, b_by = attn_bound(q, pairs, q.element_size(),
                                key_rows=int(lens.clamp(max=T).sum()))
        print(f"K5 flash ({n}, {H}, {T}, {D}) causal, ragged key lengths, "
              f"{name}: max|do|={err:.3e} mean {mean:.3e} (tol "
              f"{ATTN_TOL[name]}); kernel {ms:.4f} ms, plain {plain_ms:.3f} "
              f"ms, SDPA(is_causal) {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        check(ok, f"K5 disagrees with _reference at {(n, H, T, D, name)}")
        if name == "bfloat16":
            flash_faults(torch, flash, got, q, k, v, kvl, 0, ragged=True)
        k5[f"{n}x{H}x{T}x{D} {name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)

    # K7 at hap --pack: (16, 12, 1024, 64), 64-token and ragged segments
    N, T = 16, 1024
    rng = np.random.default_rng(0)
    ragged = [rng.integers(1, 50257, int(n)).tolist()
              for n in rng.integers(8, 300, 400)]
    seg_ragged = next(iter(pack_segments(iter(ragged), T, N, 50256)))[3]
    seg_64 = np.repeat(np.arange(1, T // 64 + 1), 64)[None].repeat(N, 0)
    for label, seg_np in (("64-token segments", seg_64),
                          ("pack_segments' ragged segments", seg_ragged)):
        q, k, v = qkv_views(torch, dev, N, H, T, D, torch.bfloat16, 13)
        seg = torch.from_numpy(np.ascontiguousarray(seg_np, np.int32)).to(dev)
        got = flash_cuda.flash_packed_cuda(q, k, v, seg, True)
        torch.cuda.synchronize()
        ok, err, mean = within(torch, got, flash._packed_reference(
            q, k, v, seg, True), ATTN_TOL["bfloat16"])
        check(bool(torch.isfinite(got.float()).all()),
              "K7 output not finite (padding rows included)")
        same = (seg[:, :, None] == seg[:, None, :]) & torch.ones(
            (T, T), dtype=torch.bool, device=dev).tril()
        pairs = int(same.sum())
        kernel = lambda: flash_cuda.flash_packed_cuda(q, k, v, seg, True)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: flash._packed_reference(
            q, k, v, seg, True))
        mask = same[:, None]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        b_ms, b_by = attn_bound(q, pairs, 2)
        print(f"K7 flash packed ({N}, {H}, {T}, {D}) bf16, {label}: "
              f"max|do|={err:.3e} mean {mean:.3e} (tol "
              f"{ATTN_TOL['bfloat16']}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA with the block-diagonal causal mask "
              f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        check(ok, f"K7 disagrees with _packed_reference ({label})")
        k7[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return by_shape(k5), by_shape(k7)


def ce_faults(torch, fused_ce_cuda, x, w, t, nll_e, lse_e):
    """K10's planted faults, emulated through K10 itself, against the
    plain version's (nll_e, lse_e): the last vocab tile's mask dropped (w
    padded with zero rows to the bf16 plan's whole 256-column tiles, whose
    logits are then 0 and count in the sum), and one chunk of the plan
    left out of the merge (w without that chunk's rows, a target inside it
    adding a target term of 0, those after it moved down). Each must read
    beyond CE_TOL. -> {fault: max |d|}."""
    from haloop_tpu_torch import kernels
    N, D = x.shape
    V = w.shape[0]
    p = fused_ce_cuda.plan(N, V, D, kernels.multiprocessors(x.device))
    padded = torch.zeros((p.vocab_tiles * fused_ce_cuda.TC_COLS, D),
                         dtype=w.dtype, device=w.device)
    padded[:V] = w
    vt0, vt1 = fused_ce_cuda.vocab_range(p, p.chunks // 2)
    c0, c1 = vt0 * fused_ce_cuda.TC_COLS, min(V, vt1 * fused_ce_cuda.TC_COLS)
    cut = torch.cat([w[:c0], w[c1:]])
    tc = torch.where(t < c0, t, torch.where(t < c1, -1, t - (c1 - c0)))
    out = {}
    for name, args in (("the last tile's V mask dropped", (x, padded, t)),
                       (f"chunk {p.chunks // 2} of {p.chunks} left out of "
                        f"the merge", (x, cut, tc))):
        if name.startswith("the last") and padded.shape[0] == V:
            continue                 # no partial tile: nothing to mask
        nll, lse = fused_ce_cuda.ce_fwd_cuda(*args)
        err = max((nll - nll_e).abs().max().item(),
                  (lse - lse_e).abs().max().item())
        print(f"  planted fault, {name}: max|dnll, dlse|={err:.3e} (must "
              f"exceed the limit)", flush=True)
        check(not all(within_ce(a, b) for a, b in ((nll, nll_e),
                                                    (lse, lse_e))),
              f"K10's check passes a planted fault: {name}")
        out[name] = err
    return out


def within_ce(got, want):
    return bool(((got - want).abs() <= CE_TOL["atol"] + CE_TOL["rtol"] *
                 want.abs()).all())


def phase_fused_ce(torch, dev):
    """K10 at hap's loss shape in bf16 (the route it took, two planted
    faults), at a ragged shape (rows and vocab off the tiles), and in fp32
    at N=2048; times beside the plain version, the library call, the
    cuBLAS product alone and the bound."""
    from haloop_tpu_torch.ops import fused_ce, fused_ce_cuda
    reports = {}
    D = 768
    for name, N, V in (("bfloat16", 16384, 50304), ("bfloat16", 4000, 4099),
                       ("float32", 2048, 50304)):
        dtype = getattr(torch, name)
        g = torch.Generator().manual_seed(N)
        x = torch.randn((N, D), generator=g).to(dev, dtype)
        w = (torch.randn((V, D), generator=g) * 0.02).to(dev, dtype)
        t = torch.randint(1, min(V, 50257), (N,), generator=g).to(dev)
        before = fused_ce_cuda.wg_launches
        nll, lse = fused_ce_cuda.ce_fwd_cuda(x, w, t)
        torch.cuda.synchronize()
        design = "warp-specialized (wgmma, TMA)" if \
            fused_ce_cuda.wg_launches == before + 1 else "CUDA cores"
        check(design.startswith("warp") == (dtype == torch.bfloat16),
              f"K10 {name} took the {design} kernel")
        nll_e, lse_e = fused_ce.ce_nll_lse(x, w, t)
        err = max((nll - nll_e).abs().max().item(),
                  (lse - lse_e).abs().max().item())
        ok = within_ce(nll, nll_e) and within_ce(lse, lse_e)
        again = torch.equal(nll, fused_ce_cuda.ce_fwd_cuda(x, w, t)[0])
        print(f"K10 fused_ce N={N} V={V} D={D} {name}, {design} kernel: "
              f"max|dnll, dlse|={err:.3e} (tol {CE_TOL}); the same bits on "
              f"a second run: {again}", flush=True)
        check(ok and again, f"K10 disagrees with ce_nll_lse ({name})")
        faults = ce_faults(torch, fused_ce_cuda, x, w, t, nll_e, lse_e) \
            if dtype == torch.bfloat16 else {}
        del nll_e, lse_e
        kernel = lambda: fused_ce_cuda.ce_fwd_cuda(x, w, t)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: fused_ce.ce_nll_lse(x, w, t))

        def library():
            logits = x @ w.T
            return torch.logsumexp(logits.float(), -1) - \
                logits.gather(1, t[:, None])[:, 0].float()
        lib_ms = cuda_ms(library)
        product_ms = cuda_ms(lambda: torch.mm(x, w.T))
        flops = 2.0 * N * V * D
        nbytes = x.element_size() * (N * D + V * D) + 4 * 3 * N
        b_ms, b_by = bound(nbytes, flops, CE_ELEM * N * V) \
            if dtype == torch.bfloat16 else \
            bound(nbytes, 0, flops + CE_ELEM * N * V)
        print(f"K10 fused_ce N={N} V={V} {name}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, torch.logsumexp(x @ w.T) - gather "
              f"{lib_ms:.3f} ms, cuBLAS torch.mm(x, w.T) alone "
              f"{product_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        reports[f"{name} N={N} V={V}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, product_ms=product_ms,
            design=design, planted_faults=faults)
    return by_shape(reports)


def check_ce_route(path, launches):
    """Every K10 call since reset_counts took the bf16 warp-specialized
    kernel."""
    from haloop_tpu_torch.ops import fused_ce_cuda
    print(f"{path}: K10 launches {launches['fused_ce']}, on the "
          f"warp-specialized route {fused_ce_cuda.wg_launches}", flush=True)
    check(launches["fused_ce"] > 0 and
          fused_ce_cuda.wg_launches == launches["fused_ce"],
          f"{path}: K10 did not take the warp-specialized kernel")


def k11_inputs(torch, dev, B, S, L, pad, E=768):
    """q, k_new, v_new (B, E) (strided rows of one projection), the caches
    (B, S, E) and left-pad starts (or None), bf16, from seed B + L."""
    g = torch.Generator().manual_seed(B + L)
    qkv = torch.randn((B, 3 * E), generator=g).to(dev, torch.bfloat16)
    q, kn, vn = qkv.split(E, dim=-1)
    kc = torch.randn((B, S, E), generator=g).to(dev, torch.bfloat16)
    vc = torch.randn((B, S, E), generator=g).to(dev, torch.bfloat16)
    starts = torch.randint(0, 16, (B,), generator=g).to(dev) if pad else None
    return q, kn, vn, kc, vc, starts


def k11_emulate(q, k_new, v_new, k_cache, v_cache, length, starts, n_head,
                cluster, step, fault=None):
    """K11's design in torch ops (csrc/decode_attn.cu decode) -> y (B, E);
    the caches written at row ``length``. Each (row, head)'s attended rows
    are cut into ``cluster`` runs of whole steps of ``step`` rows; each
    run's max and sum of e = 2^(s - max) (scores in log2 units) are taken
    alone and then over the runs, p = e / sum is rounded to the cache
    dtype, and the runs' p . v sums are added in run order. ``fault``:
    "peers ignored" (each run normalizes by its own max and sum) or "first
    step left out" (each row's first ``step`` attended rows not
    attended)."""
    import torch
    B, S, E = k_cache.shape
    H, D = n_head, E // n_head
    k_cache[:, length] = k_new
    v_cache[:, length] = v_new
    n1 = length + 1
    kh = k_cache[:, :n1].float().view(B, n1, H, D).transpose(1, 2)
    vh = v_cache[:, :n1].float().view(B, n1, H, D).transpose(1, 2)
    s = torch.einsum("bhd,bhjd->bhj", q.float().view(B, H, D), kh) * \
        (1.4426950408889634 / D ** 0.5)
    j = torch.arange(n1, device=q.device)[None]
    start = (starts.long().clamp(min=0) if starts is not None else
             torch.zeros(B, dtype=torch.long, device=q.device))[:, None]
    per = -(-(-(-(length - start + 1) // cluster)) // step) * step
    run = ((j - start) // per).clamp(0, cluster - 1)       # (B, n1)
    live = (j >= start) & (j <= length)
    if fault == "first step left out":
        live &= j >= start + step
    s = s.masked_fill(~live[:, None], float("-inf"))
    onehot = torch.nn.functional.one_hot(run, cluster).bool()   # (B, n1, C)
    at = onehot[:, None] & live[:, None, :, None]               # (B,1,n1,C)
    m_r = torch.where(at, s[..., None], float("-inf")).amax(2)  # (B,H,C)
    m = m_r.amax(-1, keepdim=True).expand_as(m_r)
    if fault == "peers ignored":
        m = m_r
    m_j = torch.gather(m, 2, run[:, None].expand(B, H, n1))
    e = torch.exp2(s - m_j).masked_fill(~live[:, None], 0.0)
    l_r = torch.where(at, e[..., None], 0.0).sum(2)             # (B,H,C)
    ll = l_r.sum(-1, keepdim=True).expand_as(l_r)
    if fault == "peers ignored":
        ll = l_r
    p = (e / torch.gather(ll, 2, run[:, None].expand(B, H, n1))).to(
        v_cache.dtype).float()
    acc = torch.zeros((B, H, D), device=q.device)
    for r in range(cluster):
        pr = torch.where(run[:, None] == r, p, 0.0)
        acc = acc + torch.einsum("bhj,bhjd->bhd", pr, vh)
    return acc.to(v_cache.dtype).reshape(B, E)


def k11_rel(got, want):
    """max |got - want| as a share of the largest |want| (K11_REL)."""
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max()).item()


def phase_decode(torch, dev):
    """K11 at K11_CASES: hat --batch's steps (B=32, S=256, E=768, H=12,
    fill levels 96 and 159, left-pad starts) and B=1, GPT-2 small's
    longest fill (1000 of S=1024) and K11's 10 MiB edge (B=1, 3000 of
    S=3412), gpt-nano's hat steps (E=64, H=2, S=64; B=3 with starts, B=1),
    bf16: against decode_attend (the caches bit for bit, y within
    DECODE_TOL and within K11_REL of the largest |y|), the same bits on a
    second call, one kernel a call; planted faults that must read past
    K11_REL: the first step of rows left out (K11 itself, starts raised by
    a step) and, where the plan takes a cluster, the peers' (max, sum)
    ignored (k11_emulate on the same inputs); times beside the plain
    version, SDPA over the head-split cache and the bound."""
    from haloop_tpu_torch.ops import decode_attn, decode_attn_cuda as dac
    reports = {}
    for label, B, S, L, pad, E, H in K11_CASES:
        D = E // H
        q, kn, vn, kc, vc, starts = k11_inputs(torch, dev, B, S, L, pad, E)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        n0 = dac.k11_kernel_launches()
        y = dac.decode_attn_cuda(q, kn, vn, k1, v1, L, starts, n_head=H)
        torch.cuda.synchronize()
        once = dac.k11_kernel_launches() == n0 + 1
        y_e = decode_attn.decode_attend(q, kn, vn, k2, v2, L, starts,
                                        n_head=H)
        exact = torch.equal(k1, k2) and torch.equal(v1, v2)
        ok, err = close(y.float(), y_e.float(), DECODE_TOL)
        rel = k11_rel(y, y_e)
        same = torch.equal(y, dac.decode_attn_cuda(q, kn, vn, k1, v1, L,
                                                   starts, n_head=H))
        plan = dac.plan(B, H, L, D, 2, dac.multiprocessors(dev))
        step = dac.step_rows(D, 2)
        first = starts.long() if starts is not None else \
            torch.zeros(B, dtype=torch.long, device=dev)
        faults = {"the first step of rows left out": k11_rel(
            dac.decode_attn_cuda(q, kn, vn, k1.clone(), v1.clone(), L,
                                 first + step, n_head=H), y_e)}
        if plan.cluster > 1:
            faults["the cluster peers' (max, sum) ignored"] = k11_rel(
                k11_emulate(q, kn, vn, kc.clone(), vc.clone(), L, starts, H,
                            plan.cluster, step, "peers ignored"), y_e)
        print(f"K11 decode_attn {label} (S={S} E={E} H={H}), plan "
              f"{tuple(plan)}: caches equal the plain version's: {exact}; "
              f"max|dy|={err:.3e} (tol {DECODE_TOL}), {rel:.3e} of the "
              f"largest |y| (limit {K11_REL}); the same bits twice: {same}; "
              f"one kernel: {once}; planted faults "
              f"{ {k: round(v, 4) for k, v in faults.items()} }", flush=True)
        check(exact and ok and rel <= K11_REL,
              f"K11 disagrees with decode_attend at {label}")
        check(same and once, f"K11 at {label}: other bits on a second call, "
                             f"or not one kernel a call")
        for f, v in faults.items():
            check(v > K11_REL, f"K11 at {label}: the planted fault ({f}) "
                               f"reads within K11_REL")
        ms = cuda_ms(lambda: dac.decode_attn_cuda(q, kn, vn, k1, v1, L,
                                                  starts, n_head=H))
        plain_ms = cuda_ms(lambda: decode_attn.decode_attend(
            q, kn, vn, k2, v2, L, starts, n_head=H))
        lib_ms = sdpa_decode_ms(torch, q, k1, v1, L, starts, H)
        b_ms, b_by = decode_bound(starts, B, L, E, H)
        print(f"K11 decode_attn {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA over the head-split cache "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        reports[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, rel_err=rel,
                              plan=list(plan), planted_faults=faults)
        del kc, vc, k1, v1, k2, v2
    return by_shape(reports)


def decode_bound(starts, B, L, E, H):
    """(ms, by) of one decode-attention step: the attended rows' k and v
    read once, q and the new k/v rows read, the new rows and y written
    (bf16); scores, softmax and p . v in fp32."""
    rows = B * (L + 1) - (int(starts.sum()) if starts is not None else 0)
    nbytes = 2 * (2 * rows * E + 3 * B * E + 2 * B * E + B * E)
    return bound(nbytes, 0, (2 * (E // H) + ATTN_ELEM) * rows * H)


def sdpa_decode_ms(torch, q, kc, vc, L, starts, H):
    """SDPA over the head-split cache with the boolean mask: the library
    call that computes K11's and K12's y (never called by the port)."""
    import torch.nn.functional as F
    B, S, E = kc.shape
    D = E // H
    qh = q.reshape(B, H, 1, D)
    kh, vh = (c.view(B, S, H, D).transpose(1, 2) for c in (kc, vc))
    cols = torch.arange(S, device=kc.device)[None]
    valid = cols <= L
    if starts is not None:
        valid = valid & (cols >= starts[:, None])
    mask = valid.expand(B, S)[:, None, None, :]
    return cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                          attn_mask=mask))


def phase_decode_long(torch, dev):
    """K12 at decoder:50304:4096's long-cache step (S=4096, E=768, H=12,
    bf16, fill level 4000): B=32 with left-pad starts and B=1; then starts
    past the first splits, and the new row inside the first split. At
    B=32 and B=1 four planted faults, run through K12 itself, must fail
    K12_REL: the new row left out (K12 at row length - 1, fed that row),
    the first attended split skipped (starts raised past it), the new row
    read from the stale cache (K12 fed the cache's old row as the new one)
    and the merge dropping the last split (K12 at the row before the last
    split, fed that row)."""
    from haloop_tpu_torch.ops import decode_attn, decode_attn_cuda
    reports = {}
    S, E, H = 4096, 768, 12
    sms = decode_attn_cuda.multiprocessors(dev)
    k12 = decode_attn_cuda.decode_attn_split_cuda
    cases = [("B=32, starts", 32, 4000, "pad"), ("B=1", 1, 4000, None),
             ("B=3, starts past the first splits", 3, 4000, "late"),
             ("B=4, the new row in the first split", 4, 100, "pad")]
    for what, B, L, kind in cases:
        g = torch.Generator().manual_seed(B + L)
        qkv = torch.randn((B, 3 * E), generator=g).to(dev, torch.bfloat16)
        q, kn, vn = qkv.split(E, dim=-1)
        kc = torch.randn((B, S, E), generator=g).to(dev, torch.bfloat16)
        vc = torch.randn((B, S, E), generator=g).to(dev, torch.bfloat16)
        rows = decode_attn_cuda.split_rows(B, H, L + 1, E // H, 2, sms)
        starts = None
        if kind == "pad":
            starts = torch.randint(0, 16, (B,), generator=g).to(dev)
        elif kind == "late":
            starts = torch.tensor([3 * rows + 1, 2 * rows, L], device=dev)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        y = k12(q, kn, vn, k1, v1, L, starts, n_head=H)
        torch.cuda.synchronize()
        y_e = decode_attn.decode_attend(q, kn, vn, k2, v2, L, starts,
                                        n_head=H)
        exact = torch.equal(k1, k2) and torch.equal(v1, v2)
        scale = y_e.float().abs().max().item()

        def rel(got):
            return (got.float() - y_e.float()).abs().max().item() / scale
        err = rel(y)
        same = torch.equal(y, k12(q, kn, vn, k1, v1, L, starts, n_head=H))
        print(f"K12 decode_attn_split {what} S={S} E={E} H={H} row {L}, "
              f"splits of {rows} rows: caches equal the plain version's: "
              f"{exact}; max|dy| / max|y| = {err:.3e} (max|y| {scale:.3e}, "
              f"limit {K12_REL}); the same bits twice: {same}", flush=True)
        check(exact and err <= K12_REL and same,
              f"K12 disagrees with decode_attend ({what})")
        if kind != "late" and L > rows:
            first = starts if starts is not None else \
                torch.zeros(B, dtype=torch.long, device=dev)
            last = L // rows * rows - 1     # the row before the last split
            faults = {
                "the new row left out": k12(
                    q, kc[:, L - 1], vc[:, L - 1], kc.clone(), vc.clone(),
                    L - 1, starts, n_head=H),
                "the first attended split skipped": k12(
                    q, kn, vn, kc.clone(), vc.clone(), L,
                    (first // rows + 1) * rows, n_head=H),
                "the new row read from the stale cache": k12(
                    q, kc[:, L], vc[:, L], kc.clone(), vc.clone(), L, starts,
                    n_head=H),
                "the merge dropping the last split": k12(
                    q, kc[:, last], vc[:, last], kc.clone(), vc.clone(),
                    last, starts, n_head=H)}
            read = {n: rel(f) for n, f in faults.items()}
            print(f"K12 decode_attn_split {what}: planted faults, max|dy| / "
                  f"max|y| against the plain version: "
                  + ", ".join(f"{n} {r:.3e}" for n, r in read.items())
                  + f"; each must exceed {K12_REL}", flush=True)
            check(min(read.values()) > K12_REL,
                  f"K12_REL does not catch a planted fault ({what})")
        before = (decode_attn_cuda.split_launches,
                  decode_attn_cuda.kernel_launches())
        k12(q, kn, vn, k1, v1, L, starts, n_head=H)
        calls, launched = (decode_attn_cuda.split_launches - before[0],
                           decode_attn_cuda.kernel_launches() - before[1])
        print(f"K12 decode_attn_split {what}: one call, {calls} counted, "
              f"{launched} kernel launched", flush=True)
        check(calls == launched == 1,
              f"K12 is not one launch a call ({what})")
        ms = cuda_ms(lambda: k12(q, kn, vn, k1, v1, L, starts, n_head=H))
        plain_ms = cuda_ms(lambda: decode_attn.decode_attend(
            q, kn, vn, k2, v2, L, starts, n_head=H))
        lib_ms = sdpa_decode_ms(torch, q, k1, v1, L, starts, H)
        b_ms, b_by = decode_bound(starts, B, L, E, H)
        print(f"K12 decode_attn_split {what}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA over the head-split cache "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        reports[what] = dict(max_abs_err=err * scale, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
    return by_shape(reports)


# GPT-2 small's int8 weights (N, K) as a decode step runs them: c_attn,
# attn c_proj, mlp c_fc and mlp c_proj 12 times each, lm_head once
Q8_WEIGHTS = (("c_attn", 2304, 768, 12), ("attn.c_proj", 768, 768, 12),
              ("c_fc", 3072, 768, 12), ("mlp.c_proj", 768, 3072, 12),
              ("lm_head", 50304, 768, 1))


def k13_dropped_slice(torch, x, w_q, sms):
    """A planted fault of K13 emulated through K13 itself: x with the
    columns of one partial sum of the plan zeroed, which is the product
    with that partial dropped: the last cluster rank's k range where the
    plan splits K across a cluster, else the chunks (64 k each) that the
    last k group of a block sums (every 8th chunk in q8_stripes, every 4th
    in q8_persist). -> (x with those columns zeroed, the fault's name)."""
    from haloop_tpu_torch.ops import q8_matmul_cuda
    M, K = x.shape
    kind, _, cl, kr = q8_matmul_cuda.plan(M, w_q.shape[0], K, K % 16 == 0,
                                          sms)
    bad = x.clone()
    if cl > 1:
        bad[:, (cl - 1) * kr:] = 0
        return bad, f"cluster rank {cl - 1}'s partial dropped"
    groups = 8 if kind == 0 else 4
    for ch in range(groups - 1, -(-K // 64), groups):
        bad[:, ch * 64:(ch + 1) * 64] = 0
    return bad, f"k group {groups - 1}'s partial dropped"


def phase_q8(torch, dev):
    """K13 on GPT-2 small's five int8 weights at a decode step's M=32 and
    M=1 (bf16 x, bf16 scales, as ``--q8`` serves them), a ragged (1000,
    777) weight, and fp32 x at one shape; at each bf16 shape a planted
    fault (k13_dropped_slice) that must fail DECODE_TOL. Beside the times,
    the floor of a launch: an empty kernel, and K13 on a (16, 768)
    weight."""
    from haloop_tpu_torch import kernels, quant
    from haloop_tpu_torch.ops import q8_matmul, q8_matmul_cuda
    reports = {}
    step_ms = {}
    sms = kernels.multiprocessors(dev)
    shapes = [(name, N, K, M) for M in (32, 1)
              for name, N, K, _ in Q8_WEIGHTS] + [("ragged", 1000, 777, 32)]
    for name, N, K, M in shapes:
        g = torch.Generator().manual_seed(N + K + M)
        w_q, scale = quant.quantize_weight(torch.randn((N, K), generator=g)
                                           * 0.02)
        w_q, scale = w_q.to(dev), scale.to(dev, torch.bfloat16)
        x = torch.randn((M, K), generator=g).to(dev, torch.bfloat16)
        y = q8_matmul_cuda.q8_matmul_cuda(x, w_q, scale)
        torch.cuda.synchronize()
        want = q8_matmul.q8_matmul(x, w_q, scale)
        ok, err = close(y.float(), want.float(), DECODE_TOL)
        same = torch.equal(y, q8_matmul_cuda.q8_matmul_cuda(x, w_q, scale))
        what = f"{name} ({N}, {K}) M={M}"
        print(f"K13 q8_matmul {what} bf16: max|dy|={err:.3e} against the "
              f"plain q8_matmul (tol {DECODE_TOL}); the same bits twice: "
              f"{same}", flush=True)
        check(ok and same, f"K13 disagrees with q8_matmul at {what}")
        bad, fault = k13_dropped_slice(torch, x, w_q, sms)
        ok_f, err_f = close(q8_matmul_cuda.q8_matmul_cuda(bad, w_q, scale)
                            .float(), want.float(), DECODE_TOL)
        print(f"K13 q8_matmul {what}: planted fault ({fault}) "
              f"max|dy|={err_f:.3e}, beyond the tolerance {not ok_f}",
              flush=True)
        check(not ok_f, f"DECODE_TOL does not catch K13's planted fault at "
                        f"{what}")
        w_deq = w_q.to(torch.bfloat16) * scale[:, None]
        ms = cuda_ms(lambda: q8_matmul_cuda.q8_matmul_cuda(x, w_q, scale))
        plain_ms = cuda_ms(lambda: q8_matmul.q8_matmul(x, w_q, scale))
        lib_ms = cuda_ms(lambda: x @ w_deq.T)
        b_ms, b_by = bound(N * K + 2 * N + 2 * M * K + 2 * M * N,
                           2.0 * M * N * K)
        print(f"K13 q8_matmul {what}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, x @ w_deq.T (cuBLAS, bf16 weight) "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        reports[what] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        step_ms[(name, M)] = (ms, lib_ms, b_ms)
    for M in (32, 1):
        k, lib, b = (sum(n * step_ms[(name, M)][i]
                         for name, _, _, n in Q8_WEIGHTS) for i in range(3))
        print(f"K13 over one GPT-2 small decode step at M={M} (12 x 4 "
              f"linears + lm_head, each timed alone): kernels {k:.4f} ms, "
              f"x @ w_deq.T {lib:.4f} ms, bound {b:.5f} ms", flush=True)
    floor = cuda_ms(lambda: q8_matmul_cuda.empty_kernel(dev))
    w16, s16 = quant.quantize_weight(torch.randn((16, 768), device=dev)
                                     * 0.02)
    s16 = s16.to(torch.bfloat16)
    x16 = {M: torch.ones((M, 768), device=dev, dtype=torch.bfloat16)
           for M in (32, 1)}
    small = {M: cuda_ms(lambda: q8_matmul_cuda.q8_matmul_cuda(x16[M], w16,
                                                              s16))
             for M in (32, 1)}
    print(f"the floor of a launch: an empty kernel {floor:.4f} ms; K13 on a "
          f"(16, 768) weight {small[32]:.4f} ms at M=32, {small[1]:.4f} ms "
          f"at M=1 (cuda_ms)", flush=True)
    x, w_q, scale = (torch.randn((32, 3072), device=dev),
                     *quant.quantize_weight(torch.randn((768, 3072),
                                                        device=dev) * 0.02))
    y = q8_matmul_cuda.q8_matmul_cuda(x, w_q, scale)
    want = q8_matmul.q8_matmul(x, w_q, scale)
    rel = ((y - want).abs().max() / want.abs().max()).item()
    print(f"K13 q8_matmul fp32 x (768, 3072) M=32: max|dy| / max|y| = "
          f"{rel:.3e} (tol 1e-5)", flush=True)
    check(rel <= 1e-5, "K13 in fp32 disagrees with q8_matmul")
    lm = "lm_head (50304, 768) M=32"
    return dict(reports[lm], by_shape={k: v for k, v in reports.items()
                                       if k != lm})


# the GPT checkpoints the phases read: arch and hai's --seed (gpt-nano
# keeps hai's default)
HAI_RUNS = (("decoder", "0"), ("decoder:50304:4096", "0"),
            ("gpt-nano:300:64", None))


@contextlib.contextmanager
def hai_checkpoints(tmp):
    """Random checkpoints from ``python -m haloop_tpu_torch.init [--seed
    0] <arch>``, written by subprocesses started at once, which run on
    the host's cores beside the kernel phases. Yields ``wait(arch)`` ->
    the arch's best.pt; a process still running at the end is killed."""
    procs = {}
    for arch, seed in HAI_RUNS:
        out = Path(tmp) / arch.replace(":", "_")
        log = Path(tmp) / f"hai_{out.name}.log"
        with open(log, "w") as f:
            procs[arch] = (subprocess.Popen(
                [sys.executable, "-m", "haloop_tpu_torch.init",
                 *(["--seed", seed] if seed else []), arch, str(out)],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT),
                out, log, time.perf_counter())

    def wait(arch):
        proc, out, log, t0 = procs[arch]
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, f"hai {arch} failed: {log.read_text()[-2000:]}")
        check((out / "best.pt").exists(), f"hai {arch} wrote no best.pt")
        print(f"python -m haloop_tpu_torch.init {arch}: {out / 'best.pt'}, "
              f"{time.perf_counter() - t0:.1f} s after its start",
              flush=True)
        return out / "best.pt"
    try:
        yield wait
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def teacher_forced(torch, cfg, params, ids, lens, toks, plain=False,
                   mask_padding=True):
    """(per-step logits (B, new, V) in fp32, the caches) of a prefill of
    ``ids`` (left-padded to ``lens`` when given) and ``new - 1`` steps fed
    ``toks``, a kernel path's greedy tokens; on the plain path with
    ``plain``; with the left padding attended (a planted fault) without
    ``mask_padding``."""
    from haloop_tpu_torch.models import gpt as G
    B, width = ids.shape
    new = toks.shape[1]
    dev = ids.device
    cache = G.init_cache(cfg, B, dtype=G.param_dtype(params),
                         size=G.cache_len_for(cfg, width, new), device=dev)
    pos = None
    if lens is not None:
        starts = (width - lens).to(torch.int32)
        if mask_padding:
            cache = [dict(c, starts=starts) for c in cache]
        pos = (torch.arange(width, device=dev)[None] -
               starts[:, None]).clamp(min=0)
    out = []
    with plain_kernels() if plain else contextlib.nullcontext(), \
            torch.inference_mode():
        lg, cache = G.forward(params, cfg, ids, past=cache, positions=pos)
        for i in range(new - 1):
            out.append(lg[:, -1].float())
            if lens is not None:
                pos = (cache[0]["length"] - starts)[:, None]
            lg, cache = G.forward(params, cfg, toks[:, i:i + 1], past=cache,
                                  positions=pos)
        out.append(lg[:, -1].float())
    return torch.stack(out, 1), cache


def max_dlogit(a, b):
    """max over the steps of max |dlogit|"""
    return (a - b).abs().amax().item()


def nll_gate(a, b, valid):
    """(max, mean) per-token |NLL difference| over the real tokens, and
    whether GPT_NLL_TOL passes it."""
    d = (a - b).abs()[valid]
    mx, mean = d.max().item(), d.mean().item()
    return mx, mean, mx <= GPT_NLL_TOL["max"] and mean <= GPT_NLL_TOL["mean"]


def nll_against_plain(score, score_fp32, score_fault, valid, what):
    """The per-token NLL gate, kernel path against plain path on the same
    batch, beside two readings that place its limits: the plain path in
    bf16 against the plain path in fp32 (how far rounding alone moves
    the NLLs), and, where ``score_fault`` is given, the plain path with a
    planted fault against the sound plain path (what the gate must
    catch)."""
    k = score()
    with plain_kernels():
        p, p32 = score(), score_fp32()
        fault = score_fault() if score_fault else None
    mx, mean, ok = nll_gate(k, p, valid)
    rmx, rmean, _ = nll_gate(p, p32, valid)
    print(f"{what}: per-token NLL, kernel path against plain path on the "
          f"same batch: max|d|={mx:.3e} mean|d|={mean:.3e} (tol "
          f"{GPT_NLL_TOL}); plain bf16 against plain fp32: max|d|="
          f"{rmx:.3e} mean|d|={rmean:.3e}; mean NLL "
          f"{k[valid].mean().item():.4f}", flush=True)
    if fault is not None:
        fmx, fmean, caught = nll_gate(fault, p, valid)
        caught = not caught
        print(f"{what}: planted fault (the segment mask dropped, positions "
              f"kept) against the sound plain path: max|d|={fmx:.3e} "
              f"mean|d|={fmean:.3e}; the gate catches it: {caught}",
              flush=True)
        check(caught, f"{what}: GPT_NLL_TOL does not catch a dropped "
                      f"segment mask")
    check(ok, f"{what}: the kernel path's NLLs differ from the plain path's")
    return k


def phase_hap(torch, dev, ckpt, card):
    """GPT-2 small scoring: 16 x 1024 packed rows of 64-token segments,
    then 32 x 512 unpacked rows, each with the counts reset just before."""
    import numpy as np
    from haloop_tpu_torch.init import load_model
    from haloop_tpu_torch.models import gpt as G
    from haloop_tpu_torch.params import tree_leaves
    from haloop_tpu_torch.score import cast_params, pack_segments
    spec, params = load_model(ckpt, dev)
    cfg = spec.config
    params32 = params                    # as hai wrote them
    check(G.param_dtype(params32) == torch.float32, "hai wrote no fp32")
    params = cast_params(params, "bfloat16")
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    sents = [rng.integers(1, 50257, 64).tolist() for _ in range(16 * 16)]
    (inp, tgt, pos, seg, _), = list(pack_segments(iter(sents), 1024, 16,
                                                  50256))
    packed = [torch.from_numpy(a).to(dev) for a in (inp, tgt, pos, seg)]
    x = rng.integers(1, 50257, (32, 512)).astype(np.int32)
    unpacked = [torch.from_numpy(a).to(dev) for a in
                (np.concatenate([np.full((32, 1), 50256, np.int32),
                                 x[:, :-1]], 1), x)]
    launches = {}
    for what, batch, expect in (
            ("hap packed 16 x 1024, 64-token segments", packed,
             dict(flash_packed=12, fused_ce=1)),
            ("hap --no-pack 32 x 512", unpacked,
             dict(flash_fwd=12, fused_ce=1))):
        kw = {} if len(batch) == 2 else dict(positions=batch[2],
                                             segment_ids=batch[3])

        @torch.inference_mode()
        def score(p=params, **over):
            return G.forward_all(p, cfg, batch[0], batch[1],
                                 reduction="none", **dict(kw, **over))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        nll = score()
        torch.cuda.synchronize()
        got = counts()
        print(f"GPT-2 small ({n_params} params, bf16) {what}: launches {got}",
              flush=True)
        check_counts(what, got, expect)
        check_ce_route(what, got)
        launches[what] = got
        valid = batch[1] != 0
        check(bool(torch.isfinite(nll).all()) and nll.shape ==
              batch[1].shape, f"{what}: malformed NLLs")
        nll_against_plain(
            score, lambda: score(params32),
            (lambda: score(segment_ids=None)) if kw else None, valid, what)

        def step():
            return score().sum().item()
        sec, times = host_ms(torch, step)
        real = int(valid.sum())
        print(f"{what}: {real / sec * 1e3:.1f} real tokens/s ({real} real "
              f"tokens, {sec:.3f} ms a batch, median of 5; "
              f"{[round(t, 3) for t in times]}) peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
              f"{card}", flush=True)
        profile_step(torch, step, f"one {what} batch")
    return launches


def phase_hat(torch, dev, ckpt, card):
    """GPT-2 small generation, B=32 left-padded and B=1, 128 greedy
    tokens, each with the counts reset just before."""
    import numpy as np
    from haloop_tpu_torch.init import load_model
    from haloop_tpu_torch.models import gpt as G
    from haloop_tpu_torch.score import cast_params
    spec, params = load_model(ckpt, dev)
    cfg = spec.config
    params32 = params                    # as hai wrote them: fp32
    params = cast_params(params, "bfloat16")
    new, width = 128, 32
    rng = np.random.default_rng(1)
    launches = {}
    for B in (32, 1):
        lens = rng.integers(17, width + 1, B) if B > 1 else np.array([width])
        ids = np.zeros((B, width), np.int32)
        for b, n in enumerate(lens):
            ids[b, width - n:] = rng.integers(1, 50257, n)
        ids, lens = torch.from_numpy(ids).to(dev), \
            torch.from_numpy(lens.astype(np.int32)).to(dev)

        @torch.inference_mode()
        def gen():
            return G.generate(params, cfg, ids, new, top_k=1, stop_token=-1,
                              prompt_lengths=lens if B > 1 else None)
        what = f"hat generate B={B}, {width}-token prompts, {new} tokens"
        reset_counts()
        toks, alive = gen()
        torch.cuda.synchronize()
        got = counts()
        print(f"GPT-2 small {what}: launches {got} (12 layers x {new} "
              f"decode steps)", flush=True)
        check_counts(what, got, dict(decode_attn=12 * new))
        launches[what] = got
        check(toks.shape == (B, new) and bool(alive.all()) and
              int(toks.max()) < cfg.vocab_size, f"{what}: malformed tokens")

        # the plain path under teacher forcing of the kernel path's tokens
        def forced_logits(plain, p=params, mask_padding=True):
            return teacher_forced(torch, cfg, p, ids, lens if B > 1 else None,
                                  toks, plain, mask_padding)[0]
        gate = max_dlogit
        k_logits = forced_logits(False)
        check(torch.equal(k_logits.argmax(-1), toks),
              f"{what}: teacher-forced kernel path does not replay its "
              f"tokens")
        p_logits = forced_logits(True)
        sound = gate(k_logits, p_logits)
        del k_logits
        rounding = gate(p_logits, forced_logits(True, params32))
        print(f"{what}: max|dlogit| under teacher forcing over {new} steps, "
              f"kernel path against plain path: {sound:.3e} (tol "
              f"{GPT_LOGIT_TOL}); plain bf16 against plain fp32: "
              f"{rounding:.3e}", flush=True)
        if B > 1:
            fault = gate(forced_logits(True, mask_padding=False), p_logits)
            print(f"{what}: planted fault (the left padding attended: "
                  f"starts dropped) against the sound plain path: "
                  f"{fault:.3e}; the gate catches it: "
                  f"{fault > GPT_LOGIT_TOL}", flush=True)
            check(fault > GPT_LOGIT_TOL, f"{what}: GPT_LOGIT_TOL does not "
                                         f"catch attended left padding")
        del p_logits
        check(sound <= GPT_LOGIT_TOL,
              f"{what}: the kernel path's logits differ from the plain path's")

        def step():
            return gen()[0].sum().item()
        sec, times = host_ms(torch, step, reps=3, warm=False)
        print(f"{what}: {B * new / sec * 1e3:.1f} tokens/s (aggregate over "
              f"{B} streams; {sec:.1f} ms a call, median of 3; "
              f"{[round(t, 1) for t in times]}) on {card}", flush=True)
        _, by_name = profile_step(torch, step, f"one {what} call")
        total = sum(t for _, t in by_name.values())
        k11 = sum(t for name, (_, t) in by_name.items()
                  if "decode<" in name or "decode_tc<" in name)
        print(f"{what}: K11 {k11 / 1e6:.3f} ms of the call's "
              f"{total / 1e6:.3f} ms of kernel time "
              f"({100 * k11 / max(total, 1):.1f}%)", flush=True)
    return launches


def phase_gpt_entry(torch, tmp, nano_ckpt, decoder_ckpt):
    """hap and hat through their entry points on gpt-nano:300:64 and on
    decoder (checkpoints from hai), each run with the counts reset just
    before it."""
    from haloop_tpu_torch import repl, score
    corpus = ("hello world\nthe quick brown fox jumps over the lazy dog\n"
              "hi\na considerably longer sentence that lands in a wider "
              "bucket\nshort\n")
    prompts = Path(tmp) / "prompts.txt"
    prompts.write_text("hello\nsome other prompt\nx\n")
    paths = {}
    for arch, ckpt in (("gpt-nano:300:64", nano_ckpt),
                       ("decoder", decoder_ckpt)):
        big = arch == "decoder"
        layers = 12 if big else 2
        runs = (
            ("hap --bytes", score.main, ["--bytes", str(ckpt)], corpus,
             dict(flash_packed=12, fused_ce=1) if big else {}),
            ("hap --bytes --q8", score.main, ["--bytes", "--q8", str(ckpt)],
             corpus, dict(flash_packed=12, fused_ce=1) if big else {}),
            # 3 prompts of at most 18 tokens: the prefill's 54 rows and
            # each of the 16 steps run every linear and lm_head on K13
            ("hat --bytes --q8 --batch --steps 16", repl.main,
             ["--bytes", "--q8", "--batch", str(prompts), "--steps", "16",
              str(ckpt)], "", dict(decode_attn=layers * 16,
                                   q8_matmul=17 * (4 * layers + 1))),
            ("hap --bytes --no-pack", score.main,
             ["--bytes", "--no-pack", str(ckpt)], corpus,
             dict(fused_ce=1) if big else {}),
            ("hat --bytes --batch --steps 16", repl.main,
             ["--bytes", "--batch", str(prompts), "--steps", "16",
              str(ckpt)], "", dict(decode_attn=12 * 16 if big else 2 * 16)),
            ("hat --bytes (two piped prompts)", repl.main,
             ["--bytes", "--steps", "8", "--histfile",
              str(Path(tmp) / "hist"), str(ckpt)], "hello\nworld\n", None),
        )
        for what, main, argv, stdin, expect in runs:
            reset_counts()
            t0 = time.perf_counter()
            out, err = run_main(main, argv, stdin)
            torch.cuda.synchronize()
            got = counts()
            lines = out.strip("\n").split("\n")
            print(f"{arch} {what} ({time.perf_counter() - t0:.1f} s): "
                  f"launches {got}; output {lines[:3]}", flush=True)
            if what.startswith("hap"):
                check(len(lines) == 5 and all(
                    len(ln.split("\t")) == 3 for ln in lines),
                    f"{arch} {what}: not one 3-column row per line")
            elif "--batch" in what:
                check(len(lines) == 3, f"{arch} {what}: not 3 completions")
            else:
                check(out.count(">- ") == 3, f"{arch} {what}: not two "
                      f"prompts answered")
                # each of the 8 streamed tokens of each of the 2 prompts is
                # fed back through one decode step: one K11 launch a layer
                # (the seeded weights sample no end-of-text here)
                expect = dict(decode_attn=(12 if big else 2) * 8 * 2)
            check_counts(f"{arch} {what}", got, expect)
            paths[f"{arch} {what}"] = got
    return paths


@contextlib.contextmanager
def k12_split_skipped():
    """K12 launched with a planted fault: each row's first attended split
    of K12's plan skipped (starts raised past it)."""
    import torch
    from haloop_tpu_torch.ops import decode_attn_cuda as dac
    real = dac.decode_attn_split_cuda

    def faulty(q, k_new, v_new, k_cache, v_cache, length, starts=None, *,
               n_head):
        B, _, E = k_cache.shape
        rows = dac.split_rows(B, n_head, int(length) + 1, E // n_head,
                              k_cache.element_size(),
                              dac.multiprocessors(k_cache.device))
        first = starts.long() if starts is not None else \
            torch.zeros(B, dtype=torch.long, device=k_cache.device)
        return real(q, k_new, v_new, k_cache, v_cache, length,
                    (first // rows + 1) * rows, n_head=n_head)
    dac.decode_attn_split_cuda = faulty
    try:
        yield
    finally:
        dac.decode_attn_split_cuda = real


def phase_hat_long(torch, dev, tmp, ckpt, card):
    """GPT-2 small widths with a 4096-token block (decoder:50304:4096,
    random weights from hai, bf16): generate 128 greedy tokens after
    3456-token prompts, at B=8 (left-padded) and B=1. The cache holds
    3,584 rows, 10.5 MiB of k and v a row: every decode step takes K12.
    Then hat --batch through its entry point on two 3456-byte prompts."""
    import numpy as np
    from haloop_tpu_torch import repl
    from haloop_tpu_torch.init import load_model
    from haloop_tpu_torch.models import gpt as G
    from haloop_tpu_torch.ops import decode_attn_cuda
    from haloop_tpu_torch.score import cast_params
    spec, params = load_model(ckpt, dev)
    cfg = spec.config
    params = cast_params(params, "bfloat16")
    new, width = 128, 3456
    S = G.cache_len_for(cfg, width, new)
    check(decode_attn_cuda.route(S, cfg.n_embd, 2) is
          decode_attn_cuda.decode_attend_update_gridded,
          f"a {S}-row cache does not route to K12")
    rng = np.random.default_rng(3)
    launches = {}
    for B in (8, 1):
        lens = rng.integers(width - 512, width + 1, B)
        lens[0] = width
        ids = np.zeros((B, width), np.int32)
        for b, n in enumerate(lens):
            ids[b, width - n:] = rng.integers(1, 50257, n)
        ids = torch.from_numpy(ids).to(dev)
        lens = torch.from_numpy(lens.astype(np.int32)).to(dev) \
            if B > 1 else None

        @torch.inference_mode()
        def gen():
            return G.generate(params, cfg, ids, new, top_k=1, stop_token=-1,
                              prompt_lengths=lens)
        what = (f"hat generate decoder:50304:4096 B={B}, {width}-token "
                f"prompts, {new} tokens, a {S}-row cache")
        reset_counts()
        toks, alive = gen()
        torch.cuda.synchronize()
        got = counts()
        print(f"{what}: launches {got}", flush=True)
        check_counts(what, got, dict(decode_attn_split=cfg.n_layer * new))
        launches[what] = got
        check(toks.shape == (B, new) and bool(alive.all()) and
              int(toks.max()) < cfg.vocab_size, f"{what}: malformed tokens")
        k_logits, k_cache = teacher_forced(torch, cfg, params, ids, lens,
                                           toks)
        check(torch.equal(k_logits.argmax(-1), toks),
              f"{what}: teacher-forced kernel path does not replay its "
              f"tokens")
        p_logits, p_cache = teacher_forced(torch, cfg, params, ids, lens,
                                           toks, plain=True)
        sound = max_dlogit(k_logits, p_logits)
        # layer 0's rows come from the embeddings alone: the same bits on
        # both paths, wherever each step wrote its new row
        rows = all(torch.equal(k_cache[0][n], p_cache[0][n])
                   for n in ("k", "v"))
        print(f"{what}: max|dlogit| under teacher forcing, kernel path "
              f"against plain path: {sound:.3e} (tol {LONG_LOGIT_TOL}); "
              f"layer 0's caches equal: {rows}", flush=True)
        check(sound <= LONG_LOGIT_TOL and rows,
              f"{what}: the kernel path differs from the plain path")
        del k_logits, k_cache, p_cache
        if B > 1:
            read = {}
            with k12_split_skipped():
                f_logits, _ = teacher_forced(torch, cfg, params, ids, lens,
                                             toks)
            read["the first attended split skipped"] = \
                max_dlogit(f_logits, p_logits)
            f_logits, _ = teacher_forced(torch, cfg, params, ids, lens, toks,
                                         mask_padding=False)
            read["the left padding attended (starts dropped)"] = \
                max_dlogit(f_logits, p_logits)
            del f_logits
            print(f"{what}: planted K12 faults against the plain path, max|"
                  f"dlogit| under teacher forcing: " + ", ".join(
                      f"{n} {r:.3e}" for n, r in read.items()) +
                  f"; each must exceed {LONG_LOGIT_TOL}", flush=True)
            check(min(read.values()) > LONG_LOGIT_TOL,
                  f"{what}: LONG_LOGIT_TOL does not catch a planted fault")
        del p_logits

        def step():
            return gen()[0].sum().item()
        sec, times = host_ms(torch, step, reps=3, warm=False)
        print(f"{what}: {B * new / sec * 1e3:.1f} tokens/s ({sec:.1f} ms a "
              f"call, median of 3; {[round(t, 1) for t in times]}) peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
              f"GiB on {card}", flush=True)
    del params
    prompts = Path(tmp) / "long_prompts.txt"
    prompts.write_text("".join(
        "".join(chr(c) for c in rng.integers(97, 123, width)) + "\n"
        for _ in range(2)))
    what = "decoder:50304:4096 hat --bytes --batch --steps 16, 3456 bytes"
    reset_counts()
    out, _ = run_main(repl.main, ["--bytes", "--batch", str(prompts),
                                  "--steps", "16", str(ckpt)])
    torch.cuda.synchronize()
    got = counts()
    print(f"{what}: launches {got}; {len(out.splitlines())} completions",
          flush=True)
    check(len(out.strip("\n").split("\n")) == 2, f"{what}: not 2 "
                                                  f"completions")
    check_counts(what, got, dict(decode_attn_split=cfg.n_layer * 16))
    launches[what] = got
    return launches


def q8_launches(cfg, B, T, new):
    """K13 launches of ``generate`` at batch B, prompt width T: the
    prefill's 4 linears a layer where B T <= 64 rows and its lm_head on
    the last position, then 4 linears a layer and lm_head a step."""
    from haloop_tpu_torch.ops.q8_matmul import MAX_ROWS
    per = 4 * cfg.n_layer
    if B > MAX_ROWS:
        return 0
    return (per if B * T <= MAX_ROWS else 0) + 1 + new * (per + 1)


def scaled_qscales(tree, factor):
    """A planted fault: every quantized linear's qscale times ``factor``."""
    if isinstance(tree, dict):
        if "qscale" in tree:
            return dict(tree, qscale=tree["qscale"] * factor)
        return {k: scaled_qscales(v, factor) for k, v in tree.items()}
    if isinstance(tree, list):
        return [scaled_qscales(v, factor) for v in tree]
    return tree


def phase_q8_serving(torch, dev, ckpt, card):
    """GPT-2 small with int8 weights (``--q8``: quantize_gpt_params, then
    the bf16 cast): hap on 16 x 1024 packed rows (K7, K10 on the once
    dequantized lm_head, no K13) and generate at B=32 (left-padded) and
    B=1, 128 greedy tokens (K13 for every linear of a decode step, K11),
    counts reset just before each. The kernel path against the plain
    path; the q8 path against the bf16 one, with limits between the
    quantization error and a planted fault (every qscale doubled)."""
    import numpy as np
    from haloop_tpu_torch.init import load_model
    from haloop_tpu_torch.models import gpt as G
    from haloop_tpu_torch.quant import quantize_gpt_params
    from haloop_tpu_torch.score import cast_params, pack_segments
    spec, params32 = load_model(ckpt, dev)
    cfg = spec.config
    q8_32 = quantize_gpt_params(params32)
    trees = {"bf16": cast_params(params32, "bfloat16"),
             "q8": cast_params(q8_32, "bfloat16"),
             "fault": cast_params(scaled_qscales(q8_32, 2.0), "bfloat16")}
    del params32, q8_32
    q8 = trees["q8"]
    check(q8["lm_head"]["weight"].dtype == torch.int8 and
          G.param_dtype(q8) == torch.bfloat16, "--q8 tree malformed")
    launches = {}

    rng = np.random.default_rng(0)
    sents = [rng.integers(1, 50257, 64).tolist() for _ in range(16 * 16)]
    (inp, tgt, pos, seg, _), = list(pack_segments(iter(sents), 1024, 16,
                                                  50256))
    inp, tgt, pos, seg = (torch.from_numpy(a).to(dev)
                          for a in (inp, tgt, pos, seg))
    valid = tgt != 0

    @torch.inference_mode()
    def score(name="q8"):
        return G.forward_all(trees[name], cfg, inp, tgt, reduction="none",
                             positions=pos, segment_ids=seg)
    what = "hap --q8 packed 16 x 1024, 64-token segments"
    reset_counts()
    nll = score()
    torch.cuda.synchronize()
    got = counts()
    print(f"{what}: launches {got}", flush=True)
    check_counts(what, got, dict(flash_packed=cfg.n_layer, fused_ce=1))
    check_ce_route(what, got)
    launches[what] = got
    check(bool(torch.isfinite(nll).all()), f"{what}: malformed NLLs")
    with plain_kernels():
        plain = score()
    mx, mean, ok = nll_gate(nll, plain, valid)
    dq = (nll - score("bf16")).abs()[valid]
    df = (score("fault") - score("bf16")).abs()[valid]
    print(f"{what}: per-token NLL, kernel path against plain path: max|d|="
          f"{mx:.3e} mean|d|={mean:.3e} (tol {GPT_NLL_TOL}); q8 against "
          f"bf16 (the quantization error): max|d|={dq.max().item():.3e} "
          f"mean|d|={dq.mean().item():.3e}; the planted fault (qscales "
          f"doubled) against bf16: max|d|={df.max().item():.3e} mean|d|="
          f"{df.mean().item():.3e} (limit mean {Q8_NLL_TOL})", flush=True)
    check(ok, f"{what}: the kernel path's NLLs differ from the plain path's")
    check(dq.mean().item() <= Q8_NLL_TOL < df.mean().item(),
          f"{what}: Q8_NLL_TOL does not part the quantization error from "
          f"the planted fault")
    sec, times = host_ms(torch, lambda: score().sum().item(), reps=3)
    real = int(valid.sum())
    print(f"{what}: {real / sec * 1e3:.1f} real tokens/s ({sec:.3f} ms a "
          f"batch, median of 3; {[round(t, 3) for t in times]}) on {card}",
          flush=True)

    new, width = 128, 32
    rng = np.random.default_rng(1)
    for B in (32, 1):
        lens = rng.integers(17, width + 1, B) if B > 1 else np.array([width])
        ids = np.zeros((B, width), np.int32)
        for b, n in enumerate(lens):
            ids[b, width - n:] = rng.integers(1, 50257, n)
        ids = torch.from_numpy(ids).to(dev)
        lens = torch.from_numpy(lens.astype(np.int32)).to(dev) \
            if B > 1 else None

        @torch.inference_mode()
        def gen():
            return G.generate(q8, cfg, ids, new, top_k=1, stop_token=-1,
                              prompt_lengths=lens)
        what = f"hat --q8 generate B={B}, {width}-token prompts, {new} tokens"
        reset_counts()
        toks, alive = gen()
        torch.cuda.synchronize()
        got = counts()
        expect = dict(decode_attn=cfg.n_layer * new,
                      q8_matmul=q8_launches(cfg, B, width, new))
        print(f"{what}: launches {got} (expected {expect})", flush=True)
        check_counts(what, got, expect)
        launches[what] = got
        check(toks.shape == (B, new) and bool(alive.all()) and
              int(toks.max()) < cfg.vocab_size, f"{what}: malformed tokens")

        def forced(name="q8", plain=False):
            return teacher_forced(torch, cfg, trees[name], ids, lens, toks,
                                  plain)[0]
        k_logits = forced()
        check(torch.equal(k_logits.argmax(-1), toks),
              f"{what}: teacher-forced kernel path does not replay its "
              f"tokens")
        sound = max_dlogit(k_logits, forced(plain=True))
        ref = forced("bf16")
        quant_err = max_dlogit(k_logits, ref)
        del k_logits
        fault = max_dlogit(forced("fault"), ref)
        del ref
        print(f"{what}: max|dlogit| under teacher forcing, kernel path "
              f"against plain path: {sound:.3e} (tol {GPT_LOGIT_TOL}); q8 "
              f"against bf16: {quant_err:.3e}; the planted fault (qscales "
              f"doubled) against bf16: {fault:.3e} (limit {Q8_LOGIT_TOL})",
              flush=True)
        check(sound <= GPT_LOGIT_TOL,
              f"{what}: the kernel path's logits differ from the plain "
              f"path's")
        check(quant_err <= Q8_LOGIT_TOL < fault,
              f"{what}: Q8_LOGIT_TOL does not part the quantization error "
              f"from the planted fault")
        sec, times = host_ms(torch, lambda: gen()[0].sum().item(),
                             reps=3, warm=False)
        print(f"{what}: {B * new / sec * 1e3:.1f} tokens/s ({sec:.1f} ms a "
              f"call, median of 3; {[round(t, 1) for t in times]}) on "
              f"{card}", flush=True)
        if B == 1:
            profile_step(torch, gen, f"one {what} call")
    return launches


def k6_bound(q, kv_pairs, itemsize, products):
    """(ms, by) of K6a (3 products a pair) or K6b (4). Bytes: six (N, H,
    T, D) tensors, each read or written once (K6a reads q, k, v, o, do
    and writes dq; K6b reads q, k, v, do and writes dk, dv), and the fp32
    lse and delta; operations over the (query, key) pairs the masks
    leave."""
    N, H, T, D = q.shape
    nbytes = 6 * N * H * T * D * itemsize + 2 * 4 * N * H * T
    flops = 2.0 * products * kv_pairs * H * D
    elem = K6_ELEM * kv_pairs * H
    if itemsize == 2:
        return bound(nbytes, flops, elem)
    return bound(nbytes, 0, flops + elem)


def grad_gate(a, b, top):
    """(max |a - b| over b's largest, mean |a - b| over b's mean)."""
    err = (a.float() - b.float()).abs()
    return err.max().item() / top, \
        err.mean().item() / b.float().abs().mean().item()


def k6_gate(got, want, name):
    """K6_TOL[name] on (dq, dk, dv) -> (ok, {grad: (max |d| over the
    largest, mean |d| over the mean, the largest)})."""
    tol, reads = K6_TOL[name], {}
    for tag, a, b in zip(("dq", "dk", "dv"), got, want):
        top = b.float().abs().max().item()
        reads[tag] = grad_gate(a, b, top) + (top,)
    ok = all(rmax <= tol["max"] and rmean <= tol.get("mean", 1.0)
             for rmax, rmean, _ in reads.values())
    return ok, reads


def k6_faults(torch, flash, got, args, ragged):
    """The K6 check's planted fault, emulated from the plain version,
    against the kernels' (dq, dk, dv) ``got`` on the causal ``args``: the
    causal diagonal off by one (``_backward_reference`` at t0 + 1) or,
    where the key lengths are ``ragged``, the last partial key tile
    dropped (each length rounded down to the bf16 kernels' 128-key tile).
    It must read beyond K6_TOL: the limit sits between rounding and the
    design's likely errors. Raises if the gate would pass it."""
    q, k, v, kvl, causal, t0, o, lse, do = args
    if ragged:
        name = "last partial key tile dropped"
        want = flash._backward_reference(
            q, k, v, torch.div(kvl, 128, rounding_mode="floor") * 128,
            causal, t0, o, lse, do)
    else:
        name = "diagonal off by one"
        want = flash._backward_reference(q, k, v, kvl, causal, t0 + 1, o,
                                         lse, do)
    ok, reads = k6_gate(got, want, "bfloat16")
    print(f"  planted fault, {name}: " + ", ".join(
        f"{tag} max|d| {rmax:.3e} mean {rmean:.3e}"
        for tag, (rmax, rmean, _) in reads.items()) +
        " (the gate must fail)", flush=True)
    check(not ok, f"K6's check passes a planted fault: {name}")


def phase_flash_bwd(torch, dev):
    """K6a/K6b at hala's (8, 12, 1024, 64) causal bf16 and fp32 at N=2,
    against the plain backward on K5's o and lse; in bf16 also at ragged
    key lengths, with two planted faults (``k6_faults``); K5 with its lse
    at the same shape."""
    import torch.nn.functional as F
    from haloop_tpu_torch.ops import flash, flash_cuda
    H, T, D = 12, 1024, 64
    dq_r, dkv_r, lse_r = {}, {}, {}
    for name, N in (("bfloat16", 8), ("float32", 2)):
        dtype = getattr(torch, name)
        q, k, v = qkv_views(torch, dev, N, H, T, D, dtype, 21)
        kvl = torch.full((N,), T, dtype=torch.int32, device=dev)
        pairs = N * T * (T + 1) // 2
        o, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0,
                                           with_lse=True)
        g = torch.Generator().manual_seed(22)
        do = torch.randn((N, T, H * D), generator=g).to(dev, dtype) \
            .reshape(N, T, H, D).transpose(1, 2)      # the GPT's layout
        args = (q, k, v, kvl, True, 0, o, lse, do)
        got = flash_cuda.flash_bwd_cuda(*args)
        torch.cuda.synchronize()
        ok, reads = k6_gate(got, flash._backward_reference(*args), name)
        errs = {tag: rmax * top for tag, (rmax, _, top) in reads.items()}
        for tag, (rmax, rmean, top) in reads.items():
            print(f"K6 {tag} ({N}, {H}, {T}, {D}) causal {name}: max|d| "
                  f"{rmax:.3e} of the largest ({top:.3e}), mean|d| "
                  f"{rmean:.3e} of the mean (tol {K6_TOL[name]})",
                  flush=True)
        check(ok, f"K6 disagrees with _backward_reference at "
                  f"{(N, H, T, D, name)}")
        again = flash_cuda.flash_bwd_cuda(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "K6a/K6b are not deterministic")
        if name == "bfloat16":
            k6_faults(torch, flash, got, args, ragged=False)
            # ragged key lengths: the last partial key tiles
            kvr = torch.tensor(K6_RAGGED, dtype=torch.int32, device=dev)
            o_g, lse_g = flash_cuda.flash_fwd_cuda(q, k, v, kvr, True, 0,
                                                   with_lse=True)
            args_r = (q, k, v, kvr, True, 0, o_g, lse_g, do)
            got_r = flash_cuda.flash_bwd_cuda(*args_r)
            torch.cuda.synchronize()
            ok, reads = k6_gate(got_r, flash._backward_reference(*args_r),
                                name)
            print(f"K6 ({N}, {H}, {T}, {D}) causal {name}, key lengths "
                  f"{K6_RAGGED}: " + ", ".join(
                      f"{tag} max|d| {rmax:.3e} mean {rmean:.3e}"
                      for tag, (rmax, rmean, _) in reads.items()) +
                  f" (tol {K6_TOL[name]})", flush=True)
            check(ok, "K6 disagrees with _backward_reference at ragged key "
                      "lengths")
            k6_faults(torch, flash, got_r, args_r, ragged=True)
            del got_r, o_g, lse_g, args_r
        del got, again
        # K6a and K6b timed apart through the wrapper's private stages
        b = flash_cuda._bwd_args(*args)
        flash_cuda._bwd_dq(b)                 # the scratch that K6b reads
        dq_ms = cuda_ms(lambda: flash_cuda._bwd_dq(b))
        dkv_ms = cuda_ms(lambda: flash_cuda._bwd_dkv(b))
        plain_ms = cuda_ms(lambda: flash._backward_reference(*args))
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
        del out, ql, kl, vl
        key = f"{N}x{H}x{T}x{D} {name}"
        for report, kind, ms, products, err in (
                (dq_r, "K6a dq", dq_ms, 3, errs["dq"]),
                (dkv_r, "K6b dk, dv", dkv_ms, 4, max(errs["dk"],
                                                     errs["dv"]))):
            b_ms, b_by = k6_bound(q, pairs, q.element_size(), products)
            print(f"{kind} ({N}, {H}, {T}, {D}) causal {name}: kernel "
                  f"{ms:.4f} ms, plain backward (dq, dk, dv) {plain_ms:.3f} "
                  f"ms, SDPA(is_causal) backward (dq, dk, dv) {lib_ms:.3f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
            report[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               library_ms=lib_ms)

        # K5 with its lse, as hala's forward runs it
        fwd = lambda: flash_cuda.flash_fwd_cuda(q, k, v, kvl, True, 0,
                                                with_lse=True)
        o_e, lse_e = flash._reference(q, k, v, kvl, True, 0, with_lse=True)
        ok, err, mean = within(torch, o, o_e, ATTN_TOL[name])
        lse_err = (lse - lse_e).abs().max().item()
        ms = cuda_ms(fwd)
        p_ms = cuda_ms(lambda: flash._reference(q, k, v, kvl, True, 0,
                                                with_lse=True))
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        itemsize = q.element_size()
        nbytes = 4 * N * H * T * D * itemsize + 4 * N * H * T
        flops = 4.0 * pairs * H * D
        b_ms, b_by = bound(nbytes, flops, ATTN_ELEM * pairs * H) \
            if itemsize == 2 else bound(nbytes, 0,
                                        flops + ATTN_ELEM * pairs * H)
        print(f"K5 with lse ({N}, {H}, {T}, {D}) causal {name}: max|do|="
              f"{err:.3e} mean {mean:.3e}, max|dlse| {lse_err:.3e}; kernel "
              f"{ms:.4f} ms, plain {p_ms:.3f} ms, SDPA(is_causal) "
              f"{l_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        check(ok and lse_err <= 1e-3, f"K5's lse path disagrees at {key}")
        if name == "bfloat16":
            flash_faults(torch, flash, o, q, k, v, kvl, 0, ragged=False)
        lse_r[key] = dict(max_abs_err=max(err, lse_err), ms=ms,
                          plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=l_ms)
    return by_shape(dq_r), by_shape(dkv_r), by_shape(lse_r)


# the e6ctc-d4:512 encoder's attention at bench.py's 24 x 12 s: 1,200
# frames through the conv strides (2, 2, 1) to T' = 300 (the non-causal
# flash floor), 8 heads of 64, bf16, non-causal, full key lengths; the
# last 128-row query tile and 128-key tile are partial
E6_ATTN = (24, 8, 300, 64)
# the kernel path's whole gradient against the plain path's on one bench
# batch of e6ctc-d4:512 (dropout off), as 1 - cos: placed between the
# rounding the run also reads (the plain path in bf16 against fp32) and
# two planted faults it must catch (K6a/K6b's gradients zeroed; the rows
# of the partial last query tile left out of K6). First run (NVIDIA H100):
# kernel against plain 1.0e-5, bf16 against fp32 1.6e-4, K6 zeroed 0.39;
# dq without its 1/sqrt(D) read 4.3e-6, under the kernel's own 1.0e-5 (q's
# gradient is a small share of the whole): not a fault a cosine can see
ATT_GRAD_GAP = 1e-3
# the attention decoder's greedy decode on the card against the same
# decode on the CPU from the same features, of 24 rows: fp32 sums in
# another order may flip an argmax within rounding of a tie
ATT_DECODE_MIN_SAME_ROWS = 21


def e6_flash_faults(torch, flash, q, k, v, kvl):
    """K5's planted faults at E6_ATTN, emulated from the plain version:
    -> {fault: (o, lse)}. The partial last query tile left unwritten (the
    rows from the last 128-row tile's start zero) and the keys past S left
    unmasked (k and v zero-filled to three whole 128-key tiles, the zero
    keys scored as TMA's out-of-bounds fill would be)."""
    import torch.nn.functional as F
    T = q.shape[-2]
    edge, pad = (T // 128) * 128, -(-T // 128) * 128 - T
    o, lse = flash._reference(q, k, v, kvl, False, 0, with_lse=True)
    o[:, :, edge:], lse[:, :, edge:] = 0, 0
    kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
    return {"the partial last query tile left unwritten": (o, lse),
            "the keys past S left unmasked": flash._reference(
                q, kp, vp, kvl + pad, False, 0, with_lse=True) +
            (kp, vp, kvl + pad)}


def e6_k6_fault(flash, fault, args):
    """K6a/K6b's gradients under one of ``e6_flash_faults``' faults, from
    the plain backward: rows past the last tile's start without their dq
    and without their share of dk and dv (do zero there); or every grad
    taken over the zero-filled keys, dk and dv cut back to S."""
    q, k, v, kvl, causal, t0, o, lse, do = args
    T = q.shape[-2]
    if len(fault) == 2:
        edge = (T // 128) * 128
        do = do.clone()
        do[:, :, edge:] = 0
        return flash._backward_reference(q, k, v, kvl, causal, t0, o, lse,
                                         do)
    o_f, lse_f, kp, vp, kvl_p = fault
    dq, dk, dv = flash._backward_reference(q, kp, vp, kvl_p, causal, t0,
                                           o_f, lse_f, do)
    return dq, dk[:, :, :T], dv[:, :, :T]


def phase_e6ctc_kernels(torch, dev):
    """K5, K5-lse, K6a and K6b at E6_ATTN (non-causal, T = S = 300, no
    tile multiple), and K3 and K4 at the e6ctc-d4:512 CTC head's (24, 300,
    512, U = 23: the 24 labels less the prompt token, 47 states), each
    against its plain version, with planted faults that must read beyond
    the limit, times beside plain, library and bound."""
    import torch.nn.functional as F
    from haloop_tpu_torch.models.conv import conv_encoder_subsampled_lengths
    from haloop_tpu_torch.ops import ctc, ctc_cuda, flash, flash_cuda
    N, H, T, D = E6_ATTN
    shape = f"{N}x{H}x{T}x{D} bf16 non-causal (e6ctc-d4:512)"
    q, k, v = qkv_views(torch, dev, N, H, T, D, torch.bfloat16, 31)
    kvl = torch.full((N,), T, dtype=torch.int32, device=dev)
    pairs = N * T * T
    tol = ATTN_TOL["bfloat16"]
    out = {}

    o = flash_cuda.flash_fwd_cuda(q, k, v, kvl, False, 0)
    o_l, lse = flash_cuda.flash_fwd_cuda(q, k, v, kvl, False, 0,
                                         with_lse=True)
    torch.cuda.synchronize()
    o_e, lse_e = flash._reference(q, k, v, kvl, False, 0, with_lse=True)
    faults = e6_flash_faults(torch, flash, q, k, v, kvl)
    nbytes = 4 * N * H * T * D * 2
    for name, got, got_lse in (("K5", o, None), ("K5-lse", o_l, lse)):
        ok, err, mean = within(torch, got, o_e, tol)
        lse_err = 0.0 if got_lse is None else \
            (got_lse - lse_e).abs().max().item()
        with_lse = got_lse is not None
        fwd = lambda: flash_cuda.flash_fwd_cuda(q, k, v, kvl, False, 0,
                                                with_lse=with_lse)
        ms = cuda_ms(fwd)
        p_ms = cuda_ms(lambda: flash._reference(q, k, v, kvl, False, 0,
                                                with_lse=with_lse))
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        b_ms, b_by = bound(nbytes + (4 * N * H * T if with_lse else 0),
                           4.0 * pairs * H * D, ATTN_ELEM * pairs * H)
        print(f"{name} flash ({N}, {H}, {T}, {D}) non-causal bf16, full key "
              f"lengths: max|do|={err:.3e} mean {mean:.3e}, max|dlse| "
              f"{lse_err:.3e} (tol {tol}, lse 1e-3); kernel {ms:.4f} ms, "
              f"plain {p_ms:.3f} ms, SDPA {l_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        check(ok and lse_err <= 1e-3, f"{name} disagrees with _reference "
                                      f"at {shape}")
        for fault, (f_o, f_lse, *_) in faults.items():
            f_ok, f_err, f_mean = within(torch, got, f_o, tol)
            f_lse_err = 0.0 if got_lse is None else \
                (got_lse - f_lse).abs().max().item()
            caught = not (f_ok and f_lse_err <= 1e-3)
            print(f"  planted fault, {fault}: max|do|={f_err:.3e} mean "
                  f"{f_mean:.3e}, max|dlse| {f_lse_err:.3e}; caught: "
                  f"{caught}", flush=True)
            check(caught, f"{name}'s check passes a planted fault: {fault}")
        out[name] = dict(max_abs_err=max(err, lse_err), ms=ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)

    g = torch.Generator().manual_seed(32)
    do = torch.randn((N, T, H * D), generator=g).to(dev, torch.bfloat16) \
        .reshape(N, T, H, D).transpose(1, 2)
    args = (q, k, v, kvl, False, 0, o_l, lse, do)
    got = flash_cuda.flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    ok, reads = k6_gate(got, flash._backward_reference(*args), "bfloat16")
    errs = {tag: rmax * top for tag, (rmax, _, top) in reads.items()}
    print(f"K6 ({N}, {H}, {T}, {D}) non-causal bf16: " + ", ".join(
        f"{tag} max|d| {rmax:.3e} of the largest ({top:.3e}), mean|d| "
        f"{rmean:.3e} of the mean" for tag, (rmax, rmean, top)
        in reads.items()) + f" (tol {K6_TOL['bfloat16']})", flush=True)
    check(ok, f"K6 disagrees with _backward_reference at {shape}")
    check(all(torch.equal(a, b) for a, b in
              zip(got, flash_cuda.flash_bwd_cuda(*args))),
          "K6a/K6b are not deterministic")
    for fault, emulated in faults.items():
        f_ok, f_reads = k6_gate(got, e6_k6_fault(flash, emulated, args),
                                "bfloat16")
        print(f"  planted fault, {fault}: " + ", ".join(
            f"{tag} max|d| {rmax:.3e} mean {rmean:.3e}"
            for tag, (rmax, rmean, _) in f_reads.items()) +
            " (the gate must fail)", flush=True)
        check(not f_ok, f"K6's check passes a planted fault: {fault}")
    del got, faults
    b = flash_cuda._bwd_args(*args)
    flash_cuda._bwd_dq(b)                    # the scratch that K6b reads
    dq_ms = cuda_ms(lambda: flash_cuda._bwd_dq(b))
    dkv_ms = cuda_ms(lambda: flash_cuda._bwd_dkv(b))
    plain_ms = cuda_ms(lambda: flash._backward_reference(*args))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(ql, kl, vl)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, (ql, kl, vl), do,
                                                 retain_graph=True))
    del sdpa, ql, kl, vl
    for name, ms, products, err in (
            ("K6a", dq_ms, 3, errs["dq"]),
            ("K6b", dkv_ms, 4, max(errs["dk"], errs["dv"]))):
        b_ms, b_by = k6_bound(q, pairs, 2, products)
        print(f"{name} ({N}, {H}, {T}, {D}) non-causal bf16: kernel "
              f"{ms:.4f} ms, plain backward (dq, dk, dv) {plain_ms:.3f} ms, "
              f"SDPA backward (dq, dk, dv) {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # K3 and K4 at the CTC head: 0.3x CTC on the encoder's 300 frames
    _, targets, il, tl = bench_arrays(N, 1200, 24, 80)
    g = torch.Generator().manual_seed(33)
    C = 512
    log_probs = torch.log_softmax(torch.randn((T, N, C), generator=g) * 2,
                                  -1).to(dev)
    tg = torch.from_numpy(targets[:, 1:].copy()).to(dev)
    lens = conv_encoder_subsampled_lengths((2, 2, 1), torch.from_numpy(il))
    args = [log_probs, tg, lens.to(dev), torch.from_numpy(tl - 1).to(dev)]
    U = tg.shape[1]
    S = 2 * U + 1
    shape = f"{N}x{T}x{C} U={U} (e6ctc-d4:512's CTC head)"
    loss = ctc_cuda.ctc_fwd_cuda(*args)
    hist, hist2 = (torch.empty((N, T, S), device=dev) for _ in range(2))
    loss_h = ctc_cuda.ctc_fwd_cuda(*args, history=hist)
    ctc_cuda.ctc_fwd_cuda(*args, history=hist2)
    torch.cuda.synchronize()
    ref = ctc.ctc_forward_score(*args)
    rel = ((loss - ref).abs() / ref.abs()).max().item()
    loss_e, hist_e = ctc.ctc_forward_history(*args)
    ok_l, err_l = close(loss, loss_e, CTC_TOL)
    ok_h, err_h = close(hist, hist_e, CTC_HIST_TOL)
    plan = ctc_cuda.fwd_plan(S, C)
    print(f"K3 ctc {shape}, S'={S}, plan {tuple(plan)}: max rel|dloss| "
          f"{rel:.3e} (tol {CTC_REL_TOL}); against ctc_forward_history "
          f"max|dloss| {err_l:.3e}, max|dhist| {err_h:.3e}", flush=True)
    check(rel <= CTC_REL_TOL and ok_l and ok_h and torch.equal(loss, loss_h)
          and torch.equal(hist, hist2), f"K3 disagrees at {shape}")
    ctc_fwd_faults(torch, ctc, plan, args, loss_e, hist_e, warp_edges=False)
    lp, tg_, il_, tl_ = args
    for history in (False, True):
        h = hist if history else None
        ms = cuda_ms(lambda: ctc_cuda.ctc_fwd_cuda(*args, history=h))
        p_ms = cuda_ms((lambda: ctc.ctc_forward_history(*args)) if history
                       else (lambda: ctc.ctc_forward_score(*args)))
        l_ms = cuda_ms(lambda: F.ctc_loss(lp, tg_, il_, tl_,
                                          reduction="none"))
        b_ms, b_by = k3_bound(il_, N, T, S, U, history)
        print(f"K3 ctc {shape} history={history}: kernel {ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, F.ctc_loss {l_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        out[f"K3 history={history}"] = dict(
            max_abs_err=err_l, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=l_ms)
    gr = torch.rand(N, generator=torch.Generator().manual_seed(34)).to(dev) \
        + 0.5
    got = ctc_cuda.ctc_bwd_cuda(*args, hist, loss, gr)
    want = ctc.ctc_grad(*args, hist, loss, gr)
    err = (got - want).abs()
    ok = bool((err <= CTC_GRAD_TOL + CTC_GRAD_TOL * want.abs()).all())
    print(f"K4 ctc_bwd {shape}, plan {ctc_cuda.plan(S, C)}: max|ddlogp| "
          f"{err.max().item():.3e} against ctc_grad (tol {CTC_GRAD_TOL})",
          flush=True)
    check(ok and torch.equal(got, ctc_cuda.ctc_bwd_cuda(*args, hist, loss,
                                                        gr)),
          f"K4 disagrees at {shape}")
    lattice_faults(torch, "K4", ctc.ctc_grad, (*args, hist, loss, gr), want,
                   ctc_faults(ctc, ctc_cuda.plan(S, C), warp_edges=False))
    ms = cuda_ms(lambda: ctc_cuda.ctc_bwd_cuda(*args, hist, loss, gr))
    p_ms = cuda_ms(lambda: ctc.ctc_grad(*args, hist, loss, gr))
    lpg = lp.clone().requires_grad_(True)
    lib = F.ctc_loss(lpg, tg_, il_, tl_, reduction="none")
    l_ms = cuda_ms(lambda: torch.autograd.grad(lib, lpg, gr,
                                               retain_graph=True))
    b_ms, b_by = k4_bound(il_, N, T, S, U, C)
    print(f"K4 ctc_bwd {shape}: kernel {ms:.4f} ms, plain {p_ms:.3f} ms, "
          f"F.ctc_loss backward {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    out["K4"] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
    return out


def cos_gap(a, b):
    """1 - cos(a, b), each list of tensors taken as one vector (fp64)."""
    dot = sum((x.double() * y.double()).sum() for x, y in zip(a, b))
    na = sum(x.double().square().sum() for x in a).sqrt()
    nb = sum(y.double().square().sum() for y in b).sqrt()
    return (1 - dot / (na * nb)).item()


def attention_grad_gate(torch, system, batch, what):
    """The kernel path's loss and whole gradient against the plain path's
    on one batch (dropout off), beside rounding (the plain path in bf16
    against fp32) and two planted faults that ATT_GRAD_GAP must catch."""
    from haloop_tpu_torch.ops import flash, flash_cuda
    leaves = [leaf for _, leaf in system.leaves]

    def reading():
        loss = system._forward_impl(*batch, train=False)[0]
        return loss.item(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def zeroed(q, k, v, *rest):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def last_tile_left_out(*args):
        return e6_k6_fault(flash, (None, None), args)
    k_loss, k_grads = reading()
    faults = {}
    with plain_kernels():
        p_loss, p_grads = reading()
        system.args.dtype = "float32"
        try:
            r_loss, r_grads = reading()
        finally:
            system.args.dtype = "bfloat16"
        for name, fault in (("K6a/K6b gradients zeroed", zeroed),
                            ("K6's partial last query tile left out",
                             last_tile_left_out)):
            flash_cuda.flash_bwd_cuda = fault
            faults[name] = cos_gap(reading()[1], p_grads)
    sound = (abs(k_loss - p_loss) / abs(p_loss), cos_gap(k_grads, p_grads))
    rounding = (abs(p_loss - r_loss) / abs(r_loss), cos_gap(p_grads, r_grads))
    print(f"{what}, kernel path against plain path, dropout off: loss "
          f"{k_loss:.6f} / {p_loss:.6f}, rel diff {sound[0]:.3e} (tol "
          f"{SLICE_REL_TOL}); gradient 1 - cos {sound[1]:.3e} (tol "
          f"{ATT_GRAD_GAP}); plain bf16 against plain fp32: {rounding[0]:.3e}"
          f", 1 - cos {rounding[1]:.3e}", flush=True)
    for name, gap in faults.items():
        print(f"{what}, planted fault ({name}) against the plain path: "
              f"1 - cos {gap:.3e}; caught: {gap > ATT_GRAD_GAP}", flush=True)
        check(gap > ATT_GRAD_GAP, f"ATT_GRAD_GAP does not catch {name}")
    check(sound[0] <= SLICE_REL_TOL and sound[1] <= ATT_GRAD_GAP,
          f"{what}: the kernel path differs from the plain path")


def attention_decode_check(torch, system, feats, feat_lens, hyps, lens,
                           scores, max_steps):
    """The greedy decode on the card against the same decode on the CPU
    from the same features: ATT_DECODE_MIN_SAME_ROWS identical rows, the
    summed log-probs within 1e-2 on those."""
    from haloop_tpu_torch.models import transformer
    from haloop_tpu_torch.params import tree_map
    rec = system.params["recognizer"]
    p_cpu = tree_map(lambda x: x.detach().cpu(), rec.get("decoder", rec))
    c_hyps, c_lens, c_scores, _ = transformer.decoder_decode(
        p_cpu, system.spec.recognizer.tcfg, feats.cpu(), feat_lens.cpu(),
        max_steps=max_steps)
    B = hyps.shape[0]
    same = [bool(torch.equal(hyps[n], c_hyps[n])) and int(lens[n]) ==
            int(c_lens[n]) for n in range(B)]
    d = max((abs(scores[n] - c_scores[n]).item() for n in range(B)
             if same[n]), default=0.0)
    print(f"attention decode on the card against the CPU: {sum(same)} of {B} "
          f"rows identical (at least {ATT_DECODE_MIN_SAME_ROWS}), max "
          f"|dlog_prob| on those {d:.3e}; lengths {lens.tolist()}",
          flush=True)
    check(sum(same) >= ATT_DECODE_MIN_SAME_ROWS and d < 1e-2,
          "the attention decode on the card disagrees with the CPU's")


def phase_attention(torch, dev, tmp, card):
    """hac e6ctc-d4:512 (the JAX package's bench workload for attention
    models, bench.py:214-216): a random checkpoint written with the
    port's Initializer; ``hac --test`` and ``hac --train --eval --save``
    on head:sinusoids0 through loop.main (utterances under the flash
    floor: the CTC head's K3/K4 alone); then bench.py's batch of 24 x 12 s,
    U = 24: hac's evaluate on it (exactly 6 K5, 1 K3), a train step
    (exactly 6 each of K5-lse, K6a, K6b; 1 K3 with history, 1 K4), the
    kernel path against the plain path (loss; gradient by cosine, beside
    rounding and planted faults), the decode against the CPU's, eval and
    train utt/s, a profile of each. The counts are reset just before each
    path and read just after it."""
    import numpy as np
    from haloop_tpu_torch import loop, params
    from haloop_tpu_torch.checkpoint import save_checkpoint
    from haloop_tpu_torch.init import Initializer
    arch, paths = "e6ctc-d4:512", {}
    init_args = loop.make_parser().parse_args(
        ["--arch", arch, "--vocab", "512", "--seed", "0", "--device", "cpu"])
    (_, p), _, _ = Initializer()(init_args)
    ckpt = Path(tmp) / "e6ctc.pt"
    save_checkpoint(ckpt, {k: params.to_numpy_tree(v) for k, v in p.items()})
    del p
    exp = Path(tmp) / "e6ctc"
    common = ["--arch", arch, "--vocab", "512", "--exp", str(exp)]

    reset_counts()
    out, _ = run_main(loop.main, ["--init", str(ckpt), "--test",
                                  "head:sinusoids0", *common])
    torch.cuda.synchronize()
    paths["attention_test"] = counts()
    rows = tsv_rows(out, tags=("hyp0", "ref", "stat0"))
    print(f"hac --arch {arch} --test head:sinusoids0: {len(rows)} TSV rows "
          f"(hyp/ref/stat, no ali); launches {paths['attention_test']}",
          flush=True)
    check_counts(f"{arch} --test", paths["attention_test"], dict(ctc_fwd=1))

    reset_counts()
    t0 = time.perf_counter()
    out, err = run_main(loop.main, [
        "--init", str(ckpt), "--train", "head:sinusoids0", "--eval",
        "head:sinusoids0", "--num-epochs", "1", "--batch-size", "8",
        "--log-interval", "1", "--lr", "3e-4", "--lr_schedule", "const",
        "--save", "last+best", *common])
    torch.cuda.synchronize()
    paths["attention_train"] = counts()
    train, valid = losses_in(err)
    print(f"hac --arch {arch} --init --train head:sinusoids0 --eval (2 "
          f"steps, eval, save) in {time.perf_counter() - t0:.1f} s: train "
          f"losses {train}, valid {valid}; launches "
          f"{paths['attention_train']}", flush=True)
    check(len(train) == 2 and len(valid) == 1 and
          all(math.isfinite(x) for x in train + valid) and
          (exp / "last.pt").exists(), f"{arch} --train did not run through")
    check_counts(f"{arch} --train", paths["attention_train"],
                 dict(ctc_fwd_history=2, ctc_bwd=2, ctc_fwd=1))

    system = make_system(torch, dev, "--arch", arch)
    arrays = bench_arrays(24, 1200, 24, 80)
    batch = system.to_device(*arrays)
    B, U = arrays[1].shape
    max_steps = U + 1                  # haloop_tpu/loop.py:711
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loss = system.evaluate(0, [(np.arange(B), *arrays)], tag="smoke")
    torch.cuda.synchronize()
    paths["attention_eval_batch"] = counts()
    rows = [r for r in (line.split("\t") for line in
                        out.getvalue().splitlines()) if len(r) == 4]
    tags = {t: sum(r[2] == t for r in rows) for t in ("hyp0", "ref",
                                                      "stat0", "ali0")}
    print(f"{arch} evaluate on bench.py's batch ({B} x 1200 frames, U={U}): "
          f"loss {loss:.4f}, rows {tags}; launches "
          f"{paths['attention_eval_batch']}", flush=True)
    check(math.isfinite(loss) and tags == dict(hyp0=B, ref=B, stat0=B,
                                               ali0=0),
          "malformed evaluate on the bench batch")
    check_counts(f"{arch} eval batch", paths["attention_eval_batch"],
                 dict(flash_fwd=6, ctc_fwd=1))

    def transcribe():
        _, feats, feat_lens, _ = system._forward_impl(*batch, train=False)
        out = system._decode_impl(feats, feat_lens, max_steps=max_steps,
                                  train=False)
        return feats, feat_lens, [t.cpu() for t in out[:4]]
    with torch.inference_mode():
        k_loss = system._forward_impl(*batch, train=False)[0].item()
        with plain_kernels():
            p_loss = system._forward_impl(*batch, train=False)[0].item()
        rel = abs(k_loss - p_loss) / abs(p_loss)
        print(f"{arch} eval loss: kernel path {k_loss:.6f}, plain path "
              f"{p_loss:.6f}, rel diff {rel:.3e} (tol {SLICE_REL_TOL})",
              flush=True)
        check(rel <= SLICE_REL_TOL, "kernel-path loss differs from plain")
        feats, feat_lens, (hyps, lens, scores, _) = transcribe()
        check(hyps.shape == (B, max_steps + 1) and bool(
            ((lens >= 1) & (lens <= max_steps + 1)).all()),
            "malformed attention decode")
        attention_decode_check(torch, system, feats, feat_lens, hyps, lens,
                               scores, max_steps)
        sec, times = host_ms(torch, transcribe)
        print(f"{arch} eval forward + greedy decode ({max_steps + 1} steps), "
              f"{B} x 12 s: {B / sec * 1e3:.2f} utt/s ({sec:.3f} ms per "
              f"batch, median of 5; {[round(t, 3) for t in times]}) on "
              f"{card}", flush=True)
        profile_step(torch, transcribe, f"one {arch} transcription batch")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, norm, bad = system.train_step(*batch)
    torch.cuda.synchronize()
    paths["attention_train_step"] = counts()
    print(f"{arch} train step, {B} x 12 s: loss {loss:.4f} encoder grad "
          f"norm {norm:.4f}; launches {paths['attention_train_step']}",
          flush=True)
    check(not bad and math.isfinite(loss), f"non-finite {arch} step")
    check_counts(f"{arch} train step", paths["attention_train_step"],
                 dict(flash_fwd=6, flash_fwd_lse=6, flash_bwd_dq=6,
                      flash_bwd_dkv=6, ctc_fwd_history=1, ctc_bwd=1))
    attention_grad_gate(torch, system, batch, f"{arch} train step")

    def step():
        check(not system.train_step(*batch)[2], "non-finite train step")
    torch.cuda.reset_peak_memory_stats()
    sec, times = host_ms(torch, step)
    print(f"{arch} train step (forward, backward, clip, AdamW), {B} x 12 s "
          f"utterances, U={U}: {B / sec * 1e3:.2f} utt/s ({sec:.3f} ms per "
          f"step, median of 5; {[round(t, 3) for t in times]}) peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}",
          flush=True)
    profile_step(torch, step, f"one {arch} train step")
    del system, batch
    torch.cuda.empty_cache()
    return paths


def phase_attention_more(torch, dev, card):
    """One train step each of rnn-transducer:e6ctc-d4:512 (the RNN-T
    joint K9a/K9b beside K5/K6) at bench.py's 24 x 12 s, U = 24, and of
    transformer:512 (hac's default arch) at 8 x 2,400 frames (strides (2,
    2, 2) reach the flash floor at T' = 300): exact launches, the kernel
    path against the plain path, utt/s, a profile."""
    paths = {}
    for arch, B, T, expect in (
            ("rnn-transducer:e6ctc-d4:512", 24, 1200,
             dict(flash_fwd=6, flash_fwd_lse=6, flash_bwd_dq=6,
                  flash_bwd_dkv=6, lstm_fwd_residual=2, lstm_bwd=2,
                  joint_lse=1, joint_lse_bwd=1)),
            ("transformer:512", 8, 2400,
             dict(flash_fwd=12, flash_fwd_lse=12, flash_bwd_dq=12,
                  flash_bwd_dkv=12, ctc_fwd_history=1, ctc_bwd=1))):
        system = make_system(torch, dev, "--arch", arch)
        batch = system.to_device(*bench_arrays(B, T, 24, 80))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss, norm, bad = system.train_step(*batch)
        torch.cuda.synchronize()
        got = paths[f"{arch} train step"] = counts()
        print(f"{arch} train step, {B} x {T} frames: loss {loss:.4f} "
              f"encoder grad norm {norm:.4f}; launches {got}", flush=True)
        check(not bad and math.isfinite(loss), f"non-finite {arch} step")
        check_counts(f"{arch} train step", got, expect)
        if "lstm_bwd" in expect:
            check_persistent(f"{arch} train step")
        check_against_plain(torch, system, batch, f"{arch} train step")

        def step():
            check(not system.train_step(*batch)[2], "non-finite train step")
        torch.cuda.reset_peak_memory_stats()
        sec, times = host_ms(torch, step)
        print(f"{arch} train step (forward, backward, clip, AdamW), {B} x "
              f"{T} frames: {B / sec * 1e3:.2f} utt/s ({sec:.3f} ms per "
              f"step, median of 5; {[round(t, 3) for t in times]}) peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"on {card}", flush=True)
        profile_step(torch, step, f"one {arch} train step")
        del system, batch
        torch.cuda.empty_cache()
    return paths


def hala_args(*flags):
    from haloop_tpu_torch import attention_loop
    return attention_loop.make_parser().parse_args(
        ["--arch", "decoder", "--batch_size", "8",
         "--gradient_accumulation_steps", "1", *flags])


def rel_l2(a, b):
    """||a - b|| / ||b|| over two lists of tensors."""
    import torch
    diff = torch._foreach_sub(a, b)
    return (torch.stack(torch._foreach_norm(diff)).norm() /
            torch.stack(torch._foreach_norm(b)).norm()).item()


def phase_hala(torch, dev, ckpt, card):
    """One hala update of GPT-2 small at batch 8 x 1024, accumulation 1:
    exact launches, the kernel path against the plain path, tokens/s,
    mfu, peak memory, the CE backward before and after its bf16 products,
    and a profile."""
    import numpy as np
    from haloop_tpu_torch import attention_loop as TAL
    from haloop_tpu_torch.init import load_model
    from haloop_tpu_torch.ops import flash, flash_cuda, fused_ce
    from haloop_tpu_torch.params import tree_leaves
    spec, params = load_model(ckpt, dev)
    cfg = spec.config
    n_params = sum(t.numel() for t in tree_leaves(params))
    step = TAL.TrainStep(cfg, hala_args(), params, 200000)
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.integers(1, 50257, (1, 8, 1024)).astype(
        np.int32)).to(dev)
    Y = TAL.lm_targets(X)
    ntok = X.numel()

    reset_counts()
    loss, gnorm = step(X, Y)
    torch.cuda.synchronize()
    launches = counts()
    print(f"GPT-2 small ({n_params} params) hala update, 8 x 1024, bf16: "
          f"loss {loss:.4f} grad norm {gnorm:.4f}; launches {launches}",
          flush=True)
    check_counts("hala update", launches, dict(
        flash_fwd=12, flash_fwd_lse=12, flash_bwd_dq=12, flash_bwd_dkv=12,
        fused_ce=1))
    check_ce_route("hala update", launches)
    check(math.isfinite(loss) and math.isfinite(gnorm) and step.updates == 1,
          "the hala update was not applied")

    # the kernel path against the plain path on one batch, beside
    # rounding (plain bf16 against plain fp32) and a planted fault
    def reading():
        grads, loss = step.micro_grads(X, Y)
        return loss.item(), grads

    def k6b_without_mask(q, k, v, kvl, causal, t0, o, lse, do):
        dq, _, _ = flash._backward_reference(q, k, v, kvl, causal, t0, o,
                                             lse, do)
        _, dk, dv = flash._backward_reference(q, k, v, kvl, False, t0, o,
                                              lse, do)
        return dq, dk, dv

    def dq_without_scale(q, k, v, kvl, causal, t0, o, lse, do):
        dq, dk, dv = flash._backward_reference(q, k, v, kvl, causal, t0, o,
                                               lse, do)
        return dq * math.sqrt(q.shape[-1]), dk, dv
    k_loss, k_grads = reading()
    faults = {}
    with plain_kernels():
        p_loss, p_grads = reading()
        step.dtype = "float32"
        r_loss, r_grads = reading()
        step.dtype = "bfloat16"
        for name, fault in (("K6b without the causal mask",
                             k6b_without_mask),
                            ("dq without its scale", dq_without_scale)):
            flash_cuda.flash_bwd_cuda = fault
            faults[name] = rel_l2(reading()[1], p_grads)
    sound = (abs(k_loss - p_loss) / abs(p_loss), rel_l2(k_grads, p_grads))
    rounding = (abs(p_loss - r_loss) / abs(r_loss), rel_l2(p_grads, r_grads))
    del k_grads, p_grads, r_grads
    print(f"hala update, kernel path against plain path on the same batch: "
          f"loss rel diff {sound[0]:.3e} (tol {HALA_LOSS_TOL}), gradient "
          f"||dg||/||g|| {sound[1]:.3e} (tol {HALA_GRAD_TOL}); plain bf16 "
          f"against plain fp32: {rounding[0]:.3e}, {rounding[1]:.3e}",
          flush=True)
    for name, fault in faults.items():
        print(f"hala update, planted fault ({name}) against the sound plain "
              f"path: ||dg||/||g|| {fault:.3e}; caught: "
              f"{fault > HALA_GRAD_TOL}", flush=True)
        check(fault > HALA_GRAD_TOL, f"HALA_GRAD_TOL does not catch "
                                     f"{name}")
    check(sound[0] <= HALA_LOSS_TOL and sound[1] <= HALA_GRAD_TOL,
          "the hala kernel path differs from the plain path")

    # rates: updates that end in the host read of loss and grad norm
    def update():
        loss, gnorm = step(X, Y)
        check(math.isfinite(loss), "non-finite hala loss")
    torch.cuda.reset_peak_memory_stats()
    sec, times = host_ms(torch, update)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # model FLOPs a token: 6 per param that multiplies (wpe is a lookup,
    # left out as nanoGPT leaves it out), and the causal half of the
    # scores' QK^T and PV
    n_mm = n_params - params["transformer"]["wpe"]["weight"].numel()
    flops_tok = 6 * n_mm + 6 * cfg.n_layer * cfg.n_embd * 1024
    tps = ntok / sec * 1e3
    mfu = tps * flops_tok / PEAK_BF16
    print(f"hala update (forward, backward, clip, AdamW), 8 x 1024 tokens: "
          f"{tps:.1f} train tokens/s ({sec:.3f} ms an update, median of 5; "
          f"{[round(t, 3) for t in times]}); mfu {mfu:.4f} = tokens/s x "
          f"(6 x {n_mm} + 6 x {cfg.n_layer} x {cfg.n_embd} x 1024) "
          f"FLOP / {PEAK_BF16:.0e}; peak memory {peak:.2f} GiB on {card}",
          flush=True)

    # the CE backward at hala's N = 8192: fp32 products, then bf16
    g = torch.Generator().manual_seed(8192)
    x = torch.randn((ntok, cfg.n_embd), generator=g).to(dev, torch.bfloat16)
    w = params["lm_head"]["weight"].detach().to(torch.bfloat16)
    t = Y.reshape(-1)
    _, lse = fused_ce.ce_nll_lse(x, w, t)
    gr = torch.full((ntok,), 1.0 / ntok, device=dev)
    before = cuda_ms(lambda: fused_ce._grad_fp32(x, w, t, lse, gr))
    after = cuda_ms(lambda: fused_ce.ce_nll_grad(x, w, t, lse, gr))
    real = fused_ce.ce_nll_grad
    fused_ce.ce_nll_grad = fused_ce._grad_fp32
    try:
        old_sec, _ = host_ms(torch, update)
    finally:
        fused_ce.ce_nll_grad = real
    print(f"CE backward at N={ntok}, V={cfg.vocab_size}, D={cfg.n_embd}: "
          f"fp32 products {before:.3f} ms, bf16 operands with fp32 sums "
          f"{after:.3f} ms; the hala update with the fp32 products "
          f"{old_sec:.3f} ms ({ntok / old_sec * 1e3:.1f} tokens/s)",
          flush=True)
    profile_step(torch, update, "one hala update (8 x 1024)")
    return launches, dict(tokens_per_s=tps, mfu=mfu, ms=sec,
                          ce_bwd_ms=(before, after))


def corpus_bins(tmp):
    """The repository's own text (its *.md and *.py files outside the
    directories .gitignore lists) as byte ids in uint16 .bin files, 90/10
    -> (train, eval, eval bytes)."""
    import numpy as np
    gitignore = ROOT / ".gitignore"     # its directories hold no source
    skip = {".git"} | {line.strip().rstrip("/") for line in (
        gitignore.read_text().splitlines() if gitignore.exists() else ())
        if line.strip().endswith("/")}
    files = sorted(p for p in ROOT.rglob("*") if p.suffix in (".md", ".py")
                   and not skip & set(p.relative_to(ROOT).parts))
    ids = np.frombuffer(b"".join(p.read_bytes() for p in files),
                        np.uint8).astype(np.uint16)
    cut = len(ids) * 9 // 10
    train, evl = Path(tmp) / "train.bin", Path(tmp) / "eval.bin"
    ids[:cut].tofile(train)
    ids[cut:].tofile(evl)
    return train, evl, len(ids) - cut


def byte_entropies(path):
    """(unigram entropy, bigram conditional entropy) in nats of a .bin
    file of byte ids: the least cross-entropy on it of any model of the
    byte frequencies alone, and of any model of the current byte alone."""
    import numpy as np
    ids = np.fromfile(path, np.uint16).astype(np.int64)
    uni = np.bincount(ids, minlength=256)
    pairs = np.bincount(ids[:-1] * 256 + ids[1:], minlength=256 * 256) \
        .reshape(256, 256).astype(np.float64)
    p = uni[uni > 0] / uni.sum()
    cond = pairs / np.maximum(pairs.sum(1, keepdims=True), 1)
    seen = pairs > 0
    return (float(-(p * np.log(p)).sum()),
            float(-(pairs[seen] * np.log(cond[seen])).sum() / pairs.sum()))


def hala_log(text):
    """(train losses, val losses) of hala's log lines."""
    return ([float(x) for x in re.findall(
        r"^iter \d+: loss ([\d.]+), time [\d.]+ms, grad_norm: [\d.]+, "
        r"lr: \S+$", text, re.M)],
            [float(x) for x in re.findall(r"^eval \d+: val loss ([\d.]+)$",
                                          text, re.M)])


@contextlib.contextmanager
def k6_zeroed():
    """K6a/K6b replaced by zero gradients: the planted fault of hala's
    entry-point check."""
    import torch
    from haloop_tpu_torch.ops import flash_cuda
    real = flash_cuda.flash_bwd_cuda
    flash_cuda.flash_bwd_cuda = lambda q, k, v, *rest: (
        torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v))
    try:
        yield
    finally:
        flash_cuda.flash_bwd_cuda = real


def hala_main(torch, corpus, exp, flags):
    """attention_loop.main on the corpus -> (stdout, seconds)."""
    from haloop_tpu_torch import attention_loop
    train, evl, eval_bytes = corpus
    t0 = time.perf_counter()
    out, _ = run_main(attention_loop.main, [
        *flags, "--seed", "0", "--train", str(train), "--eval", str(evl),
        "--eval_bytes", str(eval_bytes), "--exp", str(exp)])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_hala_entry(torch, tmp):
    """hala through attention_loop.main: decoder at full width, then
    gpt-nano:256:256, each with the counts reset just before it; the
    decoder's best.pt scored by the port's hap; the decoder's run again
    with K6 zeroed, which the val-loss check must catch."""
    from haloop_tpu_torch import score
    corpus = corpus_bins(tmp)
    unigram, bigram = byte_entropies(corpus[1])
    eval_bytes = corpus[2]
    print(f"hala's eval set: {eval_bytes} bytes, byte unigram entropy "
          f"{unigram:.4f} nats, bigram conditional entropy {bigram:.4f}",
          flush=True)
    n = HALA_ENTRY_UPDATES
    decoder = ["--arch", "decoder", "--max_iters", str(n),
               "--eval-interval", str(n // 2), *HALA_ENTRY_LR]
    paths = {}
    runs = (
        ("decoder", [*decoder, "--save", "best"], n, 12, 1024, True,
         HALA_ENTRY_DROP),
        ("gpt-nano:256:256", ["--arch", "gpt-nano:256:256", "--block_size",
                              "256", "--max_iters", "8", "--eval-interval",
                              "4", "--lr", "3e-3", "--warmup_iters", "2",
                              "--save", "none"],
         8, 2, 256, False, 0.0),
    )
    for arch, flags, iters, layers, T, big, drop in runs:
        exp = Path(tmp) / f"hala-{arch.split(':')[0]}"
        reset_counts()
        out, sec = hala_main(torch, corpus, exp, flags)
        got = counts()
        losses, vals = hala_log(out)
        micro = 2 * (iters + 1)              # 2 micro-batches an update
        batches = 2 * (eval_bytes // T // 4)   # two evals of 4 x T rows
        expect = dict(flash_fwd=layers * (micro + batches),
                      flash_fwd_lse=layers * micro,
                      flash_bwd_dq=layers * micro,
                      flash_bwd_dkv=layers * micro)
        if big:
            expect["fused_ce"] = micro + batches
        print(f"hala --arch {arch} ({sec:.1f} s): train loss {losses[0]:.4f} "
              f"-> {losses[-1]:.4f} over {len(losses)} updates, val loss "
              f"{vals}; launches {got}", flush=True)
        print("\n".join(line for line in out.splitlines()
                        if line.startswith(("eval ", "saving", "Train",
                                            "Tokens"))), flush=True)
        check(len(losses) == iters + 1 and len(vals) == 2,
              f"hala {arch}: {len(losses)} iter lines, {len(vals)} evals")
        check(losses[-1] <= losses[0] - drop,
              f"hala {arch}: the train loss did not fall {drop} nats")
        check_counts(f"hala --arch {arch}", got, expect)
        paths["hala_entry" if big else "hala_entry_nano"] = got
        if not big:
            continue
        best = exp / "best.pt"
        check(best.exists(), f"hala {arch} wrote no best.pt")
        reset_counts()
        text = ("hello world\nthe quick brown fox jumps over the lazy "
                "dog\nhi\n")
        out, _ = run_main(score.main, ["--bytes", str(best)], text)
        torch.cuda.synchronize()
        rows = [line.split("\t") for line in out.strip().split("\n")]
        print(f"hap --bytes on hala's best.pt: {rows}; launches "
              f"{counts()}", flush=True)
        check(len(rows) == 3 and all(len(r) == 3 for r in rows),
              "hap on hala's best.pt: not one 3-column row per line")
        check_counts("hap on hala's best.pt", counts(),
                     dict(flash_packed=12, fused_ce=1))
        with k6_zeroed():
            out, sec = hala_main(torch, corpus, Path(tmp) / "hala-zeroed",
                                 [*decoder, "--save", "none"])
        zeroed = hala_log(out)[1]
        limit = unigram - HALA_ENTRY_MARGIN
        print(f"hala --arch {arch}, val loss after {n} updates: "
              f"{vals[-1]:.4f}; with K6 zeroed (planted fault, {sec:.1f} s) "
              f"{zeroed}; limit {limit:.4f} (unigram entropy - "
              f"{HALA_ENTRY_MARGIN}); caught: {zeroed[-1] > limit}",
              flush=True)
        check(vals[-1] <= limit, f"hala {arch}: the val loss {vals[-1]} is "
                                 f"not {HALA_ENTRY_MARGIN} nats under the "
                                 f"byte unigram entropy {unigram:.4f}")
        check(zeroed[-1] > limit, "the val-loss check of hala's entry point "
                                  "does not catch K6 zeroed")
    return paths


def hala_curve(torch):
    """``--hala-curve``: the decoder's entry-point run over 400 updates,
    val loss every 50, with K6 and with K6 zeroed, beside the eval set's
    byte entropies (what HALA_ENTRY_UPDATES and HALA_ENTRY_MARGIN were
    placed from)."""
    with tempfile.TemporaryDirectory() as tmp:
        corpus = corpus_bins(tmp)
        print("hala's eval set: byte unigram entropy %.4f nats, bigram "
              "conditional entropy %.4f" % byte_entropies(corpus[1]),
              flush=True)
        flags = ["--arch", "decoder", "--max_iters", "400",
                 "--eval-interval", "50", *HALA_ENTRY_LR, "--save", "none"]
        for name, ctx in (("K6", contextlib.nullcontext()),
                          ("K6 zeroed", k6_zeroed())):
            with ctx:
                out, sec = hala_main(torch, corpus, Path(tmp) / "x", flags)
            losses, vals = hala_log(out)
            print(f"hala --arch decoder, {name} ({sec:.1f} s): train loss "
                  f"every 50 updates {losses[::50]}; val loss every 50 "
                  f"{vals}", flush=True)


# ------------------------------------------------------------------- hal

# hal's recurrence: the rnnlm arch (1 x 2048) at the JAX package's RNN-LM
# shape (--bptt-len 256, --batch-size 64), fp32
HAL_SHAPE = (256, 64, 2048)
# hal's corpus: seeded synthetic words, 8 chunks of 64 x 256 bytes
HAL_CORPUS_BYTES = 8 * 64 * 256
# a hal step, kernel path against the plain path (fp32 throughout, the
# sums in another order): the loss's relative difference and the whole
# gradient's 1 - cos, between the sound reading (rel 0, 1 - cos 5.8e-14
# at hal's shape, NVIDIA H100) and a planted fault read every run (the
# stream's state not carried into the chunk)
HAL_LOSS_TOL = 1e-5
HAL_GRAD_GAP = 1e-6
# the prompt hal completes in phase 30
HAL_PROMPT = "the "


def k1_fp32_slice_out(torch, w, xp, h0, c0, step):
    """A planted fault of K1 in fp32: plain lstm_scan with one 32-column
    ring slice (h's columns 64..95) of step ``step``'s recurrent product
    left out, what a slot the kernel's loop skips computes. Returns ys."""
    T, B, H4 = xp.shape
    H = H4 // 4
    h, c = h0.float(), c0.float()
    ys = torch.empty((T, B, H), device=xp.device)
    for t in range(T):
        hk = h
        if t == step:
            hk = h.clone()
            hk[:, 64:96] = 0
        i, f, g, o = (xp[t].float() + hk @ w.float().T).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return ys


def lstm_fp32_faults(torch, w, xp, h0, c0, units):
    """Planted faults of K1 in fp32 (plain lstm_scan with one change) ->
    {name: ys}: one 32-column ring slice of step 100's recurrent product
    left out, c not carried into step 100 (a cell that reads c0 again),
    and ``units`` (one block's) on h_(t-2) from the third step on (a
    missing grid barrier)."""
    T, B, H4 = xp.shape
    H = H4 // 4
    h, c = h0.float(), c0.float()
    ys = torch.empty((T, B, H), device=xp.device)
    for t in range(T):
        if t == 100:
            c = c0.float()
        i, f, g, o = (xp[t].float() + h @ w.float().T).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return {"ring slice 64..95 of step 100 left out":
            k1_fp32_slice_out(torch, w, xp, h0, c0, 100),
            "c not carried into step 100": ys,
            f"units {int(units[0])}..{int(units[-1])} on h_(t-2)":
            k1_stale_h(torch, w, xp, h0, c0, units)}


def k2_fp32_faults(torch, dys, acts, c_prev, cs, w, dh_last, dc_last, units):
    """Planted faults of K2 in fp32 -> {name: dgates}: one 32-column ring
    slice of dgates[101] . W left out of dh at step 100, dc not carried
    from step 101 into step 100, and ``units`` (one cluster's) on the
    dgates of the step before the right one (a missing grid barrier)."""
    out = {}
    for name in ("ring slice 64..95 of dgates[101] . W left out",
                 "dc not carried into step 100"):
        T = acts.shape[0]
        dh, dc = dh_last.float(), dc_last.float()
        dgates = torch.empty_like(acts)
        for t in range(T - 1, -1, -1):
            if t == 100 and name.startswith("dc"):
                dc = torch.zeros_like(dc)
            i, f, g, o = acts[t].float().chunk(4, dim=-1)
            tc = torch.tanh(cs[t].float())
            dh = dh + dys[t].float()
            do = dh * tc * o * (1 - o)
            dc = dc + dh * o * (1 - tc * tc)
            d = torch.cat([dc * g * i * (1 - i),
                           dc * c_prev[t].float() * f * (1 - f),
                           dc * i * (1 - g * g), do], dim=-1)
            dgates[t] = d
            dk = d
            if t == 101 and name.startswith("ring slice"):
                dk = d.clone()
                dk[:, 64:96] = 0
            dh = dk @ w.float()
            dc = dc * f
        out[name] = dgates
    out[f"units {int(units[0])}..{int(units[-1])} on a step-old dgates"] = \
        k2_stale_share(torch, dys, acts, c_prev, cs, w, dh_last, dc_last,
                       units)
    return out


def check_completion_k1(torch, dev, H, tol):
    """K1 in fp32 at hal's completion, B = 1 (the plan of one 8-row batch
    tile, another compiled kernel than B = 64's): on a prompt as long as
    phase 30's and on one sampled token, the route, the same bits twice,
    lstm_scan within ``tol``, and a ring slice of the first step left out
    beyond it. Returns the largest error of ys, h and c."""
    from haloop_tpu_torch.nn import lstm, lstm_cuda
    sms, smem, ncl = lstm_cuda.card(dev)
    route, plan = lstm_cuda.route("fwd", torch.float32, H, 1, sms, smem,
                                  ncl["fwd"])
    print(f"K1 fp32 at a completion (B=1, H={H}): route {route}, {plan}",
          flush=True)
    check(route == "persist_f32", f"fp32 fwd at B = 1 took {route}")
    worst = 0.0
    for T in (len(HAL_PROMPT), 1):
        args = lstm_inputs(torch, dev, T, 1, H, torch.float32)
        got = lstm_cuda.lstm_fwd_cuda(*args)
        again = lstm_cuda.lstm_fwd_cuda(*args)
        reads = [within(torch, a, b, tol)
                 for a, b in zip(got, lstm.lstm_scan(*args))]
        ok_f, err_f, mean_f = within(
            torch, got[0], k1_fp32_slice_out(torch, *args, 0), tol)
        print(f"K1 fp32 at T={T} B=1 H={H}: max|dys|={reads[0][1]:.3e} "
              f"mean {reads[0][2]:.3e}, max|dh|={reads[1][1]:.3e}, "
              f"max|dc|={reads[2][1]:.3e}; planted fault (ring slice "
              f"64..95 of step 0 left out): max|dys|={err_f:.3e} mean "
              f"{mean_f:.3e}, beyond the limit {not ok_f}", flush=True)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K1 fp32 at T={T} B=1 gave other bits on a second run")
        check(all(ok for ok, _, _ in reads),
              f"K1 fp32 disagrees with lstm_scan at T={T} B=1 H={H}")
        check(not ok_f, f"K1's planted fault at T={T} B=1 reads within "
                        "the limit")
        worst = max(worst, *(err for _, err, _ in reads))
    return worst


def f32_fault_units(torch, dev, kind, H, B):
    """The hidden units of one block (K1) or one cluster (K2) of the fp32
    persistent plan at (H, B): the second cluster's first block, or the
    second cluster."""
    from haloop_tpu_torch.nn import lstm_cuda
    sms, smem, ncl = lstm_cuda.card(dev)
    plan = lstm_cuda.f32_plan(kind, H, B, sms, smem, ncl[kind])
    cu = plan.c * plan.u
    return torch.arange(cu, min(cu + (cu if kind == "bwd" else plan.u), H),
                        device=dev)


def kernels_a_call(torch, fn, name):
    """The device kernels whose name holds ``name`` that one call of fn
    launched, counted from a profile."""
    _, by_name = profile_step(torch, fn, "one call")
    return sum(n for k, (n, _) in by_name.items() if name in k)


class all_streamed:
    """nn.lstm_cuda.f32_plan's plans with every slice of W streamed (none
    resident), for the duration."""

    def __enter__(self):
        import dataclasses
        from haloop_tpu_torch.nn import lstm_cuda
        self.m, self.plan = lstm_cuda, lstm_cuda.f32_plan

        def streamed(*args, **kwargs):
            p = self.plan(*args, **kwargs)
            return p and dataclasses.replace(
                p, nres=0, smem=lstm_cuda.f32_layout(
                    p.kc, p.n, p.tm, p.tn, p.wk, p.stages, 0))
        lstm_cuda.f32_plan = streamed

    def __exit__(self, *exc):
        self.m.f32_plan = self.plan


def phase_hal_kernels(torch, dev):
    """K1, K1 with residuals and K2 in fp32 at hal's (256, 64, 2048) on
    their fp32 persistent route: the route and plan, one kernel a call,
    the same bits twice and with W all streamed, the plain versions within
    LSTM_TOL["float32"] and planted faults beyond it, times beside plain,
    cuDNN fp32's recurrence alone (TF32 off) and the bound; K1 at hal's
    completion (B = 1) checked the same way and timed at one token."""
    from haloop_tpu_torch.nn import lstm, lstm_cuda
    T, B, H = HAL_SHAPE
    tol = LSTM_TOL["float32"]
    shape = f"T={T} B={B} H={H} fp32 (hal)"
    w, xp, h0, c0 = lstm_inputs(torch, dev, T, B, H, torch.float32)
    sms, smem, ncl = lstm_cuda.card(dev)
    for kind in ("fwd", "bwd"):
        route, plan = lstm_cuda.route(kind, torch.float32, H, B, sms, smem,
                                      ncl[kind])
        print(f"{'K1' if kind == 'fwd' else 'K2'} {shape}: route {route}, "
              f"{plan}", flush=True)
        check(route == "persist_f32", f"fp32 {kind} took {route}")

    before = dict(lstm_cuda.route_launches)
    ys, h, c = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0)
    again = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0)
    ysr, hr, cr, acts, cs = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0,
                                                    residuals=True)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
            if v != before[k]}
    check(took == {"fwd_persist_f32": 3}, f"K1 fp32 took {took}")
    with all_streamed():
        streamed = lstm_cuda.lstm_fwd_cuda(w, xp, h0, c0, residuals=True)
    check(all(torch.equal(a, b) for a, b in zip((ys, h, c), again)),
          "K1 fp32 gave other bits on a second run")
    check(all(torch.equal(a, b) for a, b in
              zip((ysr, hr, cr, acts, cs), streamed)),
          "K1 fp32 with W all streamed gave other bits")
    check(torch.equal(ys, ysr) and torch.equal(h, hr) and torch.equal(c, cr),
          "K1 fp32 with residuals changes ys/h/c")
    ye, he, ce, acts_e, cs_e = lstm.lstm_scan(w, xp, h0, c0, residuals=True)
    ok, err, mean = within(torch, ys, ye, tol)
    ok_h = within(torch, h, he, tol)[0] and within(torch, c, ce, tol)[0]
    ok_a, err_a, _ = within(torch, acts, acts_e, tol)
    ok_c, err_c, _ = within(torch, cs, cs_e, tol)
    print(f"K1 {shape}: route persist_f32, the same bits twice and with W "
          f"all streamed; max|dys|={err:.3e} mean {mean:.3e}; residuals "
          f"max|dacts|={err_a:.3e} max|dcs|={err_c:.3e} (tol atol="
          f"{tol['atol']} rtol={tol['rtol']} mean<{tol['mean']})",
          flush=True)
    check(ok and ok_h and ok_a and ok_c,
          f"K1 fp32 disagrees with lstm_scan at {HAL_SHAPE}")
    for name, bad in lstm_fp32_faults(
            torch, w, xp, h0, c0,
            f32_fault_units(torch, dev, "fwd", H, B)).items():
        ok_f, err_f, mean_f = within(torch, ys, bad, tol)
        print(f"K1 {shape} planted fault ({name}): max|dys|={err_f:.3e} "
              f"mean {mean_f:.3e}; beyond the limit {not ok_f}", flush=True)
        check(not ok_f, f"K1's planted fault ({name}) reads within the limit")

    g = torch.Generator().manual_seed(T + H)
    dys = torch.randn((T, B, H), generator=g).to(dev)
    dh = torch.randn((B, H), generator=g).to(dev) * 0.1
    dc = torch.randn((B, H), generator=g).to(dev) * 0.1
    c_prev = torch.cat([c0[None], cs_e[:-1]])
    before = dict(lstm_cuda.route_launches)
    dg, dh0, dc0 = lstm_cuda.lstm_bwd_cuda(dys, acts_e, cs_e, c0, w, dh, dc)
    again = lstm_cuda.lstm_bwd_cuda(dys, acts_e, cs_e, c0, w, dh, dc)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in lstm_cuda.route_launches.items()
            if v != before[k]}
    check(took == {"bwd_persist_f32": 2}, f"K2 fp32 took {took}")
    with all_streamed():
        streamed = lstm_cuda.lstm_bwd_cuda(dys, acts_e, cs_e, c0, w, dh, dc)
    check(all(torch.equal(a, b) for a, b in zip((dg, dh0, dc0), again)),
          "K2 fp32 gave other bits on a second run")
    check(all(torch.equal(a, b) for a, b in zip((dg, dh0, dc0), streamed)),
          "K2 fp32 with W all streamed gave other bits")
    dg_e, dh0_e, dc0_e = lstm.lstm_scan_bwd(dys, acts_e, c_prev, cs_e, w,
                                            dh, dc)
    ok, err_g, mean_g = within(torch, dg, dg_e, tol)
    ok_h = within(torch, dh0, dh0_e, tol)[0] and \
        within(torch, dc0, dc0_e, tol)[0]
    print(f"K2 {shape}: route persist_f32, the same bits twice and with W "
          f"all streamed; max|ddgates|={err_g:.3e} mean {mean_g:.3e}",
          flush=True)
    check(ok and ok_h, f"K2 fp32 disagrees with lstm_scan_bwd at {HAL_SHAPE}")
    for name, bad in k2_fp32_faults(
            torch, dys, acts_e, c_prev, cs_e, w, dh, dc,
            f32_fault_units(torch, dev, "bwd", H, B)).items():
        ok_f, err_f, mean_f = within(torch, dg, bad, tol)
        print(f"K2 {shape} planted fault ({name}): max|ddgates|={err_f:.3e}"
              f" mean {mean_f:.3e}; beyond the limit {not ok_f}", flush=True)
        check(not ok_f, f"K2's planted fault ({name}) reads within the limit")
    tok_err = check_completion_k1(torch, dev, H, tol)

    args = (w, xp, h0, c0)
    bargs = (dys, acts_e, cs_e, c0, w, dh, dc)
    calls = {name: kernels_a_call(torch, fn, "persist_f32") for name, fn in (
        ("K1", lambda: lstm_cuda.lstm_fwd_cuda(*args)),
        ("K1-residual", lambda: lstm_cuda.lstm_fwd_cuda(*args,
                                                        residuals=True)),
        ("K2", lambda: lstm_cuda.lstm_bwd_cuda(*bargs)))}
    print(f"persist_f32 kernels a layer call at {shape}: {calls} (PR 19's "
          f"fma_step route: T = {T} a K1 call, T + 1 a K2 call)", flush=True)
    check(calls == {"K1": 1, "K1-residual": 1, "K2": 1},
          f"fp32 kernels a call {calls}")

    ms = cuda_ms(lambda: lstm_cuda.lstm_fwd_cuda(*args))
    plain_ms = cuda_ms(lambda: lstm.lstm_scan(*args))
    rms = cuda_ms(lambda: lstm_cuda.lstm_fwd_cuda(*args, residuals=True))
    rplain = cuda_ms(lambda: lstm.lstm_scan(*args, residuals=True))
    bms = cuda_ms(lambda: lstm_cuda.lstm_bwd_cuda(*bargs))
    bplain = cuda_ms(lambda: lstm.lstm_scan_bwd(dys, acts_e, c_prev, cs_e, w,
                                                dh, dc))
    # a completion token: K1 at T = 1, B = 1 (hal's --complete)
    w1, xp1, h1, c1 = lstm_inputs(torch, dev, 1, 1, H, torch.float32)
    tok_ms = cuda_ms(lambda: lstm_cuda.lstm_fwd_cuda(w1, xp1, h1, c1))
    tok_b, tok_by = k1_bound(1, 1, H, 4)
    print(f"K1 fp32 at a completion token (T=1, B=1, H={H}): kernel "
          f"{tok_ms:.4f} ms, bound {tok_b:.4f} ms ({tok_by})", flush=True)
    # the yardstick: cuDNN's recurrence alone. K1 gets x already
    # projected and K2 stops at dgates, so cuDNN gets inputs of width 1
    # (its input GEMM and dx next to nothing) and frozen weights (no dW);
    # the whole layer, nn.LSTM(H, H) with x's and W's gradients, is
    # printed beside it
    lib, layer = {}, {}
    for width, table, weight_grads in ((1, lib, False), (H, layer, True)):
        ref = torch.nn.LSTM(width, H).to(dev).requires_grad_(weight_grads)
        x = torch.randn((T, B, width), generator=g).to(dev)
        with torch.inference_mode():
            table["K1"] = cuda_ms(lambda: ref(x))
        xg = x.clone().requires_grad_(True)
        table["K1-residual"] = cuda_ms(lambda: ref(xg))
        out = ref(xg)[0]
        grad = torch.randn_like(out)
        wrt = (xg, *ref.parameters()) if weight_grads else (xg,)
        table["K2"] = cuda_ms(lambda: torch.autograd.grad(
            out, wrt, grad, retain_graph=True))
        del ref, out
    reports = {}
    for name, t, p, lib_what, (b_ms, b_by) in (
            ("K1", ms, plain_ms, "forward", k1_bound(T, B, H, 4)),
            ("K1-residual", rms, rplain, "forward under autograd",
             k1_bound(T, B, H, 4, residuals=True)),
            ("K2", bms, bplain, "backward", k2_bound(T, B, H, 4))):
        print(f"{name} {shape}: kernel {t:.3f} ms, plain {p:.3f} ms, cuDNN "
              f"fp32 recurrence alone ({lib_what}) {lib[name]:.3f} ms "
              f"({'faster' if t < lib[name] else 'slower'}), the whole "
              f"nn.LSTM(H, H) layer {layer[name]:.3f} ms, bound {b_ms:.3f} "
              f"ms ({b_by}), {b_ms / t:.1%} of it", flush=True)
        reports[name] = dict(
            max_abs_err={"K1": err, "K1-residual": max(err_a, err_c),
                         "K2": err_g}[name], ms=t, plain_ms=p,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib[name],
            layer_ms=layer[name], launches_a_call=calls[name])
    reports["K1"]["completion_token_ms"] = tok_ms
    reports["K1"]["completion_max_abs_err"] = tok_err
    return shape, reports


def hal_corpus(tmp):
    """HAL_CORPUS_BYTES of seeded text: words of 2-9 lowercase letters
    from a 400-word lexicon, drawn with Zipf-like weights, spaces and a
    newline every 12 words."""
    import numpy as np
    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    lexicon = [bytes(rng.choice(letters, rng.integers(2, 10)))
               for _ in range(400)]
    weights = 1.0 / np.arange(1, 401)
    picks = rng.choice(400, HAL_CORPUS_BYTES // 3, p=weights / weights.sum())
    text = b"".join(lexicon[k] + (b"\n" if n % 12 == 11 else b" ")
                    for n, k in enumerate(picks))[:HAL_CORPUS_BYTES]
    path = Path(tmp) / "hal_corpus.txt"
    path.write_bytes(text)
    return path


def hal_main(argv):
    """rnnlm.main(argv) -> (its System, stdout, stderr). hal calls
    wandb.init on every training run: where wandb is installed it runs
    disabled here (no login, no network, no error reports)."""
    import os
    from haloop_tpu_torch import rnnlm
    os.environ["WANDB_MODE"] = "disabled"
    os.environ["WANDB_ERROR_REPORTING"] = "false"
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        system = rnnlm.main(argv)
    return system, out.getvalue(), err.getvalue()


def hal_loss_grads(torch, system, inputs, targets, state):
    """One hal step's loss and gradients, without the update."""
    loss = system.loss(inputs, targets, state)[0]
    leaves = [leaf for _, leaf in system.leaves]
    return loss.item(), torch.autograd.grad(loss, leaves)


def phase_hal(torch, dev, tmp, card):
    """hal through its entry point at the rnnlm arch's 1 x 2048, B = 64,
    T = 256, fp32: 5 steps, a checkpoint and a completion (counts reset
    just before, read just after: K1 with residuals and K2 once a step,
    K1 once for the prompt and once a sampled token, all on
    persist_f32);
    exact stream resume (5 steps straight against 3, --init and 2 more);
    one step's loss and gradient against the plain path; train and
    completion tokens/s and a profile of one step. Returns (the launches,
    the checkpoint)."""
    from haloop_tpu_torch.nn import lstm_cuda
    T, B, H = HAL_SHAPE
    corpus = hal_corpus(tmp)
    lm = Path(tmp) / "hal_lm.pt"
    prompt = HAL_PROMPT
    flags = ["--train", f"bytes:{corpus}", "--rnn-size", str(H),
             "--num-layers", "1", "--batch-size", str(B), "--bptt-len",
             str(T)]
    reset_counts()
    t0 = time.perf_counter()
    system, out, err = hal_main(flags + ["--max-steps", "4", "--save",
                                         str(lm), "--complete", prompt,
                                         "--log-interval", "2"])
    torch.cuda.synchronize()
    launches = counts()
    routes = {k: v for k, v in lstm_cuda.route_launches.items() if v}
    sec = time.perf_counter() - t0
    lines = [line for line in out.splitlines() if line.startswith("step ")]
    print(f"hal --train (5 steps, 3 log lines with a completion each, "
          f"save, --complete) in {sec:.1f} s: launches {launches}; by "
          f"route {routes}", flush=True)
    print("\n".join(lines + [line for line in out.splitlines()
                             if "bpc" in line and not line.startswith(
                                 "step ")]), flush=True)
    # each completion: one K1 call on the prompt, one a sampled token
    completions = 4 * (1 + T)
    check_counts("hal", launches, dict(lstm_fwd_residual=5, lstm_bwd=5,
                                       lstm_fwd=completions))
    check(routes == {"fwd_persist_f32": 5 + completions,
                     "bwd_persist_f32": 5}, f"hal: K1/K2 routes {routes}")
    losses = [float(x) for x in re.findall(r"loss: ([\d.]+)", out)]
    check(len(lines) == 3 and all(map(math.isfinite, losses)) and
          f"saving {lm}" in out and lm.exists() and "mean bpc" in out,
          "hal's entry point did not train, save and complete")
    del system

    # exact stream resume through the entry point
    quiet = ["--log-interval", "1000"]
    straight, _, _ = hal_main(flags + quiet + ["--max-steps", "4",
                                               "--save", str(lm) + ".a"])
    hal_main(flags + quiet + ["--max-steps", "2", "--save",
                              str(lm) + ".b"])
    resumed, _, _ = hal_main(flags + quiet + ["--max-steps", "4", "--init",
                                              str(lm) + ".b", "--save",
                                              str(lm) + ".c"])
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(straight.leaves, resumed.leaves)) and \
        all(torch.equal(straight.optimizer.state[a][k],
                        resumed.optimizer.state[b][k])
            for (_, a), (_, b) in zip(straight.leaves, resumed.leaves)
            for k in ("exp_avg", "exp_avg_sq")) and \
        all(torch.equal(a, b) for a, b in zip(straight.state,
                                              resumed.state)) and \
        torch.equal(straight.prompt, resumed.prompt)
    print(f"hal stream resume: 5 steps straight against 3, --init and 2 "
          f"more: params, moments, state and carried token the same bits "
          f"{same} (steps {straight.step} / {resumed.step})", flush=True)
    check(same and straight.step == resumed.step == 5,
          "hal's resumed stream differs from the straight one")
    del straight

    # one step against the plain path, from the resumed system's stream
    system = resumed
    chunk = torch.from_numpy(system.dataset[5].astype("int64")).to(dev)
    inputs = torch.cat([system.prompt, chunk[:-1]])
    k_loss, k_grads = hal_loss_grads(torch, system, inputs, chunk,
                                     system.state)
    with plain_kernels():
        p_loss, p_grads = hal_loss_grads(torch, system, inputs, chunk,
                                         system.state)
        # a planted fault: the stream's state not carried into the chunk
        f_loss, f_grads = hal_loss_grads(
            torch, system, inputs, chunk,
            tuple(torch.zeros_like(s) for s in system.state))
    rel, gap = abs(k_loss - p_loss) / abs(p_loss), cos_gap(k_grads, p_grads)
    f_rel, f_gap = abs(f_loss - p_loss) / abs(p_loss), \
        cos_gap(f_grads, p_grads)
    print(f"hal step, kernel path against plain path: loss {k_loss:.7f} / "
          f"{p_loss:.7f}, rel diff {rel:.3e} (tol {HAL_LOSS_TOL}); "
          f"gradient 1 - cos {gap:.3e} (tol {HAL_GRAD_GAP}); planted fault "
          f"(the state not carried): rel {f_rel:.3e}, 1 - cos {f_gap:.3e}",
          flush=True)
    check(rel <= HAL_LOSS_TOL and gap <= HAL_GRAD_GAP,
          "hal's kernel path differs from the plain path")
    check(f_rel > HAL_LOSS_TOL and f_gap > HAL_GRAD_GAP,
          "the gate does not catch a state left uncarried")
    del k_grads, p_grads, f_grads

    state = [system.state]

    def step():                 # one host read: the loss
        state[0], loss, _, _ = system.train_step(inputs, chunk, state[0])
        check(math.isfinite(loss.item()), "non-finite hal step")
    torch.cuda.reset_peak_memory_stats()
    ms, times = host_ms(torch, step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"hal train step (forward, backward, clip, AdamW) at B={B} x "
          f"T={T}, 1 x {H} fp32: {B * T / ms * 1e3:.1f} tokens/s ({ms:.3f} "
          f"ms per step, median of 5; {[round(t, 3) for t in times]}) peak "
          f"memory {peak:.2f} GiB on {card}", flush=True)
    n_events, by_name = profile_step(torch, step, "one hal train step")

    x, st = system.prepare_prompt(b"\nthe ")
    with torch.inference_mode():
        from haloop_tpu_torch.models import rnn
        logits, st = rnn.decoder_apply(system.params, x, st,
                                       num_layers=system.num_layers)
    l0 = logits[-1, 0]
    cms, ctimes = host_ms(torch, lambda: system.sample_ids(l0, st, T, 1))
    print(f"hal completion at B=1, {T} top-1 tokens: {T / cms * 1e3:.1f} "
          f"tokens/s ({cms:.3f} ms, median of 5; "
          f"{[round(t, 3) for t in ctimes]}) on {card}", flush=True)
    profile_step(torch, lambda: system.sample_ids(l0, st, 16, 1),
                 "16 completion tokens")
    del system, resumed
    torch.cuda.empty_cache()
    return launches, lm


def fusion_check(torch, inputs, lens, got, n, fusion, transducer=None):
    """The best hyps of the device beam ``got`` (CTC on log-probs
    ``inputs``, or with ``transducer`` params on features) against the
    same code on the CPU for the first n items, which decode
    independently: ([each item's the same], max |dscore|)."""
    from haloop_tpu_torch.ops import beam_device
    from haloop_tpu_torch.params import tree_map

    def cpu(t):
        return t.detach().cpu()
    fusion = dict(fusion, fusion_params=tree_map(cpu,
                                                 fusion["fusion_params"]))
    K = got[0].shape[1]
    if transducer is None:
        want = beam_device.ctc_beam_search_batched(
            cpu(inputs[:n]), cpu(lens[:n]), beam_width=K, **fusion)
    else:
        want = beam_device.transducer_beam_search_batched(
            tree_map(cpu, transducer), cpu(inputs[:n]), cpu(lens[:n]),
            beam_width=K, max_symbols=got[0].shape[-1], **fusion)
    same = [bool(torch.equal(got[0][i, 0, :max(int(got[1][i, 0]), 0)].cpu(),
                             want[0][i, 0, :max(int(want[1][i, 0]), 0)]))
            for i in range(n)]
    d = (got[2][:n, 0].cpu() - want[2][:, 0]).abs().max().item()
    return same, d


def phase_fusion(torch, dev, tmp, card, lm, serve_launches):
    """hac --beam 4 --lm <hal's 1 x 2048 checkpoint> on lstm:512 through
    loop.main (exactly phase 4's launches), then phase 4's batch of 48 x
    12 s (K1 three times, K3 once; the device beam's best hyps those of
    the same code on the CPU, given the same log-probs, for 4 items;
    --beam 1 exactly greedy), and rnn-transducer:lstm:512 at phase 10's
    batch of 16 with the same checks; utt/s and profiles."""
    from haloop_tpu_torch import loop
    from haloop_tpu_torch.models import recognizer
    from haloop_tpu_torch.ops import beam_device
    ckpt = Path(tmp) / "lstm512.pt"
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        system = loop.main(["--init", str(ckpt), "--arch", "lstm:512",
                            "--vocab", "512", "--test", "head:sinusoids0",
                            "--beam", "4", "--lm", str(lm), "--exp",
                            str(Path(tmp) / "exp")])
    torch.cuda.synchronize()
    launches = counts()
    print(f"hac --test head:sinusoids0 --beam 4 --lm <hal 1 x 2048>: "
          f"launches {launches}; fusion LM {system.fusion_layers} x "
          f"{system.fusion_dim}", flush=True)
    check(launches == serve_launches,
          f"the fused beam's launches {launches} are not phase 4's "
          f"{serve_launches}")
    check_persistent("hac --beam 4 --lm")
    rows = tsv_rows(out.getvalue())
    print(f"--beam 4 --lm TSV rows: {len(rows)}", flush=True)
    check((system.fusion_layers, system.fusion_dim) == (1, 2048),
          "hac did not take the hal checkpoint's geometry")

    _, batch = eval_batch(system)
    paths = {"fusion_ctc": launches}
    for kind, system, batch, n in (
            ("ctc", system, batch, 4),
            ("transducer", None, None, 2)):
        if kind == "transducer":
            system = make_system(torch, dev, "--arch",
                                 "rnn-transducer:lstm:512", "--beam", "4",
                                 "--lm", str(lm))
            batch = transducer_batch(system)
        max_steps = int(batch[1].shape[1]) + 1
        B = batch[0].shape[0]
        with torch.inference_mode():
            reset_counts()
            _, feats, feat_lens, _ = system._forward_impl(*batch,
                                                          train=False)
            fwd = counts()
            reset_counts()
            got = system._decode_impl(feats, feat_lens, max_steps=max_steps,
                                      train=False)
            torch.cuda.synchronize()
            dec = counts()
            rec = system.params["recognizer"]
            fusion = dict(fusion_params=system.fusion_params,
                          fusion_layers=system.fusion_layers,
                          fusion_dim=system.fusion_dim,
                          lm_weight=system.args.lm_weight)
            if kind == "ctc":
                lp = recognizer.temporal_classifier_log_probs(rec, feats)
                beams = beam_device.ctc_beam_search_batched(
                    lp, feat_lens, beam_width=4, **fusion)
                same, d = fusion_check(torch, lp, feat_lens, beams, n,
                                       fusion)
            else:
                beams = beam_device.transducer_beam_search_batched(
                    rec, feats, feat_lens, beam_width=4,
                    max_symbols=max_steps, **fusion)
                same, d = fusion_check(torch, feats, feat_lens, beams, n,
                                       fusion, rec)
            check(torch.equal(beams[0][:, 0], got[0]),
                  f"hac's {kind} beam is not the batched beam's best")
            system.args.beam = 1
            greedy = system._decode_impl(feats, feat_lens,
                                         max_steps=max_steps, train=False)
            plain = system.spec.recognizer.decode(
                rec, feats, feat_lens, max_steps=max_steps)
            system.args.beam = 4
        one = all(a is b is None or torch.equal(a, b)
                  for a, b in zip(greedy, plain))
        expect = dict(lstm_fwd=3, ctc_fwd=1) if kind == "ctc" else \
            dict(lstm_fwd=5, joint_lse=1)
        print(f"{kind} --beam 4 --lm, batch {B}: forward launches {fwd}, "
              f"beam decode launches {dec}; the best hyps of {n} items on "
              f"the card against the CPU: {sum(same)} of {n} the same, max "
              f"|dscore| {d:.3e}; --beam 1 the greedy decode {one}",
              flush=True)
        check_counts(f"{kind} fused beam forward", fwd, expect)
        check_counts(f"{kind} fused beam decode", dec, {})
        check(all(same) and d < 1e-3,
              f"the {kind} beam on the card differs from the CPU's")
        check(one, f"{kind} --beam 1 is not the greedy decode")

        def serve():
            _, feats, feat_lens, _ = system._forward_impl(*batch,
                                                          train=False)
            out = system._decode_impl(feats, feat_lens, max_steps=max_steps,
                                      train=False)
            return [t.cpu() for t in out if t is not None]
        with torch.inference_mode():
            ms, times = host_ms(torch, serve)
            print(f"{kind} eval forward + beam 4 with the 1 x 2048 LM, "
                  f"batch {B}: {B / ms * 1e3:.2f} utt/s ({ms:.3f} ms per "
                  f"batch, median of 5; {[round(t, 3) for t in times]}) on "
                  f"{card}", flush=True)
            profile_step(torch, serve, f"one {kind} fused beam batch")
        paths[f"fusion_{kind}_batch"] = fwd
    del system
    torch.cuda.empty_cache()
    return paths


def profile_step(torch, step, what="one train step"):
    """A torch.profiler breakdown of one call of ``step``: device time by
    kernel, and the device's busy share of the step's span; returns the
    device events and {kernel name: (count, ns)}. One traced
    warm-up call comes first and is discarded: the first milliseconds
    of device records a profiler takes can go missing. Device activity
    only, read from the raw records: host op records, and the profiler's
    own event tree, cost seconds over a decode call's ~18,000 launches."""
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.autograd.DeviceType.CUDA
    events = []                       # (name, start ns, end ns)

    def keep(p):
        # kernels and copies on the card, not the ranges that annotate them
        events.extend((e.name(), e.start_ns(), e.end_ns())
                      for e in p.profiler.kineto_results.events()
                      if e.device_type() == cuda and
                      not e.is_user_annotation())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        for _ in range(2):
            step()
            torch.cuda.synchronize()
            prof.step()
    if not events:
        print("profiler: no device events recorded", flush=True)
        return 0, {}
    t0 = min(s for _, s, _ in events)
    t1 = max(e for _, _, e in events)
    busy, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(events, key=lambda x: x[1]):  # union of spans
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for name, s, e in events:
        n, t = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, t + e - s)
    total = sum(t for _, t in by_name.values())
    print(f"profiler, {what}: device busy {busy / 1e6:.3f} ms of a "
          f"{(t1 - t0) / 1e6:.3f} ms span ({100 * busy / (t1 - t0):.1f}%), "
          f"{len(events)} device events", flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                               )[:14]:
        print(f"  {t / 1e6:9.3f} ms {100 * t / total:5.1f}%  x{n:<5d} "
              f"{name[:90]}", flush=True)
    return len(events), by_name


def main():
    if sys.argv[1:] not in ([], ["--hala-curve"]):
        raise SystemExit("usage: python3 chip_smoke.py [--hala-curve]")
    card = card_line()
    print(card, flush=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the smoke run needs one GPU")
    if not (ROOT / "haloop_tpu_torch" / "csrc").is_dir():
        raise SystemExit("haloop_tpu_torch/ not found beside chip_smoke.py: "
                         "run from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from haloop_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {kernels.build_seconds} s)", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)
    if sys.argv[1:] == ["--hala-curve"]:
        hala_curve(torch)
        return

    t_start = time.perf_counter()

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s, "
              f"{time.perf_counter() - t_start:.1f} s in all]", flush=True)
        return out
    paths = {}
    with tempfile.TemporaryDirectory() as tmp, hai_checkpoints(tmp) as hai:
        k1 = timed(phase_lstm, torch, dev)
        k3 = timed(phase_ctc, torch, dev)
        k1r, k2 = timed(phase_lstm_train, torch, dev)
        k1q8, k1q8r, k2q8 = timed(phase_lstm_q8, torch, dev, k1, k1r, k2)
        k4 = timed(phase_ctc_bwd, torch, dev)
        k9 = timed(phase_joint, torch, dev)
        k8 = timed(phase_star, torch, dev)
        timed(phase_long_lattice, torch, dev)
        k5, k7 = timed(phase_flash, torch, dev)
        k10 = timed(phase_fused_ce, torch, dev)
        k11 = timed(phase_decode, torch, dev)
        k12 = timed(phase_decode_long, torch, dev)
        k13 = timed(phase_q8, torch, dev)
        k6a, k6b, k5lse = timed(phase_flash_bwd, torch, dev)
        e6 = timed(phase_e6ctc_kernels, torch, dev)
        shape = f"{'x'.join(map(str, E6_ATTN))} bf16 non-causal " \
                "(e6ctc-d4:512)"
        for report, name in ((k5, "K5"), (k5lse, "K5-lse"), (k6a, "K6a"),
                             (k6b, "K6b"), (k3[False], "K3 history=False"),
                             (k3[True], "K3 history=True"), (k4, "K4")):
            report.setdefault("by_shape", {})[
                shape if name.startswith(("K5", "K6")) else
                "24x300x512 U=23 (e6ctc-d4:512's CTC head)"] = e6[name]
        hal_shape, hal_k = timed(phase_hal_kernels, torch, dev)
        for report, name in ((k1, "K1"), (k1r, "K1-residual"), (k2, "K2")):
            report["by_shape"][hal_shape] = hal_k[name]
        paths["serve"] = timed(phase_slice, torch, dev, tmp, card)
        paths["train"] = timed(phase_train, torch, dev, tmp, card)
        paths["hal"], hal_lm = timed(phase_hal, torch, dev, tmp, card)
        paths.update(timed(phase_fusion, torch, dev, tmp, card, hal_lm,
                           paths["serve"]))
        paths["transducer_train"], paths["transducer_serve"], \
            paths["transducer_16k_train"] = timed(phase_transducer, torch,
                                                  dev, card)
        paths["star_train"] = timed(phase_star_train, torch, dev, card)
        paths.update(timed(phase_attention, torch, dev, tmp, card))
        paths.update(timed(phase_attention_more, torch, dev, card))
        paths.update(timed(phase_rnn_q8, torch, dev, tmp, card))
        paths["transducer_entry"], paths["star_entry"] = timed(
            phase_entry, torch, tmp)
        decoder = hai("decoder")
        paths.update(timed(phase_hap, torch, dev, decoder, card))
        paths.update(timed(phase_hat, torch, dev, decoder, card))
        paths.update(timed(phase_gpt_entry, torch, tmp,
                           hai("gpt-nano:300:64"), decoder))
        paths["hala"], _ = timed(phase_hala, torch, dev, decoder, card)
        paths.update(timed(phase_hala_entry, torch, tmp))
        paths.update(timed(phase_hat_long, torch, dev, tmp,
                           hai("decoder:50304:4096"), card))
        paths.update(timed(phase_q8_serving, torch, dev, decoder, card))
    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "haloop_tpu") or
                     m.startswith(("jax.", "haloop_tpu.")))
    check(not foreign, f"the port imported the JAX package or JAX: "
                       f"{foreign}")

    def entry(name, source, replaces, report):
        by_path = {path: launches[name] for path, launches in paths.items()}
        check(sum(by_path.values()) > 0, f"no main path launched {name}")
        return dict(name=name, route="cuda",
                    source=f"haloop_tpu_torch/csrc/{source}",
                    replaces=f"haloop_tpu/{replaces}",
                    launches=sum(by_path.values()),
                    launches_by_path=by_path, **report)
    print(json.dumps({"kernels": [
        entry("lstm_fwd", "lstm_fwd.cu", "nn/lstm_pallas.py:178", k1),
        entry("lstm_fwd_residual", "lstm_fwd.cu", "nn/lstm_pallas.py:178",
              k1r),
        entry("lstm_bwd", "lstm_bwd.cu", "nn/lstm_pallas.py:294", k2),
        entry("lstm_fwd_q8", "lstm_q8.cu", "nn/lstm_pallas.py:178", k1q8),
        entry("lstm_fwd_q8_residual", "lstm_q8.cu", "nn/lstm_pallas.py:178",
              k1q8r),
        entry("lstm_bwd_q8", "lstm_q8.cu", "nn/lstm_pallas.py:294", k2q8),
        entry("ctc_fwd", "ctc_fwd.cu", "ops/ctc_pallas.py:184", k3[False]),
        entry("ctc_fwd_history", "ctc_fwd.cu", "ops/ctc_pallas.py:184",
              k3[True]),
        entry("ctc_bwd", "ctc_bwd.cu", "ops/ctc_pallas.py:275", k4),
        entry("joint_lse", "joint_lse.cu", "ops/joint_pallas.py:99",
              k9["fwd"]),
        entry("joint_lse_bwd", "joint_lse_bwd.cu", "ops/joint_pallas.py:131",
              k9["bwd"]),
        entry("star_fwd", "star_fwd.cu", "ops/star_pallas.py:227",
              k8[False]),
        entry("star_fwd_history", "star_fwd.cu", "ops/star_pallas.py:227",
              k8[True]),
        entry("star_bwd", "star_bwd.cu", "ops/star_pallas.py:275",
              k8["bwd"]),
        entry("flash_fwd", "flash_fwd.cu", "ops/flash.py:354", k5),
        entry("flash_fwd_lse", "flash_fwd.cu", "ops/flash.py:354", k5lse),
        entry("flash_bwd_dq", "flash_bwd.cu", "ops/flash.py:484", k6a),
        entry("flash_bwd_dkv", "flash_bwd.cu", "ops/flash.py:527", k6b),
        entry("flash_packed", "flash_fwd.cu", "ops/flash.py:449", k7),
        entry("fused_ce", "fused_ce.cu", "ops/fused_ce.py:106", k10),
        entry("decode_attn", "decode_attn.cu", "ops/decode_attn.py:148",
              k11),
        entry("decode_attn_split", "decode_attn.cu",
              "ops/decode_attn.py:296", k12),
        entry("q8_matmul", "q8_matmul.cu", "ops/q8_matmul.py:108", k13),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
