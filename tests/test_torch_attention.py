"""The port's attention and GPT kernel modules on the CPU (ops/attention,
ops/rope, ops/flash + flash_cuda, ops/fused_ce + fused_ce_cuda,
ops/decode_attn + decode_attn_cuda, nn/core's layer_norm and new_gelu)
against the JAX package's, on the same numpy inputs. Where the JAX
function is a Pallas kernel it runs in interpret mode, as its own tests
run it (tests/test_flash.py, test_decode_attn.py,
test_lattice_kernels.py).

Tolerances: fp32 forward values 2e-5 (the JAX package's bound for its
flash kernel against its reference); decode attention 1e-5 in fp32 and
2e-2 in bf16, caches bit for bit (tests/test_decode_attn.py); gradients
rtol 1e-4, atol 1e-5 (tests/test_flash.py's packed backward); the
cross-entropy 1e-5 (one fp32 logsumexp in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haloop_tpu.nn import core as JC
from haloop_tpu.ops import attention as JA
from haloop_tpu.ops import decode_attn as JD
from haloop_tpu.ops import flash as JF
from haloop_tpu.ops import fused_ce as JCE
from haloop_tpu.ops import rope as JR
from haloop_tpu_torch.nn import core as TC
from haloop_tpu_torch.ops import attention as TA
from haloop_tpu_torch.ops import decode_attn as TD
from haloop_tpu_torch.ops import flash as TF
from haloop_tpu_torch.ops import fused_ce as TCE
from haloop_tpu_torch.ops import rope as TR

TFC, TCEC, TDC = (importlib.import_module(f"haloop_tpu_torch.ops.{m}")
                  for m in ("flash_cuda", "fused_ce_cuda",
                            "decode_attn_cuda"))
torch.set_num_threads(1)


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- nn/core, rope

def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = normal(rng, 3, 5, 64, scale=3.0)
    p = {"weight": normal(rng, 64), "bias": normal(rng, 64)}
    got = TC.layer_norm({k: t(v) for k, v in p.items()}, t(x))
    want = JC.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    nob = TC.layer_norm({"weight": t(p["weight"])}, t(x).to(torch.bfloat16))
    assert nob.dtype == torch.bfloat16
    np.testing.assert_allclose(TC.new_gelu(t(x)).numpy(),
                               np.asarray(JC.new_gelu(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["t0", "positions", "rows"])
def test_rotate_interleaved_matches_jax(kind):
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 3, 7, 16)
    kw_t, kw_j = {}, {}
    if kind == "t0":
        kw_t = kw_j = {"t0": 5}
    elif kind == "positions":
        pos = rng.integers(0, 50, 7).astype(np.int32)
        kw_t, kw_j = {"positions": t(pos)}, {"positions": jnp.asarray(pos)}
    else:
        pos = rng.integers(0, 50, (2, 7)).astype(np.int32)
        kw_t, kw_j = {"positions": t(pos)}, {"positions": jnp.asarray(pos)}
    got = TR.rotate_interleaved(t(x), **kw_t)
    want = JR.rotate_interleaved(jnp.asarray(x), **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------- attend, mha

def test_attend_matches_jax_with_mask_and_entropy():
    rng = np.random.default_rng(2)
    q, k, v = normal(rng, 2, 3, 9, 16), normal(rng, 2, 3, 11, 16), \
        normal(rng, 2, 3, 11, 16)
    mask = rng.random((2, 1, 9, 11)) < 0.3
    mask[0, 0, 4] = True                        # a fully masked row
    got, ent = TA.attend(t(q), t(k), t(v), mask=t(mask),
                         measure_entropy=True)
    want, went = JA.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask=jnp.asarray(mask), measure_entropy=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(ent.item(), float(went), rtol=1e-5)
    assert torch.equal(TA.causal_mask(4, 6, 1),
                       t(np.asarray(JA.causal_mask(4, 6, 1))))


@pytest.mark.parametrize("T,causal,packed", [
    (40, True, False),          # under the floors: attend
    (256, True, False),         # causal floor: flash attention (K5)
    (300, False, False),        # non-causal floor: K5
    (256, True, True),          # packed: K7
    (100, True, True),          # packed under the floor: attend
])
def test_mha_routes_and_matches_jax(T, causal, packed):
    """The port routes by shape as the JAX package does on its TPU; on the
    CPU every route's plain version gives the JAX package's values (whose
    CPU route is always attend)."""
    rng = np.random.default_rng(T)
    q, k, v = (normal(rng, 2, 2, T, 32) for _ in range(3))
    seg = None
    if packed:
        seg = np.repeat(np.arange(1, T // 20 + 2), 20)[:T][None]
        seg = np.concatenate([seg, seg[:, ::-1]]).astype(np.int32)
        seg[1, -7:] = 0
    before = (TFC.launches, TFC.packed_launches)
    calls = []
    real = (TF._reference, TF._packed_reference)
    TF._reference = lambda *a, **kw: calls.append("K5") or real[0](*a, **kw)
    TF._packed_reference = lambda *a, **kw: calls.append("K7") or \
        real[1](*a, **kw)
    try:
        got, _ = TA.mha(t(q), t(k), t(v), causal=causal,
                        segment_ids=None if seg is None else t(seg))
    finally:
        TF._reference, TF._packed_reference = real
    want, _ = JA.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal,
                     segment_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    floor = 256 if causal else 300
    route = [] if T < floor else ["K7" if packed else "K5"]
    assert calls == route
    assert (TFC.launches, TFC.packed_launches) == before   # CPU: no kernel


# ------------------------------------------------------- flash (K5, K7)

@pytest.mark.parametrize("T,S,causal,t0", [(160, 160, False, 0),
                                           (300, 300, True, 0),
                                           (160, 288, True, 5)])
def test_flash_reference_matches_jax_kernel(T, S, causal, t0):
    rng = np.random.default_rng(0)
    q = normal(rng, 2, 2, T, 64)
    k, v = normal(rng, 2, 2, S, 64), normal(rng, 2, 2, S, 64)
    kvl = np.array([S, max(S // 2, 1)], np.int32)
    want = JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(kvl), causal, t0, True)
    got = TFC.flash_attention(t(q), t(k), t(v), t(kvl), causal, t0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    o, lse = TFC.FlashAttention.apply(t(q), t(k), t(v), t(kvl), causal, t0)
    _, (*_, jlse) = JF._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(kvl), causal, t0, True)
    jlse = np.asarray(jlse)[:, :T, 0].reshape(2, 2, T)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-4, rtol=1e-5)


def test_flash_reference_fully_masked_row_is_the_mean_of_v():
    rng = np.random.default_rng(3)
    q, k, v = (normal(rng, 1, 2, 8, 16) for _ in range(3))
    got = TF._reference(t(q), t(k), t(v), torch.tensor([0]), True, 0)
    np.testing.assert_allclose(got.numpy(),
                               np.broadcast_to(v.mean(2, keepdims=True),
                                               q.shape), atol=1e-6)
    want = JF._reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray([0]), True, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


K6_CASES = [(160, 160, False, 0), (300, 300, True, 0), (160, 288, True, 5)]


def _k6_inputs(T, S, D, seed):
    """q, k, v, do and ragged key lengths, the second row's length 0 at
    T = 300 (every column masked) and S // 2 + 3 otherwise."""
    rng = np.random.default_rng(seed)
    q, do = normal(rng, 2, 2, T, D), normal(rng, 2, 2, T, D)
    k, v = normal(rng, 2, 2, S, D), normal(rng, 2, 2, S, D)
    kvl = np.array([S, 0 if T == 300 else S // 2 + 3], np.int32)
    return q, k, v, do, kvl


@pytest.mark.parametrize("T,S,causal,t0", K6_CASES)
@pytest.mark.parametrize("D", [32, 64])
def test_backward_reference_matches_jax_kernel(T, S, causal, t0, D):
    """The plain K6 against the JAX package's dq/dkv kernels
    (_flash_backward, interpret mode) on the same o and lse, fp32: the
    same fp32 products summed in another order (rel 1e-5 of the largest
    gradient). The zero-length row gets zero gradients in both."""
    q, k, v, do, kvl = _k6_inputs(T, S, D, T + S + D)
    jq, jk, jv, jkvl = (jnp.asarray(a) for a in (q, k, v, kvl))
    _, (*_, jo, jlse) = JF._fwd(jq, jk, jv, jkvl, causal, t0, True)
    want = JF._flash_backward(jq, jk, jv, jkvl, causal, t0, jo, jlse,
                              jnp.asarray(do), interpret=True)
    lse = np.asarray(jlse)[:, :T, 0].reshape(2, 2, T)
    got = TF._backward_reference(t(q), t(k), t(v), t(kvl), causal, t0,
                                 t(jo), t(lse), t(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
        if kvl[1] == 0:
            assert not g[1].any() and not w[1].any()


def test_flash_attention_backward_is_kernel_k6():
    """FlashAttention's backward on the CPU (the plain K6 from the
    forward's lse) against jax.grad of the JAX package's flash_attention
    in interpret mode (its K6a/K6b), ragged lengths with a zero-length
    row, causal with t0 > 0, T != S; the CPU takes no kernel."""
    T, S, t0 = 100, 140, 7
    q, k, v, do, _ = _k6_inputs(T, S, 32, 4)
    kvl = np.array([120, 0], np.int32)
    jg = jax.grad(lambda *a: jnp.sum(JF.flash_attention(
        *a, jnp.asarray(kvl), True, t0, True) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    before = (TFC.bwd_dq_launches, TFC.bwd_dkv_launches)
    (TFC.flash_attention(tq, tk, tv, t(kvl), True, t0) * t(do)).sum() \
        .backward()
    assert (TFC.bwd_dq_launches, TFC.bwd_dkv_launches) == before
    for a, b in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
        assert not a.grad[1].any()


@pytest.mark.parametrize("causal", [True, False])
def test_packed_reference_matches_jax_kernel(causal):
    rng = np.random.default_rng(2)
    T = 256
    q, k, v = (normal(rng, 2, 2, T, 64) for _ in range(3))
    seg = np.zeros((2, T), np.int32)
    for r in range(2):
        fill, s = 0, 1
        while fill < T - 16:
            n = min(int(rng.integers(8, 90)), T - 16 - fill)
            seg[r, fill:fill + n] = s
            fill, s = fill + n, s + 1
    want = JF.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(seg),
                                     causal, interpret=True)
    got = TFC.flash_attention_packed(t(q), t(k), t(v), t(seg), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_packed_gradients_match_jax():
    """FlashAttentionPacked's backward (recompute through the plain
    version) against the JAX package's custom VJP."""
    rng = np.random.default_rng(0)
    N, H, T, D = 1, 2, 16, 8
    q, k, v = (normal(rng, N, H, T, D) for _ in range(3))
    g = normal(rng, N, H, T, D)
    seg = np.repeat([1, 2, 3, 0], 4)[None, :].astype(np.int32)
    jg = jax.grad(lambda *a: jnp.sum(JF.flash_attention_packed(
        *a, jnp.asarray(seg), True, True) * g), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    (TFC.flash_attention_packed(tq, tk, tv, t(seg), True) * t(g)).sum() \
        .backward()
    for a, b in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------- fused CE (K10)

@pytest.mark.parametrize("N,V,D", [(70, 5000, 64), (300, 4100, 32)])
def test_fused_ce_matches_jax(N, V, D):
    rng = np.random.default_rng(N)
    x, w = normal(rng, N, D), normal(rng, V, D, scale=0.2)
    tg = rng.integers(0, V, N).astype(np.int32)
    want = JCE.fused_ce_nll(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tg),
                            True)
    got = TCEC.fused_ce_nll(t(x), t(w), t(tg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    ref = TCE.reference_ce_nll(t(x), t(w), t(tg))
    np.testing.assert_allclose(ref.numpy(), np.asarray(JCE.reference_ce_nll(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(tg))), atol=1e-5,
        rtol=1e-5)


def test_fused_ce_gradients_match_jax():
    rng = np.random.default_rng(5)
    N, V, D = 40, 4200, 32
    x, w = normal(rng, N, D), normal(rng, V, D, scale=0.2)
    tg = rng.integers(0, V, N).astype(np.int32)
    g = normal(rng, N)
    jdx, jdw = jax.grad(lambda x, w: jnp.sum(JCE.fused_ce_nll(
        x, w, jnp.asarray(tg), True) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = t(x).requires_grad_(True), t(w).requires_grad_(True)
    (TCEC.fused_ce_nll(tx, tw, t(tg)) * t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------- decode attention (K11)

@pytest.mark.parametrize("B,S,H,D", [(2, 128, 2, 16), (3, 256, 12, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_starts", [False, True])
def test_decode_attend_matches_jax_kernel(B, S, H, D, dtype, with_starts):
    E = H * D
    rng = np.random.default_rng(B * S + with_starts)
    q, kn, vn = (normal(rng, B, E) for _ in range(3))
    kc, vc = (normal(rng, B, S, E) for _ in range(2))
    L = S // 2 + 3
    starts = rng.integers(0, 5, B).astype(np.int32) if with_starts else None
    jd = getattr(jnp, dtype)
    jy, jk, jv = JD.decode_attend_update(
        *(jnp.asarray(a, jd) for a in (q, kn, vn, kc, vc)), jnp.int32(L),
        None if starts is None else jnp.asarray(starts), n_head=H,
        interpret=True)
    td = getattr(torch, dtype)
    tk, tv = t(kc).to(td), t(vc).to(td)
    before = TDC.launches
    y = TDC.decode_attend_update(
        *(t(a).to(td) for a in (q, kn, vn)), tk, tv, L,
        None if starts is None else t(starts), n_head=H)
    assert TDC.launches == before
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,L,with_starts", [(1024, 1000, True),
                                             (256, 0, False),
                                             (256, 0, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attend_matches_jax_kernel_at_the_fill_edges(S, L,
                                                           with_starts,
                                                           dtype):
    """K11's plain path against the JAX kernel (interpret mode) at GPT-2
    small's longest fill (row 1000 of a 1024-row cache, left-pad starts,
    12 heads of 64) and at the first token (row 0; starts 0, since a row
    starts at or before the new token): the caches bit for bit, y within
    the tolerances above."""
    B, H, D = 2, 12, 64
    E = H * D
    rng = np.random.default_rng(S + L)
    q, kn, vn = (normal(rng, B, E) for _ in range(3))
    kc, vc = (normal(rng, B, S, E) for _ in range(2))
    starts = None
    if with_starts:
        starts = rng.integers(0, min(L, 16) + 1, B).astype(np.int32)
    jd = getattr(jnp, dtype)
    jy, jk, jv = JD.decode_attend_update(
        *(jnp.asarray(a, jd) for a in (q, kn, vn, kc, vc)), jnp.int32(L),
        None if starts is None else jnp.asarray(starts), n_head=H,
        interpret=True)
    td = getattr(torch, dtype)
    tk, tv = t(kc).to(td), t(vc).to(td)
    y = TDC.decode_attend_update(
        *(t(a).to(td) for a in (q, kn, vn)), tk, tv, L,
        None if starts is None else t(starts), n_head=H)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)


def test_decode_attend_first_token_is_v_new():
    rng = np.random.default_rng(0)
    q, kn, vn = (t(normal(rng, 2, 64)) for _ in range(3))
    kc, vc = torch.zeros((2, 128, 64)), torch.zeros((2, 128, 64))
    y = TD.decode_attend(q, kn, vn, kc, vc, 0, n_head=2)
    torch.testing.assert_close(y, vn, rtol=1e-6, atol=1e-6)
    assert torch.equal(kc[:, 0], kn) and not kc[:, 1:].any()
