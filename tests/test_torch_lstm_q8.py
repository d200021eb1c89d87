"""The int8 mode of the LSTM recurrence (hac ``--rnn-q8``): the port's
plain versions of kernels K1-q8 and K2-q8 (``nn.lstm.lstm_scan_q8`` /
``lstm_scan_bwd_q8``, through ``nn.lstm_cuda``'s ``LSTMScanQ8`` Function
on CPU tensors) against the JAX package's int8 kernel
(``haloop_tpu.nn.lstm_pallas``, interpreted) on the same numpy inputs, and
the slice as a whole against the JAX package's hac with ``--rnn-q8`` and
its kernels forced (``HALOOP_KERNELS=1``; on the CPU the JAX package
otherwise runs the exact scan under ``--rnn-q8``).

Tolerances. The integer sums are exact in both packages, so the two
differ only where sigmoid, tanh or a sum of fp32 products rounds one ulp
apart; such an ulp can flip round(h * 127), or a bf16 rounding, which is
the expected noise. quantize_rows: bit for bit. Module outputs: fp32
values within 1e-5 on all but 1% of the elements and 1e-3 on every one;
bf16 values within 1e-5 on all but 1% and one bf16 step (at most 2^-7 of
the larger magnitude) on every one. Gradients: cosine > 0.9999 against
jax.grad of the JAX kernel, and each element within 1e-2 of the largest
|g| on all but 1% of the elements. The q8 output differs from the exact
one by 1e-9 < rel < 0.05 (as tests/test_lstm_pallas.py::
test_multilayer_dispatch asks), so the mode is known to have run. The
slice (fp32 encoder) and the train steps: the bounds stated at each
test, with the readings that placed them.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import haloop_tpu.models.recognizer as j_recognizer
import haloop_tpu.models.rnn as j_rnn
from haloop_tpu.nn import lstm_pallas as Q
import haloop_tpu_torch.models.recognizer as t_recognizer
import haloop_tpu_torch.models.rnn as t_rnn
from haloop_tpu_torch import loop
from haloop_tpu_torch.nn import lstm, lstm_cuda
from haloop_tpu_torch.ops import joint as t_joint

from test_torch_loop import by_tag, run, stats, write_hac_checkpoint
from test_torch_train import batch, make_systems

torch.set_num_threads(1)
# the modules, not the functions their packages re-export by these names
j_lstm = importlib.import_module("haloop_tpu.nn.lstm")
Q8_SHAPES = [(12, 3, 64), (7, 5, 40), (20, 4, 128)]


def _data(T, B, H, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(4 * H, H)).astype(np.float32) * scale
    xp = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32) * 0.1
    c0 = rng.normal(size=(B, H)).astype(np.float32) * 0.1
    return w, xp, h0, c0


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_q8_close(got, want, bf16):
    """The share-of-elements rule of the module docstring."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d > 1e-5).mean() <= 0.01, (d > 1e-5).mean()
    top = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7 if bf16 \
        else 1e-3
    assert (d <= top).all(), d.max()


# ------------------------------------------------------------ quantize

def test_quantize_rows_matches_jax_bit_for_bit():
    """Random rows (fp32 and bf16 values), a zero row (s = 1e-20) and a
    row of exact ties: max 63.5 gives s = 0.5, so 0.25, 0.75, -1.25 and
    2.5 sit at w / s = 0.5, 1.5, -2.5, 5 and round half to even."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 8)).astype(np.float32)
    w[3] = 0.0
    w[4] = [63.5, 0.25, 0.75, -1.25, 2.5, -0.25, 1.75, -63.5]
    w[5] = np.asarray(jnp.asarray(w[5]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    for dtype in ("float32", "bfloat16"):
        wq, s = lstm.quantize_rows(torch.from_numpy(w).to(getattr(torch,
                                                                  dtype)))
        jwq, js = Q.quantize_rows(jnp.asarray(w).astype(dtype))
        assert wq.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert wq[4].tolist() == [127, 0, 2, -2, 5, 0, 4, -127]
    assert s[3].item() == np.float32(1e-20)


# ------------------------------------------------------------ K1-q8

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", Q8_SHAPES)
def test_lstm_scan_q8_matches_jax_kernel(shape, dtype):
    """Plain K1-q8, with and without residuals, against the JAX kernel's
    _fwd (interpreted) on the same quantized weights; the residuals are
    bf16 even for fp32 x_proj, and the residual mode changes nothing
    else."""
    w, xp, h0, c0 = _data(*shape, seed=sum(shape))
    td = getattr(torch, dtype)
    wq, s = lstm.quantize_rows(torch.from_numpy(w))
    args = (wq, s, torch.from_numpy(xp).to(td), torch.from_numpy(h0),
            torch.from_numpy(c0))
    ys, h, c, acts, cs = lstm.lstm_scan_q8(*args, residuals=True)
    assert ys.dtype == td and h.dtype == c.dtype == torch.float32
    assert acts.dtype == cs.dtype == torch.bfloat16
    for g, e in zip(lstm.lstm_scan_q8(*args), (ys, h, c)):
        assert torch.equal(g, e)
    jwq, js = Q.quantize_rows(jnp.asarray(w))
    want = Q._fwd(jwq, js, jnp.asarray(xp).astype(dtype), jnp.asarray(h0),
                  jnp.asarray(c0), True, interpret=True, residuals=True)
    assert want[1].dtype == want[2].dtype == jnp.bfloat16
    for g, e, bf16 in zip((ys, acts, cs, h, c), want,
                          (dtype == "bfloat16", True, True, False, False)):
        assert_q8_close(g.float().numpy(), _f32(e), bf16)


def test_q8_differs_from_the_exact_mode():
    """The int8 mode ran: close to the exact fp32 recurrence, not equal."""
    w, xp, h0, c0 = (torch.from_numpy(a) for a in _data(20, 4, 128, 1))
    wq, s = lstm.quantize_rows(w)
    ys, _, _ = lstm.lstm_scan_q8(wq, s, xp, h0, c0)
    ye, _, _ = lstm.lstm_scan(w, xp, h0, c0)
    rel = float((ys - ye).abs().mean() / (ye.abs().mean() + 1e-9))
    assert 1e-9 < rel < 0.05, rel


# ------------------------------------------------------------ gradients

def _grad_inputs(T, B, H, seed):
    w, xp, h0, c0 = _data(T, B, H, seed)
    rng = np.random.default_rng(seed + 100)
    cot = tuple(rng.normal(size=shape).astype(np.float32)
                for shape in ((T, B, H), (B, H), (B, H)))
    return (w, xp, h0, c0), cot


def _loss_terms(ys, h, c, cot, xnp):
    wy, wh, wc = (xnp(a) for a in cot)
    return ((ys * wy).sum() + (h * wh).sum() + (c * wc).sum())


def _port_grads(inputs, cot, dtype):
    td = getattr(torch, dtype)
    w, xp, h0, c0 = (torch.from_numpy(a) for a in inputs)
    w, xp = w.to(td).requires_grad_(True), xp.to(td).requires_grad_(True)
    h0, c0 = h0.requires_grad_(True), c0.requires_grad_(True)
    ys, h, c = lstm_cuda.lstm_scan(w, xp, h0, c0, q8=True)
    assert type(ys.grad_fn).__name__ == "LSTMScanQ8Backward"
    loss = _loss_terms(ys.float(), h.float(), c.float(), cot,
                       torch.from_numpy)
    grads = torch.autograd.grad(loss, (w, xp, h0, c0))
    assert [g.dtype for g in grads] == [td, td, torch.float32,
                                        torch.float32]
    return [g.float().numpy() for g in grads]


def _jax_grads(inputs, cot, dtype):
    w, xp, h0, c0 = (jnp.asarray(a) for a in inputs)

    def loss(w, xp, h0, c0):
        ys, h, c = Q.lstm_scan_pallas(w, xp, h0, c0, True)
        return _loss_terms(ys.astype(jnp.float32), h.astype(jnp.float32),
                           c.astype(jnp.float32), cot, jnp.asarray)
    return [_f32(g) for g in jax.grad(loss, (0, 1, 2, 3))(
        w.astype(dtype), xp.astype(dtype), h0, c0)]


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 3, 64), (6, 5, 40)])
def test_lstm_q8_grads_match_jax_kernel(shape, dtype):
    """The LSTMScanQ8 Function on CPU tensors (plain K1-q8 with residuals,
    plain K2-q8, the dW_hh matmul) against jax.grad of the JAX int8 kernel
    (interpreted): W_hh, x_proj, h0, c0."""
    inputs, cot = _grad_inputs(*shape, seed=2 * sum(shape))
    got = _port_grads(inputs, cot, dtype)
    want = _jax_grads(inputs, cot, dtype)
    for name, g, e in zip(("W_hh", "x_proj", "h0", "c0"), got, want):
        assert _cos(g, e) > 0.9999, (name, _cos(g, e))
        d = np.abs(g - e) / np.abs(e).max()
        assert (d > 1e-2).mean() <= 0.01, (name, (d > 1e-2).mean())


def test_lstm_scan_bwd_q8_quantizes_each_row_over_all_4h():
    """Plain K2-q8 on its own: dgates are the exact mode's sweep of the
    same residuals at T = 1 (nothing recurrent yet), and dh0 is the
    dequantized product with one scale a batch row taken over all 4H
    columns, to the bit."""
    T, B, H = 1, 3, 16
    w, xp, h0, c0 = (torch.from_numpy(a) for a in _data(T, B, H, 7))
    wq, s = lstm.quantize_rows(w)
    _, _, _, acts, cs = lstm.lstm_scan_q8(wq, s, xp, h0, c0, residuals=True)
    rng = np.random.default_rng(8)
    dys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32))
    dh, dc = (torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
              for _ in range(2))
    c_prev = c0[None].to(torch.bfloat16)
    dys = dys.to(torch.bfloat16)
    dg, dh0, dc0 = lstm.lstm_scan_bwd_q8(dys, acts, c_prev, cs, wq, s, dh,
                                         dc)
    dg_e, _, dc0_e = lstm.lstm_scan_bwd(dys, acts, c_prev, cs,
                                        wq.float() * s[:, None], dh, dc)
    assert dg.dtype == torch.bfloat16 and torch.equal(dg, dg_e)
    assert torch.equal(dc0, dc0_e)
    # dh0 from the fp32 dgates (not the stored bf16 ones) times s
    dgs = _fp32_dgates(dys, acts, c_prev, cs, dh, dc)[0] * s
    m = dgs.abs().amax(-1, keepdim=True)
    q = torch.clamp(torch.round(dgs / m * 127), -127, 127)
    want = (q.double() @ wq.double()).float() * (m / 127)
    assert torch.equal(dh0, want)


def _fp32_dgates(dys, acts, c_prev, cs, dh, dc):
    """The fp32 dgates of one step of the exact sweep (T = 1)."""
    i, f, g, o = acts[0].float().chunk(4, dim=-1)
    tc = torch.tanh(cs[0].float())
    dh = dh.to(torch.bfloat16).float() + dys[0].float()
    dc = dc.to(torch.bfloat16).float()
    do = dh * tc * o * (1 - o)
    dc = dc + dh * o * (1 - tc * tc)
    return torch.cat([dc * g * i * (1 - i),
                      dc * c_prev[0].float() * f * (1 - f),
                      dc * i * (1 - g * g), do], dim=-1)[None]


def test_q8_training_converges():
    """tests/test_lstm_pallas.py::test_q8_training_converges for the port:
    a tiny LSTM regression trained through LSTMScanQ8's straight-through
    gradients (Adam, lr 3e-2, 200 steps) ends under 0.35 of its first
    loss."""
    H, B, T = 32, 4, 16
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(T, B, 4 * H)).astype(np.float32))
    target = torch.from_numpy(
        rng.normal(size=(T, B, H)).astype(np.float32)) * .3
    w = torch.from_numpy(rng.normal(size=(4 * H, H)).astype(np.float32)
                         * 0.1).requires_grad_(True)
    h0 = c0 = torch.zeros((B, H))
    opt = torch.optim.Adam([w], lr=3e-2)
    losses = []
    for _ in range(200):
        ys, _, _ = lstm_cuda.lstm_scan(w, x, h0, c0, q8=True)
        loss = torch.mean((ys - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.35, (losses[0], losses[-1])


# ------------------------------------------------------------ the slice

def test_q8_slice_matches_jax_kernels(tmp_path):
    """hac --rnn-q8 --dtype float32 --test on a JAX-written lstm-tiny:512
    checkpoint: the port (--device cpu, the plain int8 versions) against
    the JAX package with its int8 kernel interpreted: the same hyp, ref
    and ali rows, stat fields within 1e-3, the loss within rel 1e-4. (With
    the bf16 encoder the two packages' bf16 convolutions already differ by
    a bf16 step, each such step can flip a round(h * 127), and 2 of the 16
    near-tie greedy hypotheses of this random-init model flip with them;
    the bf16 int8 path is held module by module above and in the
    transducer's train steps below.)"""
    ckpt = write_hac_checkpoint(tmp_path / "tiny.pt")
    flags = ("--rnn-q8", "--dtype", "float32")
    j_rows, j_loss = run("haloop_tpu.loop", ckpt, tmp_path, *flags,
                         env={"HALOOP_KERNELS": "1"})
    t_rows, t_loss = run("haloop_tpu_torch.loop", ckpt, tmp_path, *flags,
                         "--device", "cpu")
    for tag in ("hyp0", "ref", "ali0"):
        assert len(by_tag(t_rows, tag)) == 16
        assert by_tag(t_rows, tag) == by_tag(j_rows, tag), tag
    j_stat, t_stat = by_tag(j_rows, "stat0"), by_tag(t_rows, "stat0")
    assert j_stat.keys() == t_stat.keys()
    for k in j_stat:
        js, ts = stats(j_stat[k]), stats(t_stat[k])
        assert js.keys() == ts.keys()
        for name in js:
            if name != "prompt":
                assert abs(float(js[name]) - float(ts[name])) <= 1e-3, \
                    (k, name, js[name], ts[name])
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout as the identity in both packages (their draws differ)."""
    for mod in (j_rnn, j_recognizer, t_rnn, t_recognizer):
        monkeypatch.setattr(mod, "dropout", lambda k, x, *a, **kw: x)
    for mod in (j_lstm, lstm):
        monkeypatch.setattr(mod, "dropout_fn", lambda k, x, *a, **kw: x)


def _joint_grad_direct(f, g, lse, dlse, mf, mg):
    """The joint's backward as ops/joint.py's direct oracle (the JAX
    kernel's arithmetic), in place of the port's factored form."""
    return t_joint.pairwise_lse_grad_reference(f, g, lse, dlse)


def _joint_grad_fp64(f, g, lse, dlse, mf, mg):
    """The joint's backward as the direct sum in fp64: the exact gradient
    of the fp32 lse the forward gave."""
    f, g, lse, dlse = (x.double() for x in (f, g, lse, dlse))
    p = torch.exp(f[:, :, None] + g[:, None] - lse[..., None]) * \
        dlse[..., None]                                    # (N, T, U+1, V)
    return p.sum(2).float(), p.sum(1).float()


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ["lstm-tiny:512", "rnn-transducer-tiny:512"])
def test_q8_train_steps_match_jax(no_dropout, monkeypatch, arch, steps):
    """make_systems("--rnn-q8") (fp32 encoder masters, the transducer's
    prediction net in bf16): train steps of the port on the CPU against
    the JAX System with HALOOP_RNN_Q8=1 and its kernels interpreted.

    One step: loss rel 1e-5 and grad norm rel 1e-4 (read: 1.5e-7 and
    4.1e-6 at most); per leaf the gradients agree to rel 6e-4 in L2, but
    Adam's first step is lr * g / (|g| + 1e-8), so an element near 1e-8
    moves visibly: params within 1e-5 on all but 5% of the elements (read
    3.0% at most) and 2 lr on every one. Three steps: the first update's
    moved elements change the next gradients, and Adam's early steps are
    near lr * sign(g), so a rounding anywhere moves the third loss by up
    to ~1e-3: every param within 2 lr a step, and the losses and norms
    held by three runs of the port on the same batches, its joint
    backward the factored form in the first, the direct sum in fp32 (the
    JAX kernel's arithmetic) in the second and in fp64 (the exact
    gradient) in the third:
      * direct fp32 against JAX: the int8 paths with the joint's
        arithmetic matched, loss rel 1e-3, norm rel 1e-2 (read 9.95e-4
        and 3.4e-3 at most);
      * the port against JAX within the same limits plus what the joint's
        arithmetic alone moves in this run (|port - direct fp32|; the
        port's third loss read 1.58e-3 from JAX's, 5.8e-4 of it from the
        joint's arithmetic);
      * the port no farther from the fp64 run than the direct fp32 run
        is: its factored form is nearer the exact gradient (at the second
        step, where the prediction net's logits reach 112, 2.2e-8 from it
        against the direct form's 2.9e-7). The third losses read: the
        fp64 run 1.58e-3 from JAX's, the port 4.5e-6 from the fp64 run (its
        second step the fp64 run's bits) and the direct fp32 run 5.9e-4."""
    monkeypatch.setenv("HALOOP_RNN_Q8", "1")
    monkeypatch.setenv("HALOOP_KERNELS", "1")
    jsys, tsys = make_systems("--arch", arch, "--rnn-q8")
    assert tsys.args.rnn_q8
    lr = tsys.args.lr
    controls = [] if steps == 1 else [
        make_systems("--arch", arch, "--rnn-q8")[1] for _ in range(2)]
    grads = [t_joint.pairwise_lse_grad, _joint_grad_direct, _joint_grad_fp64]
    for step in range(steps):
        _, inputs, ct, il, tl = batch(start=8 * (step % 2))
        out = jsys._train_step(jsys.params, jsys.opt_state, inputs, ct, il,
                               tl, jsys.next_key(), jnp.int32(step))
        jsys.params, jsys.opt_state = out[0], out[1]
        want = np.array([float(out[2]), float(out[3])])
        runs = []
        for sys_, grad in zip([tsys] + controls, grads):
            monkeypatch.setattr(t_joint, "pairwise_lse_grad", grad)
            loss, norm, bad = sys_.train_step(*sys_.to_device(inputs, ct, il,
                                                              tl))
            assert not bad and not bool(out[4])
            runs.append(np.array([loss, norm], dtype=np.float64))
        if steps == 1:
            np.testing.assert_allclose(runs[0][0], want[0], rtol=1e-5)
            np.testing.assert_allclose(runs[0][1], want[1], rtol=1e-4)
            continue
        port, direct, exact = runs
        limit = np.array([1e-3, 1e-2]) * np.abs(want)
        assert (np.abs(direct - want) <= limit).all(), (step, direct, want)
        assert (np.abs(port - want) <= limit + np.abs(port - direct)).all(), \
            (step, port, direct, want)
        assert (np.abs(port - exact) <= np.abs(direct - exact)).all(), \
            (step, port, direct, exact)
    assert tsys.updates == steps
    want = jax.tree.map(np.asarray, jsys.params)
    for path, leaf in tsys.leaves:
        w = want
        for k in path:
            w = w[k]
        d = np.abs(leaf.detach().numpy() - w)
        assert d.max() <= 2 * lr * steps, (path, d.max())
        if steps == 1:
            assert (d > 1e-5).mean() < 0.05, (path, (d > 1e-5).mean())


def test_rnn_q8_reaches_the_plain_int8_versions(monkeypatch, tmp_path,
                                                capsys):
    """hac --rnn-q8 --train --eval on the CPU: every LSTM layer runs the
    plain K1-q8 (with residuals under autograd, without in eval) and
    K2-q8, and never the exact mode's plain versions."""
    calls = {"fwd": 0, "fwd_res": 0, "bwd": 0}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name if not kwargs.get("residuals") else "fwd_res"] += 1
            return fn(*args, **kwargs)
        return wrapped

    def refuse(*args, **kwargs):
        raise AssertionError("the exact mode ran under --rnn-q8")
    monkeypatch.setattr(lstm, "lstm_scan_q8", count("fwd",
                                                    lstm.lstm_scan_q8))
    monkeypatch.setattr(lstm, "lstm_scan_bwd_q8",
                        count("bwd", lstm.lstm_scan_bwd_q8))
    monkeypatch.setattr(lstm, "lstm_scan", refuse)
    monkeypatch.setattr(lstm, "lstm_scan_bwd", refuse)
    loop.main(["--arch", "lstm-tiny:512", "--vocab", "512", "--device",
               "cpu", "--rnn-q8", "--train", "head:sinusoids0", "--eval",
               "head:sinusoids0", "--num-epochs", "1", "--batch-size", "8",
               "--log-interval", "1", "--save", "none", "--exp",
               str(tmp_path), "-q"])
    losses = re.findall(r"\] time: [\d.]+ loss: ([\d.]+)",
                        capsys.readouterr().err)
    assert len(losses) == 2 and np.isfinite([float(x) for x in losses]).all()
    # 2 train steps x 3 layers; one eval batch x 3 layers
    assert calls == {"fwd": 3, "fwd_res": 6, "bwd": 6}, calls
