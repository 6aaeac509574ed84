"""The flash-attention backward's plain version against the reference on
the CPU.

The reference trains by ``jax.grad`` through ``flash_attention_jnp``
(it has no Pallas backward), so the port's plain backward
``flash_attention_bwd_torch`` (P recomputed from the forward's
log-sum-exp) is held against that gradient and against torch autograd of
the plain forward, on the same inputs made with numpy from a seed: hd 64
and 128, G 2 and 3, S 128 and a ragged 77, causal and not, and a window of
32 with a softcap of 30.  Everything is fp32; tolerance 1e-5 of the
largest magnitude of each gradient (the three compute the same sums in
other orders).  The card's kernel is held against this plain version in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5

# (B, S, K, G, hd, causal, window, cap)
CASES = [
    (2, 128, 2, 2, 64, True, 0, 0.0),
    (1, 77, 2, 3, 64, True, 0, 0.0),
    (1, 128, 2, 3, 128, True, 0, 0.0),
    (2, 77, 2, 2, 128, False, 0, 0.0),
    (1, 128, 2, 3, 64, False, 0, 0.0),
    (1, 128, 2, 2, 64, True, 32, 30.0),
    (1, 77, 1, 3, 128, True, 32, 30.0),
]


def _ids(c):
    B, S, K, G, hd, causal, window, cap = c
    return (f"S{S}-K{K}-G{G}-hd{hd}-{'causal' if causal else 'full'}"
            + (f"-w{window}-cap{cap:g}" if window else ""))


def _inputs(B, S, K, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, K * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    do = rng.normal(size=(B, S, K * G, hd)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max |err| {err} > {TOL} * {scale}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_grad_and_autograd(case):
    B, S, K, G, hd, causal, window, cap = case
    q, k, v, do = _inputs(B, S, K, G, hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)

    def ref(q_, k_, v_):
        return flash_attention_jnp(q_, k_, v_, **kw)
    out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ot = fa.flash_attention_torch(qt, kt, vt, **kw)
    auto = torch.autograd.grad(ot, (qt, kt, vt), torch.from_numpy(do))

    o, lse = fa.flash_attention_torch(*(torch.from_numpy(a) for a in
                                        (q, k, v)), return_lse=True, **kw)
    _close(o.numpy(), out, "forward")
    got = fa.flash_attention_bwd_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse,
        torch.from_numpy(do), **kw)
    for name, g, w, a in zip("qkv", got, want, auto):
        _close(g.numpy(), w, f"d{name} vs jax.grad")
        _close(g.numpy(), a.numpy(), f"d{name} vs autograd")


@pytest.mark.parametrize("case", CASES[:2] + CASES[-2:], ids=_ids)
def test_plain_forward_lse_is_the_masked_logsumexp(case):
    B, S, K, G, hd, causal, window, cap = case
    q, k, v, _ = _inputs(B, S, K, G, hd, seed=1)
    scale = hd ** -0.5
    _, lse = fa.flash_attention_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=scale,
        causal=causal, window=window, logit_cap=cap, return_lse=True)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                  np.repeat(k, G, axis=2).astype(np.float64)) * scale
    if cap:
        s = cap * np.tanh(s / cap)
    i = np.arange(S)
    live = np.ones((S, S), bool)
    if causal:
        live &= i[None, :] <= i[:, None]
    if window:
        live &= i[:, None] - i[None, :] < window
    s = np.where(live, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert lse.shape == (B, K * G, S)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_the_autograd_function_is_taken_only_for_training():
    """With grad on, ``ops.flash_attention_bshd`` goes through the
    Function, whose backward on CPU tensors is the plain backward (no
    kernel launch counted); under ``inference_mode`` it is the plain
    forward with no graph."""
    B, S, K, G, hd = 1, 77, 2, 3, 64
    q, k, v, do = _inputs(B, S, K, G, hd, seed=2)
    kw = dict(scale=hd ** -0.5, causal=True, window=0, logit_cap=0.0)
    ops.reset_launches()
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention_bshd(qt, kt, vt, **kw)
    assert out.grad_fn is not None \
        and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    o, lse = fa.flash_attention_torch(qt.detach(), kt.detach(), vt.detach(),
                                      return_lse=True, **kw)
    want = fa.flash_attention_bwd_torch(qt.detach(), kt.detach(),
                                        vt.detach(), o, lse,
                                        torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.launches["flash_attention_bshd"] == 0
    assert ops.launches["flash_attention_bwd"] == 0
    with torch.inference_mode():
        served = ops.flash_attention_bshd(qt, kt, vt, **kw)
    assert served.grad_fn is None
    assert torch.equal(served, out.detach())


def test_backward_wrapper_checks_its_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 2, 64))
    o, lse = fa.flash_attention_torch(q, k, v, scale=0.125, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, lse[:, :, :8], do, scale=0.125)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_bwd(q, k, v, o, lse.double(), do, scale=0.125)
