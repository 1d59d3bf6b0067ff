"""Port parity of the attention kernels' wrappers on the CPU, where they run
their plain torch versions: the same seeded numpy inputs go through the
reference's Pallas kernels in interpret mode (as ``tests/test_kernels.py``
runs them), the reference's ``ref.py`` oracles, and the port.

Tolerances: f32 outputs within 2e-5 (flash) and 3e-5 (decode) absolute
and relative, the reference's own bounds for its kernels against its
oracles (online against one-pass softmax, another summation order); f32
log-sum-exp within 1e-5; bf16 outputs within 3e-2, about two bf16 ulps
at the outputs' magnitude (both sides round an f32 result to bf16, and
one ulp of disagreement in the f32 value can move the rounding).  f32
gradients (dq, dk, dv) within 5e-5 absolute and relative, the bound of
the reference's own gradient test (``tests/test_kernels.py``): the FA2
backward from the saved lse against ``jax.grad``, other summation
orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import combine_partial_attention as \
    ref_combine
from repro.kernels.decode_attention import decode_attention as ref_decode
from repro.kernels.decode_attention import decode_attention_ref as \
    ref_decode_oracle
from repro.kernels.flash_attention import attention_ref as ref_attention
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels.decode_attention import (combine_partial_attention,
                                                  decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd_ref)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
LSE_TOL = 1e-5
GRAD_TOL = 5e-5


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax and a torch array of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,hq,hkv,l,d", [
    (2, 4, 2, 200, 32),       # GQA 2:1, length not a multiple of 128
    (1, 14, 2, 130, 64),      # the generator's heads, ragged length
    (2, 6, 1, 128, 64),       # MQA, tile-aligned
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference_kernel_and_oracle(b, hq, hkv, l, d, dtype):
    rng = np.random.default_rng(b * 1000 + hq * 10 + l)
    q = rng.normal(size=(b, hq, l, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, l, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, l, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    tol = DTYPES[dtype][2]
    out, lse = flash_attention(tq, tk, tv, causal=True, return_lse=True)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == (b, hq, l)
    want_kernel = ref_flash(jq, jk, jv, True, None, True)
    want, want_lse = ref_attention(jq, jk, jv, causal=True, return_lse=True)
    for w in (want_kernel, want):
        np.testing.assert_allclose(_f32(out), _f32(w), atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(lse.numpy(), _f32(want_lse),
                                   atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("lq,lkv,causal", [(70, 200, True),
                                           (1, 457, True),
                                           (50, 96, False)])
def test_flash_ragged_and_offset_lengths(lq, lkv, causal):
    """Right-aligned causal positions with Lq < Lkv, and full attention,
    against the oracle (the reference's kernel pads to 128-row tiles and
    takes only Lq % 128 == Lkv % 128 here)."""
    rng = np.random.default_rng(lq + lkv)
    q = rng.normal(size=(2, 4, lq, 32)).astype(np.float32)
    k = rng.normal(size=(2, 2, lkv, 32)).astype(np.float32)
    v = rng.normal(size=(2, 2, lkv, 32)).astype(np.float32)
    out, lse = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal, scale=0.3, return_lse=True)
    want, want_lse = ref_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=causal, scale=0.3, return_lse=True)
    np.testing.assert_allclose(out.numpy(), _f32(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _f32(want_lse), atol=LSE_TOL,
                               rtol=LSE_TOL)


def _grads_torch(q, k, v, do, causal=True, scale=None):
    """(dq, dk, dv) of sum(out * do) through the port's wrapper (its
    autograd.Function on the CPU) and from ``flash_attention_bwd_ref``."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do)
    out, lse = flash_attention(tq, tk, tv, causal=causal, scale=scale,
                               return_lse=True)
    auto = torch.autograd.grad(out, (tq, tk, tv), tdo)
    plain = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                    out.detach(), lse, tdo, causal, scale)
    return auto, plain


def _grads_jax(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("b,hq,hkv,l,d", [
    (2, 4, 2, 128, 32),       # GQA 2:1, tile-aligned
    (1, 4, 2, 200, 64),       # GQA 2:1, length not a multiple of 128
    (1, 14, 2, 128, 64),      # GQA 7:1, the generator's heads
    (2, 7, 1, 200, 32),       # GQA 7:1, ragged
])
def test_flash_grads_match_reference_kernel(b, hq, hkv, l, d):
    """f32 dq, dk, dv through the port against ``jax.grad`` of the
    reference's custom_vjp (Pallas forward and backward, interpret mode)
    and of its oracle."""
    rng = np.random.default_rng(b * 1000 + hq * 10 + l + d)
    q = rng.normal(size=(b, hq, l, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, l, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, l, d)).astype(np.float32)
    do = rng.normal(size=(b, hq, l, d)).astype(np.float32)
    auto, plain = _grads_torch(q, k, v, do)
    want_kernel = _grads_jax(lambda *a: ref_flash(*a, True, None, True),
                             q, k, v, do)
    want = _grads_jax(lambda *a: ref_attention(*a, causal=True), q, k, v, do)
    for got in (auto, plain):
        for g, wk, w, name in zip(got, want_kernel, want, "qkv"):
            assert g.shape == w.shape and g.dtype == torch.float32, name
            for x in (wk, w):
                np.testing.assert_allclose(g.numpy(), _f32(x), atol=GRAD_TOL,
                                           rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("lq,lkv,causal", [(70, 200, True),
                                           (1, 457, True),
                                           (50, 96, False)])
def test_flash_grads_ragged_and_offset_lengths(lq, lkv, causal):
    """Gradients with Lq < Lkv (right-aligned causal positions) and of
    full attention, against ``jax.grad`` of the reference's oracle (its
    kernel takes only Lq % 128 == Lkv % 128)."""
    rng = np.random.default_rng(lq * 3 + lkv)
    q = rng.normal(size=(2, 4, lq, 32)).astype(np.float32)
    k = rng.normal(size=(2, 2, lkv, 32)).astype(np.float32)
    v = rng.normal(size=(2, 2, lkv, 32)).astype(np.float32)
    do = rng.normal(size=(2, 4, lq, 32)).astype(np.float32)
    auto, plain = _grads_torch(q, k, v, do, causal, 0.3)
    want = _grads_jax(lambda *a: ref_attention(*a, causal=causal, scale=0.3),
                      q, k, v, do)
    for got in (auto, plain):
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), _f32(w), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=f"d{name}")


def test_flash_contract_errors():
    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    # a tensor that requires grad gets gradients, equal to autograd
    # through the plain forward
    rng = np.random.default_rng(5)
    qg, kg, vg = (torch.from_numpy(rng.normal(size=t.shape).astype(
        np.float32)).requires_grad_() for t in (q, kv, kv))
    got = torch.autograd.grad(flash_attention(qg, kg, vg).sum(),
                              (qg, kg, vg))
    want = torch.autograd.grad(attention_ref(qg, kg, vg).sum(),
                               (qg, kg, vg))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(torch.zeros(1, 4, 9, 32), kv, kv)
    with pytest.raises(ValueError, match="grouping"):
        flash_attention(torch.zeros(1, 3, 8, 32), kv, kv)
    assert attention_ref(q, kv, kv).shape == q.shape


@pytest.mark.parametrize("b,hq,hkv,s,d,lens", [
    (3, 14, 2, 300, 64, (1, 255, 300)),
    (4, 4, 2, 96, 32, (96, 17, 64, 65)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference_kernel_and_oracle(b, hq, hkv, s, d, lens,
                                                    dtype):
    rng = np.random.default_rng(s + d)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    cl = np.asarray(lens, np.int32)
    tol = 3e-5 if dtype == "float32" else DTYPES[dtype][2]
    out, lse = decode_attention(tq, tk, tv, torch.from_numpy(cl),
                                return_lse=True)
    assert out.dtype == tq.dtype and lse.shape == (b, hq)
    want_kernel, want_kernel_lse = ref_decode(jq, jk, jv, jnp.asarray(cl),
                                              interpret=True,
                                              return_lse=True)
    want, want_lse = ref_decode_oracle(jq, jk, jv, jnp.asarray(cl),
                                       return_lse=True)
    for w in (want_kernel, want):
        np.testing.assert_allclose(_f32(out), _f32(w), atol=tol, rtol=tol)
    if dtype == "float32":
        for w in (want_kernel_lse, want_lse):
            np.testing.assert_allclose(lse.numpy(), _f32(w), atol=LSE_TOL,
                                       rtol=LSE_TOL)


def test_decode_ignores_rows_past_cache_len():
    """Garbage past each row's length changes nothing."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 2, 64, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 2, 64, 32)).astype(np.float32))
    lens = torch.tensor([10, 40], dtype=torch.int32)
    k2, v2 = k.clone(), v.clone()
    k2[0, :, 10:] = 1e4
    v2[1, :, 40:] = -1e4
    torch.testing.assert_close(decode_attention(q, k, v, lens),
                               decode_attention(q, k2, v2, lens),
                               atol=0, rtol=0)


def test_combine_partial_attention_matches_reference_and_whole():
    """Sequence-sharded partial decode attention merged with the lse
    equals the monolithic result and the reference's combine."""
    rng = np.random.default_rng(11)
    b, hq, hkv, s, d, parts = 2, 8, 2, 384, 64, 3
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    shard = s // parts
    full = torch.full((b,), shard, dtype=torch.int32)
    outs, lses = zip(*(decode_attention(
        tq, tk[:, :, i * shard:(i + 1) * shard],
        tv[:, :, i * shard:(i + 1) * shard], full, return_lse=True)
        for i in range(parts)))
    outs, lses = torch.stack(outs), torch.stack(lses)
    got = combine_partial_attention(outs, lses)
    whole = decode_attention_ref(tq, tk, tv,
                                 torch.full((b,), s, dtype=torch.int32))
    want = ref_combine(jnp.asarray(outs.numpy()), jnp.asarray(lses.numpy()))
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=2e-5,
                               rtol=2e-5)
