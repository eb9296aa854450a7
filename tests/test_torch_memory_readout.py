"""Memory readout of the PyTorch port against the JAX package.

The port's plain version (what the wrapper runs on CPU tensors) is held to
``memory_readout_pallas`` in interpret mode and to ``memory_readout_dense`` on
the shapes of ``tests/test_pallas_kernels.py``, rtol/atol 2e-4 (fp32 sums of up
to 1024 terms in another order), and in bf16 to the interpreted Pallas kernel.
The plain versions of what the CUDA kernel does beyond the formula are tested
here too: the readout split over runs of the memory and combined, and the
error-compensated TF32 product of its fp32 path.  The CUDA kernel itself is held
to the plain version by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.ops.pallas.mem_attention import memory_readout_pallas
from yolo_puncture_tpu.track.network import memory_readout_dense as jax_dense
from yolo_puncture_tpu_torch.ops.kernels.memory_readout import (
    combine_partials,
    memory_readout,
    memory_readout_partials,
    memory_readout_reference,
)

TOL = dict(rtol=2e-4, atol=2e-4)
CASES = {  # name: (Q, M, No, Cv, valid)
    "full_softmax": (256, 1024, 4, 128, "random"),
    "all_invalid": (256, 512, 2, 128, "none"),
    "ragged": (52, 300, 3, 32, "random"),
}


def _inputs(Q, M, No, Cv, valid, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, 64)).astype(np.float32)
    k = rng.standard_normal((M, 64)).astype(np.float32)
    v = rng.standard_normal((No, M, Cv)).astype(np.float32)
    ok = rng.uniform(size=M) > 0.3 if valid == "random" else np.zeros(M, bool)
    return q, k, v, ok


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("oracle", ["pallas_interpret", "dense"])
def test_plain_version_matches_jax(case, oracle):
    Q, M, No, Cv, valid = CASES[case]
    q, k, v, ok = _inputs(Q, M, No, Cv, valid)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ok))
    ref = np.asarray(memory_readout_pallas(*args, interpret=True) if oracle == "pallas_interpret"
                     else jax_dense(*args))
    got = memory_readout(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(ok)).numpy()
    assert got.shape == (No, Q, Cv) and got.dtype == np.float32
    assert np.isfinite(got).all()
    if valid == "none":
        assert (got == 0).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_first_valid_element_in_the_last_tile_and_bf16():
    q, k, v, _ = _inputs(70, 333, 2, 128, "none")
    ok = np.arange(333) >= 330
    ref = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ok)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = memory_readout_reference(*t, torch.from_numpy(ok))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # bf16 storage: fp32 statistics, output in the values' type.  The weights are rounded
    # to bf16 before they meet the values (half an ulp, 2^-9 relative, each: at most
    # 2^-9 * max|v| in a weighted mean), then the result is rounded once (2^-8 relative)
    got16 = memory_readout_reference(*(a.bfloat16() for a in t), torch.from_numpy(ok))
    assert got16.dtype == torch.bfloat16
    ref16 = memory_readout_reference(*(a.bfloat16().float() for a in t), torch.from_numpy(ok))
    tol = 2.0 ** -9 * float(np.abs(v).max()) + 2.0 ** -8 * ref16.abs().clamp_min(1.0)
    assert ((got16.float() - ref16).abs() <= tol).all()


def test_wrapper_checks_shapes_and_types():
    q, k, v = torch.zeros(4, 64), torch.zeros(6, 64), torch.zeros(2, 6, 128)
    ok = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError):
        memory_readout(q, k, torch.zeros(2, 5, 128), ok)
    with pytest.raises(ValueError):
        memory_readout(torch.zeros(4, 32), k, v, ok)
    with pytest.raises(TypeError):
        memory_readout(q, k, v, ok.float())


@pytest.mark.parametrize("case", ["full_softmax", "all_invalid", "ragged_128"])
def test_plain_version_in_bf16_matches_the_interpreted_pallas_kernel(case):
    """Both round p to bf16 before the second product and sum the fp32 p.  They
    differ where a p straddles a bf16 rounding edge (the kernel's running max is
    not the final max while it accumulates, so its p are scaled differently
    before they are rounded: relative 2^-9 each, averaging out over the sum) and
    by one rounding of the output to bf16 (2^-8 relative).  Limit: 2^-7 of
    max(1, |ref|)."""
    Q, M, No, Cv, valid = dict(CASES, ragged_128=(52, 300, 3, 128, "random"))[case]
    q, k, v, ok = _inputs(Q, M, No, Cv, valid, seed=6)
    j16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    ref = memory_readout_pallas(j16(q), j16(k), j16(v), jnp.asarray(ok), interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    got = memory_readout(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), torch.from_numpy(ok))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (No, Q, Cv)
    if valid == "none":
        assert (got.float() == 0).all()
    assert ((got.float() - ref).abs() <= 2.0 ** -7 * ref.abs().clamp_min(1.0)).all()


def _split_valid(M, pattern, rng):
    ok = rng.uniform(size=M) > 0.3
    if pattern == "invalid_chunk":        # with 3 splits of 300: the middle run has no valid element
        ok[128:256] = False
    elif pattern == "first_valid_in_last_chunk":
        ok[:] = False
        ok[M - 3:] = True
    return ok


@pytest.mark.parametrize("pattern", ["random", "invalid_chunk", "first_valid_in_last_chunk", "none"])
@pytest.mark.parametrize("n_split", [2, 3, 5])
def test_split_readout_combines_to_the_unsplit_one(pattern, n_split):
    """Partials per run of whole 64-element tiles, then the combine: 1e-6 of the
    unsplit plain version in fp32 (the same sums, grouped by run)."""
    rng = np.random.default_rng(8)
    Q, M, No, Cv = 52, 300, 3, 128
    q, k, v, _ = _inputs(Q, M, No, Cv, "none", seed=9)
    ok = np.zeros(M, bool) if pattern == "none" else _split_valid(M, pattern, rng)
    t = [torch.from_numpy(a) for a in (q, k, v, ok)]
    m, l, acc = memory_readout_partials(*t, n_split)
    assert m.shape == l.shape == (n_split, Q) and acc.shape == (n_split, No, Q, Cv)
    if pattern == "invalid_chunk" and n_split == 3:
        assert torch.isinf(m[1]).all() and (l[1] == 0).all() and (acc[1] == 0).all()
    got = combine_partials(m, l, acc)
    ref = memory_readout_reference(*t)
    if pattern == "none":
        assert (got == 0).all()                                   # every row all-invalid: exact zeros
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_split_readout_keeps_an_all_invalid_row_among_valid_ones():
    """Rows see the same validity, so a row is all-invalid only with the whole
    memory; what a split must keep is a RUN that is all-invalid for every row
    beside runs that are not, and rows whose max sits in different runs."""
    q, k, v, _ = _inputs(40, 200, 2, 128, "none", seed=10)
    ok = np.ones(200, bool)
    ok[64:128] = False
    k[130] = 4.0 * q[7]            # row 7 peaks in the third run, the others elsewhere
    t = [torch.from_numpy(a) for a in (q, k, v, ok)]
    m, l, acc = memory_readout_partials(*t, 4)
    assert int(m[:, 7].argmax()) == 2 and torch.isinf(m[1]).all()
    np.testing.assert_allclose(combine_partials(m, l, acc).numpy(), memory_readout_reference(*t).numpy(),
                               rtol=0, atol=1e-6)


def _tf32_hi(x):
    """Round fp32 to TF32 (10 mantissa bits), ties away from zero: cvt.rna.tf32.f32."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor core reads of an fp32 register: the low 13 bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _matmul_tf32(a, b, compensated):
    """a @ b as the fp32 kernel's tensor-core products take it: TF32 operands,
    fp32 accumulation; compensated = lo·hi + hi·lo + hi·hi, small terms first."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    if not compensated:
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _readout_with(matmul, q, k, v, ok):
    aff = matmul(q, k.T.contiguous()) * q.shape[-1] ** -0.5
    aff = aff.masked_fill(~ok[None, :], float("-inf"))
    p = torch.exp(aff - aff.max(dim=-1, keepdim=True).values)
    return torch.stack([matmul(p, vo) for vo in v]) / p.sum(dim=-1, keepdim=True)[None]


@pytest.mark.parametrize("scheme,within", [("3xtf32", True), ("tf32", False)])
def test_compensated_tf32_is_fp32_class_and_single_tf32_is_not(scheme, within):
    """Logits up to |s| ≈ 30, as the needle checkpoint's keys give.  Against a
    float64 readout the compensated product stays within 2e-6 (the dropped lo·lo
    term and the truncated lo are 2^-21 of a product, and the logit error is
    multiplied by |s|), while one TF32 product (2^-11 per operand) is more than
    a hundred times off."""
    rng = np.random.default_rng(12)
    Q, M, No, Cv = 96, 640, 2, 128
    q = rng.standard_normal((Q, 64)).astype(np.float32) * 2.0
    k = rng.standard_normal((M, 64)).astype(np.float32) * 2.0
    k[:Q] += 1.2 * q                                       # each row has a strong match: |s| up to ~30
    v = rng.standard_normal((No, M, Cv)).astype(np.float32)
    ok = rng.uniform(size=M) > 0.3
    ok[:Q] = True
    q, k, v, ok = (torch.from_numpy(a) for a in (q, k, v, ok))
    s_max = float((q.double() @ k.double().T).abs().max()) / 8.0
    assert 25.0 < s_max < 60.0
    ref = _readout_with(lambda a, b: a @ b, q.double(), k.double(), v.double(), ok)
    got = _readout_with(lambda a, b: _matmul_tf32(a, b, scheme == "3xtf32"), q, k, v, ok)
    err = float((got.double() - ref).abs().max())
    assert (err <= 2e-6) == within, err
    if not within:
        assert err > 2e-4


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_with_bf16_affinity_matches_the_dense_jax_readout(dtype, scale):
    """``affinity_bf16=True``: the plain version rounds each logit as the JAX dense
    readout rounds its (Q, M) affinity, bf16(bf16(q · k) · bf16(Ck^-0.5)).  fp32:
    the logits equal JAX's bit for bit on these inputs, and the readouts agree
    within 2e-5 (sums in another order); JAX's readout without the option is
    more than a hundred times farther.  bf16: within 2^-7 of max(1, |ref|) (the
    JAX readout sums the bf16-rounded weights, the plain version the fp32 ones,
    and both round the output), and nearer than JAX's readout without the
    option.  ``scale`` 2 makes the softmax peaked, where a rounded logit moves
    its weight the most."""
    from yolo_puncture_tpu_torch.ops.kernels.memory_readout import readout_logits

    q, k, v, ok = _inputs(256, 1024, 4, 128, "random", seed=7)
    q, k = q * np.float32(scale), k * np.float32(scale)
    jt = getattr(jnp, dtype)
    jax_in = [jnp.asarray(a).astype(jt) for a in (q, k, v)]
    with_flag, without = (np.asarray(jax_dense(*jax_in, jnp.asarray(ok), affinity_bf16=f).astype(jnp.float32))
                          for f in (True, False))
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    got = memory_readout(*t, torch.from_numpy(ok), affinity_bf16=True).float().numpy()
    err, err_without = np.abs(got - with_flag), np.abs(got - without)
    if dtype == "float32":
        jax_logits = jnp.einsum("qc,mc->qm", *jax_in[:2], preferred_element_type=jnp.bfloat16) * jnp.asarray(
            0.125, jnp.bfloat16)
        np.testing.assert_array_equal(readout_logits(t[0], t[1], True).numpy(),
                                      np.asarray(jax_logits.astype(jnp.float32)))
        assert err.max() <= 2e-5 and err_without.max() > 100 * err.max(), (err.max(), err_without.max())
    else:
        assert (err <= 2.0 ** -7 * np.maximum(np.abs(with_flag), 1.0)).all(), err.max()
        assert err.mean() < err_without.mean(), (err.mean(), err_without.mean())


# -- gradients (training) -----------------------------------------------------------------
# The tracker's training shape: a query of 16×16 (256×256 frames), a ring of 4 × 256
# elements and the 8 vestigial long-term slots that ``TrackerCore._memory_bank``
# appends with long-term memory off, 4 objects; the same with a 128-slot long-term
# bank (M 1152); and a ring with only its first two frames written.
GRAD_REL = 1e-5   # per tensor, ‖g_port − g_jax‖ / ‖g_jax‖, fp32
# with affinity_bf16 the cotangent of the logits is rounded to bf16 on both sides from
# fp32 values that differ by fp32 rounding, so a few elements round to the neighbouring
# bf16 value (2^-8 relative each); measured 1.2e-4 on a 64 × 200 case
GRAD_REL_AFFINITY_BF16 = 1e-3
GRAD_CASES = {  # name: (Q, M, No, valid elements)
    "training_ring": (256, 1032, 4, 1024),
    "training_ring_lt128": (256, 1152, 4, 1024),
    "partly_valid_ring": (256, 1032, 4, 512),
}


def _grad_inputs(Q, M, No, n_valid, seed=11):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, 64)).astype(np.float32)
    k = rng.standard_normal((M, 64)).astype(np.float32)
    v = rng.standard_normal((No, M, 128)).astype(np.float32)
    ok = np.arange(M) < n_valid
    d_out = rng.standard_normal((No, Q, 128)).astype(np.float32)
    return q, k, v, ok, d_out


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _port_grads(q, k, v, ok, d_out, affinity_bf16=False):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = memory_readout(tq, tk, tv, torch.from_numpy(ok), affinity_bf16=affinity_bf16)
    assert out.grad_fn is not None
    (out * torch.from_numpy(d_out)).sum().backward()
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


def _jax_grads(q, k, v, ok, d_out, affinity_bf16=False):
    import jax

    def f(q, k, v):
        return (jax_dense(q, k, v, jnp.asarray(ok), affinity_bf16=affinity_bf16) * d_out).sum()

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients_match_jax_grad_of_the_dense_readout(case):
    """The repair: q, k and v get the gradients of ``jax.grad(memory_readout_dense)``
    (before, the kernel's output had no ``grad_fn`` on the card)."""
    q, k, v, ok, d_out = _grad_inputs(*GRAD_CASES[case])
    out, gq, gk, gv = _port_grads(q, k, v, ok, d_out)
    np.testing.assert_allclose(out, np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                         jnp.asarray(ok))), **TOL)
    for name, got, ref in zip("qkv", (gq, gk, gv), _jax_grads(q, k, v, ok, d_out)):
        assert _rel(got, ref) <= GRAD_REL, (name, _rel(got, ref))
    assert not gk[~ok].any() and not gv[:, ~ok].any()      # invalid elements get nothing


def test_gradients_with_bf16_affinity_match_jax_grad():
    q, k, v, ok, d_out = _grad_inputs(256, 1032, 4, 768, seed=12)
    got = _port_grads(q, k, v, ok, d_out, affinity_bf16=True)[1:]
    for name, g, ref in zip("qkv", got, _jax_grads(q, k, v, ok, d_out, affinity_bf16=True)):
        assert _rel(g, ref) <= GRAD_REL_AFFINITY_BF16, (name, _rel(g, ref))


def test_rows_without_a_valid_element_get_zero_gradients():
    q, k, v, _, d_out = _grad_inputs(64, 300, 2, 0, seed=13)
    _, gq, gk, gv = _port_grads(q, k, v, np.zeros(300, bool), d_out)
    assert not gq.any() and not gk.any() and not gv.any()


def test_gradient_path_keeps_the_forward_and_refuses_bf16():
    q, k, v, ok, _ = _grad_inputs(64, 300, 2, 200, seed=14)
    tq, tk, tv, tok = map(torch.from_numpy, (q, k, v, ok))
    with torch.no_grad():
        plain = memory_readout(tq, tk, tv, tok)
    assert torch.equal(memory_readout(tq.requires_grad_(), tk, tv, tok).detach(), plain)
    # bf16 (bf16 training) goes through the Function too; fp16, or mixed types, raise
    b16 = [t.detach().bfloat16() for t in (tq, tk, tv)]
    with torch.no_grad():
        plain16 = memory_readout(*b16, tok)
    out16 = memory_readout(b16[0].clone().requires_grad_(), *b16[1:], tok)
    assert out16.grad_fn is not None and torch.equal(out16.detach(), plain16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        memory_readout(tq.detach().half().requires_grad_(), tk.half(), tv.half(), tok)
    with pytest.raises(TypeError, match="one type"):
        memory_readout(tq.detach().requires_grad_(), tk.bfloat16(), tv.bfloat16(), tok)
