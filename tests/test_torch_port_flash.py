"""PyTorch port, flash attention (``ops/flash_attention.py``) on the CPU,
where every kernel wrapper runs its plain version: the forward and the
gradients of q, k and v against the JAX package's ``flash_attention`` in
interpret mode and its ``attention_reference`` (tolerances 1e-5 and 1e-4,
as ``tests/test_ops.py``), the fused and two-pass backwards, the backward
route, the Philox keep mask (Random123's known answers, kept fraction,
determinism) and dropout gradients against autograd through the plain
attention with the extracted mask.  Also: a changed ``csrc/`` header
changes the kernel library's path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.ops.flash_attention import (
    attention_reference as jax_attention_reference,
)
from multimodal_emotion_detection_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from multimodal_emotion_detection_tpu_torch.ops import _build
from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these small
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, b, h, tq, tk, d, masked):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, tk, d)).astype(np.float32) for _ in range(2))
    bias = None
    if masked:
        keep = rng.random((b, tk)) > 0.25
        keep[:, 0] = True  # no fully masked row
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    cot = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    return q, k, v, bias, cot


CASES = [
    pytest.param((0, 2, 4, 77, 77, 40, True), id="T77-D40-masked"),
    pytest.param((1, 1, 2, 130, 130, 32, False), id="T130-D32"),
    pytest.param((2, 2, 2, 50, 90, 64, True), id="cross-Tq50-Tk90-masked"),
]


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax_flash_and_reference(case):
    q, k, v, bias, _ = _case(*case)
    jargs = [None if a is None else jnp.asarray(a) for a in (q, k, v, bias)]
    with jax.default_matmul_precision("highest"):
        want_flash = np.asarray(jax_flash_attention(*jargs, interpret=True))
        want_ref = np.asarray(jax_attention_reference(*jargs))
    got = fa.flash_attention(*_torch(q, k, v, bias)).numpy()
    np.testing.assert_allclose(got, want_flash, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax_flash_and_reference(case):
    q, k, v, bias, cot = _case(*case)
    jbias = None if bias is None else jnp.asarray(bias)

    def jax_grads(f):
        def loss(q, k, v):
            return jnp.sum(f(q, k, v, jbias) * jnp.asarray(cot))
        with jax.default_matmul_precision("highest"):
            return jax.grad(loss, argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, _torch(bias)[0]) * torch.from_numpy(cot)).sum().backward()
    got = (tq.grad, tk.grad, tv.grad)
    for want in (jax_grads(lambda *a: jax_flash_attention(*a, interpret=True)),
                 jax_grads(jax_attention_reference)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _saved(q, k, v, bias, seed, rate, cot):
    o, lse = fa.flash_fwd(q, k, v, bias, seed, rate)
    return (q, k, v, bias, seed, rate, cot, lse, (cot * o).sum(-1))


def test_fused_and_two_pass_backwards_agree(monkeypatch):
    q, k, v, bias, cot = _torch(*_case(3, 2, 2, 70, 150, 24, True))
    seed = torch.tensor([123456789], dtype=torch.int64)
    args = _saved(q, k, v, bias, seed, 0.1, cot)
    dq, dk, dv = fa.flash_bwd_fused(*args)
    dk2, dv2 = fa.flash_bwd_dkv(*args)
    dq2 = fa.flash_bwd_dq(*args)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    # and through the autograd Function, on both routes
    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, bias, dropout_rate=0.1, dropout_seed=seed)
        (out * cot).sum().backward()
        return [t.grad for t in leaves]

    fused = grads()
    monkeypatch.setattr(fa, "FUSE_MAX_TK", 64)
    assert fa.bwd_route(150) == "two_pass"
    for a, b in zip(fused, grads()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bwd_route_and_spans():
    assert fa.bwd_route(372) == "fused"       # the encoder's sequence
    assert fa.bwd_route(512) == "fused"       # the blockwise fold's block
    assert fa.bwd_route(4096) == "fused"
    assert fa.bwd_route(4097) == "two_pass"
    assert fa.bwd_route(5000) == "two_pass"
    # (spans, 64-key tiles per span): at most 8 slots of dQ partials
    assert fa.kv_spans(372) == (6, 1)
    assert fa.kv_spans(512) == (8, 1)
    assert fa.kv_spans(1000) == (8, 2)
    assert fa.kv_spans(4096) == (8, 8)
    assert fa.kv_spans(1) == (1, 1)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    as_t = lambda ws: [torch.tensor(w, dtype=torch.int64) for w in ws]  # noqa: E731
    got = fa.philox4x32(as_t(counter), as_t(key))
    assert tuple(int(w) for w in got) == want


def test_keep_mask_fraction_and_determinism():
    rate, shape = 0.1, (2, 4, 66, 256)
    seed = torch.tensor([2**40 + 17], dtype=torch.int64)
    mask = fa.attn_keep_mask(seed, rate, shape)
    assert mask.shape == shape
    assert set(np.unique(mask.numpy())) == {0.0, np.float32(1.0 / 0.9)}
    kept = float((mask > 0).float().mean())
    n = mask.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(kept - (1 - rate)) < 6 * sigma, kept
    torch.testing.assert_close(fa.attn_keep_mask(seed, rate, shape), mask, rtol=0, atol=0)
    other = fa.attn_keep_mask(seed + 1, rate, shape)
    assert float((other != mask).float().mean()) > 0.1
    # a sub-block of the call is the same mask: it depends on (b, h, i, j),
    # not on how a kernel tiles the call
    torch.testing.assert_close(fa.attn_keep_mask(seed, rate, (1, 2, 9, 70)),
                               mask[:1, :2, :9, :70], rtol=0, atol=0)
    assert fa.drop_threshold(0.0) == 0
    assert fa.drop_threshold(0.1) == 429496729
    assert fa.drop_threshold(1 - 1e-12) == 2**32 - 1


def test_dropout_grads_match_autograd_through_reference_with_mask():
    q, k, v, bias, cot = _torch(*_case(4, 2, 2, 45, 45, 16, True))
    seed = torch.tensor([987654321], dtype=torch.int64)
    rate = 0.3
    keep = fa.attn_keep_mask(seed, rate, (2, 2, 45, 45))

    def run(f):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = f(*leaves)
        (out * cot).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    got = run(lambda *a: fa.flash_attention(*a, bias, dropout_rate=rate,
                                            dropout_seed=seed))
    want = run(lambda *a: fa.attention_reference(*a, bias, keep=keep))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # dropout really acts, and rate 0 is the plain attention
    assert float((got[0] - fa.attention_reference(q, k, v, bias)).abs().max()) > 1e-2
    torch.testing.assert_close(fa.flash_attention(q, k, v, bias),
                               fa.attention_reference(q, k, v, bias),
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_refusals():
    q, k, v, bias, _ = _torch(*_case(5, 1, 1, 4, 6, 8, True))
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not in"):
        fa.flash_attention(q, k, v, dropout_rate=1.0, dropout_seed=torch.zeros(1))
    with pytest.raises(ValueError, match="bias shape"):
        fa.flash_attention(q, k, v, bias[:, :5])
    # the bias is a mask: no gradient reaches it
    b = bias.clone().requires_grad_()
    fa.flash_attention(q.requires_grad_(), k, v, b).sum().backward()
    assert b.grad is None and q.grad is not None


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\nint x;\n')
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "deep.cuh"\n')
    (tmp_path / "deep.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("kern")
    assert _build.library_path("kern") == first
    (tmp_path / "deep.cuh").write_text("// v2\n")
    second = _build.library_path("kern")
    assert second != first
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "deep.cuh"\n// x\n')
    assert _build.library_path("kern") not in (first, second)
    # the repository's flash sources reach both headers
    monkeypatch.undo()
    names = [p.name for p in _build._sources(_build.CSRC / "flash_bwd_fused.cu", [])]
    assert names == ["flash_bwd_fused.cu", "flash_mma.cuh", "philox.cuh"]
