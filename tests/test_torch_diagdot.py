"""block_diagdot: the port's plain version against the JAX function it
replaces (einsum fallback and Pallas interpret mode) and against
gather_diagdot's with the identity gather (the kernel is gather_diagdot's
rows kernel reading no index), the CPU wrapper's routing and checks, and
(with a CUDA device) the hand-written kernel.

Tolerance rtol 1e-5 / atol 1e-3: (c − 128) is exact in bf16 and every
bf16 × bf16 product is exact in f32, so the two sides differ only in the
order of the f32 sums.

JAX is imported inside the tests that use it, so the card's case runs
where JAX is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_diagdot.py``."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops.diagdot import block_diagdot, block_diagdot_ref
from alayalite_tpu_torch.ops.gather_diagdot import gather_diagdot_ref

SHAPES = [(32, 16, 128), (5, 24, 128), (7, 10, 96)]
# one query, K not a multiple of a group's 8 rows, Dp 40 and 96 (the
# kernel's byte loads), K of 1
ODD_SHAPES = [(1, 256, 128), (7, 13, 128), (33, 77, 40), (3, 5, 96),
              (4, 1, 16)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=shape, dtype=np.uint8)
    qs = rng.normal(size=(shape[0], shape[2])).astype(np.float32)
    return codes, qs


@pytest.mark.parametrize("mode", ["einsum", "interpret"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_jax(shape, mode, monkeypatch):
    import jax.numpy as jnp

    from alayalite_tpu.ops.pallas_block import \
        block_diagdot as jax_block_diagdot

    monkeypatch.setenv("ALAYA_PALLAS", "1" if mode == "interpret" else "0")
    codes, qs = _inputs(shape, seed=sum(shape))
    want = np.asarray(jax_block_diagdot(jnp.asarray(codes), jnp.asarray(qs)))
    got = block_diagdot_ref(torch.from_numpy(codes),
                            torch.from_numpy(qs).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES + ODD_SHAPES)
def test_ref_is_gather_ref_with_identity_gather(shape):
    """block_diagdot is gather_diagdot with u = arange(B)[:, None]: node b
    for query b, one block of K rows each (C = B, M = 1, R = K). The
    kernel rests on this identity: its entry is the gather's rows kernel
    told to read no index."""
    codes, qs = _inputs(shape, seed=len(shape) + sum(shape))
    c = torch.from_numpy(codes)
    q = torch.from_numpy(qs).to(torch.bfloat16)
    u = torch.arange(shape[0], dtype=torch.int32)[:, None]
    assert torch.equal(block_diagdot_ref(c, q), gather_diagdot_ref(c, u, q))


def test_cpu_wrapper_runs_plain_version_and_counts_calls():
    codes, qs = _inputs((9, 33, 128), seed=1)
    c = torch.from_numpy(codes)
    q = torch.from_numpy(qs).to(torch.bfloat16)
    calls, launches = block_diagdot.calls, block_diagdot.launches
    got = block_diagdot(c, q)
    assert block_diagdot.calls == calls + 1
    assert block_diagdot.launches == launches  # no kernel on the CPU
    assert torch.equal(got, block_diagdot_ref(c, q))


def test_wrapper_rejects_bad_inputs():
    c = torch.zeros((4, 8, 16), dtype=torch.uint8)
    q = torch.zeros((4, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        block_diagdot(c.to(torch.int16), q)
    with pytest.raises(TypeError):
        block_diagdot(c, q.float())
    with pytest.raises(TypeError):
        block_diagdot(c, q[:3])
    with pytest.raises(ValueError):
        block_diagdot(c[:, :, ::2], q[:, :8].contiguous())


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for shape in SHAPES + [(1000, 200, 96), (33, 77, 40), (4096, 256, 128)]:
        codes, qs = _inputs(shape, seed=7)
        c = torch.from_numpy(codes).cuda()
        q = torch.from_numpy(qs).to(torch.bfloat16).cuda()
        launches = block_diagdot.launches
        got = block_diagdot(c, q)
        torch.cuda.synchronize()
        assert block_diagdot.launches == launches + 1
        want = block_diagdot_ref(c, q)
        tol = 1e-3 * float(want.abs().max()) + 1e-3
        assert float((got - want).abs().max()) <= tol, shape


def _shifted(t):
    """A contiguous copy of ``t`` one element past its allocation's start:
    not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ODD_SHAPES + [(4096, 256, 128)])
def test_cuda_kernel_odd_shapes_and_alignment(shape):
    """The kernel at one query, K not a multiple of a group's rows, Dp 40
    and 96, and with qs or codes off a 16-byte boundary (byte loads), against
    the plain version; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    codes, qs = _inputs(shape, seed=11)
    c = torch.from_numpy(codes).cuda()
    q = torch.from_numpy(qs).to(torch.bfloat16).cuda()
    want = block_diagdot_ref(c, q)
    tol = 1e-3 * float(want.abs().max()) + 1e-3
    for cc, qq in ((c, q), (c, _shifted(q)), (_shifted(c), q),
                   (_shifted(c), _shifted(q))):
        launches = block_diagdot.launches
        got = block_diagdot(cc, qq)
        torch.cuda.synchronize()
        assert block_diagdot.launches == launches + 1
        assert float((got - want).abs().max()) <= tol, shape
