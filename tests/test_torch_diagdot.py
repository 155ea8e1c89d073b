"""block_diagdot: the port's plain version against the JAX function it
replaces (einsum fallback and Pallas interpret mode), the CPU wrapper's
routing and checks, and (with a CUDA device) the hand-written kernel.

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

SHAPES = [(32, 16, 128), (5, 24, 128), (7, 10, 96)]


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
