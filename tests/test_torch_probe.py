"""The port's counterpart of the reference's Pallas compile probe
(``scripts/pallas_minimal_repro.py``: ``o = 2x + y`` on [64, 128] float32).
The script runs at import, so its kernel body is restated here and run in
interpret mode; the plain version equals it bitwise (2x is exact).  The
``cuda`` tests hold the CUDA kernel bitwise to the plain version on the card,
at sizes with a scalar tail and on views at every offset modulo 16 bytes,
and count which path each launch took
(``python -m pytest --noconftest -m cuda tests/test_torch_probe.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.kernels.probe import probe, probe_reference  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal(shape).astype(np.float32)),
            torch.as_tensor(rng.standard_normal(shape).astype(np.float32)))


def test_plain_matches_pallas_kern_bitwise():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def kern(x_ref, y_ref, o_ref):  # scripts/pallas_minimal_repro.py:7-8
        o_ref[...] = x_ref[...] * 2.0 + y_ref[...]

    f = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((64, 128), jnp.float32),
                       interpret=True)
    x, y = _inputs((64, 128), 0)
    np.testing.assert_array_equal(probe(x, y).numpy(),
                                  np.asarray(f(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))))
    ones = torch.ones((64, 128))
    assert torch.equal(probe(ones, ones), torch.full((64, 128), 3.0))  # the script's check


def test_wrapper_rejects_bad_inputs_and_routes_cpu_uncounted():
    x, y = _inputs((64, 128), 1)
    with pytest.raises(ValueError):
        probe(x, y[:32])
    with pytest.raises(TypeError):
        probe(x.double(), y.double())
    with pytest.raises(ValueError):
        probe(x.t(), y.t())
    with recording() as rec:
        assert torch.equal(probe(x, y), probe_reference(x, y))
    assert rec.total("kernel.probe") == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (1 << 20) + 3, (1 << 24) + 3, 1, 5])
def test_kernel_matches_plain_bitwise_on_card(cuda_device, shape):
    x, y = (t.to(cuda_device) for t in _inputs(shape, 2))
    with recording() as rec:
        o = probe(x, y)
    assert rec.total("kernel.probe") == 1
    assert rec.total("kernel.probe.scalar") == 0  # fresh tensors are 16-byte aligned
    assert torch.equal(o, probe_reference(x, y))


# (x offset, y offset) in floats, and whether the float4 path runs: equal
# offsets take it (o is allocated at the same offset, the head is scalar),
# different offsets take the scalar loop of the same kernel
VIEWS = [((1, 1), True), ((2, 2), True), ((3, 3), True), ((1, 0), False), ((1, 3), False),
         ((0, 2), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 5, 7])
@pytest.mark.parametrize("offsets,vector", VIEWS, ids=lambda v: str(v))
def test_misaligned_views_on_card(cuda_device, n, offsets, vector):
    (ox, oy) = offsets
    xb, yb = (t.to(cuda_device) for t in _inputs(n + 3, 3))
    x, y = xb[ox:ox + n], yb[oy:oy + n]
    with recording() as rec:
        o = probe(x, y)
    assert rec.total("kernel.probe") == 1
    assert rec.total("kernel.probe.scalar") == (0 if vector else 1)
    assert torch.equal(o, probe_reference(x, y))
    if vector:
        assert o.data_ptr() % 16 == x.data_ptr() % 16
