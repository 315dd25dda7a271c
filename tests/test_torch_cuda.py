"""Kernels of the port on the card: each against its plain version.

Marked ``cuda``: they need an NVIDIA card and ``nvcc``, and skip elsewhere
(the decision is made in the fixture, never at import).  Run them on the
machine with the card with ``python -m pytest tests/test_torch_cuda.py``.
Exact equality: the row gather moves bytes.
"""
import pytest
import torch

from ddp_tpu_torch.ops.gather import gather_rows, gather_rows_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "interpreter)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype", [
    ((1000, 32, 32, 3), torch.uint8),
    ((300, 3072), torch.float32),
    ((500, 105), torch.uint8),
    ((500, 3), torch.float32),
    ((64, 2), torch.int16),
])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_equals_plain(cuda, shape, dtype, idx_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    table = (torch.randn(shape, device=cuda, generator=g).to(dtype)
             if dtype.is_floating_point else
             torch.randint(0, 100, shape, device=cuda, generator=g).to(dtype))
    m = shape[0]
    idx = torch.randint(-5, m + 5, (337,), dtype=idx_dtype, device=cuda,
                        generator=g)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))


def test_row_gather_rejects_what_the_kernel_does_not_take(cuda):
    table = torch.zeros(10, 4, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        gather_rows(table, torch.zeros(3, dtype=torch.int32))  # idx on CPU
    with pytest.raises(ValueError):
        gather_rows(table, torch.zeros(3, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        gather_rows(table.t(), torch.zeros(3, dtype=torch.int32,
                                           device=cuda))
