"""The EGCL pair kernel's plain version against the JAX package, and the
kernel's wrapper.

The plain version (``egcl_pair_edges_reference``) is held against
``_edge_math_dense`` and against the Pallas kernel run in interpret mode,
as ``tests/test_pallas_egcl.py`` runs it. The CUDA kernel itself is held
against the plain version on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.ops.egcl_pallas import (
    _edge_math_dense,
    egcl_pair_kernel,
)
from diffusion_model_tpu_torch.ops import egcl_pair
from torch_port_fixtures import edge_args, edge_inputs

torch.set_num_threads(4)

NAMES = egcl_pair._NAMES


def jax_args(inputs):
    return tuple(jnp.asarray(inputs[k]) for k in NAMES)


@pytest.mark.parametrize("seed,n_real", [(0, (11, 16)), (1, (3, 9)),
                                         (2, (16, 1))])
def test_plain_matches_jax_dense_math(seed, n_real):
    inputs = edge_inputs(seed, n_real=n_real)
    want_m, want_x = _edge_math_dense(*jax_args(inputs))
    got_m, got_x = egcl_pair.egcl_pair_edges_reference(*edge_args(inputs))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_matches_pallas_kernel_interpret(seed):
    inputs = edge_inputs(seed)
    want_m, want_x = egcl_pair_kernel(*jax_args(inputs), interpret=True)
    got_m, got_x = egcl_pair.egcl_pair_edges_reference(*edge_args(inputs))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=2e-4, atol=2e-5)


def test_padded_rows_inert():
    inputs = edge_inputs(4, n_real=(5, 12))
    args = edge_args(inputs)
    m_sum, x_out = egcl_pair.egcl_pair_edges_reference(*args)
    pad = args[5][..., 0] == 0
    assert bool(pad.any())
    assert torch.equal(m_sum[pad], torch.zeros_like(m_sum[pad]))
    assert torch.equal(x_out[pad], args[4][pad])


def test_cpu_tensors_take_the_plain_version_uncounted():
    args = edge_args(edge_inputs(5))
    before = egcl_pair.egcl_pair_launches
    got = egcl_pair.egcl_pair_edges(*args)
    want = egcl_pair.egcl_pair_edges_reference(*args)
    assert egcl_pair.egcl_pair_launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _valid(dtype=torch.bfloat16):
    return dict(zip(NAMES, edge_args(edge_inputs(6, f1=64, fm=64),
                                      dtype=dtype)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_accepts_kernel_layout(dtype):
    assert egcl_pair._check(_valid(dtype)) == dtype


@pytest.mark.parametrize("name,change,error", [
    ("w2x", lambda t: t[:, :32], ValueError),                 # shape
    ("am_j", lambda t: t.to(torch.float32), TypeError),       # mixed dtype
    ("x", lambda t: t.to(torch.bfloat16), TypeError),         # geometry f32
    ("am_i", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),                                             # strides
    ("w2m", lambda t: t.clone().requires_grad_(True), ValueError),
])
def test_check_refuses_what_the_kernel_does_not_take(name, change, error):
    tensors = _valid()
    tensors[name] = change(tensors[name])
    with pytest.raises(error):
        egcl_pair._check(tensors)


def test_check_refuses_float16():
    tensors = {k: v.to(torch.float16) if v.dtype == torch.bfloat16 else v
               for k, v in _valid().items()}
    with pytest.raises(TypeError, match="neither"):
        egcl_pair._check(tensors)


def test_check_refuses_widths_off_the_tile():
    tensors = dict(zip(NAMES, edge_args(edge_inputs(7, f1=32, fm=16),
                                         dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="multiples of 64"):
        egcl_pair._check(tensors)
