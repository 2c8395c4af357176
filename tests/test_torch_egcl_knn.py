"""The EGCL kNN kernel's plain version against the JAX package, and the
kernel's wrapper.

The plain version (``egcl_knn_edges_reference``) is held against
``_edge_math_sparse`` and against the Pallas kernel run in interpret mode,
as ``tests/test_pallas_sparse.py`` runs it (N a multiple of its 8-row tile
there; the port has no such restriction). The CUDA kernel itself is held
against the plain version on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.ops.egcl_pallas_sparse import (
    _edge_math_sparse,
    egcl_knn_kernel,
)
from diffusion_model_tpu_torch.ops import egcl_knn
from torch_port_fixtures import KNN_NAMES, knn_args, knn_inputs

torch.set_num_threads(4)


def jax_args(inputs):
    return tuple(jnp.asarray(inputs[k]) for k in KNN_NAMES)


def test_argument_order_is_the_tpu_kernels():
    assert egcl_knn._NAMES == KNN_NAMES


@pytest.mark.parametrize("seed,n,k,n_real", [(0, 16, 4, (11, 16)),
                                             (1, 13, 12, (3, 13)),
                                             (2, 20, 7, (20, 1))])
def test_plain_matches_jax_sparse_math(seed, n, k, n_real):
    inputs = knn_inputs(seed, n=n, k=k, n_real=n_real)
    want_m, want_x = _edge_math_sparse(*jax_args(inputs))
    got_m, got_x = egcl_knn.egcl_knn_edges_reference(*knn_args(inputs))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,k", [(0, 4), (3, 15)])
def test_plain_matches_pallas_kernel_interpret(seed, k):
    inputs = knn_inputs(seed, n=16, k=k)
    want_m, want_x = egcl_knn_kernel(*jax_args(inputs), ti=8, interpret=True)
    got_m, got_x = egcl_knn.egcl_knn_edges_reference(*knn_args(inputs))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=2e-4, atol=2e-5)


def test_padded_targets_inert():
    inputs = knn_inputs(4, n=16, k=5, n_real=(5, 12))
    args = knn_args(inputs)
    m_sum, x_out = egcl_knn.egcl_knn_edges_reference(*args)
    pad = args[5].sum(dim=-1) == 0
    assert bool(pad.any())
    assert torch.equal(m_sum[pad], torch.zeros_like(m_sum[pad]))
    assert torch.equal(x_out[pad], args[3][pad])


def test_cpu_tensors_take_the_plain_version_uncounted():
    args = knn_args(knn_inputs(5))
    before = egcl_knn.egcl_knn_launches
    got = egcl_knn.egcl_knn_edges(*args)
    want = egcl_knn.egcl_knn_edges_reference(*args)
    assert egcl_knn.egcl_knn_launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _valid(dtype=torch.bfloat16):
    return dict(zip(KNN_NAMES, knn_args(knn_inputs(6, hdim=36, f1=64, fm=64),
                                         dtype=dtype)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_accepts_kernel_layout(dtype):
    assert egcl_knn._check(_valid(dtype)) == dtype


@pytest.mark.parametrize("name,change,error", [
    ("idx", lambda t: t.to(torch.int64), TypeError),          # int64 idx
    ("idx", lambda t: t[..., :3].contiguous(), ValueError),   # K differs
    ("edge_mask", lambda t: t[:, :8].contiguous(), ValueError),  # shape
    ("w2x", lambda t: t[:, :32], ValueError),                 # shape
    ("h", lambda t: t.to(torch.float32), TypeError),          # mixed dtype
    ("x", lambda t: t.to(torch.bfloat16), TypeError),         # geometry f32
    ("edge_mask", lambda t: t.to(torch.bfloat16), TypeError),
    ("am_i", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),                                             # strides
    ("wm_j", lambda t: t.clone().requires_grad_(True), ValueError),  # grad
])
def test_check_refuses_what_the_kernel_does_not_take(name, change, error):
    tensors = _valid()
    tensors[name] = change(tensors[name])
    with pytest.raises(error):
        egcl_knn._check(tensors)


def test_check_refuses_float16():
    tensors = {k: v.to(torch.float16) if v.dtype == torch.bfloat16 else v
               for k, v in _valid().items()}
    with pytest.raises(TypeError, match="neither"):
        egcl_knn._check(tensors)


def test_check_refuses_widths_off_the_tile():
    tensors = dict(zip(KNN_NAMES, knn_args(knn_inputs(7, f1=32, fm=16),
                                            dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="multiples of 64"):
        egcl_knn._check(tensors)


def test_check_refuses_features_wider_than_the_kernel_holds():
    tensors = dict(zip(KNN_NAMES, knn_args(
        knn_inputs(8, hdim=egcl_knn.MAX_H + 1, f1=64, fm=64),
        dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="node features"):
        egcl_knn._check(tensors)
