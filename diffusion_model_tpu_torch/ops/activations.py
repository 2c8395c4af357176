"""Activations rounded as the JAX package rounds them, the node MLP, and
the fused bias-SiLU kernel.

The JAX package computes every sigmoid as ``jax.nn.sigmoid`` (``lax.
logistic``, lowered as ``1 / (1 + exp(-x))``) and every SiLU as ``x *
sigmoid(x)``, each op rounded to the compute dtype; a flax ``Dense`` adds
its bias after the product, rounded again. torch's one-op ``sigmoid`` and
``silu`` round once, and ``F.linear`` rounds the bias into the product, so
in bfloat16 they put the port as far from JAX's bf16 numbers as its float32
statement is (``tests/test_torch_compute_statement.py``,
``tests/test_torch_node_statement.py``). ``logistic``, ``silu`` and
``bias_silu`` are JAX's forms; the port uses them wherever its compute
dtype is not float32 (``silu_for``, ``sigmoid_for`` and ``add_silu`` pick
the form by dtype; a float32 model keeps torch's one-op forms), but in the
node MLP under autograd (``node_mlp``, F12 in ``ROADMAP.md`` §3).

``bias_silu(v, b)`` is ``silu(v + b)``: for each element ``t = r(v + b)``,
``e = r(exp(-t))``, ``d = r(1 + e)``, ``s = r(1 / d)``, ``y = r(t * s)``,
``r`` the rounding to ``v``'s dtype, each op computed in float32 as torch's
elementwise ops compute it. It adds no kernel of the JAX package's: XLA
fuses those five ops into one pass on the TPU; the port's op-by-op form is
five launches and a bias add where ``F.linear`` + ``F.silu`` were one
launch between them. So ``bias_silu`` is the custom op
``torch.ops.diffusion_model_tpu_torch.bias_silu`` (``bias_silu_op``): on
CUDA tensors it launches the hand-written kernel (``csrc/bias_silu.cu``,
bit for bit the op-by-op statement) or raises, on CPU tensors it runs
``bias_silu_reference``, and its fake implementation lets ``torch.export``
record one opaque node (``serve.py``). Its backward recomputes
``bias_silu_reference`` from the saved ``v`` and ``b`` and takes autograd
of it (``logistic``'s derivative is JAX's ``g * (s * (1 - s))``): the
gradient of the op-by-op statement, bit for bit, since the forward is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from diffusion_model_tpu_torch.ops.edge_grad import wants_grad

# Launches of the CUDA kernel in this process; only ``_launch`` adds to it,
# right after a launch was accepted.
bias_silu_launches = 0

_SOURCE = "bias_silu.cu"


class _Logistic(torch.autograd.Function):
    """The sigmoid as the JAX package's ``jax.nn.sigmoid`` computes it
    (``lax.logistic``, lowered as ``1 / (1 + exp(-x))`` with each op
    rounded to the dtype; its derivative ``g * (s * (1 - s))``). In
    bfloat16 torch's one-op ``sigmoid`` and ``silu`` round once, which puts
    the statement's outputs as far from JAX's as the float32 statement's
    (``tests/test_torch_compute_statement.py``)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` in ``x``'s dtype (``_Logistic``)."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` in ``x``'s dtype: ``x * sigmoid(x)``, two roundings."""
    return x * logistic(x)


def bias_silu_reference(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``silu(v + b)`` op by op in ``v``'s dtype: the kernel's plain
    version, and the statement autograd differentiates."""
    return silu(v + b)


def bias_silu(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``silu(v + b)`` with each op rounded to ``v``'s dtype, as a flax
    ``Dense`` and ``nn.silu`` compute it. ``v`` ``[..., F]`` (a product's
    output), ``b`` ``[F]``, one dtype. The custom op: the CUDA kernel on a
    CUDA tensor (bfloat16, or it raises), the statement on a CPU tensor;
    its backward is the statement's."""
    return bias_silu_op(v.contiguous(), b.contiguous())


def silu_for(dtype: torch.dtype) -> Callable:
    """The SiLU the port takes in ``dtype``: torch's one-op ``F.silu`` in
    float32, else ``silu`` (JAX's rounding)."""
    return F.silu if dtype == torch.float32 else silu


def sigmoid_for(dtype: torch.dtype) -> Callable:
    """The sigmoid the port takes in ``dtype``: torch's one-op
    ``torch.sigmoid`` in float32, else ``logistic`` (JAX's rounding)."""
    return torch.sigmoid if dtype == torch.float32 else logistic


def add_silu(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``silu(v + b)`` as the port computes it in ``v``'s dtype: torch's
    one-op ``F.silu`` in float32, else ``bias_silu`` (JAX's rounding)."""
    if v.dtype == torch.float32:
        return F.silu(v + b)
    return bias_silu(v, b)


def node_mlp(cat: torch.Tensor, h0: tuple, h1: tuple,
             zeros: tuple | None = None) -> torch.Tensor:
    """The EGCL's node MLP, Dense-SiLU-Dense on ``cat [..., H + m_out]``
    with the ``nn.Linear`` weights ``(weight [out, in], bias)`` cast to its
    dtype: ``F.linear`` and torch's one-op SiLU in float32 and wherever
    autograd records; else (a bf16 model's sampling and serving) each
    product, bias add and SiLU op rounded as the JAX package's flax
    ``Dense`` and ``nn.silu`` round (F12), the first bias and SiLU one
    ``bias_silu`` launch. Training keeps torch's form: with JAX's rounding
    the flagship's bf16 train step leaves its per-leaf parity gate against
    JAX's step (``ROADMAP.md`` §3 F12). Each product is ``F.linear`` with a
    zero bias (``zeros``, one per layer, made here where not given):
    cuBLAS's bias-epilogue GEMM, the kernel ``F.linear`` takes with a bias,
    where a bare product may take split-K and a reduction, one launch more;
    adding 0 to the float32 sum leaves the product's one rounding as it
    was."""
    if cat.dtype == torch.float32 or wants_grad((cat, *h0, *h1)):
        return F.linear(F.silu(F.linear(cat, *h0)), *h1)
    (w0, b0), (w1, b1) = h0, h1
    z0, z1 = zeros or (torch.zeros_like(b0), torch.zeros_like(b1))
    return F.linear(bias_silu(F.linear(cat, w0, z0), b0), w1, z1) + b1


def _check(v: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if v.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(
            f"the bias_silu kernel takes bfloat16 v and b; got {v.dtype} and "
            f"{b.dtype} (a float32 model uses F.silu)")
    if v.dim() < 1 or b.shape != v.shape[-1:]:
        raise ValueError(f"b has shape {tuple(b.shape)}, want "
                         f"{tuple(v.shape[-1:])} (v {tuple(v.shape)})")
    if b.device != v.device:
        raise ValueError(f"b is on {b.device}, v on {v.device}")
    if not (v.is_contiguous() and b.is_contiguous()):
        raise ValueError("the bias_silu kernel takes contiguous v and b")
    if v.numel() >= 2**31:
        raise ValueError(f"v has {v.numel()} elements; the kernel indexes "
                         "with 32-bit ints")


@functools.cache
def _library() -> ctypes.CDLL:
    from diffusion_model_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    lib.bias_silu_forward.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 2
                                      + [ctypes.c_void_p])
    lib.bias_silu_forward.restype = ctypes.c_int
    lib.bias_silu_error_string.argtypes = [ctypes.c_int]
    lib.bias_silu_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


def _launch(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, or raise: the op's CUDA implementation."""
    global bias_silu_launches
    _check(v, b)
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.bias_silu_forward(v.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), v.numel() // v.shape[-1],
                                   v.shape[-1], stream)
    if rc != 0:
        raise RuntimeError(
            f"bias_silu kernel launch failed: "
            f"{lib.bias_silu_error_string(rc).decode()} (cudaError {rc})")
    bias_silu_launches += 1
    return out


# The custom op: the kernel on CUDA tensors, the op-by-op statement on CPU
# tensors, no implementation on any other device.
bias_silu_op = torch.library.custom_op(
    "diffusion_model_tpu_torch::bias_silu", _launch, mutates_args=(),
    device_types="cuda", schema="(Tensor v, Tensor b) -> Tensor")
bias_silu_op.register_kernel("cpu", bias_silu_reference)


@bias_silu_op.register_fake
def _(v, b):
    return torch.empty_like(v)


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    """Autograd of ``bias_silu_reference`` recomputed from the saved
    inputs: the statement's gradient, bit for bit."""
    v, b = (t.detach().requires_grad_() for t in ctx.saved_tensors)
    with torch.enable_grad():
        y = bias_silu_reference(v, b)
    return torch.autograd.grad(y, (v, b), g)


bias_silu_op.register_autograd(_backward, setup_context=_save_inputs)
