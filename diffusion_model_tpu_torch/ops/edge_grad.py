"""The EGCL edge functions' gradient: the port of the JAX package's
``custom_vjp`` pairing (``diffusion_model_tpu/ops/egcl_pallas.py``
``egcl_pair_edges``, ``ops/egcl_pallas_sparse.py`` ``egcl_knn_edges``).

The forward is the edge function's kernel on the card, or its plain
statement on the CPU, on detached inputs; the backward is autograd over a
plain statement at the primals' own dtype, as ``_edges_bwd`` takes
``jax.vjp`` of the edge math. The edge functions pick the statement by
the compute dtype: float32 primals take the float32 reference, any other
the compute-dtype statement (``egcl_*_edges_compute``), which computes
what the JAX package's training differentiates (the flax module in that
dtype: JAX's training reaches no Pallas kernel). There is no backward
kernel: the JAX package has none either.

The plain statement materialises ``[graphs, targets, sources, width]``
intermediates, so both the plain route of the forward (``nn.egnn.
plain_edges``) and the backward run it in chunks (``edge_chunks``) of at
most ``PLAIN_EDGE_ELEMENTS`` elements an intermediate.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import torch

# The most elements one ``[B', T, N|K, F]`` edge intermediate of the plain
# statement may hold (float32: 64 MiB); the backward of a compute-dtype
# statement holds as many bytes (``EdgeFunction``: twice the elements in
# bfloat16).
PLAIN_EDGE_ELEMENTS = 1 << 24
# Arguments of both edge functions that are per graph (sliced by chunk).
GRAPH_ARGS = 6


def edge_chunks(b: int, n: int, sources: int, width: int,
                budget: int = PLAIN_EDGE_ELEMENTS) -> Iterator[tuple]:
    """(graphs, targets) slices covering ``b`` graphs of ``n`` targets in
    chunks of whole graphs, or of one graph's targets where a graph is too
    large, so that no ``[graphs, targets, sources, width]`` intermediate
    exceeds ``budget`` elements."""
    per_target = sources * width
    graphs = max(1, min(b, budget // max(n * per_target, 1)))
    targets = n if graphs * n * per_target <= budget else max(
        1, budget // per_target)
    for g0 in range(0, b, graphs):
        for t0 in range(0, n, targets):
            yield (slice(g0, min(b, g0 + graphs)),
                   slice(t0, min(n, t0 + targets)))


def edge_vjp(statement: Callable, primals: Sequence[torch.Tensor],
             cotangents: Sequence[torch.Tensor], needs: Sequence[bool],
             sources: int, width: int,
             budget: int = PLAIN_EDGE_ELEMENTS) -> list:
    """Gradients of ``statement(*primals) -> (m_sum, x_out)`` against the
    cotangents (each cast to its output's dtype), for the primals whose
    ``needs`` is true (None for the rest), taken at the primals' own dtype
    over chunks of targets, the chunks' parts summed in float32 and each
    gradient cast to its primal's dtype."""
    f32 = torch.float32
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() if need else p.detach()
                  for p, need in zip(primals, needs)]
        wanted = [i for i, need in enumerate(needs) if need]
        grads = [None] * len(leaves)
        b, n = primals[0].shape[:2]
        for g, t in edge_chunks(b, n, sources, width, budget):
            per_graph = [a[g] for a in leaves[:GRAPH_ARGS]]
            outs = statement(*per_graph, *leaves[GRAPH_ARGS:], targets=t)
            parts = torch.autograd.grad(
                outs, [leaves[i] for i in wanted],
                tuple(c[g, t].to(o.dtype) for c, o in zip(cotangents, outs)),
                allow_unused=True)
            for i, part in zip(wanted, parts):
                if part is not None:
                    part = part.to(f32)
                    grads[i] = part if grads[i] is None else grads[i] + part
    return [None if not need else
            (torch.zeros_like(p) if g is None else g.to(p.dtype))
            for p, g, need in zip(primals, grads, needs)]


class EdgeFunction(torch.autograd.Function):
    """``apply(forward, statement, sources, width, data, *args)``:
    ``forward(*args)`` on detached inputs (the kernel, or the float32
    reference on the CPU), and the gradient of ``statement``
    (``edge_vjp``) on the way back. ``sources`` and ``width`` size the
    backward's chunks (``PLAIN_EDGE_ELEMENTS`` float32 bytes an
    intermediate, in elements of the first argument's dtype); the arguments
    at the indices in ``data`` (masks, neighbour lists) get None."""

    @staticmethod
    def forward(ctx, forward, statement, sources, width, data, *args):
        ctx.statement, ctx.sources, ctx.width = statement, sources, width
        ctx.data = data
        ctx.save_for_backward(*args)
        return forward(*(a.detach() for a in args))

    @staticmethod
    def backward(ctx, g_m, g_x):
        needs = [need and i not in ctx.data
                 for i, need in enumerate(ctx.needs_input_grad[5:])]
        saved = ctx.saved_tensors
        budget = PLAIN_EDGE_ELEMENTS * 4 // saved[0].element_size()
        grads = edge_vjp(ctx.statement, saved, (g_m, g_x), needs,
                         ctx.sources, ctx.width, budget)
        return (None, None, None, None, None, *grads)


def wants_grad(args: Sequence[torch.Tensor]) -> bool:
    """True where autograd records: grad mode on and an input requires it."""
    return torch.is_grad_enabled() and any(a.requires_grad for a in args)
