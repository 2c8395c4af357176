"""Ring-sharded dense message passing (the ring-attention analogue), as
``diffusion_model_tpu/parallel/ring.py``.

For cells whose dense ``[N, N]`` pair grid exceeds one card, the node axis
is split over a mesh axis: each rank keeps its *target* block of ``Nb = N /
W`` nodes and accumulates their partial message sums while the *source*
block rotates around the ring, one rank on a step (``W`` steps a layer).
The masked means over the whole graph (the virtual node's pooling, the
radius feature's centre, the CoM epilogue) are sums over the ring.

Two collectives carry the ring, each a ``torch.autograd.Function``, since
``torch.distributed``'s calls are not differentiable:

  * ``rotate``: send to the next rank of the ring, receive from the
    previous one (``batch_isend_irecv``); its backward is the inverse
    rotation. The rotation after a layer's last step is dead work (the
    JAX scan's carry out is unused), so it is not made: at a world of one
    the ring makes no point-to-point call at all.
  * ``psum``: ``all_reduce(SUM)``; its backward is ``all_reduce(SUM)`` of
    the incoming gradient, as JAX transposes a ``psum`` under
    ``shard_map``.

The parameters are the port's own ``DiffusionDenoiser``'s (the tensors a
``Trainer`` updates, so gradients land on its parameter dict); a rank's
gradients are its part, and the sum over the ring is the gradient of the
sum of the ranks' losses.

The edge work of a block is the plain PyTorch statement, ``[Nb, Nb]``
targets by sources with the global-index exclusion of self pairs, line by
line the JAX module's ``jnp`` (which is plain XLA there too: no Pallas
kernel runs in the JAX ring). It is not a fallback of K1: K1 takes the
square pair grid of whole graphs. Numerics follow the JAX module: the MLPs
in the compute dtype with the message sum accumulated in it, geometry and
the coordinate update in float32. ``ring_edge_calls`` counts its layer
calls (apart from ``nn.egnn.plain_edge_calls``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.ops import activations
from diffusion_model_tpu_torch.ops.edges import rbf_features
from diffusion_model_tpu_torch.parallel.mesh import Mesh

# Layer calls of the ring's plain edge statement in this process.
ring_edge_calls = 0


class _Ring:
    """This rank's ring along a mesh axis: its process group, the ranks in
    ring order and this rank's place."""

    def __init__(self, mesh: Mesh, axis: str):
        self.group, self.ranks = mesh.lines[axis]
        self.place = mesh.axis_index(axis)
        self.size = len(self.ranks)

    def shift(self, tensors, step: int) -> list:
        """Each tensor of the rank ``step`` places back in the ring (``step``
        +1: from the previous rank, sending to the next)."""
        dst = self.ranks[(self.place + step) % self.size]
        src = self.ranks[(self.place - step) % self.size]
        outs = [torch.empty_like(t) for t in tensors]
        ops = []
        for tag, (t, o) in enumerate(zip(tensors, outs)):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst,
                                  self.group, tag))
            ops.append(dist.P2POp(dist.irecv, o, src, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        ctx.float_at = [i for i, t in enumerate(tensors)
                        if t.is_floating_point()]
        outs = ring.shift(tensors, +1)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        back = ctx.ring.shift([grads[i] for i in ctx.float_at], -1)
        out = [None] * len(grads)
        for i, g in zip(ctx.float_at, back):
            out[i] = g
        return (None, *out)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def psum(tensor: torch.Tensor, ring: _Ring) -> torch.Tensor:
    """The sum of ``tensor`` over the ring, on every rank (differentiable)."""
    return _Psum.apply(tensor, ring.group)


def _dense(p, v, dt):
    """``v @ kernel + bias`` of an ``[in, out]`` kernel module, in ``dt``."""
    return v @ p.kernel.to(dt) + p.bias.to(dt)


def _linear(p, v, dt):
    return F.linear(v, p.weight.to(dt), p.bias.to(dt))


def _dense_silu(p, v, dt):
    """The SiLU of ``_dense(p, v, dt)``, the bias added last
    (``ops.activations.add_silu``: JAX's rounding where ``dt`` is not
    float32, F12 in ``ROADMAP.md`` §3)."""
    return activations.add_silu(v @ p.kernel.to(dt), p.bias.to(dt))


def _psum_masked_mean(v, mask, ring: _Ring):
    """The masked mean of the resident block ``v [Nb, D]`` over the whole
    ring's node axis, and the ring's count of masked-in nodes: the
    collective counterpart of ``ops.com.masked_mean``."""
    m = mask.to(v.dtype)[:, None]
    total = psum((v * m).sum(dim=0), ring)
    count = psum(m.sum(), ring)
    return total / count.clamp_min(1.0), count


def _vn_ring(lp, h_i, x_i, mask_i, ring: _Ring, dt, hdim):
    """The virtual-node channel over the sharded node axis (``nn.egnn.EGCL.
    _virtual_channel``): the pooled transform's masked mean is one psum a
    layer. Returns ``(vn_msg [Nb, m_out] dt, x_vn [Nb, 3] float32)``."""
    f32 = torch.float32
    m3_f = mask_i[:, None].to(f32)
    h_m = (h_i * mask_i[:, None].to(h_i.dtype)).to(dt)
    x_f = x_i.to(f32)
    x_v, _ = _psum_masked_mean(x_f, mask_i, ring)          # [3] global CoM
    diff = (x_f - x_v[None, :]) * m3_f                      # [Nb, 3]
    r2_f = (diff * diff).sum(dim=-1, keepdim=True)          # [Nb, 1]
    r2 = r2_f.to(dt)

    u = _dense_silu(lp.vnode_in, torch.cat([h_m, r2], dim=-1), dt)
    u = u * m3_f.to(dt)
    mean_u, _ = _psum_masked_mean(u, mask_i.to(u.dtype), ring)
    h_v = _dense_silu(lp.vnode_pool, mean_u[None, :], dt)  # [1, V]
    vdim = h_v.shape[-1]

    def global_first(p):
        k = p.kernel.to(dt)
        return (h_m @ k[:hdim] + h_v @ k[hdim:hdim + vdim]
                + r2 * k[hdim + vdim] + p.bias.to(dt))

    vn_msg = global_first(lp.vnode_out) * m3_f.to(dt)
    s_v = ((activations.silu_for(dt)(global_first(lp.vnode_x))
            * lp.vnode_x_head.kernel[:, 0].to(dt)).sum(dim=-1, keepdim=True)
           + lp.vnode_x_head.bias.to(dt))
    norm = torch.sqrt(torch.where(m3_f > 0, r2_f.clamp_min(1e-12),
                                  torch.ones_like(r2_f)))
    x_vn = diff * (s_v.to(f32) / (norm + 1.0)) * m3_f
    return vn_msg, x_vn


def _egcl_ring(lp, h_i, x_i, mask_i, idx_i, ring: _Ring, dt, hdim,
               h_residual=False, rbf=None, vn=None):
    """One EGCL over ring-rotated source blocks: ``h_i``, ``x_i``,
    ``mask_i`` the resident target block ``[Nb, ...]``, ``idx_i [Nb]`` its
    global node indices; ``rbf`` ``(num, rmax)`` of the radial-basis edge
    features; ``vn`` the layer's virtual-node channel (``_vn_ring``)."""
    global ring_edge_calls
    ring_edge_calls += 1
    f32 = torch.float32
    m0k = lp.mlp_m_dense0.kernel.to(dt)
    m0b = lp.mlp_m_dense0.bias.to(dt)
    x0k = lp.mlp_x_dense0.kernel.to(dt)
    x0b = lp.mlp_x_dense0.bias.to(dt)
    rbf_m_k = lp.rbf_m.kernel.to(dt) if rbf else None
    rbf_x_k = lp.rbf_x.kernel.to(dt) if rbf else None
    att_k = lp.attention_dense.kernel[:, 0].to(dt)
    att_b = lp.attention_dense.bias.to(dt)
    x2_k = lp.mlp_x_dense2.kernel[:, 0].to(dt)
    x2_b = lp.mlp_x_dense2.bias.to(dt)

    silu, sigmoid = activations.silu_for(dt), activations.sigmoid_for(dt)
    h_c = h_i.to(dt)
    # target-side projections (the bias folded in) and the source-side
    # ones of the resident block, which rotate
    am_i = h_c @ m0k[:hdim] + m0b
    ax_i = h_c @ x0k[:hdim] + x0b
    bm = h_c @ m0k[hdim:2 * hdim]
    bx = h_c @ x0k[hdim:2 * hdim]
    w_dm = m0k[2 * hdim]
    w_dx = x0k[2 * hdim]

    nb = h_i.shape[0]
    m_sum = torch.zeros(nb, lp.mlp_m_dense1.kernel.shape[1], dtype=dt,
                        device=h_i.device)
    upd = torch.zeros(nb, 3, dtype=f32, device=h_i.device)
    x_if = x_i.to(f32)
    bm_r, bx_r, x_r, mask_r, idx_r = bm, bx, x_i, mask_i, idx_i
    for step in range(ring.size):
        # float32 geometry; only the MLP feature copy casts to dt
        diff = x_if[:, None, :] - x_r.to(f32)[None, :, :]
        d2 = (diff * diff).sum(dim=-1, keepdim=True)
        pm_b = (((mask_i[:, None, None] * mask_r[None, :, None]) > 0)
                & (idx_i[:, None, None] != idx_r[None, :, None]))
        pm = pm_b.to(dt)

        pre_m = am_i[:, None, :] + bm_r[None, :, :] + d2.to(dt) * w_dm
        pre_x = ax_i[:, None, :] + bx_r[None, :, :] + d2.to(dt) * w_dx
        if rbf is not None:
            feats = rbf_features(d2, pm_b, *rbf).to(dt)
            pre_m = pre_m + feats @ rbf_m_k
            pre_x = pre_x + feats @ rbf_x_k
        m = _dense_silu(lp.mlp_m_dense1, silu(pre_m), dt)
        att = sigmoid((m * att_k).sum(dim=-1, keepdim=True) + att_b)
        m_sum = m_sum + (m * att * pm).sum(dim=1)

        u = _dense_silu(lp.mlp_x_dense1, silu(pre_x), dt)
        s = (u * x2_k).sum(dim=-1, keepdim=True) + x2_b
        norm = torch.sqrt(torch.where(pm > 0, d2.clamp_min(1e-12),
                                      torch.ones_like(d2)))
        upd = upd + (diff * (s.to(f32) / (norm + 1.0))
                     * pm.to(f32)).sum(dim=1)
        if step < ring.size - 1:
            bm_r, bx_r, x_r, mask_r, idx_r = _Rotate.apply(
                ring, bm_r, bx_r, x_r, mask_r, idx_r)

    if vn is not None:
        m_sum = m_sum + vn[0].to(m_sum.dtype)
    h0, h1 = lp.mlp_h_dense0, lp.mlp_h_dense1
    h_new = activations.node_mlp(torch.cat([h_c, m_sum], dim=-1),
                                 (h0.weight.to(dt), h0.bias.to(dt)),
                                 (h1.weight.to(dt), h1.bias.to(dt)))
    if h_residual and h_new.shape[-1] == h_c.shape[-1]:
        h_new = h_new + h_c
    x_new = x_i.to(f32) + upd
    if vn is not None:
        x_new = x_new + vn[1]
    return h_new.to(h_i.dtype), x_new.to(x_i.dtype)


def _compressed(comp, spectrum, dt):
    y = spectrum.to(dt)
    for i in range(comp.num_hidden):
        y = torch.relu(_linear(getattr(comp, f"dense{i}"), y, dt))
    return _linear(comp.dense_out, y, dt)


def _check(cfg: Config) -> None:
    if cfg.compat_scalar_norm:
        raise ValueError(
            "compat_scalar_norm (one norm over a graph's whole pair grid) is "
            "not computed by the ring, whose blocks see one block of pairs "
            "at a time; it is a dense-path validation mode")


def ring_denoise_apply(cfg: Config, mesh: Mesh, axis: str = "data"
                       ) -> Callable:
    """The ring-sharded denoiser over one graph, differentiable in the
    model's parameters.

    Returns ``fn(model, species_ch [N, A], pos [N, 3], spectrum [N, S],
    exo [N, 1], t_norm [N, 1], mask [N]) -> (eps_x [Nb, 3], eps_h [Nb,
    A])``: ``model`` a ``DiffusionDenoiser`` whose parameters are read, the
    inputs the whole graph (the same on every rank of the ring), the
    outputs this rank's block of nodes (block ``mesh.axis_index(axis)`` of
    ``N / W``). The JAX function returns the node-sharded global arrays;
    here each rank holds its block, and ``ring_denoise_fn`` gathers them.
    Raises where ``N`` does not split into the ring's ``W`` blocks.
    """
    _check(cfg)
    dt = cfg.torch_dtype
    hdim = cfg.h_size
    ring = _Ring(mesh, axis)
    rbf = (cfg.edge_rbf, cfg.edge_rbf_rmax) if cfg.edge_rbf else None

    def fn(model, species_ch, pos, spectrum, exo, t_norm, mask):
        n = pos.shape[0]
        if n % ring.size != 0:
            raise ValueError(f"N={n} not divisible by the ring's size "
                             f"{ring.size}")
        width = n // ring.size
        blk = slice(ring.place * width, (ring.place + 1) * width)
        species_ch, pos, spectrum, exo, t_norm, mask = (
            a[blk] for a in (species_ch, pos, spectrum, exo, t_norm, mask))
        idx = torch.arange(blk.start, blk.stop, dtype=torch.int32,
                           device=pos.device)

        feats = [species_ch.to(dt)]
        if cfg.conditional:
            comp = model.spectrum_compressor
            feats.append(spectrum.to(dt) if comp is None
                         else _compressed(comp, spectrum, dt))
        if cfg.give_exO:
            feats.append(exo.to(dt))
        if cfg.global_radius_feature:
            # the radius feature's centre is the masked CoM of the whole
            # graph: one psum
            m3 = mask[:, None].to(pos.dtype)
            com, _ = _psum_masked_mean(pos, mask.to(pos.dtype), ring)
            d2g = ((pos - com[None, :]) ** 2).sum(dim=-1, keepdim=True)
            r = torch.sqrt(d2g.clamp_min(1e-12))
            gate = model.radius_feature_gate.to(pos.dtype)
            feats.append((torch.log1p(r) * m3 * gate).to(dt))
        feats.append(t_norm.to(dt))
        h = torch.cat(feats, dim=-1)

        x = pos
        for l in range(cfg.L):
            lp = getattr(model.egnn, f"egcl_{l}")
            vn = (_vn_ring(lp, h, x, mask, ring, dt, hdim)
                  if cfg.virtual_node else None)
            h, x = _egcl_ring(lp, h, x, mask, idx, ring, dt, hdim,
                              h_residual=cfg.h_residual, rbf=rbf, vn=vn)

        # the CoM over the whole graph
        m3 = mask[:, None].to(pos.dtype)
        delta = (x - pos) * m3
        total = psum(delta.sum(dim=0), ring)
        count = psum(mask.sum(), ring)
        eps_x = (delta - total / count.clamp_min(1.0)) * m3
        eps_h = h[:, : cfg.atom_type_size].to(pos.dtype) * m3
        return eps_x, eps_h

    return fn


def _gather(block: torch.Tensor, ring: _Ring) -> torch.Tensor:
    if ring.size == 1:
        return block
    parts = [torch.empty_like(block) for _ in range(ring.size)]
    dist.all_gather(parts, block.contiguous(), group=ring.group)
    return torch.cat(parts, dim=0)


def ring_denoise_fn(cfg: Config, model, mesh: Mesh, axis: str = "data"
                    ) -> Callable:
    """The ring denoiser with ``model``'s parameters, for inference:
    ``fn(species_ch, pos, spectrum, exo, t_norm, mask) -> (eps_x [N, 3],
    eps_h [N, A])``, the whole graph's outputs on every rank (the blocks of
    ``ring_denoise_apply`` gathered over the ring)."""
    apply_fn = ring_denoise_apply(cfg, mesh, axis)
    ring = _Ring(mesh, axis)

    def fn(species_ch, pos, spectrum, exo, t_norm, mask):
        eps_x, eps_h = apply_fn(model, species_ch, pos, spectrum, exo,
                                t_norm, mask)
        return _gather(eps_x, ring), _gather(eps_h, ring)

    return fn


def ring_sampler_denoise_fn(cfg: Config, model, mesh: Mesh,
                            axis: str = "data") -> Callable:
    """The ring denoiser under the sampler's contract: ``fn(species_ch,
    pos, spectrum, exo, t_norm, mask, edges=None)`` over ``[1, N, ...]``,
    so that the unchanged sampler (strided, deterministic, guidance, the
    t=0 epilogue, retries) generates through the ring. Every rank runs the
    sampler over the whole graph with the same draws, and the ring splits
    each denoiser call. One graph a call (a batch of several raises); the
    dense topology only (``neighbor_k`` raises: kNN cells scale on one card
    through the kNN kernel)."""
    if cfg.neighbor_k:
        raise ValueError(
            "ring_sample is the dense-topology scale-out; kNN cells "
            "(neighbor_k > 0) scale on one card through the kNN kernel: "
            "unset neighbor_k or ring_sample")
    inner = ring_denoise_fn(cfg, model, mesh, axis)

    def fn(species_ch, pos, spectrum, exo, t_norm, mask,
           edges: Optional[object] = None):
        del edges  # the ring builds its pair blocks itself
        if pos.shape[0] != 1:
            raise ValueError(
                f"ring sampling takes one node-sharded graph per call "
                f"(got batch_size={pos.shape[0]}); use api.generate_ring")
        eps_x, eps_h = inner(species_ch[0], pos[0], spectrum[0], exo[0],
                             t_norm[0], mask[0])
        return eps_x[None], eps_h[None]

    return fn
