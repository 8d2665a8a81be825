"""Tensor-parallel wrappers of the fused kernels (counterpart of
vitax/parallel/tp_kernels.py).

vitax runs each fused Pallas kernel per model shard under `shard_map`, on
the weights each device holds (attention: heads column-parallel, the
out-projection row-parallel; MLP: fc1 column-, fc2 row-parallel), and sums
the shards' bf16 partials with one psum per half-block. Here each rank runs
the same hand-written kernel on its shards, K1 (`fused_ln_qkvo_attention`)
or its int8/int4 tiers K3 and K11-C, K9 (`fused_qkvo_attention`), or the
MLP half without its residual (`fused_ln_mlp(..., residual=False)`, K4's
and K11-A's `*_partial` wrappers with the tiers), with the output bias
zero, then one all-reduce (SUM) of the partials over the mesh's model
group, then the bias once (and the residual, for the MLP). A tier
quantizes per shard, as vitax's `shard_map` does: the per-column scales of
the row-parallel wo and w2 span the shard's rows, the per-row scales of
the attention output and of h1 the shard's columns.

Where vitax's per-shard gate declines, or a fused half is off, vitax's
plain halves run on the sharded weights, which XLA all-gathers around
them; here `gather_from_model` does that gather, an autograd Function
whose backward keeps this rank's slice of the whole grad.

The transpose of `shard_map` is the Megatron pair of autograd Functions:
`copy_to_model` (identity forward, all-reduce of the grad backward) on every
replicated input of a per-shard kernel, x and the LN's γ and β, whose
per-shard grads are partial sums; `reduce_from_model` (all-reduce forward,
identity backward) on the output. The shards' weight grads stay on their
rank, as vitax's sharded optimizer state expects.

x is this rank's rows of the batch (the data axis split it), [B, spq, D]
with spq a multiple of 8 and seq_len the real rows; the weights are this
rank's shards in the model's layouts.
"""

from __future__ import annotations

import torch

from vitax_torch.ops import cuda_kernels as ck
from vitax_torch.parallel.distributed import all_reduce
from vitax_torch.parallel.mesh import Mesh, gather_along, tp_size


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward: the grad summed over the model group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the partials summed over the model group; identity
    backward."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Forward: the whole tensor from the model group's shards of `axis`;
    backward: this rank's slice of the grad. Every model rank computes that
    grad whole and alike (the plain halves' input is replicated over the
    model axis), so the slice needs no sum."""

    @staticmethod
    def forward(ctx, t, axis, mesh):
        ctx.axis, ctx.size = axis, t.shape[axis]
        ctx.start = mesh.model_index * ctx.size
        return gather_along(t.contiguous(), axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.start, ctx.size).contiguous(), None, None


def gather_from_model(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """The whole weight of which `t` is this rank's shard along `axis`."""
    return _GatherFromModel.apply(t, axis, mesh)


def copy_to_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(t, mesh.model_group)


def reduce_from_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(t, mesh.model_group)


def _zeros(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(d, dtype=torch.float32, device=like.device)


def fused_ln_qkvo_attention_tp(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo,
                               mesh: Mesh, eps: float, seq_len: int,
                               heads: int, head_dim: int, int8: bool = False,
                               int8_grad: bool = False, int8_dw: bool = False,
                               int4: bool = False, int4_grad: bool = False
                               ) -> torch.Tensor:
    """LN1 + QKV + attention + out-projection per model shard (vitax's
    :33-72): K1, or with `int4` K11-C, with `int8` K3, and their backwards
    as vitax's dispatch picks them (K11-D only under int8, int8_grad and
    int4_grad). wq/wk/wv this rank's [D, H/tp, Hd] shards, bq/bk/bv [H/tp,
    Hd], wo [H/tp, Hd, D], bo whole [D]. Returns the attention half's output
    without the residual, [B, spq, D]."""
    h_local = heads // tp_size(mesh)
    d = x.shape[-1]
    x_, g_, b_ = (copy_to_model(t, mesh) for t in (x, gamma, beta))
    wqkv = torch.cat([w.reshape(d, -1) for w in (wq, wk, wv)], dim=1)
    bqkv = torch.cat([b.reshape(-1) for b in (bq, bk, bv)]).float()
    args = (x_, g_, b_, wqkv, bqkv, wo.reshape(-1, d), _zeros(d, x), eps,
            seq_len, h_local, head_dim)
    if int4:
        out = ck.fused_ln_qkvo_attention_int4(
            *args, int8_grad=int8 and int8_grad, int8_dw=int8_dw,
            int4_grad=int4_grad)
    elif int8:
        out = ck.fused_ln_qkvo_attention_int8(*args, int8_grad=int8_grad,
                                              int8_dw=int8_dw)
    else:
        out = ck.fused_ln_qkvo_attention(*args)
    out = reduce_from_model(out, mesh)
    return out + bo.float().to(out.dtype)


def fused_qkvo_attention_tp(x, wq, wk, wv, bq, bk, bv, wo, bo, mesh: Mesh,
                            seq_len: int, heads: int,
                            head_dim: int) -> torch.Tensor:
    """The Res-ViT layout (vitax's :75-103): QKV + attention +
    out-projection (K9) per model shard on the LN'd x: wq/wk/wv this rank's
    [D, D/tp] column shards (heads contiguous), bq/bk/bv [D/tp], wo [D/tp,
    D], bo whole [D]. LoRA-merged weights pass as they are."""
    h_local = heads // tp_size(mesh)
    d = x.shape[-1]
    wqkv = torch.cat([wq, wk, wv], dim=1)
    bqkv = torch.cat([bq, bk, bv]).float()
    out = ck.fused_qkvo_attention(copy_to_model(x, mesh), wqkv, bqkv, wo,
                                  _zeros(d, x), seq_len, h_local, head_dim)
    out = reduce_from_model(out, mesh)
    return out + bo.float().to(out.dtype)


def fused_ln_mlp_tp(x, gamma, beta, w1, b1, w2, b2, mesh: Mesh, eps: float,
                    int8: bool = False, int8_grad: bool = False,
                    int8_dw: bool = False, int4: bool = False,
                    int4_grad: bool = False) -> torch.Tensor:
    """LN2 + fc1 + GELU + fc2 without the residual per model shard (vitax's
    :106-129): K2, or with `int4` K11-A, with `int8` K4, each with the
    backward vitax's dispatch picks from the flags. No save-acts: vitax's
    wrapper passes none. w1 this rank's [D, M/tp] columns, b1 [M/tp], w2
    [M/tp, D] rows, b2 whole [D]; the partials summed, then the residual x
    and b2 added once."""
    x_, g_, b_ = (copy_to_model(t, mesh) for t in (x, gamma, beta))
    args = (x_, g_, b_, w1, b1, w2, _zeros(x.shape[-1], x), eps)
    if int4:
        y = ck.fused_ln_mlp_int4(*args, int8_grad=int8_grad, int8_dw=int8_dw,
                                 int4_grad=int4_grad, residual=False)
    elif int8:
        y = ck.fused_ln_mlp_int8(*args, int8_grad=int8_grad, int8_dw=int8_dw,
                                 residual=False)
    else:
        y = ck.fused_ln_mlp(*args, residual=False)
    y = reduce_from_model(y, mesh)
    return x + (y + b2.float().to(y.dtype))
