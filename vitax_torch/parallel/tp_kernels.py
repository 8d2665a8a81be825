"""Tensor-parallel wrappers of the fused kernels (counterpart of
vitax/parallel/tp_kernels.py).

vitax runs each fused Pallas kernel per model shard under `shard_map`, on
the weights each device holds (attention: heads column-parallel, the
out-projection row-parallel; MLP: fc1 column-, fc2 row-parallel), and sums
the shards' bf16 partials with one psum per half-block. Here each rank runs
the same hand-written kernel on its shards, K1 (`fused_ln_qkvo_attention`),
K9 (`fused_qkvo_attention`) or K2 without its residual
(`fused_ln_mlp(..., residual=False)`), with the output bias zero, then one
all-reduce (SUM) of the partials over the mesh's model group, then the
bias once (and the residual, for the MLP).

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
from vitax_torch.parallel.mesh import Mesh, tp_size


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


def copy_to_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(t, mesh.model_group)


def reduce_from_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(t, mesh.model_group)


def _zeros(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(d, dtype=torch.float32, device=like.device)


def fused_ln_qkvo_attention_tp(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo,
                               mesh: Mesh, eps: float, seq_len: int,
                               heads: int, head_dim: int) -> torch.Tensor:
    """LN1 + QKV + attention + out-projection (K1) per model shard (vitax's
    :33-72): wq/wk/wv this rank's [D, H/tp, Hd] shards, bq/bk/bv [H/tp, Hd],
    wo [H/tp, Hd, D], bo whole [D]. Returns the attention half's output
    without the residual, [B, spq, D]."""
    h_local = heads // tp_size(mesh)
    d = x.shape[-1]
    x_, g_, b_ = (copy_to_model(t, mesh) for t in (x, gamma, beta))
    wqkv = torch.cat([w.reshape(d, -1) for w in (wq, wk, wv)], dim=1)
    bqkv = torch.cat([b.reshape(-1) for b in (bq, bk, bv)]).float()
    out = ck.fused_ln_qkvo_attention(x_, g_, b_, wqkv, bqkv,
                                     wo.reshape(-1, d), _zeros(d, x), eps,
                                     seq_len, h_local, head_dim)
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


def fused_ln_mlp_tp(x, gamma, beta, w1, b1, w2, b2, mesh: Mesh,
                    eps: float) -> torch.Tensor:
    """LN2 + fc1 + GELU + fc2 (K2 without its residual) per model shard
    (vitax's :106-129): w1 this rank's [D, M/tp] columns, b1 [M/tp], w2
    [M/tp, D] rows, b2 whole [D]; the partials summed, then the residual x
    and b2 added once: the same result as `fused_ln_mlp`."""
    x_, g_, b_ = (copy_to_model(t, mesh) for t in (x, gamma, beta))
    y = ck.fused_ln_mlp(x_, g_, b_, w1, b1, w2, _zeros(x.shape[-1], x), eps,
                        residual=False)
    y = reduce_from_model(y, mesh)
    return x + (y + b2.float().to(y.dtype))
