"""vitax's gates of the fused attention halves and of the MLP half, as
integer arithmetic on shapes (a copy of vitax/ops/pallas_kernels.py:
2185-2213, :3363-3381 and :453-483 at their default limits; no environment
knob, no jax).

vitax picks its attention half with these gates: K1 (the whole-row core,
and its int8/int4 tiers) where `qkv_attention_supported` passes, else K6
(the KV-chunked core, bf16 only) where `qkv_attention_flash_supported`
passes, else its plain path (vitax/models/vit.py:220-227). Res-ViT's square
half asks the first with its heads (:2189-2196, the packed GQA width), its
rect half and its unfused `attention` (K9/K10) without
(vitax/models/resvit.py:266, :375). The port's halves need these AND its
own gates (cuda_kernels.py: Hopper shared memory, head dims, bf16 on the
card), so that a shape runs the half, and the tier, that vitax runs; where
vitax's gate passes and the port's does not, the port falls to its own
plain path or raises.

Under tensor parallelism vitax asks K1's gate at the shard width 3·(H/tp)·Hd
and the MLP gate on the shards of fc1 and fc2 (vitax/models/vit.py:190-194,
:276-279); where either declines it hands the sharded weights to XLA, and
the port runs its plain half on the gathered weights (models/vit.py).

Each gate takes anything with `.ndim` and `.shape` (meta tensors too): x
[B, S, D] (S unpadded or padded to spq = round_up(S, 8); both give the same
answer) and wqkv [D, W].
"""

from __future__ import annotations

QKVO_MAX_D = 1024        # VITAX_QKVO_MAX_D's default
QKVO_VMEM = 80 * 1024 * 1024
FLASH_MAX_D = 1536       # VITAX_QKVO_FLASH_MAX_D's default
FLASH_VMEM = 88 * 1024 * 1024
MAX_SEQ = 1024
MLP_MAX_D = 1280         # VITAX_MLP_MAX_D's default
MLP_MONO_MAX_D = 1024    # _MLP_MONO_MAX_D
MLP_DW_CHUNK = 1280      # VITAX_MLP_DW_CHUNK's default
MLP_VMEM = 96 * 1024 * 1024


def qkv_attention_vmem(s: int, d: int, hhd: int) -> int:
    """vitax's VMEM estimate of one grid step of its whole-row kernel
    (:2204-2212): bf16 wqkv and wo, their fp32 dW accumulators, two images'
    fp32 probabilities of hhd // 64 heads, two images' qkv (bf16 and the
    fp32 before its cast)."""
    spq = (s + 7) // 8 * 8
    heads = max(hhd // 64, 1)
    tile = 2
    weights = 2 * d * 3 * hhd + 2 * hhd * d
    accum = 4 * d * 3 * hhd + 4 * hhd * d
    probs = tile * heads * spq * spq * 4
    qkv_act = tile * spq * 3 * hhd * 6
    return weights + accum + probs + qkv_act


def qkv_attention_supported(x, wqkv, heads=None, kv_heads=None) -> bool:
    """vitax's `qkv_attention_supported` (:2185-2213): the packed GQA width
    when heads and kv_heads differ (it does not check heads % kv_heads,
    ROADMAP's reference caveats), else wqkv [D, 3·hhd]; s <= 1024, d and
    hhd <= 1024, d % 128 == 0, and the VMEM estimate within 80 MiB."""
    if x.ndim != 3 or len(wqkv.shape) != 2:
        return False
    _, s, d = x.shape
    w0, w1 = wqkv.shape
    if heads and kv_heads and kv_heads != heads:
        if w0 != d or w1 % (heads + 2 * kv_heads):
            return False
        hhd = w1 * heads // (heads + 2 * kv_heads)
    elif w0 != d or w1 % 3:
        return False
    else:
        hhd = w1 // 3
    if s > MAX_SEQ or d > QKVO_MAX_D or hhd > QKVO_MAX_D or d % 128:
        return False
    return qkv_attention_vmem(s, d, hhd) <= QKVO_VMEM


def qkv_attention_flash_supported(x, wqkv) -> bool:
    """vitax's `qkv_attention_flash_supported` (:3363-3381): wqkv [D,
    3·hhd], s <= 1024, d and hhd <= 1536, d % 128 == 0, and weights, fp32
    weight-grad accumulators and one image's whole-row activations within
    88 MiB."""
    if x.ndim != 3 or len(wqkv.shape) != 2:
        return False
    _, s, d = x.shape
    if wqkv.shape[0] != d or wqkv.shape[1] % 3:
        return False
    hhd = wqkv.shape[1] // 3
    spq = (s + 7) // 8 * 8
    if s > MAX_SEQ or d > FLASH_MAX_D or hhd > FLASH_MAX_D or d % 128:
        return False
    weights = 2 * d * 3 * hhd + 2 * hhd * d
    accum = 4 * d * 3 * hhd + 4 * hhd * d
    act = spq * 3 * hhd * 6 + spq * d * 10
    return weights + accum + act <= FLASH_VMEM


def ln_mlp_supported(x, w1, w2) -> bool:
    """vitax's `ln_mlp_supported` (:453-475): x [B, S, D], w1 [D, M], w2
    [M, D]; d <= 1280, d and M multiples of 128; above d 1024 (the chunked
    backward) M a multiple of its dW chunk (`_mc_for` :478-482), else the
    bf16 weights and fp32 accumulators, 12·d·M bytes, within 96 MiB."""
    if x.ndim != 3 or len(w1.shape) != 2 or len(w2.shape) != 2:
        return False
    d, m = x.shape[-1], w1.shape[1]
    if w1.shape[0] != d or tuple(w2.shape) != (m, d) or d > MLP_MAX_D:
        return False
    if d % 128 or m % 128:
        return False
    if d > MLP_MONO_MAX_D:
        mc = min(MLP_DW_CHUNK, m)
        while m % mc:
            mc //= 2
        return m % max(mc, 128) == 0
    return 12 * d * m <= MLP_VMEM
