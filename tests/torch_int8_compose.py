"""Plain pieces of the Hopper int8 attention halves, composed on CPU tensors
by the decomposition tests (test_torch_int8_fwd_decomposition.py,
test_torch_int8_bwd_decomposition.py, test_torch_rect_int8_decomposition.py,
test_torch_gqa_int8_bwd_decomposition.py,
test_torch_int4_attn_decomposition.py, test_torch_int4_bwd_decomposition.py):
the LN-quant prologue, K13's forward core with its fp32 out
(attention_core.cuh, kRowsFwdF32), K13's three backward passes
(attention_core_bwd.cu), the int8_dw group folds as the card runs them
(dw_int8.cuh's packs, `s8_group`, and for the int4_grad tier both
operands' column packs and `s8_group_rc`), and K3's forward and backward
in their launch order (the backward also K7's, kv_heads < heads; with
`int4` both are K11-C's and K11-D's, G-F's and G-B's with kv_heads).
Every core piece takes per-head tensors [B, H, rows, Hd] with the query and
key sides apart, so the square geometry (K3) and K8's rect one (cpq query
rows against spq key rows) run the same code; the core grads also take
K7's GQA geometry (`kv_heads`). `check_hopper_body` scans a source for
the pieces an entry point's Hopper body launches.
"""

import math
import re

import torch

from vitax_torch.ops import cuda_kernels as ck
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.quant import quant_cols

BF = torch.bfloat16
TILE = 128  # gemm_sm90.cuh's s8 K tile (kBK8)
# what a Hopper body may not name: the first design's products (gemm.cuh's
# s8 and bf16 WMMA GEMMs, its group folds) and its whole-row cores
FIRST_DESIGN_CALLS = ("launch_gemm_s8", "launch_attention_core_geom",
                      "launch_attention_bwd_geom", "launch_gemm_tn",
                      "launch_dw_int8(", "launch_dw_int8<",
                      "launch_dw_int8_cols", "AttnGeom")


def _body(src, name):
    """The text of the function `name` of a source, up to its closing
    brace at column 0."""
    start = re.search(rf"^\S.* {name}\(", src, re.M).start()
    return src[start:src.index("\n}\n", start)]


def check_hopper_body(source, hopper, entry, launches):
    """csrc/`source`'s entry point `entry` calls the function `hopper`
    alone (a template's name without its arguments), whose body holds each
    of `launches` and names none of FIRST_DESIGN_CALLS."""
    from vitax_torch.kernels import build
    src = (build.CSRC / source).read_text()
    called = set(re.findall(r"(\w+)(?:<[\w:, ]+>)?\(",
                            _body(src, entry).split("{", 1)[1]))
    assert called - {"static_cast"} == {hopper}, called
    body = _body(src, hopper)
    for call in launches:
        assert call in body, call
    for first_design in FIRST_DESIGN_CALLS:
        assert first_design not in body, first_design


def ln_quant(x2, gamma, beta, eps, int4=False):
    """The LN-quant prologue: the codes and scales of the fp32 LN output."""
    xhat, _ = ck._ln_stats(x2.float(), eps)
    return ck._quantizers(int4)[0](ck._affine(xhat, gamma, beta))


def _scores(q, k, seq_len):
    """s·scale·log2e of q [B, H, Sq, Hd] against k [B, H, Sk, Hd], the keys
    >= seq_len at −inf."""
    s = matmul_f32(q, k.transpose(-1, -2)) * (math.log2(math.e)
                                              / math.sqrt(q.shape[-1]))
    s[..., seq_len:] = -math.inf
    return s


def k13_core_f32(q, k, v, seq_len):
    """K13's forward core (kRowsFwdF32): per query row m of s·scale·log2e
    over the keys < seq_len, 1/l of Σ exp2(s·c − m), p = exp2(s·c −
    m)·(1/l), 0 on the keys >= seq_len, rounded to bf16 once; the fp32
    head outputs p·v [B, H, Sq, Hd], never rounded (the bf16 forward rounds
    them once)."""
    s = _scores(q, k, seq_len)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    return matmul_f32(p.to(BF), v)


def k13_core_grads(q, k, v, o, d_o, seq_len, kv_heads=None):
    """K13's three backward passes on q, o, d_o [B, H, Sq, Hd] and k, v
    [B, H, Sk, Hd]: the row pass's m (of s·scale·log2e), 1/l and dd = Σ
    f32(dO)·f32(o) of every query row, o the bf16 head outputs; the key
    pass's p = exp2(s·c − m)·(1/l), 0 on the keys >= seq_len, ds =
    bf16(p (dO·vᵀ − dd)), dk = bf16((dsᵀ·q)·scale) and dv =
    bf16(bf16(p)ᵀ·dO), written as 0 on the key rows >= seq_len; the query
    pass's dq = bf16((ds·k)·scale). Returns (dq, dk, dv). With `kv_heads`
    < H (the GQA geometry: k, v repeated per query head, each kv group's
    H/kv_heads heads adjacent) dk and dv are [B, kv_heads, Sk, Hd]: the key
    pass's fp32 sum over a group's query heads, in head order, scaled and
    cast once."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # the row pass
    s = _scores(q, k, seq_len)
    m = s.amax(dim=-1, keepdim=True)
    inv = 1.0 / torch.exp2(s - m).sum(dim=-1, keepdim=True)
    dd = (d_o.float() * o.float()).sum(dim=-1, keepdim=True)
    # the key pass
    p = torch.exp2(s - m) * inv
    ds = (p * (matmul_f32(d_o, v.transpose(-1, -2)) - dd)).to(BF)
    if kv_heads is None or kv_heads == q.shape[1]:
        dk = (matmul_f32(ds.transpose(-1, -2), q) * scale).to(BF)
        dv = matmul_f32(p.to(BF).transpose(-1, -2), d_o).to(BF)
    else:
        dk = (ck._group_sum(matmul_f32(ds.transpose(-1, -2), q), kv_heads)
              * scale).to(BF)
        dv = ck._group_sum(matmul_f32(p.to(BF).transpose(-1, -2), d_o),
                        kv_heads).to(BF)
    dk[..., seq_len:, :] = 0
    dv[..., seq_len:, :] = 0
    # the query pass
    dq = (matmul_f32(ds, k) * scale).to(BF)
    return dq, dk, dv


def group_fold(a, u, q, group):
    """An int8_dw weight grad as the card computes it: dw_int8.cuh's packs
    (the column codes of a·u over each group of `group` rows, and the row
    codes q, both transposed to [W, kp] with each group's rows zero-padded
    to whole 128-code K tiles), then `s8_group`'s fold."""
    gp = -(-group // TILE) * TILE
    packs, scales, codes = [], [], []
    for r0 in range(0, a.shape[0], group):
        ac, sc = quant_cols(a[r0:r0 + group].float() * u[r0:r0 + group])
        pad = (0, 0, 0, gp - ac.shape[0])
        packs.append(torch.nn.functional.pad(ac, pad))
        codes.append(torch.nn.functional.pad(q[r0:r0 + group], pad))
        scales.append(sc.reshape(-1))
    at, qt = torch.cat(packs).t().contiguous(), torch.cat(codes).t()
    return ck.gemm_sm90_s8_ref("s8_group", at, qt.contiguous(),
                               torch.stack(scales), group=gp)


def group_fold_cols(a, b, group):
    """The int4_grad tier's int8_dw weight grad as the card computes it:
    dw_int8.cuh's column packs of both operands (the column codes of a and
    of b over each group of `group` rows, no row scale, transposed to
    [W, kp] with each group's rows zero-padded to whole 128-code K tiles),
    then `s8_group_rc`'s two-scale fold."""
    gp = -(-group // TILE) * TILE

    def packs(m):
        codes, scales = [], []
        for r0 in range(0, m.shape[0], group):
            c, sc = quant_cols(m[r0:r0 + group].float())
            codes.append(torch.nn.functional.pad(c, (0, 0, 0,
                                                     gp - c.shape[0])))
            scales.append(sc.reshape(-1))
        return torch.cat(codes).t().contiguous(), torch.stack(scales)

    (at, sa), (bt, sb) = packs(a), packs(b)
    return ck.gemm_sm90_s8_ref("s8_group_rc", at, bt, sa, sb, group=gp)


def _packed_heads(qkv, b, spq, heads, head_dim, kv_heads):
    """q [B, H, spq, Hd] and k, v [B, Hkv, spq, Hd] of the packed rows
    [q (H·Hd) | k (Hkv·Hd) | v (Hkv·Hd)]."""
    hhd, kvw = heads * head_dim, kv_heads * head_dim
    rows = qkv.view(b, spq, -1)
    return (ck._split_heads(rows[..., :hhd], heads),
            ck._split_heads(rows[..., hhd:hhd + kvw], kv_heads),
            ck._split_heads(rows[..., hhd + kvw:], kv_heads))


def k3_fwd_composed(t, seq_len, heads, head_dim, eps, kv_heads=None,
                    int4=False):
    """K3's forward (ln_qkvo_attention_int8.cu, kv_heads == heads) in its
    launch order on t["x"] [B, spq, D]: the weights' column codes, the
    LN-quant prologue, qkv on `gemm_sm90_s8_ref("s8_bf16")` + bias, K13's
    core with the fp32 out on the packed rows, the attn's row codes, the
    out-projection on `s8_bf16` + bias. With `int4` K11-C's, every
    quantizer on the int4 grid, and with `kv_heads` < heads G-F's (the core
    in its GQA geometry: query head h reads k, v of group h·Hkv/H). Returns
    (out, qkv)."""
    b, spq, d = t["x"].shape
    kv_heads = kv_heads or heads
    rows, cols_host, _ = ck._quantizers(int4)
    w8, sw = cols_host(t["wqkv"])  # stored [W, D]: its transpose
    wo8, swo = cols_host(t["wo"])
    xq, sx = ln_quant(t["x"].reshape(-1, d), t["gamma"], t["beta"], eps,
                      int4)
    qkv = ck.gemm_sm90_s8_ref("s8_bf16", xq, w8.t().contiguous(), sx, sw,
                              t["bqkv"])
    q, k, v = _packed_heads(qkv, b, spq, heads, head_dim, kv_heads)
    k, v = (m.repeat_interleave(heads // kv_heads, dim=1) for m in (k, v))
    aq, sa = rows(ck._heads_to_rows(k13_core_f32(q, k, v, seq_len)))
    out = ck.gemm_sm90_s8_ref("s8_bf16", aq, wo8.t().contiguous(), sa, swo,
                              t["bo"])
    return out.view(t["x"].shape), qkv


def qkvo_int8_bwd_composed(t, seq_len, heads, head_dim, eps, int8_dw, group,
                           kv_heads=None, int4=False):
    """K3's backward (csrc/ln_qkvo_attention_int8_bwd.cu; with `kv_heads` <
    heads K7's, at the packed width (H + 2·Hkv)·Hd) in its launch order on
    t["x"], t["do"] [B, spq, D] and the half's weights: the weights' codes,
    the LN-quant recompute, qkv on `s8_bf16` + bias, the core on the packed
    rows (its forward as the twin's, its grads as K13's three passes,
    `k13_core_grads`), do's codes, dattn (`s8_bf16`), dWo (`tn_f32`, or
    under int8_dw the group fold), dbo, dqkv's codes, dxn (`s8_f32`), dW,
    dbqkv and the LN tail. With `int4` K11-D's (G-B's with `kv_heads`):
    the weights', the recompute's and the dx-path's codes on the int4 grid,
    and under int8_dw the two-scale fold of both operands' column packs
    (`group_fold_cols`). Returns ((dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo),
    dqkv)."""
    b, spq, d = t["x"].shape
    rows, cols_host, rows_host = ck._quantizers(int4)
    do2 = t["do"].reshape(-1, d)
    w8, sw = cols_host(t["wqkv"])  # stored [W, D]: its transpose
    w8r, swr = rows_host(t["wqkv"])
    wo8r, swor = rows_host(t["wo"])
    xhat, rstd = ck._ln_stats(t["x"].reshape(-1, d).float(), eps)
    xn32 = ck._affine(xhat, t["gamma"], t["beta"])
    xq, sx = rows(xn32)
    qkv = ck.gemm_sm90_s8_ref("s8_bf16", xq, w8.t().contiguous(), sx, sw,
                              t["bqkv"])
    q, k, v, _, o32 = ck._attn_core(qkv.view(b, spq, -1), seq_len, heads,
                                    head_dim, kv_heads)
    o = o32.to(BF)
    attn = ck._heads_to_rows(o)
    doq, sdo = rows(do2.float())
    dattn = ck.gemm_sm90_s8_ref("s8_bf16", doq, wo8r, sdo, swor)
    if not int8_dw:
        dwo = ck.gemm_sm90_ref("tn_f32", attn, do2)
    elif int4:
        dwo = group_fold_cols(attn, do2, group)
    else:
        dwo = group_fold(attn, sdo, doq, group)
    dbo = do2.float().sum(dim=0)
    d_o = ck._split_heads(dattn.view(b, spq, -1), heads)
    dqkv = torch.cat([ck._heads_to_rows(g) for g in k13_core_grads(
        q, k, v, o, d_o, seq_len, kv_heads)], dim=1)
    dqq, sdq = rows(dqkv.float())
    dxn = ck.gemm_sm90_s8_ref("s8_f32", dqq, w8r, sdq, swr)
    if not int8_dw:
        dw = ck.gemm_sm90_ref("tn_f32", xn32.to(BF), dqkv)
    elif int4:
        dw = group_fold_cols(xn32, dqkv, group)
    else:
        dw = group_fold(xn32, sdq, dqq, group)
    dbqkv = dqkv.float().sum(dim=0)
    dxln, dg, dbe = ck._ln_bwd_tail(dxn, xhat, rstd, t["gamma"])
    return (dxln.to(BF).view(t["x"].shape), dg, dbe, dw, dbqkv, dwo,
            dbo), dqkv


def rect_int8_bwd_composed(t, seq_len, heads, head_dim, eps, int8_dw,
                           int4=False):
    """K8's int8 backward (csrc/ln_qkvo_attention_rect_int8_bwd.cu) in its
    launch order on t["xc"], t["do"] [B, cpq, D], t["x"] [B, spq, D] and
    the half's weights: the weights' codes (Wqkv's columns whole, the rows
    of the slices Wq and Wkv), the LN-quant recompute of xc and x, q and kv
    on `s8_bf16`, K13's forward (attn bf16), do's codes, dattn (`s8_bf16`),
    dWo (`tn_f32`, or the group fold over group_c rows), dbo, K13's three
    passes in the rect geometry, dq's and dkv's codes, dxnc and dxn
    (`s8_f32`), dWq and dWkv (`tn_f32`, or the folds over group_c and
    group_k rows), dbq, dbkv and the two LN tails. With `int4` R-B's: the
    weights', the recompute's and the dx-path's codes on the int4 grid, and
    under int8_dw the two-scale folds of both operands' column packs
    (`group_fold_cols`). Returns ((dxc, dx, dγ, dβ, dWqkv, dbqkv, dWo,
    dbo), dk, dv), dk and dv the core's [B, H, spq, Hd]."""
    b, cpq, d = t["xc"].shape
    spq = t["x"].shape[1]
    hhd = heads * head_dim
    group_c, group_k = ck.qkvo_rect_dw_groups(b, cpq, spq)
    rows, cols_host, rows_host = ck._quantizers(int4)
    do2 = t["do"].reshape(-1, d)
    w8, sw = cols_host(t["wqkv"])
    w8t = w8.t().contiguous()  # stored [3·hhd, D]
    wq8r, swqr = rows_host(t["wqkv"][:, :hhd])
    wkv8r, swkvr = rows_host(t["wqkv"][:, hhd:])
    wo8r, swor = rows_host(t["wo"])

    def ln(key):
        xhat, rstd = ck._ln_stats(t[key].reshape(-1, d).float(), eps)
        xn32 = ck._affine(xhat, t["gamma"], t["beta"])
        return (xhat, rstd, xn32) + rows(xn32)

    xhat_c, rstd_c, xnc32, xqc, sxc = ln("xc")
    xhat_k, rstd_k, xn32, xq, sx = ln("x")
    q = ck.gemm_sm90_s8_ref("s8_bf16", xqc, w8t[:hhd], sxc, sw[:hhd],
                            t["bqkv"][:hhd])
    kv = ck.gemm_sm90_s8_ref("s8_bf16", xq, w8t[hhd:], sx, sw[hhd:],
                             t["bqkv"][hhd:])
    qh, k, v = ck._rect_heads(q.view(b, cpq, -1), kv.view(b, spq, -1),
                              heads)
    o = k13_core_f32(qh, k, v, seq_len).to(BF)  # the bf16 recompute
    attn = ck._heads_to_rows(o)
    doq, sdo = rows(do2.float())
    dattn = ck.gemm_sm90_s8_ref("s8_bf16", doq, wo8r, sdo, swor)

    def fold(a, s, codes, m, group):
        if not int8_dw:
            return ck.gemm_sm90_ref("tn_f32", a.to(BF), m)
        if int4:
            return group_fold_cols(a, m, group)
        return group_fold(a, s, codes, group)

    dwo = fold(attn, sdo, doq, do2, group_c)
    dbo = do2.float().sum(dim=0)
    d_o = ck._split_heads(dattn.view(b, cpq, -1), heads)
    dqh, dk, dv = k13_core_grads(qh, k, v, o, d_o, seq_len)
    dq = ck._heads_to_rows(dqh)
    dkv = torch.cat([ck._heads_to_rows(dk), ck._heads_to_rows(dv)], dim=1)
    dqq, sdq = rows(dq.float())
    dxnc = ck.gemm_sm90_s8_ref("s8_f32", dqq, wq8r, sdq, swqr)
    dkvq, sdkv = rows(dkv.float())
    dxn = ck.gemm_sm90_s8_ref("s8_f32", dkvq, wkv8r, sdkv, swkvr)
    dwq = fold(xnc32, sdq, dqq, dq, group_c)
    dwkv = fold(xn32, sdkv, dkvq, dkv, group_k)
    dxc, dg, dbe = ck._ln_bwd_tail(dxnc, xhat_c, rstd_c, t["gamma"])
    dx, dg2, dbe2 = ck._ln_bwd_tail(dxn, xhat_k, rstd_k, t["gamma"])
    return (dxc.to(BF).view(t["xc"].shape), dx.to(BF).view(t["x"].shape),
            dg + dg2, dbe + dbe2, torch.cat([dwq, dwkv], dim=1),
            torch.cat([dq.float().sum(dim=0), dkv.float().sum(dim=0)]), dwo,
            dbo), dk, dv


def mlp_int8_bwd_composed(t, eps, int8_dw, group, residual, int4=False):
    """K4's backward (csrc/ln_mlp_int8_bwd.cu) in its launch order on
    t["x"], t["do"] [..., D] and the half's weights: the weights' codes, the
    LN-quant recompute from the bf16 xn, do's codes, the dual product
    (`s8_gelu_pair`: h1, dh1, dh1_32), db2, db1, dh1_32's codes, dW2 and dW1
    (`tn_f32`, or the group folds over `group` rows), dxn (`s8_f32`) and
    the LN tail, dx without `do +` when not `residual`. With `int4` K11-B's:
    every code of the recompute and the dx-path on the int4 grid, and under
    int8_dw the two-scale folds of the column packs of h1 | do and of the
    bf16 xn | dh1_32 (`group_fold_cols`) over the rows as given (the
    caller pads them to whole groups). Returns (dx, dγ, dβ, dW1, db1, dW2,
    db2)."""
    d = t["x"].shape[-1]
    rows, cols_host, rows_host = ck._quantizers(int4)
    x2, do2 = t["x"].reshape(-1, d), t["do"].reshape(-1, d)
    w1r, s1r = rows_host(t["w1"])
    w2r, s2r = rows_host(t["w2"])
    w1c, s1c = cols_host(t["w1"])  # stored [M, D]: its transpose
    xhat, rstd = ck._ln_stats(x2.float(), eps)
    xn = ck._affine(xhat, t["gamma"], t["beta"]).to(BF)
    xq, sx = rows(xn.float())
    doq, sdo = rows(do2.float())
    h1, dh1, dh1_32 = ck.gemm_sm90_s8_ref(
        "s8_gelu_pair", xq, w1c.t().contiguous(), sx, s1c, t["b1"], doq,
        w2r, sdo, s2r)
    db2, db1 = do2.float().sum(dim=0), dh1_32.sum(dim=0)
    dh1q, sd = rows(dh1_32)
    if int8_dw and int4:
        dw2 = group_fold_cols(h1, do2, group)
        dw1 = group_fold_cols(xn, dh1_32, group)
    elif int8_dw:
        dw2 = group_fold(h1, sdo, doq, group)
        dw1 = group_fold(xn, sd, dh1q, group)
    else:
        dw2 = ck.gemm_sm90_ref("tn_f32", h1, do2)
        dw1 = ck.gemm_sm90_ref("tn_f32", xn, dh1)
    dxn = ck.gemm_sm90_s8_ref("s8_f32", dh1q, w1r, sd, s1r)
    dxln, dg, dbe = ck._ln_bwd_tail(dxn, xhat, rstd, t["gamma"])
    dx = do2 + dxln.to(BF) if residual else dxln.to(BF)
    return dx.view(t["x"].shape), dg, dbe, dw1, db1, dw2, db2
