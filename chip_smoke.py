#!/usr/bin/env python3
"""Bring-up check of the vitax_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device  — needs torch.cuda; prints the card's name and power limit
             (nvidia-smi) and turns TF32 off for the plain versions;
2. build   — compiles vitax_torch/csrc/*.cu (one nvcc per source, in
             parallel) and loads the library;
3. kernels — each hand-written kernel against its plain PyTorch version on the
             card, in bf16: the forward kernels at the ViT-B/16 shapes of the
             serving path (batch 64 at spq 200, as eval_cli gives them), batch
             8 at spq 200 and 584, a ragged row count, train_cli's b32
             spq 200 (K1's, K2's, K3's and K4's forwards timed there too, a
             step's shape) and b8 at b16@416's spq 680 (past the first
             design's whole-row core); the backward kernels
             on every output at train_cli's b32 spq 200, b8 spq 200, the
             token-drop geometry (spq 104) and a ragged row count; max error
             against the stated tolerance, then median CUDA-event times of
             kernel and plain;
4. slice   — `vitax_torch.eval_cli` at b16@224 bf16 on Synthetic data with
             random weights from --seed, with the launch counters set to 0
             just before and read just after (each kernel must have run, per
             layer for K1/K2 and once per forward for LN); then the same run
             on the plain path (no kernel may launch); then one batch through
             vit.apply with kernels, plain bf16 and plain fp32, with the
             kernel-vs-plain logit difference held to a stated bf16 band;
5. train   — `vitax_torch.train_cli` at b16@224 batch 32 for 8 SGD steps and
             one eval epoch, counters set to 0 just before and read just after
             (exact counts: per step 12 K1 and 12 K2 forward and backward, one
             LN forward and backward; the eval epoch's forwards), every loss
             finite; the same run on the plain path (no kernel may launch);
             the grads of every parameter for one batch on the kernel, plain
             bf16 and plain fp32 paths (kernel vs plain bf16 per tensor within
             a stated relative band; the key biases, whose exact grad is 0,
             within that band of their layer's query-bias grad); then a
             device-timed train step (forward, backward, SGD on a resident
             batch) with kernels and plain;
6. int8    — the W8A8 tiers: `train_cli --int8-grad` (b16@224, b32, 8 steps
             and one eval epoch; exact counts: per step 12 launches of each
             int8 forward and backward kernel and none of K1/K2's, the eval
             epoch's int8 forwards), `train_cli --int8` (int8 forwards with
             K1/K2's bf16 backwards) and `eval_cli --int8` at b64, counters
             set to 0 just before each run and read just after; logits and
             the grads of every parameter for one batch on the int8 kernel
             path, the int8 twin path (the same autograd Functions with the
             int8 wrappers swapped for their plain twins) and the bf16
             kernel path; the `--int8-dw` grads on the kernel and twin
             paths; the s8 products of each run (K3's and K4's forwards,
             the `--int8-grad` run's backwards), counted by kind, exact, and
             no gemm.cuh s8 product or whole-row core; a b8 `--int8`
             forward at 416 px through vit.apply (vitax's K1 gate takes seq
             677, and so does the port's: exact K3 and K4 launches, logits
             against the int8 twin path); then device-timed train
             steps (bf16, `--int8-grad`, `--int8-dw`, in turns, and the
             twin path);
7. fast     — vitax's fastest recipe (scripts/FT_CIFAR100_fast.sh:
             --int8-dw --token-keep 0.5 --token-keep-schedule 0.9, b768,
             dense tail b192): `train_cli --int8-dw --token-keep 0.5
             --token-keep-schedule 0.5` at b32 over a drop epoch (spq 104:
             12 launches a step of each K5 half and none of K3/K4's forward)
             and a dense epoch (spq 200: K3/K4 forward), int8_dw backwards in
             both, exact counts per epoch; `train_cli` with the recipe's own
             flags on 1536 images (9 drop epochs of 2 b768 steps, a dense
             one of 8 b192 steps; its b768 eval batches, 153600 rows, take
             K5 too), exact counts per epoch (and of the s8 products, the
             group folds of int8_dw and K5's products included, no
             first-design piece, in the b32 run); logits and
             full-width grads of the
             handoff + int8_dw path against its twin path; device-timed steps
             at b768 keep 0.5 and b192 dense, int8_dw and int8_grad in turns;
8. resvit  — Res-ViT serving (scripts/ft_resvit.sh's b16 Res-ViT: --use_lora
             True --lora_rank 48 --use_reslr True --block_size 4
             --dynamic_start_layer 1 --dynamic_reserve_initials 2
             --dynamic_active_target 0.4), the routers' final biases drawn at
             random first (the init's keep bias 5.0 routes every token
             active): `vitax_torch.resvit_eval_cli` on 256 Synthetic images at
             b64 dense and `--compact-capacity` 0.625 and 0.5, each in bf16
             and with `--int8`, `--compact-capacity 0.625 --n_kv_heads 4`,
             and on the plain path (`--no-pallas --no-fused-qkv`), counters
             set to 0 just before each run and read just after (exact counts
             per batch: K1 1 and K8 11 when compacted, K3 1 + K8-int8 11 +
             K4 12 with --int8, K7 12 with GQA; the LN kernel for the three
             routers, the final norm and, off the int8 tier, the twelve MLP
             halves; no first-design piece but in the GQA run); the routing
             maps of
             the kernel and plain paths, the share that agrees; whole-model
             logits with the kernel path's routing decisions replayed on the
             plain path, within the bf16 band; device-timed forwards at b64;
9. resvit-train — Res-ViT training through `vitax_torch.resvit_train_cli`
             with ft_resvit.sh's model and loss flags (λa 10, λd 1, AdamW
             lr 1e-4 wd 0.05, warmup-cosine), the routers' biases drawn as
             in phase 8, one epoch each on Synthetic data: (a) ft_resvit.sh's
             flags at b32 with --save-routing-viz; (b) --compact-capacity
             0.625 --compact-warmup 2; (c) ft_resvit_fast.sh's flags at b192
             (--int8-dw --compact-capacity 0.625 --compact-warmup 2
             --token-keep 0.5); (d) --int8-grad --compact-capacity 0.625;
             (e) --n_kv_heads 4 --compact-capacity 0.625; (f) the plain path.
             The launches of every train step and eval batch against counts
             derived from the layer roles (`_resvit_launches`: teacher and
             student forwards, the student's backwards); full-width grads of
             every trainable tensor for (a), (b), (c) and (e) against the plain
             bf16 path (GRAD_BAND) or the int8 twin path (INT8_GRAD_BAND),
             with the same Gumbel noise and kept tokens injected and the
             routing replayed; (b)'s, (c)'s and (d)'s s8 products by kind
             against their launches (`_s8_expect`) and no first-design
             piece (K8 in both tiers, K1, K2, K3 and K4 on their Hopper
             designs); device-timed
             train steps of (a)-(e) on a resident batch.

10. h14    — ViT-H/14 (32 layers, D 1280, 16 heads of 80, MLP 5120), whose
             attention half is K6 (vitax's K1 gate rejects d > 1024; K6's
             core is the online one of attention_core.cuh, one walk over
             64-key tiles) and whose MLP backward is K2's
             :1610 route (d > 1024): `vitax_torch.eval_cli --model-arch h14`
             at its default 384 px (spq 736), b32, 64 Synthetic images,
             counters set to 0 just before and read just after (exact: 32
             K6 and 32 K2 a forward, LN once, no K1), then the plain run;
             logits of one b32 batch at 384 and at 224, kernel vs plain bf16
             within LOGIT_BAND, and device-timed forwards; `train_cli
             --model-arch h14 --image-size 224` at b32 for 4 SGD steps and
             an eval epoch (exact per step: 32 K6 and K2 forward, 32 K6
             backward, 32 K2 backward on the :1610 route, one LN forward and
             backward), every loss finite; the grads of every parameter for
             one batch, kernel vs plain bf16 within GRAD_BAND; device-timed
             train steps, plain and kernels in turns.
11. k13    — `--no-fused-qkv` on K13 (the standalone attention core) and
             K7's int8 tier: K13 forward and every output of its backward
             against the twins at train_cli's b32 seq 197 (the einsums'
             [B, S, H, Hd] memory and vitax's [B, H, S, Hd]), eval_cli's
             b64 seq 577, b8 seq 730 hd 80, seq 1024 hd 128, hd 40 and 48,
             a ragged seq 21 and seq 65 (one key in the last tile); timed
             beside its twin and, in turns (kernel, library, library,
             kernel: events around back-to-back launches), beside
             scaled_dot_product_attention (forward at b64 seq 577 and b32
             seq 197, backward at b32 seq 197), with each time's share of
             its bound; a checksum of K6's forward and backward outputs on
             a seeded input (K6's bits must not move with K13's; the same
             line from `vitax_torch/scripts/turns.py` on another
             checkout); K7's int8 tier (forward,
             int8_grad, int8_dw) at b64 spq 200 with 4 kv heads against its
             twins as phase 3 holds K3, timed, the backwards on K3's s8
             products and no first-design piece; then six paths with exact
             launch counts a batch or step: `eval_cli --no-fused-qkv` at
             384 px (b64) and `train_cli --no-fused-qkv` at 224 b32 (logits
             and grads against the plain path), `resvit_eval_cli
             --no-fused-qkv` dense and `--compact-capacity 0.625` (the
             apply_compact route), `resvit_train_cli --no-fused-qkv` b32,
             `resvit_eval_cli --int8 --n_kv_heads 4` dense and 0.625,
             `resvit_train_cli --int8-grad --n_kv_heads 4` and
             ft_resvit_fast.sh's flags with `--n_kv_heads 4` at b32 (logits
             with the routing replayed, grads with the noise and routing
             replayed, against the plain path or the int8 twin path; the
             two training runs' s8 products by kind, and first-design
             pieces only from K7's int8 forward), and device-timed forwards
             and steps.
12. save-acts — `--save-acts` (K12, the save pair of the MLP half): its
             bf16 and int8 kernels (the int8 backward with int8_dw off and
             on) against their twins on every output at train_cli's b32 spq
             200 and b8 on ragged rows (8 x 197), the int8 pair also at the
             drop phase's b32 spq 104 and by its codes, INT8_REL and the
             bf16 stand-in as phase 3 holds K4; each save forward's out the
             same bits as K2's or K4's; CUDA-event times beside K2's and
             K4's forwards and backwards; `train_cli --save-acts`,
             `--int8-grad --save-acts` and the fast recipe's flags with
             `--save-acts` at b32 (exact launches per epoch: the save pair in
             every step, K2's or K4's forward in the eval batches, no K5);
             full-width grads of the three tiers' save paths against the
             plain path and the int8 twin path; resident ViT-B/16 b32 steps
             with and without `--save-acts` (bf16, `--int8-grad`,
             `--int8-dw`, in turns); `resvit_train_cli` with ft_resvit.sh's
             flags `--fused-mlp --save-acts`, (h) `--int8-grad --n_kv_heads 4
             --save-acts` and ft_resvit_fast.sh's flags with `--save-acts`
             at b32 (exact launches per step and eval batch: the student's
             MLP halves through K12, the teacher's through K2 or K4); the
             Res-ViT b32 steps (a) and (h) with and without it, and their
             grads against the plain and int8 twin paths;
13. int4    — the A4W4 tiers (K11): the MLP half's forward and backward and
             the attention half's forward and int4_grad backward, each
             backward with and without int8_dw, against their twins at
             train_cli's b32 spq 200, the drop phase's b32 spq 104 and a
             ragged case: the weights' codes the same bits, each int4
             activation code tensor within 1e-3 of its codes moved by one
             step, every output within ‖k − t‖/‖t‖ <= 2e-2, and the bf16
             kernel on the same inputs at least 3x farther from the twin;
             timed beside their int8 counterparts (K3, K4) in turns;
             `train_cli` with each int4 flag set (`--int4` and `--int4-attn
             --int4-grad --int8-dw` for 8 steps, `--int4-attn --int4-grad
             --int8-grad`, `--int4-attn --int4-grad`, `--int4-grad` and
             `--int4-attn` for 2), exact launches per step and eval batch
             as vitax's dispatch picks them; logits and the grads of every
             parameter on the int4 kernel path against the int4 twin path;
             the 12 layers one by one (each block of the twin path fed the
             kernel path's input to it: its contribution and grads held to
             the int8 bands); resident b32 steps of the bf16, `--int8-dw`,
             `--int4-attn --int8-dw` and `--int4-attn --int4-grad
             --int8-dw` tiers.
14. resvit-int4 — Res-ViT's int4: R-F (the rect half's A4W4 forward, b64
             spq 200 cpq 128), R-B and R-B dw (its int4_grad backward, b32),
             G-F (K11-C with 4 kv heads, b64) and G-B with and without
             int8_dw (b32) against their twins (codes, ‖k − t‖/‖t‖ <=
             INT4_REL, the bf16 stand-in outside it, two launches the same
             bits), timed beside K8's and K7's int8 kernels in turns;
             `resvit_train_cli` with `--int4`, `--int4-attn`, `--int4-attn
             --int4-grad --int8-grad` and `--int4-attn --int4-grad
             --int8-dw`, each at `--compact-capacity 0.625` and with
             `--n_kv_heads 4` (2 steps of b32 and an eval epoch; vitax's
             warning printed; exact launches a step and eval batch as
             vitax's dispatch picks them); `--int4-attn --int4-grad
             --int8-dw` at C 0.625 against its int4 twin path with the
             noise injected and the routing replayed: one routed layer end
             to end (logits, grads of every trainable tensor) and the
             12-layer model layer by layer (each block fed the kernel
             path's input and keep bits); resident b32 steps of (d)
             `--int8-grad` C 0.625 and (e) with 4 kv heads, each beside
             its `--int4-attn --int4-grad` tier; `eval_cli --model-arch
             l16 --image-size 384` (vitax's K1 gate rejects it: 24 K6 a
             forward, no K1) and its `--int8`, which raises Queue 1 item
             8's message.
15. k10    — K10 (`fused_qkv_attention`, the QKV projection and the core
             without LN or out-projection), which vitax's Res-ViT `attention`
             runs with fused_qkv and not fused_qkvo (a config built in code:
             the CLIs tie the two), since its redesign the first launches
             of K1's Hopper sequence: its forward at b64 spq 200 and every
             output of its backward at b32 spq 200 against the twins (TOL),
             timed beside them, both also at B/16 @416's spq 680 and at
             head dim 80 (d 640, 8 heads), two backward launches the same
             bits, no first-design piece in K10's launches, its forward
             against K9's with Wo = I and bo = 0 to the bit; the b16
             Res-ViT of ft_resvit.sh's flags with fused_qkvo off through
             make_eval_step at b64, dense and at C 0.625, bf16 and --int8
             (exact launches a forward: 12 K10, the LN kernel before each;
             int8_attn does not reach K10, as in vitax; no first-design
             piece), logits with the routing replayed within LOGIT_BAND of
             the plain path (the K4 and K10 twin path for --int8) and the
             routing maps' agreement; two b32 train steps of (a) through
             make_train_step (exact launches a step: 12 + 11 K10 forwards,
             the teacher's included, 12 backwards; no first-design piece);
             the grads of every trainable tensor against the plain path
             (GRAD_BAND, the noise injected, the routing replayed); resident
             b64 forwards and b32 steps beside the K1 path (fused_qkvo on),
             in turns.
16. mesh   — K9 (`fused_qkvo_attention`: the QKV projection, the core
             and the out-projection of the LN'd input, K1's Hopper sequence
             without its LN), which vitax's Res-ViT runs under any mesh,
             and K2 without its residual (`fused_ln_mlp_partial`), the MLP
             half per model shard: K9's forward at b64 spq 200, its
             backward at b32 (every output, two launches the same bits),
             both on a ragged spq 40, at the TP shard width (6 heads: wqkv
             [768, 1152], wo [384, 768]), at B/16 @416's spq 680 and at
             head dim 80 (d 640, 8 heads), no first-design piece in K9's
             launches; K9 on LN(x) against K1 on x to the bit (out, dWqkv,
             dbqkv, dWo, dbo) at b32 and the TP shard width; K1 at that
             width, K2's partial pair at M 3072 and 1536, against their
             twins (TOL), timed beside K10, K1, K2 and, for K9, the library
             (`multi_head_attention_forward` and its autograd backward,
             its real rows within TOL of the twin); then (c0)
             `train_cli` (ViT-B/16 b32, 4 steps and 4 eval batches) in one
             process; this process's NCCL group of one rank and its (1, 1)
             mesh: (b) the b16 Res-ViT of ft_resvit.sh's flags through
             make_eval_step(mesh=) at b64 dense and C 0.625, bf16 and
             --int8 (exact launches: 12 K9 and the LN kernel a forward, no
             K1 or K8, no first-design piece; logits with the routing
             replayed within LOGIT_BAND
             of one process's K1 path; routing maps), two b32 train steps
             through make_train_step(mesh=) (exact launches, no
             first-design piece, three all-reduces a step), the grads of
             every trainable tensor against the plain path, and resident
             forwards and steps beside one process's in turns; (c)
             `train_cli --n-gpu 1`, whose losses are (c0)'s bit for bit and
             its launches (c0)'s; (d) two
             spawned processes, each a gloo rank on the card, through
             `train_cli --n-gpu 2 --n-model 2` (exact per-shard launches:
             12 K1 and 12 K2 partials a forward; each step's loss within
             LOGIT_BAND of (c0)'s), within a timeout.
17. tp tiers — the residual=False branches of the int8, int4 and
             save-acts MLP halves (K4, K11-A/B, K12; vitax's tensor-parallel
             MLP half runs them per model shard) and of K2's wide backward:
             (a) each against its twin (bf16 TOL; int8 and int4 by codes,
             INT8_REL or INT4_REL and a bf16 stand-in that must miss) and
             against its residual kernel, exactly (out = bf16(x + partial),
             dx = bf16(do + dx_partial), every other output the same bits)
             at b32 spq 200, M 3072 and the shard's 1536, the wide one at
             h14's D 1280 on a shard's M 2560, timed in turns with the
             residual kernel; K12's partial pair through its one caller,
             `fused_ln_mlp(save_acts=True, residual=False)`, exact
             launches; (b) two spawned processes, each a gloo rank on the
             card: one full-width ViT-B/16 layer per flag set (--int8,
             --int8-grad, --int8-dw, --int4, --int4-attn --int4-grad with
             --int8-grad and with --int8-dw, --int8-grad --save-acts) per
             shard, its output and every grad against the twin path per
             shard (phase 13's layer bands: LOGIT_BAND for the layer's
             contribution, INT8_GRAD_BAND for the grads) and one
             process's layer
             (per-shard scales: INT8_GRAD_BAND, or twice the tier's own
             distance from the bf16 layer where larger), exact launches; (c)
             `train_cli --n-gpu 2 --n-model 2` with each flag set, ViT-H/14
             at b8 (the plain attention on the gathered weights, K13; the
             wide partial backward) and --no-fused-qkv, exact per-shard
             launches, losses within LOGIT_BAND (int4: QUANT_LOGIT_BAND) of
             one process's run of the same flags.

Phase 3 also holds K6 forward (b32 spq 736 and 264, a ragged spq 40), its
backward on every output (b32 and b8 spq 264, spq 40; two launches the
same bits) and K2's backward at D 1280, MLP 5120 (32 x 264 rows, 3 x 257)
against their twins; K6's online core alone, its forward and its backward
row pass (head outputs, m, 1/l, dd), against its plain version at head_dim
64, 80 and 128 (b32 spq 736 and 264, spq 40), timed; and K6 against K1 at
ViT-B/16's b32 spq 200, forward and backward, within TOL, both timed in
turns.

Phase 3 also holds the Res-ViT kernels against their twins: K7 (GQA in
K1, 4 and 6 kv heads) at b64 spq 200; K8 (the rect attention half, bf16
and int8) at b64 spq 200 with cpq 128 and 104, on a ragged case and at
ft_resvit_fast.sh's b192 cpq 64 of spq 104, and against the square kernel
(K1, K3) followed by the row gather, whose largest difference it prints
and holds to 0 in both tiers (each runs its square kernel's launches, K1's
or K3's, on K8's two row sets, each per row, K13's core in its rect
geometry); and their
backwards on every output: K8's three (bf16, int8_grad, int8_dw; the int8
ones by codes, INT8_REL and the bf16 stand-in too) at b32 spq 200 cpq 128,
on a ragged case and at b192 cpq 64 of spq 104, K8's bf16 one also against
K1's backward on all rows
with do scattered to the kept rows plus the gather transpose (the bf16
tolerance: K1 sums a kept row's two dxn paths in fp32 before one LN
backward); K7's at b32 spq 200 with 4 kv heads, two launches the same bits.

Phase 3 also holds the int8 kernels (K3, K4, forward and backward, their
int8_dw backwards and K5's two halves) against their twins: forward at b64
spq 200, b8 spq 200, b8 spq 584, the ragged rows and the drop phase's b32
spq 104; backward at b32 spq 200, b8 spq 200, spq 104 (b16 and b32), b8 spq
584 and the ragged rows (int8_dw at b32 spq 200, b32 spq 104 and the ragged
rows); K5 at b32 spq 104, b8 spq 200, a ragged batch (b3 spq 104) and
b16@416's spq 680, the attention half packing its own input (the first
block) and taking a pack, its output held by the half's own contribution
(out − in), its qkv the twin's bits from its own codes, and the MLP half's
r2 and h1q the twin's bits from the same packed input. Besides the bf16
tolerance, each int8 kernel's codes, read back from its scratch, are held
to the twin's (the weights' the same bits,
each activation code tensor within its CODE_BAND of moved codes), and each
output's relative distance to the twin to INT8_REL; a bf16 stand-in (the
twin with every quantizer replaced by a rounding to bf16, as a kernel that
skipped quantization would compute) must land outside INT8_REL on every
output that quantization reaches, so the band is shown to tell the two
apart in every run. The int8_dw backwards must also land within INT8_REL
where the int8_grad kernel's bf16 weight grads land outside it (dW, dWo,
dW1, dW2), so the band shows that their weight grads are int8. K4's
forward, with and without the residual, must give the twin's bits from the
kernel's own LN codes at every case: the weights' codes, h1q and its row
scales, and out (`fused_ln_mlp_int8_from_codes_ref`).

K3's forward and backward (kv_heads == heads), K4's, K5's two halves,
K8's int8 forward and backward and, at L = 7, K11-C, K11-D, G-F and G-B
run their int8 products on gemm_sm90.cuh's s8 wgmma path and K3's, K5's,
K8's and K11's cores on K13's (the forwards with an fp32 out, the grads on
K13's passes; K8's in the rect geometry, G-F's and G-B's in the GQA one).
Phase 3 launches each
of those s8 products alone (`ck.gemm_sm90_s8`, the rows
`gemm_sm90_s8:<kind>` of the kernel table: s8_bf16, s8_f32, s8_gelu_pair,
s8_group, s8_gelu_q_f32, s8_residual, s8_residual_f32, s8_group_rc) at the b32 spq 200
shapes (s8_residual_f32: K5's fc2 at the drop phase's b32 spq 104) and on
ragged M, N and K (groups whose rows do not fill the 128-code K tile)
against exact int32 products dequantized by its twin: the twin's bits on
every output, two launches the same bits; timed beside the twin. The library counts
their launches by kind where `launch_s8` launches one
(`ck.s8_launch_counts`), and the launches of the first design's gemm.cuh
s8 and bf16 WMMA products and whole-row forward and backward cores
(`ck.first_design_launch_counts`); phases 6, 7, 8, 9, 13, 14 and 17 hold
the s8 counts of their runs exact (`_s8_expect`), 6, 7, 8 (but its GQA
run), 9's (b), (c), (d), 13's and 14's (but where K7's bf16 pair runs) the
first-design ones too (none, but what R-F, K7's int8 forward and K11-A
launch); phases 13 and 14 read the first-design pieces around each call of
K11-B, K11-C, K11-D, G-F, G-B and R-B (none), and phase 16 around K9's
launches and in (b)'s mesh runs (none).

The line before the last is the JSON kernel table (each kernel's time at
the main path's shape beside its bound: the larger of its bytes over 3.35
TB/s and its operations over 989 TFLOP/s bf16, 1979 TOP/s s8, 67 TFLOP/s
fp32; and the time of F.layer_norm, forward and backward, for LN). The LN
pair's `ms` and `library_ms` are device times from torch.profiler's kernel
records over four copies of the inputs in turn (a call of 10-30 µs timed by
events around one synchronised call reads mostly the host); the other
kernels' are CUDA-event medians. The last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time

# kernel -> (C++ source, TPU kernel it replaces)
KERNEL_INFO = {
    "layer_norm": ("vitax_torch/csrc/layernorm.cu",
                   "vitax/ops/pallas_kernels.py:267"),
    "fused_ln_qkvo_attention": ("vitax_torch/csrc/ln_qkvo_attention.cu",
                                "vitax/ops/pallas_kernels.py:2640"),
    "fused_ln_mlp": ("vitax_torch/csrc/ln_mlp.cu",
                     "vitax/ops/pallas_kernels.py:587"),
    "layer_norm_bwd": ("vitax_torch/csrc/layernorm_bwd.cu",
                       "vitax/ops/pallas_kernels.py:278"),
    "fused_ln_qkvo_attention_bwd": ("vitax_torch/csrc/ln_qkvo_attention_bwd.cu",
                                    "vitax/ops/pallas_kernels.py:2898"),
    "fused_ln_mlp_bwd": ("vitax_torch/csrc/ln_mlp_bwd.cu",
                         "vitax/ops/pallas_kernels.py:1308"),
    "fused_ln_qkvo_attention_int8": ("vitax_torch/csrc/ln_qkvo_attention_int8.cu",
                                     "vitax/ops/pallas_kernels.py:2690"),
    "fused_ln_mlp_int8": ("vitax_torch/csrc/ln_mlp_int8.cu",
                          "vitax/ops/pallas_kernels.py:683"),
    "fused_ln_qkvo_attention_int8_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:2977"),
    "fused_ln_mlp_int8_bwd": ("vitax_torch/csrc/ln_mlp_int8_bwd.cu",
                              "vitax/ops/pallas_kernels.py:1122"),
    # K5 and the int8_dw branches of K3's and K4's backwards
    "fused_ln_qkvo_attention_int8_ho": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_ho.cu",
        "vitax/ops/pallas_kernels.py:3669"),
    "fused_ln_mlp_int8_ho": ("vitax_torch/csrc/ln_mlp_int8_ho.cu",
                             "vitax/ops/pallas_kernels.py:3732"),
    "fused_ln_qkvo_attention_int8_dw_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:3041"),
    "fused_ln_mlp_int8_dw_bwd": ("vitax_torch/csrc/ln_mlp_int8_bwd.cu",
                                 "vitax/ops/pallas_kernels.py:1173"),
    # Res-ViT serving: K7 (the kv_heads branch of K1's kernel) and K8
    "fused_ln_qkvo_attention_gqa": ("vitax_torch/csrc/ln_qkvo_attention.cu",
                                    "vitax/ops/pallas_kernels.py:2803"),
    "fused_ln_qkvo_attention_rect": (
        "vitax_torch/csrc/ln_qkvo_attention_rect.cu",
        "vitax/ops/pallas_kernels.py:4033"),
    "fused_ln_qkvo_attention_rect_int8": (
        "vitax_torch/csrc/ln_qkvo_attention_rect_int8.cu",
        "vitax/ops/pallas_kernels.py:4067"),
    # Res-ViT training: K8's backward (bf16, int8_grad, int8_dw) and K7's
    # (the kv_heads branch of K1's backward)
    "fused_ln_qkvo_attention_rect_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_rect_bwd.cu",
        "vitax/ops/pallas_kernels.py:4155"),
    "fused_ln_qkvo_attention_rect_int8_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_rect_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:4253"),
    "fused_ln_qkvo_attention_rect_int8_dw_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_rect_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:4253"),
    "fused_ln_qkvo_attention_gqa_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_bwd.cu",
        "vitax/ops/pallas_kernels.py:2846"),
    # ViT-H/14: K6 (the KV-chunked attention half) forward and backward, and
    # K2's backward at d > 1024 (the :1610 route)
    "fused_ln_qkvo_attention_flash": (
        "vitax_torch/csrc/ln_qkvo_attention_flash.cu",
        "vitax/ops/pallas_kernels.py:3419"),
    "fused_ln_qkvo_attention_flash_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_flash_bwd.cu",
        "vitax/ops/pallas_kernels.py:3446"),
    "fused_ln_mlp_bwd_wide": ("vitax_torch/csrc/ln_mlp_bwd.cu",
                              "vitax/ops/pallas_kernels.py:1527"),
    # --no-fused-qkv: K13, the standalone attention core, forward and
    # backward; and K7's int8 tier (the kv_heads branches of K3's kernels)
    "flash_attention": ("vitax_torch/csrc/attention_core.cu",
                        "vitax/ops/pallas_kernels.py:83"),
    "flash_attention_bwd": ("vitax_torch/csrc/attention_core_bwd.cu",
                            "vitax/ops/pallas_kernels.py:112"),
    "fused_ln_qkvo_attention_int8_gqa": (
        "vitax_torch/csrc/ln_qkvo_attention_int8.cu",
        "vitax/ops/pallas_kernels.py:2690"),
    "fused_ln_qkvo_attention_int8_gqa_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:2977"),
    "fused_ln_qkvo_attention_int8_gqa_dw_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:3041"),
    # --save-acts: K12, the save pair of the MLP half, bf16 and int8 (the
    # int8 backward's int8_dw branch counted apart)
    "fused_ln_mlp_save": ("vitax_torch/csrc/ln_mlp_save.cu",
                          "vitax/ops/pallas_kernels.py:620"),
    "fused_ln_mlp_bwd_fast": ("vitax_torch/csrc/ln_mlp_save.cu",
                              "vitax/ops/pallas_kernels.py:1245"),
    "fused_ln_mlp_int8_save": ("vitax_torch/csrc/ln_mlp_int8_save.cu",
                               "vitax/ops/pallas_kernels.py:732"),
    "fused_ln_mlp_int8_save_bwd": ("vitax_torch/csrc/ln_mlp_int8_save.cu",
                                   "vitax/ops/pallas_kernels.py:778"),
    "fused_ln_mlp_int8_save_dw_bwd": ("vitax_torch/csrc/ln_mlp_int8_save.cu",
                                      "vitax/ops/pallas_kernels.py:816"),
    # int4 (K11): the int8 sources' L = 7 instantiations (the backwards'
    # int8_dw branches counted apart)
    "fused_ln_mlp_int4": ("vitax_torch/csrc/ln_mlp_int8.cu",
                          "vitax/ops/pallas_kernels.py:961"),
    "fused_ln_mlp_int4_bwd": ("vitax_torch/csrc/ln_mlp_int8_bwd.cu",
                              "vitax/ops/pallas_kernels.py:1003"),
    "fused_ln_mlp_int4_dw_bwd": ("vitax_torch/csrc/ln_mlp_int8_bwd.cu",
                                 "vitax/ops/pallas_kernels.py:1057"),
    "fused_ln_qkvo_attention_int4": (
        "vitax_torch/csrc/ln_qkvo_attention_int8.cu",
        "vitax/ops/pallas_kernels.py:2745"),
    "fused_ln_qkvo_attention_int4_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:2998"),
    "fused_ln_qkvo_attention_int4_dw_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:3033"),
    # Res-ViT's int4: the rect int8 sources' L = 7 instantiations (R-F, R-B,
    # R-B dw) and the kv_heads branches of K11-C and K11-D (G-F, G-B)
    "fused_ln_qkvo_attention_rect_int4": (
        "vitax_torch/csrc/ln_qkvo_attention_rect_int8.cu",
        "vitax/ops/pallas_kernels.py:4112"),
    "fused_ln_qkvo_attention_rect_int4_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_rect_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:4272"),
    "fused_ln_qkvo_attention_rect_int4_dw_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_rect_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:4310"),
    "fused_ln_qkvo_attention_int4_gqa": (
        "vitax_torch/csrc/ln_qkvo_attention_int8.cu",
        "vitax/ops/pallas_kernels.py:2803"),
    "fused_ln_qkvo_attention_int4_gqa_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:2998"),
    "fused_ln_qkvo_attention_int4_gqa_dw_bwd": (
        "vitax_torch/csrc/ln_qkvo_attention_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:3033"),
    # Res-ViT with fused_qkv and not fused_qkvo: K10, the QKV projection and
    # the core (no LN, no out-projection), forward and backward
    "fused_qkv_attention": ("vitax_torch/csrc/qkv_attention.cu",
                            "vitax/ops/pallas_kernels.py:2216"),
    "fused_qkv_attention_bwd": ("vitax_torch/csrc/qkv_attention_bwd.cu",
                                "vitax/ops/pallas_kernels.py:2239"),
    # Res-ViT under a mesh and per model shard: K9, the QKV projection, the
    # core and the out-projection (no LN), forward and backward; and K2's
    # residual=False branch, the MLP half per model shard
    "fused_qkvo_attention": ("vitax_torch/csrc/qkvo_attention.cu",
                             "vitax/ops/pallas_kernels.py:2396"),
    "fused_qkvo_attention_bwd": ("vitax_torch/csrc/qkvo_attention_bwd.cu",
                                 "vitax/ops/pallas_kernels.py:2432"),
    "fused_ln_mlp_partial": ("vitax_torch/csrc/ln_mlp.cu",
                             "vitax/ops/pallas_kernels.py:614"),
    "fused_ln_mlp_partial_bwd": ("vitax_torch/csrc/ln_mlp_bwd.cu",
                                 "vitax/ops/pallas_kernels.py:1308"),
    # the residual=False branches of K4, K11-A/B and K12 (the int8, int4
    # and save-acts MLP halves per model shard) and of K2's wide backward
    "fused_ln_mlp_int8_partial": ("vitax_torch/csrc/ln_mlp_int8.cu",
                                  "vitax/ops/pallas_kernels.py:718"),
    "fused_ln_mlp_int8_partial_bwd": ("vitax_torch/csrc/ln_mlp_int8_bwd.cu",
                                      "vitax/ops/pallas_kernels.py:1219"),
    "fused_ln_mlp_int8_partial_dw_bwd": (
        "vitax_torch/csrc/ln_mlp_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:1219"),
    "fused_ln_mlp_int4_partial": ("vitax_torch/csrc/ln_mlp_int8.cu",
                                  "vitax/ops/pallas_kernels.py:997"),
    "fused_ln_mlp_int4_partial_bwd": ("vitax_torch/csrc/ln_mlp_int8_bwd.cu",
                                      "vitax/ops/pallas_kernels.py:1096"),
    "fused_ln_mlp_int4_partial_dw_bwd": (
        "vitax_torch/csrc/ln_mlp_int8_bwd.cu",
        "vitax/ops/pallas_kernels.py:1096"),
    "fused_ln_mlp_save_partial": ("vitax_torch/csrc/ln_mlp_save.cu",
                                  "vitax/ops/pallas_kernels.py:653"),
    "fused_ln_mlp_bwd_fast_partial": ("vitax_torch/csrc/ln_mlp_save.cu",
                                      "vitax/ops/pallas_kernels.py:1281"),
    "fused_ln_mlp_int8_save_partial": ("vitax_torch/csrc/ln_mlp_int8_save.cu",
                                       "vitax/ops/pallas_kernels.py:772"),
    "fused_ln_mlp_int8_save_partial_bwd": (
        "vitax_torch/csrc/ln_mlp_int8_save.cu",
        "vitax/ops/pallas_kernels.py:862"),
    "fused_ln_mlp_int8_save_partial_dw_bwd": (
        "vitax_torch/csrc/ln_mlp_int8_save.cu",
        "vitax/ops/pallas_kernels.py:862"),
    "fused_ln_mlp_bwd_wide_partial": ("vitax_torch/csrc/ln_mlp_bwd.cu",
                                      "vitax/ops/pallas_kernels.py:1589"),
}
SAVE_KERNELS = ("fused_ln_mlp_save", "fused_ln_mlp_bwd_fast",
                "fused_ln_mlp_int8_save", "fused_ln_mlp_int8_save_bwd",
                "fused_ln_mlp_int8_save_dw_bwd")
SAVE_KERNELS_INT8 = SAVE_KERNELS[2:]
K13_KERNELS = ("flash_attention", "flash_attention_bwd")
INT8_GQA_KERNELS = ("fused_ln_qkvo_attention_int8_gqa",
                    "fused_ln_qkvo_attention_int8_gqa_bwd",
                    "fused_ln_qkvo_attention_int8_gqa_dw_bwd")
H14_KERNELS = ("fused_ln_qkvo_attention_flash",
               "fused_ln_qkvo_attention_flash_bwd", "fused_ln_mlp_bwd_wide")
RESVIT_KERNELS = ("fused_ln_qkvo_attention_gqa",
                  "fused_ln_qkvo_attention_rect",
                  "fused_ln_qkvo_attention_rect_int8")
RECT_BWD_KERNELS = ("fused_ln_qkvo_attention_rect_bwd",
                    "fused_ln_qkvo_attention_rect_int8_bwd",
                    "fused_ln_qkvo_attention_rect_int8_dw_bwd")
TRAIN_RESVIT_KERNELS = RECT_BWD_KERNELS + ("fused_ln_qkvo_attention_gqa_bwd",)
DW_KERNELS = ("fused_ln_qkvo_attention_int8_dw_bwd",
              "fused_ln_mlp_int8_dw_bwd")
# gemm_sm90.cuh's s8 products inside K3's (kv_heads == heads) and K4's
# int8 forwards and backwards, K5's halves, K8's int8 tier and the int4
# backwards (s8_group_rc: their int4_grad int8_dw fold), counted by kind
# where the library launches them (`ck.s8_launch_counts`): their source
# and the TPU kernels whose bodies hold the product (s8_bf16, s8_f32,
# s8_gelu_pair, s8_group, s8_gelu_q_f32, s8_residual_f32 and s8_group_rc
# run in several)
S8_INFO = {f"gemm_sm90_s8:{kind}": ("vitax_torch/csrc/gemm_sm90.cuh",
                                    f"vitax/ops/pallas_kernels.py:{lines}")
           for kind, lines in (("s8_bf16",
                                "3163, :3252, :1758, :3784 and :4534"),
                               ("s8_f32", "3252, :1820, :1914 and :4534"),
                               ("s8_gelu_pair", "1820 and :1914"),
                               ("s8_group", "3252 and :1820"),
                               ("s8_gelu_q_f32", "1758 and :3817"),
                               ("s8_residual", "1758"),
                               ("s8_residual_f32", "3784 and :3817"),
                               ("s8_group_rc", "3252, :1914 and :4534"))}
HO_KERNELS = ("fused_ln_qkvo_attention_int8_ho", "fused_ln_mlp_int8_ho")
BWD_KERNELS = ("layer_norm_bwd", "fused_ln_qkvo_attention_bwd",
               "fused_ln_mlp_bwd", "fused_ln_qkvo_attention_int8_bwd",
               "fused_ln_mlp_int8_bwd") + DW_KERNELS
INT8_KERNELS = ("fused_ln_qkvo_attention_int8", "fused_ln_mlp_int8",
                "fused_ln_qkvo_attention_int8_bwd", "fused_ln_mlp_int8_bwd"
                ) + HO_KERNELS + DW_KERNELS

B16 = D, HEADS, HEAD_DIM, MLP = 768, 12, 64, 3072      # ViT-B/16
H14 = 1280, 16, 80, 5120  # ViT-H/14: D, heads, head_dim, MLP; 32 layers
EPS = 1e-5
# kernel vs plain: |k - ref| <= TOL * max(1, max|ref|). bf16 keeps 8 bits
# (ulp 2^-8 relative); both sides round at the same points, so what is left
# is one-ulp flips from sums taken in another order.
TOL = 2e-2
# whole-model logits, kernel path vs plain bf16 path: 12 layers of such
# flips in the residual stream, then the final LN and the head.
LOGIT_BAND = 5e-2
EVAL_ARGS = ["--model-arch", "b16", "--image-size", "224",
             "--dataset", "Synthetic", "--synthetic-samples", "256",
             "--batch-size", "64", "--num-classes", "10", "--seed", "0"]
PLAIN_FLAGS = ["--no-pallas", "--no-fused-qkv", "--no-fused-mlp"]

# (label, batch, rows per image, seq_len); the first is the serving path's
CASES = [("b64 spq200 (eval_cli)", 64, 200, 197),
         ("b8 spq200", 8, 200, 197),
         ("b8 spq584", 8, 584, 577),
         ("ragged", 3, 200, 197),
         ("b32 spq104 (keep 0.5)", 32, 104, 99),
         ("b32 spq200 (train_cli)", 32, 200, 197),
         ("b8 spq680 (b16@416)", 8, 680, 677)]
DROP_CASE = "b32 spq104 (keep 0.5)"  # the fast recipe's drop phase at b32
# K1's, K2's, K3's and K4's forwards are also timed at train_cli's b32, a
# step's shape
STEP_CASE, STEP_TIMED = ("b32 spq200 (train_cli)",
                         ("fused_ln_qkvo_attention", "fused_ln_mlp",
                          "fused_ln_qkvo_attention_int8", "fused_ln_mlp_int8"))
# backward: the first is train_cli's (timed); keep 0.5 drops 196 patch tokens
# to 98 (+ cls = 99, spq 104); "ragged" cuts LN's and K2's rows to 3 x 197
BWD_CASES = [("b32 spq200 (train_cli)", 32, 200, 197),
             ("b8 spq200", 8, 200, 197),
             ("b16 spq104 (keep 0.5)", 16, 104, 99),
             ("b8 spq584", 8, 584, 577),
             ("ragged", 3, 200, 197),
             ("b32 spq104 (keep 0.5)", 32, 104, 99)]
# the int8_dw backwards run at train_cli's dense and drop-phase b32 and on
# the ragged rows (K4: groups 128, 128, 128, 128, 79)
DW_CASES = ("b32 spq200 (train_cli)", "b32 spq104 (keep 0.5)", "ragged")
# the halves that take a ragged row count (LN and the MLP's); the attention
# halves take the padded stream only
RAGGED_OK = ("layer_norm", "fused_ln_mlp", "fused_ln_mlp_int8",
             "layer_norm_bwd", "fused_ln_mlp_bwd", "fused_ln_mlp_int8_bwd",
             "fused_ln_mlp_int8_dw_bwd")
TRAIN_ARGS = ["--model-arch", "b16", "--image-size", "224",
              "--dataset", "Synthetic", "--synthetic-samples", "256",
              "--batch-size", "32", "--lr", "0.03", "--wd", "0",
              "--warmup-steps", "2", "--train-steps", "8", "--num-classes",
              "10", "--seed", "0"]
TRAIN_STEPS, TRAIN_BATCH = 8, 32
# per-tensor grads, kernel path vs plain bf16 path: ‖g_k − g_p‖ / ‖g_p‖. Both
# round at the same points; one-ulp flips in 12 layers of forward and
# backward leave a few % of relative distance in the smallest grads.
GRAD_BAND = 5e-2
# int8 kernel path vs int8 twin path: the same rounding points and the same
# quantization grid; logits are held to the bf16 pair's band. Besides the
# bf16 flips above, a value on a .5 tie quantizes one step apart (a share of
# ~1e-6 of the activation codes, card test), and one moved code in a row of
# xq moves the keys and values of a whole image, so the smallest grads (the
# last layers' query/key kernels, 4.4e-2 already for the bf16 pair) move
# further: 6.8e-2 measured on the card, held to 1e-1. int8 vs bf16 kernel
# paths: the W8A8 quantization itself (8-bit codes of every projection's
# operands, ~0.4 % rms a product, over 12 layers forward and the dx-path
# backward). These model-level bands show that the int8 path runs and stays
# near its twin; they cannot tell a kernel that skipped quantization apart,
# since 12 layers amplify the moved codes to nearly the quantization's own
# distance: the twin path with _bf16_stand_in's quantizers lands at
# ‖Δlogits‖/‖t‖ 2.27e-2 and a median per-tensor grad distance of 2.06e-2,
# the int8 kernel path at 1.66e-2 and 1.25e-2 (on the card). Phase 3 tells
# them apart, kernel by kernel.
INT8_GRAD_BAND = 1e-1
QUANT_LOGIT_BAND = 0.25
QUANT_GRAD_BAND = 0.25
# int8 kernel vs int8 twin, per output: ‖k − t‖ / ‖t‖ <= INT8_REL. Measured
# on the card: at most 2.0e-3 (K3 backward's dx at spq 584), where the bf16
# stand-in lands at 1.08e-2 or more (the W8A8 quantization noise); the band
# sits between the two, 2.5x above the one and 2.2x below the other.
INT8_REL = 5e-3
# codes moved from the twin's: (largest step, share) per activation code
# tensor. xq quantizes the LN output, which the kernel and the twin compute
# to the last ulp or two, so a code moves one step, and only on a .5 tie:
# <= 2.2e-6 measured, except K4 backward's xq, which quantizes the bf16-
# rounded LN output: where the rounding of a row's max flips, the row's
# scale moves by 2^-8 and ~15 % of its codes with it (3.2e-5 at b8 spq 584,
# one row; a row of the ragged case's 591 is 2.5e-4). h1q and dh1q quantize
# GELU values of a1 the same way (<= 3e-5), but where an xq code moved, its
# row's a1 and row max move with it, and a code two steps. aq quantizes sums
# with cancellation (p·v over the keys), whose last bits depend on the order
# of the sum, up to 1.4e-3; dqq the core's dqkv, which is rounded to bf16, so
# a flipped last bit of a value and of its row's max can move a code two
# steps: 1.6e-3 measured (on the card). doq quantizes the bf16 input do: the
# same bits. A kernel that skipped quantization would move most codes.
# int8_dw's column codes quantize a folded operand per column over a group:
# h1c (h1·sdo) and xnc (K4's bf16 xn·sdh, K3's fp32 xn·sdq) move like h1q
# and xq (<= 1.8e-4 measured, one step), atc (K3's bf16 attn recompute ·
# sdo) like aq (3.6e-4). K5's packed outputs quantize LN of the bf16 r1/r2
# the kernel computed: xq2 moves where an aq code moved r1 by one bf16 ulp
# (1.8e-3 at most with the first block's pack, K13's core), xqn, given the
# twin's r1, only where LN's sums in another order cross a .5 tie (<= 9.6e-7;
# phase 3 at b32 spq 104, b8 spq 200, ragged b3 and spq 680).
CODE_BAND = {"xq": (1, 1e-3), "h1q": (2, 1e-3), "dh1q": (2, 1e-3),
             "aq": (2, 5e-3), "dqq": (2, 5e-3), "doq": (0, 0.0),
             "h1c": (2, 1e-3), "xnc": (2, 1e-3), "atc": (2, 5e-3),
             "xq2": (2, 5e-3), "xqn": (1, 1e-3), "xqk": (1, 1e-3),
             "dkvq": (2, 5e-3), "xnk": (2, 5e-3), "gpq": (1, 1e-3),
             "doc": (2, 1e-3)}
# K8's int8 backward (card test, b32 spq 200 cpq 128): dkvq quantizes the
# core's bf16 dK/dV rows as dqq the dq rows (7.1e-4 measured); xnk folds the
# fp32 LN output of x's rows with those rows' scales sdkv, which move where a
# row's largest dK/dV value flipped a bf16 bit, so its share follows dkvq's,
# not xnc's (1.37e-3 measured). K12-int8: gpq quantizes GELU'(a1) on a
# static grid, so it moves only where a1 does (an xq code moved) or on a .5
# tie; doc, the column codes of sh·do (sh the forward's row scales, do the
# same bf16 input), like h1c


def _s8_expect(counts):
    """The s8 products of gemm_sm90.cuh that the wrappers' launches in
    `counts` imply: K3's forward (kv_heads == heads) two s8_bf16 (qkv, out);
    K4's one s8_gelu_q_f32 (fc1) and one s8_residual (fc2), its
    residual=False branch s8_bf16 in place of the latter; K3's and K7's
    backwards two s8_bf16 and one s8_f32, K4's (either branch) one
    s8_gelu_pair and one s8_f32, and under int8_dw two s8_group more in
    each; K5's attention half
    one s8_bf16 (qkv) and one s8_residual_f32, its MLP half one
    s8_gelu_q_f32 and one s8_residual_f32; K8's int8 forward three s8_bf16
    (q, kv, out), its backward three s8_bf16 (q, kv, dattn) and two s8_f32
    (dxnc, dxn), and under int8_dw three s8_group more; K11-C's and G-F's
    forwards two s8_bf16, K11-D's and G-B's backwards two s8_bf16 and one
    s8_f32, and under int8_dw two s8_group_rc more; K11-B's (either
    branch) K4's, one s8_gelu_pair and one s8_f32, and under int8_dw two
    s8_group_rc more; R-B's K8's, three s8_bf16 and two s8_f32, and under
    int8_dw three s8_group_rc more. No other wrapper launches one."""
    def c(*names):
        return sum(counts.get(n, 0) for n in names)
    k3f = c("fused_ln_qkvo_attention_int8")
    k3b = c("fused_ln_qkvo_attention_int8_bwd",
            "fused_ln_qkvo_attention_int8_dw_bwd",
            "fused_ln_qkvo_attention_int8_gqa_bwd",
            "fused_ln_qkvo_attention_int8_gqa_dw_bwd")
    k4f, k4p = c("fused_ln_mlp_int8"), c("fused_ln_mlp_int8_partial")
    k4b = c("fused_ln_mlp_int8_bwd", "fused_ln_mlp_int8_dw_bwd",
            "fused_ln_mlp_int8_partial_bwd", "fused_ln_mlp_int8_partial_dw_bwd")
    dw = c("fused_ln_qkvo_attention_int8_dw_bwd",
           "fused_ln_qkvo_attention_int8_gqa_dw_bwd",
           "fused_ln_mlp_int8_dw_bwd", "fused_ln_mlp_int8_partial_dw_bwd")
    k5a, k5m = (c("fused_ln_qkvo_attention_int8_ho"),
                c("fused_ln_mlp_int8_ho"))
    k8f = c("fused_ln_qkvo_attention_rect_int8")
    k8b = c("fused_ln_qkvo_attention_rect_int8_bwd",
            "fused_ln_qkvo_attention_rect_int8_dw_bwd")
    k8dw = c("fused_ln_qkvo_attention_rect_int8_dw_bwd")
    k11f = c("fused_ln_qkvo_attention_int4", "fused_ln_qkvo_attention_int4_gqa")
    k11b = c("fused_ln_qkvo_attention_int4_bwd",
             "fused_ln_qkvo_attention_int4_dw_bwd",
             "fused_ln_qkvo_attention_int4_gqa_bwd",
             "fused_ln_qkvo_attention_int4_gqa_dw_bwd")
    k11dw = c("fused_ln_qkvo_attention_int4_dw_bwd",
              "fused_ln_qkvo_attention_int4_gqa_dw_bwd")
    k11bb = c("fused_ln_mlp_int4_bwd", "fused_ln_mlp_int4_dw_bwd",
              "fused_ln_mlp_int4_partial_bwd",
              "fused_ln_mlp_int4_partial_dw_bwd")
    k11bdw = c("fused_ln_mlp_int4_dw_bwd", "fused_ln_mlp_int4_partial_dw_bwd")
    rb = c("fused_ln_qkvo_attention_rect_int4_bwd",
           "fused_ln_qkvo_attention_rect_int4_dw_bwd")
    rbdw = c("fused_ln_qkvo_attention_rect_int4_dw_bwd")
    return {"gemm_sm90_s8:s8_bf16": (2 * k3f + 2 * k3b + k4p + k5a
                                     + 3 * k8f + 3 * k8b + 2 * k11f
                                     + 2 * k11b + 3 * rb),
            "gemm_sm90_s8:s8_f32": (k3b + k4b + 2 * k8b + k11b + k11bb
                                    + 2 * rb),
            "gemm_sm90_s8:s8_gelu_pair": k4b + k11bb,
            "gemm_sm90_s8:s8_group": 2 * dw + 3 * k8dw,
            "gemm_sm90_s8:s8_gelu_q_f32": k4f + k4p + k5m,
            "gemm_sm90_s8:s8_residual": k4f,
            "gemm_sm90_s8:s8_residual_f32": k5a + k5m,
            "gemm_sm90_s8:s8_group_rc": 2 * k11dw + 2 * k11bdw + 3 * rbdw}


def _check_s8(label, counts, first_design=False):
    """The s8 products that the library counted in a run, against what its
    wrappers' launches imply, and with `first_design` the first-design
    pieces (`ck.first_design_launch_counts`), of which a ViT run of LN, K1,
    K2, K3, K4 (forwards and backwards), K5 and K13, a Res-ViT int8 run of
    those, K8's int8 tier and K7's int8 backwards, and an int4 run's
    backwards (K11-B, K11-D, G-B, R-B) launch none; K7's int8 forward two
    gemm.cuh s8 products and one whole-row core each, R-F three and one,
    K11-A (either branch) two s8 products; returns the s8 counts."""
    from vitax_torch.ops import cuda_kernels as ck
    s8 = ck.s8_launch_counts()
    fd = ck.first_design_launch_counts() if first_design else {}
    k7f = counts.get("fused_ln_qkvo_attention_int8_gqa", 0)
    rf = counts.get("fused_ln_qkvo_attention_rect_int4", 0)
    k11a = (counts.get("fused_ln_mlp_int4", 0)
            + counts.get("fused_ln_mlp_int4_partial", 0))
    expect = {**_s8_expect(counts), **dict.fromkeys(fd, 0)}
    if first_design:
        expect.update({"gemm.cuh:s8": 2 * k7f + 3 * rf + 2 * k11a,
                       "attention.cuh:core": k7f + rf})
    print(f"  {label}: s8 products {_nonzero(s8)}"
          + (f", first-design pieces {fd}" if first_design else ""),
          flush=True)
    if {**s8, **fd} != expect:
        raise AssertionError(f"{label}: expected {expect}")
    return s8


def _expect(**launches):
    """Every kernel's expected launch count: the given ones, else 0."""
    return {**dict.fromkeys(KERNEL_INFO, 0), **launches}


def _median_ms(fn, warmup=3, iters=25):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(batch, rows, seed, dims=None):
    """bf16 activations and weights scaled to the model's width, made on the
    card; `dims` (D, heads, head_dim, MLP), ViT-B/16's by default."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32
    D, HEADS, HEAD_DIM, MLP = dims or B16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    hhd = HEADS * HEAD_DIM
    return dict(
        x=rnd(batch, rows, D),
        gamma=1.0 + rnd(D, scale=0.1, dtype=f32),
        beta=rnd(D, scale=0.1, dtype=f32),
        wqkv=rnd(D, 3 * hhd, scale=D ** -0.5),
        bqkv=rnd(3 * hhd, scale=0.02, dtype=f32),
        wo=rnd(hhd, D, scale=hhd ** -0.5),
        bo=rnd(D, scale=0.02, dtype=f32),
        w1=rnd(D, MLP, scale=D ** -0.5),
        b1=rnd(MLP, scale=0.02, dtype=f32),
        w2=rnd(MLP, D, scale=MLP ** -0.5),
        b2=rnd(D, scale=0.02, dtype=f32),
    )


def _calls(ck, t, seq_len):
    """kernel name -> (kernel call, plain call) on inputs t."""
    ln = (t["x"], t["gamma"], t["beta"], EPS)
    qkvo = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"],
            t["bo"], EPS, seq_len, HEADS, HEAD_DIM)
    mlp = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"],
           EPS)
    args = {"layer_norm": ln, "fused_ln_qkvo_attention": qkvo,
            "fused_ln_mlp": mlp, "fused_ln_qkvo_attention_int8": qkvo,
            "fused_ln_mlp_int8": mlp}
    return {name: (lambda f=getattr(ck, name), a=a: f(*a),
                   lambda f=getattr(ck, name + "_ref"), a=a: f(*a), a)
            for name, a in args.items()}


def check_kernels():
    """Phase 3: every kernel against its plain version; returns per-kernel
    {max_abs_err, ms, plain_ms} (times at the serving-path case)."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    stats = {name: {"max_abs_err": 0.0} for name in KERNEL_INFO}
    for i, (label, batch, rows, seq_len) in enumerate(CASES):
        t = _inputs(batch, rows, seed=i)
        for name, (kern, plain, args) in _calls(ck, t, seq_len).items():
            if label == "ragged" and name in RAGGED_OK:
                # rows not a multiple of 8 per image: 3*197 = 591 rows
                t_r = dict(t, x=t["x"][:, :seq_len].contiguous())
                kern, plain, args = _calls(ck, t_r, seq_len)[name]
            with torch.inference_mode():
                out = kern()
                torch.cuda.synchronize()
                ref = plain()
                if name in INT8_KERNELS:
                    _check_int8(ck, name, label, args, (out,), (ref,), stats)
                if name == "fused_ln_mlp_int8":
                    _check_k4_bits(ck, label, args)
            err = (out.float() - ref.float()).abs().max().item()
            bound = TOL * max(1.0, ref.float().abs().max().item())
            finite = bool(torch.isfinite(out).all())
            print(f"  {name:28s} {label:22s} {tuple(out.shape)} "
                  f"max|k-ref| {err:.3e} <= {bound:.3e}: "
                  f"{'ok' if err <= bound and finite else 'FAIL'}", flush=True)
            if not (finite and err <= bound):
                raise AssertionError(f"{name} {label}: max error {err} "
                                     f"exceeds {bound} (finite={finite})")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            if (i <= 2 or label == DROP_CASE and name in INT8_KERNELS
                    or label == STEP_CASE and name in STEP_TIMED):
                with torch.inference_mode():
                    k_ms, p_ms = _median_ms(kern), _median_ms(plain)
                print(f"  {name:28s} {label:22s} kernel {k_ms:.4f} ms  "
                      f"plain {p_ms:.4f} ms (median of 25)", flush=True)
                if i == 0:
                    stats[name].update(ms=k_ms, plain_ms=p_ms,
                                       shape=(batch, rows))
                if label == DROP_CASE:  # K3 + K4 against K5 at b32 spq 104
                    stats[name]["drop_ms"] = k_ms
                if label == STEP_CASE:
                    stats[name]["step_ms"] = k_ms
            if i == 0 and name == "layer_norm":
                stats[name].update(_layer_norm_device_ms(*args))
        del t
        torch.cuda.empty_cache()
    for name in STEP_TIMED:
        print(f"  {name:28s} kernel {stats[name]['ms']:.4f} ms at b64 spq200, "
              f"{stats[name]['step_ms']:.4f} ms at b32 spq200", flush=True)
    return stats


def _layer_norm_device_ms(x, gamma, beta, eps):
    """{ms, library_ms}: device times (torch.profiler's kernel records,
    `turns.device_ms`) of the LN kernel and of one PyTorch call that
    computes the row LN, F.layer_norm (γ, β cast to the input's dtype
    beforehand), each over four copies of x in turn so that no call finds
    its input in L2."""
    import torch
    import torch.nn.functional as F
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.scripts.turns import device_ms
    xs = [x] + [x.clone() for _ in range(3)]
    g, b = gamma.to(x.dtype), beta.to(x.dtype)
    with torch.inference_mode():
        ms = device_ms([lambda x=x: ck.layer_norm(x, gamma, beta, eps)
                        for x in xs])
        lib = device_ms([lambda x=x: F.layer_norm(x, (x.shape[-1],), g, b, eps)
                         for x in xs])
    print(f"  layer_norm device time {ms:.4f} ms, F.layer_norm {lib:.4f} ms "
          f"(torch.profiler)", flush=True)
    return {"ms": ms, "library_ms": lib}


def _layer_norm_bwd_device_ms(x, gamma, dy, eps):
    """{ms, library_ms}: device times of the LN backward kernel and of the
    LN backward as PyTorch's autograd of F.layer_norm computes it (one
    torch.autograd.grad call for dx, dγ, dβ), over four copies of the
    inputs in turn, as _layer_norm_device_ms."""
    import torch
    import torch.nn.functional as F
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.scripts.turns import device_ms
    sets = [(x, dy)] + [(x.clone(), dy.clone()) for _ in range(3)]
    with torch.no_grad():
        ms = device_ms([lambda x=x, dy=dy: ck.layer_norm_bwd(x, gamma, dy, eps)
                        for x, dy in sets])
    grads = []
    for xs, dys in sets:
        xr = xs.detach().requires_grad_()
        g = gamma.to(x.dtype).requires_grad_()
        b = torch.zeros_like(g).requires_grad_()
        y = F.layer_norm(xr, (x.shape[-1],), g, b, eps)
        grads.append(lambda y=y, xr=xr, g=g, b=b, dy=dys: torch.autograd.grad(
            y, (xr, g, b), dy, retain_graph=True))
    lib = device_ms(grads)
    print(f"  layer_norm_bwd device time {ms:.4f} ms, autograd of "
          f"F.layer_norm {lib:.4f} ms (torch.profiler)", flush=True)
    return {"ms": ms, "library_ms": lib}


def _bwd_calls(ck, t, seq_len, ragged):
    """backward kernel name -> (kernel call, plain call) on inputs t."""
    x, do = t["x"], t["do"]
    if ragged:  # rows not a multiple of 8 per image: LN, K2 and K4 only
        x, do = x[:, :seq_len].contiguous(), do[:, :seq_len].contiguous()
    qkvo = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"],
            t["do"], EPS, seq_len, HEADS, HEAD_DIM)
    mlp = (x, t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], do, EPS)
    args = {
        "layer_norm_bwd": (x, t["gamma"], do, EPS),
        "fused_ln_qkvo_attention_bwd": qkvo,
        "fused_ln_mlp_bwd": mlp,
        "fused_ln_qkvo_attention_int8_bwd": qkvo,
        "fused_ln_mlp_int8_bwd": mlp,
        "fused_ln_qkvo_attention_int8_dw_bwd": qkvo,
        "fused_ln_mlp_int8_dw_bwd": mlp,
    }
    return {name: (lambda f=getattr(ck, name), a=a: f(*a),
                   lambda f=getattr(ck, name + "_ref"), a=a: f(*a), a)
            for name, a in args.items()}


def check_bwd_kernels(stats):
    """Phase 3, backward: every output of each backward kernel against its
    plain twin; times at every case, the first (train_cli's) recorded."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in BWD_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, batch, rows, seq_len) in enumerate(BWD_CASES):
        t = _inputs(batch, rows, seed=10 + i)
        g = torch.Generator(device="cuda").manual_seed(20 + i)
        t["do"] = torch.randn(t["x"].shape, generator=g,
                              device="cuda").to(torch.bfloat16)
        calls = _bwd_calls(ck, t, seq_len, label == "ragged")
        for name, (kern, plain, args) in calls.items():
            if name in DW_KERNELS and label not in DW_CASES:
                continue
            with torch.no_grad():
                outs = kern()
                torch.cuda.synchronize()
                refs = plain()
                if name in INT8_KERNELS:
                    _check_int8(ck, name, label, args, outs, refs, stats)
            errs = []
            for out, ref in zip(outs, refs):
                err = (out.float() - ref.float()).abs().max().item()
                bound = TOL * max(1.0, ref.float().abs().max().item())
                finite = bool(torch.isfinite(out).all())
                if not (finite and err <= bound and out.shape == ref.shape
                        and out.dtype == ref.dtype):
                    raise AssertionError(
                        f"{name} {label} output {len(errs)}: max error {err} "
                        f"exceeds {bound} (finite={finite}, "
                        f"{tuple(out.shape)} {out.dtype} vs "
                        f"{tuple(ref.shape)} {ref.dtype})")
                errs.append(f"{err:.2e}<={bound:.2e}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 err)
            del outs, refs
            with torch.no_grad():
                k_ms = _median_ms(kern, warmup=2, iters=10)
                p_ms = _median_ms(plain, warmup=1, iters=5)
            print(f"  {name:32s} {label:22s} max|k-ref| per output "
                  f"[{' '.join(errs)}]: ok; kernel {k_ms:.4f} ms  plain "
                  f"{p_ms:.4f} ms (medians of 10 / 5)", flush=True)
            if i == 0:
                stats[name].update(ms=k_ms, plain_ms=p_ms,
                                   shape=(batch, rows))
            if i == 0 and name == "layer_norm_bwd":
                stats[name].update(_layer_norm_bwd_device_ms(*args))
        del t, calls
        torch.cuda.empty_cache()
    return stats


def _s8_work(kind, m, n, k, extra):
    """(bytes, {"s8": operations}) of one s8 product: its codes and scales
    read once, its outputs written once. A group fold counts its real rows
    only, 25/32 of each group's (`ck.gemm_sm90_s8_inputs`): the pad rows
    are zeros that the kernel multiplies and the function does not need."""
    if kind in ("s8_group", "s8_group_rc"):
        groups, rows = k // extra, extra * 25 // 32
        scales = m + (n if kind == "s8_group_rc" else 0)
        return (m + n) * groups * rows + 4 * groups * scales + 4 * m * n, \
            {"s8": 2 * m * n * groups * rows}
    pairs = 2 if kind == "s8_gelu_pair" else 1
    # bytes an output element: the residual kinds read their bf16 residual too
    out = {"s8_bf16": 2, "s8_f32": 4, "s8_gelu_pair": 8, "s8_gelu_q_f32": 4,
           "s8_residual": 4, "s8_residual_f32": 4}[kind] * m * n
    return (pairs * ((m + n) * k + 4 * (m + n)) + 4 * n * bool(extra) + out,
            {"s8": pairs * 2 * m * n * k})


def check_s8_products(stats):
    """Phase 3, gemm_sm90.cuh's s8 path: each epilogue launched alone
    against exact integer products dequantized by its twin
    (`ck.GEMM_SM90_S8_CASES`): every output the twin's bits (the bias add
    fused as the twin's addcmul; K4's forward rests on it), two launches the
    same bits; the first case of each kind timed beside the twin."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for i, (kind, m, n, k, extra) in enumerate(ck.GEMM_SM90_S8_CASES):
        name = f"gemm_sm90_s8:{kind}"
        inputs = ck.gemm_sm90_s8_inputs(kind, m, n, k, extra,
                                        seed=60 + i)
        with torch.no_grad():
            outs = ck.gemm_sm90_s8(kind, **inputs)
            again = ck.gemm_sm90_s8(kind, **inputs)
            torch.cuda.synchronize()
            refs = ck.gemm_sm90_s8_ref(kind, **inputs)
        if kind != "s8_gelu_pair":
            outs, again, refs = (outs,), (again,), (refs,)
        rels, errs, same = [], [], []
        for out, out2, ref in zip(outs, again, refs):
            rels.append(_rel(out, ref))
            errs.append((out.float() - ref.float()).abs().max().item())
            same.append(torch.equal(out, ref))
            if not (torch.equal(out, out2) and out.shape == ref.shape
                    and out.dtype == ref.dtype
                    and bool(torch.isfinite(out.float()).all())):
                raise AssertionError(f"{name} {m}x{n}x{k}: two launches "
                                     "differ, or shape, dtype or finiteness")
        if not all(same):
            raise AssertionError(f"{name} {m}x{n}x{k}: ‖k−t‖/‖t‖ {rels}, "
                                 f"the twin's bits {same}")
        st = stats.setdefault(name, {"max_abs_err": 0.0})
        st["max_abs_err"] = max(st["max_abs_err"], *errs)
        line = (f"  {name:26s} {m}x{n}x{k}{' bias' if extra is True else ''}"
                f" ‖k−t‖/‖t‖ [{' '.join(f'{r:.2e}' for r in rels)}], the "
                f"twin's bits {same}, two launches the same bits")
        if "ms" not in st:
            with torch.no_grad():
                k_ms = _median_ms(lambda: ck.gemm_sm90_s8(kind, **inputs),
                                  warmup=3, iters=25)
                p_ms = _median_ms(lambda: ck.gemm_sm90_s8_ref(kind, **inputs),
                                  warmup=1, iters=5)
            st.update(ms=k_ms, plain_ms=p_ms, shape=(m, n, k),
                      work=_s8_work(kind, m, n, k, extra))
            line += f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
        print(line, flush=True)
        del inputs, outs, again, refs
    return stats


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def _bf16_stand_in(ck):
    """The int8 (and int4) twins as a kernel that skipped quantization would
    compute them: every quantizer the twins call returns its input rounded to
    bf16
    with a scale of 1, so each s8 product becomes a product of bf16 values
    (exact in fp64), and the rest of each twin is unchanged."""
    import torch
    names = ("quant_rows", "quant_cols", "quant_cols_host", "quant_rows_host",
             "quant_rows4", "quant_cols_host4", "quant_rows_host4")
    saved = {n: getattr(ck, n) for n in names}

    def bf(x):
        return x.float().to(torch.bfloat16).float()

    ck.quant_rows = ck.quant_rows4 = lambda x: (bf(x),
                                                torch.ones_like(x[..., :1]))
    ck.quant_cols = lambda x: (bf(x), torch.ones_like(x[:1]))
    ck.quant_cols_host = ck.quant_cols_host4 = lambda w: (
        bf(w), torch.ones_like(bf(w)[0]))
    ck.quant_rows_host = ck.quant_rows_host4 = lambda w: (
        bf(w), torch.ones_like(bf(w)[:, 0]))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ck, n, f)


def _code_moves(kern, twin):
    """An int8 kernel's codes (its scratch) against its twin's: the
    weights' codes and scales must be the same bits; for each activation
    code tensor, (largest step, share of codes moved)."""
    import torch
    moves = {}
    for key, (q, s) in twin.items():
        qk, sk = kern[key]
        if key.startswith("w"):
            if not (torch.equal(qk, q) and torch.equal(sk, s)):
                raise AssertionError(f"weight codes {key} differ from the "
                                     "twin's")
            continue
        d = (qk.long() - q.long()).abs()
        moves[key] = (d.max().item(), d.float().mean().item())
    return moves


def _check_int8(ck, name, label, args, outs, refs, stats, band=None,
                rel=INT8_REL):
    """Phase 3, the int8 kernels beyond the bf16 tolerance: their codes
    against the twin's (within `band`, CODE_BAND by default); every output
    within `rel` (INT8_REL) of the twin, and the bf16 stand-in outside it
    wherever quantization reaches (every output but the backward's Σ do,
    which no quantizer touches)."""
    sk, st = {}, {}
    getattr(ck, name)(*args, scratch=sk)
    getattr(ck, name + "_ref")(*args, scratch=st)
    with _bf16_stand_in(ck):
        stand = getattr(ck, name + "_ref")(*args)
    if not isinstance(stand, tuple):
        stand = (stand,)
    moves = _code_moves(sk, st)
    r_k = [_rel(o, r) for o, r in zip(outs, refs)]
    r_s = [_rel(o, r) for o, r in zip(stand, refs)]
    # Σ do is reached by no quantizer, nor is the int8 save backward's bf16
    # dW2 = bf16(h1q)ᵀ·bf16(sh·do): its codes come saved from the forward
    skip = {len(r_s) - 1} if name.endswith("_bwd") else set()
    if name == "fused_ln_mlp_int8_save_bwd":
        skip.add(5)
    reached = [r for i, r in enumerate(r_s) if i not in skip]
    # the stand-in against the bf16 tolerance alone: max error over bound
    tol_s = max((o.float() - r.float()).abs().max().item()
                / (TOL * max(1.0, r.float().abs().max().item()))
                for o, r in zip(stand, refs))
    print(f"  {name:32s} {label:22s} codes moved (max step, share) "
          + " ".join(f"{k} {m[0]} {m[1]:.2e}" for k, m in moves.items())
          + f"; ‖k−t‖/‖t‖ per output [{' '.join(f'{r:.2e}' for r in r_k)}]"
          f" <= {rel}; bf16 stand-in [{' '.join(f'{r:.2e}' for r in r_s)}]"
          f", its max error {tol_s:.2f}x the bf16 tolerance", flush=True)
    st_ = stats[name]
    st_["worst_rel"] = max(st_.get("worst_rel", 0.0), *r_k)
    st_["stand_in_min_rel"] = min(st_.get("stand_in_min_rel", 1.0), *reached)
    if name.endswith("_dw_bwd"):
        # the int8_grad kernel's bf16 weight grads against the int8_dw twin:
        # outside INT8_REL on dW and dWo (dW1 and dW2), or the dW is not int8
        plain_dw = getattr(ck, name.replace("_dw", ""))(*args)
        idx = (4, 6) if "rect" in name else (3, 5)
        r_bf = [_rel(plain_dw[i], refs[i]) for i in idx]
        print(f"  {name:32s} {label:22s} bf16-dW kernel (int8_grad) vs "
              f"int8_dw twin, dW and dWo/dW1 and dW2 [{r_bf[0]:.2e} "
              f"{r_bf[1]:.2e}] > {INT8_REL}; kernel vs twin "
              f"[{r_k[idx[0]]:.2e} {r_k[idx[1]]:.2e}]", flush=True)
        st_["bf16_dw_min_rel"] = min(st_.get("bf16_dw_min_rel", 1.0), *r_bf)
        if min(r_bf) <= INT8_REL:
            raise AssertionError(f"{name} {label}: the bf16 weight grads land "
                                 f"within INT8_REL of the int8 ones")
    for key, (top, share) in moves.items():
        max_step, max_share = (band or CODE_BAND)[key]
        if top > max_step or share > max_share:
            raise AssertionError(f"{name} {label}: codes {key} moved {share} "
                                 f"(largest step {top})")
    if max(r_k) > rel:
        raise AssertionError(f"{name} {label}: {max(r_k)} from the twin")
    if min(reached) <= rel:
        raise AssertionError(f"{name} {label}: the bf16 stand-in lands "
                             f"within {rel} ({min(reached)})")


def _check_k4_bits(ck, label, args):
    """Phase 3: K4's forward, with and without the residual, the twin's
    bits from the kernel's own LN codes (`fused_ln_mlp_int8_from_codes_ref`;
    the LN's codes are held to CODE_BAND by `_check_int8`): the weights'
    codes, h1q and its row scales, and out."""
    import torch
    for residual in (True, False):
        sk, st = {}, {}
        out = ck.fused_ln_mlp_int8(*args, residual=residual, scratch=sk)
        torch.cuda.synchronize()
        ref = ck.fused_ln_mlp_int8_from_codes_ref(
            args[0], *sk["xq"], *args[3:7], residual=residual, scratch=st)
        same = {k: all(map(torch.equal, sk[k], st[k]))
                for k in ("w1q", "w2q", "h1q")}
        same["out"] = torch.equal(out, ref)
        print(f"  fused_ln_mlp_int8 {label:22s} residual {residual}: the "
              f"twin's bits from the kernel's LN codes {same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"fused_ln_mlp_int8 {label} residual "
                                 f"{residual}: not the twin's bits {same}")


# K5 at the drop phase's b32 spq 104 (timed), at b8 spq 200, on a ragged
# batch and at b16@416's spq 680 (seq 677, past the whole-row core)
HO_CASES = [(DROP_CASE, 32, 104, 99), ("b8 spq200", 8, 200, 197),
            ("ragged b3 spq104", 3, 104, 99),
            ("b2 spq680 (b16@416)", 2, 680, 677)]


def _check_ho(ck, name, label, args, base, stats):
    """One K5 kernel against its twin: the stream out (r1 or r2) within the
    bf16 tolerance; the half's own contribution, out − in (the residual
    dominates the stream), within INT8_REL of the twin's, the bf16 stand-in
    outside it; every code it wrote, the packed output too, within its
    CODE_BAND (weights the same bits). The attention half's qkv must be the
    twin's bits from the kernel's own codes (`s8_bf16`'s dequant of xq·W8),
    the MLP half's r2 and h1q the twin's bits from the same packed input."""
    import torch
    sk, st = {}, {}
    with torch.no_grad():
        out_bf = getattr(ck, name)(*args, scratch=sk)[0]
        torch.cuda.synchronize()
        ref_bf = getattr(ck, name + "_ref")(*args, scratch=st)[0]
        with _bf16_stand_in(ck):
            stand = getattr(ck, name + "_ref")(*args)[0].float()
        if "qkv" in sk:  # the attention half
            (xq, sx), (w8, sw) = sk["xq"], sk["w8"]
            qkv_t = ck._dequant(ck.int_mm(xq, w8), sx.reshape(-1, 1), sw,
                                args[8]).to(torch.bfloat16)
            bits = {"qkv": torch.equal(sk["qkv"], qkv_t)}
        else:
            bits = {"r2": torch.equal(out_bf, ref_bf),
                    "h1q": all(map(torch.equal, sk["h1q"], st["h1q"]))}
    out, ref = out_bf.float(), ref_bf.float()
    base = base.float().reshape(ref.shape)
    err = (out - ref).abs().max().item()
    bound = TOL * max(1.0, ref.abs().max().item())
    r_k, r_s = _rel(out - base, ref - base), _rel(stand - base, ref - base)
    moves = _code_moves(sk, st)
    print(f"  {name:32s} {label:22s} max|k-ref| {err:.3e} <= {bound:.3e}; "
          f"‖Δk−Δt‖/‖Δt‖ {r_k:.2e} <= {INT8_REL}, bf16 stand-in {r_s:.2e}; "
          "codes moved (max step, share) "
          + " ".join(f"{k} {m[0]} {m[1]:.2e}" for k, m in moves.items())
          + f"; the twin's bits {bits}", flush=True)
    st_ = stats[name]
    st_["max_abs_err"] = max(st_["max_abs_err"], err)
    st_["worst_rel"] = max(st_.get("worst_rel", 0.0), r_k)
    st_["stand_in_min_rel"] = min(st_.get("stand_in_min_rel", 1.0), r_s)
    if not (torch.isfinite(out).all() and err <= bound):
        raise AssertionError(f"{name} {label}: max error {err} > {bound}")
    for key, (top, share) in moves.items():
        max_step, max_share = CODE_BAND[key]
        if top > max_step or share > max_share:
            raise AssertionError(f"{name} {label}: codes {key} moved {share} "
                                 f"(largest step {top})")
    if r_k > INT8_REL or r_s <= INT8_REL:
        raise AssertionError(f"{name} {label}: {r_k} from the twin, the "
                             f"stand-in {r_s}")
    if not all(bits.values()):
        raise AssertionError(f"{name} {label}: not the twin's bits {bits}")


def check_handoff_kernels(stats):
    """Phase 3, K5: the attention half packing its own input (the first
    block) and from the twin's pack, and the MLP half on the twin's
    attention outputs, each against its twin (`_check_ho`), on
    gemm_sm90.cuh's s8 path and K13's core only (the library's counts);
    times at the drop phase's b32 spq 104 (a later block's attention
    half)."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in HO_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, batch, rows, seq_len) in enumerate(HO_CASES):
        t = _inputs(batch, rows, seed=30 + i)
        g = torch.Generator(device="cuda").manual_seed(40 + i)
        ln2 = (1.0 + 0.1 * torch.randn(D, generator=g, device="cuda"),
               0.1 * torch.randn(D, generator=g, device="cuda"))
        ln1 = (t["gamma"], t["beta"])
        with torch.no_grad():
            xq, sx = ck.pack_rows(t["x"], *ln1, EPS)
        weights = (t["wqkv"], t["bqkv"], t["wo"], t["bo"], EPS, seq_len,
                   HEADS, HEAD_DIM)
        first = (t["x"], None, None, *ln1, *ln2, *weights)
        later = (t["x"], xq, sx, *ln1, *ln2, *weights)
        with torch.no_grad():
            r1, xq2, sx2 = ck.fused_ln_qkvo_attention_int8_ho_ref(*later)
        # the next block's LN1: this one's, as good as any
        mlp = (r1, xq2, sx2, *ln1, t["w1"], t["b1"], t["w2"], t["b2"], EPS)
        ck.s8_launch_counts(reset=True)
        ck.first_design_launch_counts(reset=True)
        for name, args, base in (
                ("fused_ln_qkvo_attention_int8_ho", first, t["x"]),
                ("fused_ln_qkvo_attention_int8_ho", later, t["x"]),
                ("fused_ln_mlp_int8_ho", mlp, r1)):
            _check_ho(ck, name, label, args, base, stats)
        _check_s8(f"K5 {label}", {"fused_ln_qkvo_attention_int8_ho": 2,
                                  "fused_ln_mlp_int8_ho": 1},
                  first_design=True)
        if label != DROP_CASE:
            continue
        # timed: a later block's attention half (11 of 12 blocks), whose
        # input comes packed
        for name, args in (("fused_ln_qkvo_attention_int8_ho", later),
                           ("fused_ln_mlp_int8_ho", mlp)):
            with torch.no_grad():
                k_ms = _median_ms(lambda f=getattr(ck, name): f(*args),
                                  warmup=2, iters=10)
                p_ms = _median_ms(lambda f=getattr(ck, name + "_ref"):
                                  f(*args), warmup=1, iters=5)
            print(f"  {name:32s} {label:22s} kernel {k_ms:.4f} ms  plain "
                  f"{p_ms:.4f} ms (medians of 10 / 5)", flush=True)
            stats[name].update(ms=k_ms, plain_ms=p_ms, shape=(batch, rows))
        del t
        torch.cuda.empty_cache()
    k5 = sum(stats[n]["ms"] for n in HO_KERNELS)
    k34 = sum(stats[n]["drop_ms"] for n in ("fused_ln_qkvo_attention_int8",
                                            "fused_ln_mlp_int8"))
    print(f"  K5 pair {k5:.4f} ms against K3 + K4 forward {k34:.4f} ms at "
          f"{DROP_CASE}", flush=True)
    return stats


# Res-ViT serving at b64 (spq 200, seq 197): K8 at capacity 0.625 (124 rows,
# cpq 128; the timed case) and 0.5 (99, cpq 104), a ragged case, and
# ft_resvit_fast.sh's drop geometry at its b192 (keep 0.5: 99 of spq 104;
# C 0.625: 62 rows, cpq 64); K7 at 4 (timed) and 6 kv heads
RECT_CASES = [("b64 cap124 cpq128 (C 0.625)", 64, 200, 197, 124),
              ("b64 cap99 cpq104 (C 0.5)", 64, 200, 197, 99),
              ("ragged b3 cap37", 3, 200, 197, 37),
              ("b192 cap62 cpq64 spq104 (fast)", 192, 104, 99, 62)]
GQA_CASES = [("b64 spq200 kv4", 64, 200, 197, 4),
             ("b64 spq200 kv6", 64, 200, 197, 6)]


def _rect_inputs(t, cap, seq_len, seed):
    """xc: `cap` of each image's first seq_len rows of t["x"], in random
    order, zero-padded to round_up(cap, 8) rows (compact_routed_block's
    form); and their indices."""
    import torch
    x = t["x"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.stack([torch.randperm(seq_len, generator=g, device="cuda")
                       [:cap] for _ in range(x.shape[0])])
    xc = torch.zeros((x.shape[0], (cap + 7) // 8 * 8, D), dtype=x.dtype,
                     device="cuda")
    xc[:, :cap] = torch.gather(x, 1, idx[..., None].expand(-1, -1, D))
    return xc, idx


def _hold(name, label, out, ref, stats):
    """A kernel's output against its twin's, within the bf16 tolerance."""
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    bound = TOL * max(1.0, ref.float().abs().max().item())
    finite = bool(torch.isfinite(out).all())
    if not (finite and err <= bound and out.shape == ref.shape):
        raise AssertionError(f"{name} {label}: max error {err} exceeds "
                             f"{bound} (finite={finite})")
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    return err, bound


def check_resvit_kernels(stats):
    """Phase 3, Res-ViT: K8 (bf16, int8) against its twin and against the
    square kernel + row gather, to the bit on the kept rows in both tiers
    (each runs its square kernel's launches, K1's or K3's, each per row, on
    the two row sets), K8 int8 also by its codes and INT8_REL; K7 against
    its twin; times at the serving path's shapes."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in RESVIT_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, batch, rows, seq_len, cap) in enumerate(RECT_CASES):
        t = _inputs(batch, rows, seed=50 + i)
        xc, idx = _rect_inputs(t, cap, seq_len, seed=60 + i)
        args = (xc, t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                t["wo"], t["bo"], EPS, seq_len, HEADS, HEAD_DIM)
        for name, square in (("fused_ln_qkvo_attention_rect",
                              ck.fused_ln_qkvo_attention),
                             ("fused_ln_qkvo_attention_rect_int8",
                              ck.fused_ln_qkvo_attention_int8)):
            kern = lambda f=getattr(ck, name): f(*args)
            plain = lambda f=getattr(ck, name + "_ref"): f(*args)
            with torch.inference_mode():
                out = kern()
                torch.cuda.synchronize()
                ref = plain()
                err, bound = _hold(name, label, out, ref, stats)
                full = square(*args[1:])
                gathered = torch.gather(full, 1,
                                        idx[..., None].expand(-1, -1, D))
                sq = (out[:, :cap].float() - gathered.float()).abs().max()
                sq = sq.item()
                if "int8" in name:
                    _check_int8(ck, name, label, args, (out,), (ref,), stats)
            print(f"  {name:32s} {label:28s} {tuple(out.shape)} max|k-ref| "
                  f"{err:.3e} <= {bound:.3e}; max|rect - square+gather| "
                  f"{sq:.3e}", flush=True)
            stats[name]["square_gather_max_diff"] = max(
                stats[name].get("square_gather_max_diff", 0.0), sq)
            if sq > 0.0:
                raise AssertionError(f"{name} {label}: {sq} from the square "
                                     "kernel + gather")
            if i == 0:
                with torch.inference_mode():
                    k_ms = _median_ms(kern)
                    p_ms = _median_ms(plain, warmup=1, iters=5)
                    s_ms = _median_ms(lambda: square(*args[1:]))
                print(f"  {name:32s} {label:28s} kernel {k_ms:.4f} ms  plain "
                      f"{p_ms:.4f} ms  square kernel on all rows {s_ms:.4f}"
                      " ms (medians of 25 / 5 / 25)", flush=True)
                stats[name].update(ms=k_ms, plain_ms=p_ms, square_ms=s_ms,
                                   shape=(batch, rows, xc.shape[1]))
        del t, xc
        torch.cuda.empty_cache()
    name = "fused_ln_qkvo_attention_gqa"
    for i, (label, batch, rows, seq_len, hkv) in enumerate(GQA_CASES):
        t = _inputs(batch, rows, seed=70 + i)
        g = torch.Generator(device="cuda").manual_seed(80 + i)
        width = (HEADS + 2 * hkv) * HEAD_DIM
        wqkv = (torch.randn((D, width), generator=g, device="cuda")
                * D ** -0.5).to(torch.bfloat16)
        bqkv = 0.02 * torch.randn(width, generator=g, device="cuda")
        args = (t["x"], t["gamma"], t["beta"], wqkv, bqkv, t["wo"], t["bo"],
                EPS, seq_len, HEADS, HEAD_DIM, hkv)
        kern = lambda: ck.fused_ln_qkvo_attention_gqa(*args)
        plain = lambda: ck.fused_ln_qkvo_attention_gqa_ref(*args)
        with torch.inference_mode():
            out = kern()
            torch.cuda.synchronize()
            err, bound = _hold(name, label, out, plain(), stats)
        print(f"  {name:32s} {label:28s} {tuple(out.shape)} max|k-ref| "
              f"{err:.3e} <= {bound:.3e}", flush=True)
        if i == 0:
            with torch.inference_mode():
                k_ms = _median_ms(kern)
                p_ms = _median_ms(plain, warmup=1, iters=5)
            print(f"  {name:32s} {label:28s} kernel {k_ms:.4f} ms  plain "
                  f"{p_ms:.4f} ms (medians of 25 / 5)", flush=True)
            stats[name].update(ms=k_ms, plain_ms=p_ms,
                               shape=(batch, rows, hkv))
        del t
        torch.cuda.empty_cache()
    print(f"  K8 at {RECT_CASES[0][0]}: bf16 "
          f"{stats['fused_ln_qkvo_attention_rect']['ms']:.4f} ms against the "
          f"square K1 on all rows "
          f"{stats['fused_ln_qkvo_attention_rect']['square_ms']:.4f} ms; int8 "
          f"{stats['fused_ln_qkvo_attention_rect_int8']['ms']:.4f} ms against"
          f" K3 {stats['fused_ln_qkvo_attention_rect_int8']['square_ms']:.4f}"
          " ms", flush=True)
    return stats


# Res-ViT training at b32 (spq 200, seq 197): K8's backwards at capacity
# 0.625 (124 rows, cpq 128; timed), a ragged case and ft_resvit_fast.sh's
# b192 drop geometry (cpq 64 of spq 104); K7's at 4 kv heads
RECT_BWD_CASES = [("b32 cap124 cpq128 (C 0.625)", 32, 200, 197, 124),
                  ("ragged b3 cap37", 3, 200, 197, 37),
                  ("b192 cap62 cpq64 spq104 (fast)", 192, 104, 99, 62)]
GQA_BWD_CASES = [("b32 spq200 kv4", 32, 200, 197, 4)]


def _hold_all(name, label, outs, refs, stats):
    """Every output of a backward kernel against its twin's (`_hold`)."""
    if len(outs) != len(refs):
        raise AssertionError(f"{name} {label}: {len(outs)} outputs")
    return [f"{e:.2e}<={b:.2e}" for e, b in
            (_hold(name, label, o, r, stats) for o, r in zip(outs, refs))]


def check_resvit_bwd_kernels(stats):
    """Phase 3, Res-ViT training: K8's three backwards against their twins on
    every output (the int8 ones also by codes, INT8_REL and the bf16
    stand-in), K8's bf16 backward against K1's backward on all rows with do
    scattered to the kept rows plus the gather transpose; K7's backward
    against its twin; times at b32 spq 200 (cpq 128, 4 kv heads)."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in TRAIN_RESVIT_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, batch, rows, seq_len, cap) in enumerate(RECT_BWD_CASES):
        t = _inputs(batch, rows, seed=90 + i)
        xc, idx = _rect_inputs(t, cap, seq_len, seed=100 + i)
        g = torch.Generator(device="cuda").manual_seed(110 + i)
        do = torch.randn(xc.shape, generator=g, device="cuda").to(
            torch.bfloat16)
        do[:, cap:] = 0  # the caller cuts the pad rows off
        args = (xc, t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                t["wo"], do, EPS, seq_len, HEADS, HEAD_DIM)
        for name in RECT_BWD_KERNELS:
            kern = lambda f=getattr(ck, name): f(*args)
            plain = lambda f=getattr(ck, name + "_ref"): f(*args)
            with torch.no_grad():
                outs = kern()
                torch.cuda.synchronize()
                refs = plain()
                errs = _hold_all(name, label, outs, refs, stats)
                if "int8" in name:
                    _check_int8(ck, name, label, args, outs, refs, stats)
            del outs, refs
            line = (f"  {name:32s} {label:28s} max|k-ref| per output "
                    f"[{' '.join(errs)}]: ok")
            if i == 0:
                with torch.no_grad():
                    k_ms = _median_ms(kern, warmup=2, iters=10)
                    p_ms = _median_ms(plain, warmup=1, iters=5)
                line += f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
                stats[name].update(ms=k_ms, plain_ms=p_ms,
                                   shape=(batch, rows, xc.shape[1]))
            print(line, flush=True)
        # against K1's backward on all rows: do scattered to the kept rows,
        # dxc added back through the gather transpose
        rows_idx = idx[..., None].expand(-1, -1, D)
        do_full = torch.zeros_like(t["x"]).scatter(1, rows_idx, do[:, :cap])
        with torch.no_grad():
            rect = ck.fused_ln_qkvo_attention_rect_bwd(*args)
            square = ck.fused_ln_qkvo_attention_bwd(
                t["x"], *args[2:7], do_full, *args[8:])
            if i == 0:
                stats["fused_ln_qkvo_attention_rect_bwd"]["square_ms"] = \
                    _median_ms(lambda: ck.fused_ln_qkvo_attention_bwd(
                        t["x"], *args[2:7], do_full, *args[8:]),
                        warmup=2, iters=10)
        dx = rect[1].float().scatter_add(1, rows_idx,
                                         rect[0][:, :cap].float())
        diffs = []
        for o, r in zip((dx,) + rect[2:], square):
            err = (o.float() - r.float()).abs().max().item()
            bound = TOL * max(1.0, r.float().abs().max().item())
            if err > bound:
                raise AssertionError(f"K8 backward {label}: {err} from K1's "
                                     f"backward + gather (bound {bound})")
            diffs.append(f"{err:.2e}<={bound:.2e}")
        print(f"  K8 bwd vs K1 bwd + gather {label:28s} per output "
              f"(dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) [{' '.join(diffs)}]",
              flush=True)
        del t, xc, do, do_full, rect, square
        torch.cuda.empty_cache()
    name = "fused_ln_qkvo_attention_gqa_bwd"
    for label, batch, rows, seq_len, hkv in GQA_BWD_CASES:
        t = _inputs(batch, rows, seed=120)
        g = torch.Generator(device="cuda").manual_seed(121)
        width = (HEADS + 2 * hkv) * HEAD_DIM
        wqkv = (torch.randn((D, width), generator=g, device="cuda")
                * D ** -0.5).to(torch.bfloat16)
        bqkv = 0.02 * torch.randn(width, generator=g, device="cuda")
        do = torch.randn(t["x"].shape, generator=g, device="cuda").to(
            torch.bfloat16)
        args = (t["x"], t["gamma"], t["beta"], wqkv, bqkv, t["wo"], do, EPS,
                seq_len, HEADS, HEAD_DIM, hkv)
        kern = lambda: ck.fused_ln_qkvo_attention_gqa_bwd(*args)
        plain = lambda: ck.fused_ln_qkvo_attention_gqa_bwd_ref(*args)
        with torch.no_grad():
            outs = kern()
            again = kern()
            torch.cuda.synchronize()
            errs = _hold_all(name, label, outs, plain(), stats)
            if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                raise AssertionError("K7 backward: two launches differ")
            k_ms = _median_ms(kern, warmup=2, iters=10)
            p_ms = _median_ms(plain, warmup=1, iters=5)
        print(f"  {name:32s} {label:28s} max|k-ref| per output "
              f"[{' '.join(errs)}]: ok, two launches the same bits; kernel "
              f"{k_ms:.4f} ms  plain {p_ms:.4f} ms", flush=True)
        stats[name].update(ms=k_ms, plain_ms=p_ms, shape=(batch, rows, hkv))
        del t, outs, again
        torch.cuda.empty_cache()
    print(f"  K8 bwd at {RECT_BWD_CASES[0][0]}: bf16 "
          f"{stats['fused_ln_qkvo_attention_rect_bwd']['ms']:.4f} ms against "
          f"K1 bwd on all rows "
          f"{stats['fused_ln_qkvo_attention_rect_bwd']['square_ms']:.4f} ms",
          flush=True)
    return stats


# ViT-H/14 (phase 3): (kernel, label, batch, rows, seq_len, timed). K6's
# forward at eval_cli's b32 spq 736 (the table's time) and train_cli's b32
# spq 264, its backward at b32 spq 264 (the table's) and b8, each on a
# ragged case too (spq 40: not a multiple of the 16-row tiles or 64-key
# tiles, keys masked past 37); K2's backward at d 1280 over train_cli's
# 32 x 264 rows (the table's) and 3 x 257 rows.
H14_CASES = [
    ("fused_ln_qkvo_attention_flash", "b32 spq736 (eval_cli)", 32, 736, 730,
     "ms"),
    ("fused_ln_qkvo_attention_flash", "b32 spq264 (train_cli)", 32, 264, 257,
     "ms_264"),
    ("fused_ln_qkvo_attention_flash", "ragged", 3, 40, 37, None),
    ("fused_ln_qkvo_attention_flash_bwd", "b32 spq264 (train_cli)", 32, 264,
     257, "ms"),
    ("fused_ln_qkvo_attention_flash_bwd", "b8 spq264", 8, 264, 257, None),
    ("fused_ln_qkvo_attention_flash_bwd", "ragged", 3, 40, 37, None),
    ("fused_ln_mlp_bwd_wide", "b32 rows264 (train_cli)", 32, 264, 264, "ms"),
    ("fused_ln_mlp_bwd_wide", "ragged", 3, 257, 257, None),
]


def check_h14_kernels(stats):
    """Phase 3, ViT-H/14: K6 forward and backward (every output) and K2's
    backward at d 1280 against their twins (the K6 twins run vitax's KV
    chunks, the kernels 64-key tiles: the bf16 rounding of p moves with the
    running max, inside TOL); then K6 against K1 at ViT-B/16's b32 spq
    200, forward and backward, within TOL: one function up to the softmax's
    rounding, timed in turns."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in H14_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    _, heads, hd, _ = H14
    for i, (name, label, batch, rows, seq_len, timed) in enumerate(H14_CASES):
        t = _inputs(batch, rows, seed=140 + i, dims=H14)
        g = torch.Generator(device="cuda").manual_seed(160 + i)
        do = torch.randn(t["x"].shape, generator=g, device="cuda").to(
            torch.bfloat16)
        if name == "fused_ln_mlp_bwd_wide":
            args = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
                    do, EPS)
        else:
            last = t["bo"] if name == "fused_ln_qkvo_attention_flash" else do
            args = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                    t["wo"], last, EPS, seq_len, heads, hd)
        kern = (lambda f=getattr(ck, name), a=args: f(*a))
        plain = (lambda f=getattr(ck, name + "_ref"), a=args: f(*a))
        with torch.no_grad():
            outs = kern()
            again = kern() if name == "fused_ln_qkvo_attention_flash_bwd" \
                else outs
            torch.cuda.synchronize()
            refs = plain()
        if isinstance(outs, torch.Tensor):
            outs, again, refs = (outs,), (again,), (refs,)
        errs = _hold_all(name, label, outs, refs, stats)
        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
            raise AssertionError(f"{name} {label}: two launches differ")
        line = (f"  {name:34s} {label:24s} max|k-ref| per output "
                f"[{' '.join(errs)}]: ok"
                + ("; two launches the same bits" if again is not outs
                   else ""))
        del outs, refs, again
        if timed:
            with torch.no_grad():
                k_ms = _median_ms(kern, warmup=2, iters=10)
                p_ms = _median_ms(plain, warmup=1, iters=5)
            line += (f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms (medians "
                     "of 10 / 5)")
            stats[name][timed] = k_ms
            if timed == "ms":
                stats[name].update(plain_ms=p_ms, shape=(batch, rows),
                                   dims=H14)
        print(line, flush=True)
        del t, args, kern, plain
        torch.cuda.empty_cache()

    check_online_core(stats)

    t = _inputs(32, 200, seed=170)
    g = torch.Generator(device="cuda").manual_seed(171)
    do = torch.randn(t["x"].shape, generator=g, device="cuda").to(
        torch.bfloat16)
    qkvo = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"],
            t["bo"], EPS, 197, HEADS, HEAD_DIM)
    bwd = qkvo[:6] + (do,) + qkvo[7:]
    calls = {"K6": (lambda: ck.fused_ln_qkvo_attention_flash(*qkvo),
                    lambda: ck.fused_ln_qkvo_attention_flash_bwd(*bwd)),
             "K1": (lambda: ck.fused_ln_qkvo_attention(*qkvo),
                    lambda: ck.fused_ln_qkvo_attention_bwd(*bwd))}
    with torch.no_grad():
        pairs = [(calls["K6"][0](), calls["K1"][0]())]
        pairs += zip(calls["K6"][1](), calls["K1"][1]())
        # in turns: K6, K1, K1, K6
        ms = {(k, i): [] for k in calls for i in range(2)}
        for k in ("K6", "K1", "K1", "K6"):
            for i in range(2):
                ms[k, i].append(_median_ms(calls[k][i], warmup=2, iters=10))
    errs = []
    for a, b in pairs:
        err = (a.float() - b.float()).abs().max().item()
        bound = TOL * max(1.0, b.float().abs().max().item())
        if not (err <= bound and bool(torch.isfinite(a).all())):
            raise AssertionError(f"K6 vs K1 at b32 spq200: {err} > {bound}")
        errs.append(f"{err:.2e}<={bound:.2e}")
    print(f"  K6 vs K1 (ViT-B/16 b32 spq200, hd 64), forward and the 7 "
          f"grads: [{' '.join(errs)}]: ok; times (medians of 10, in turns "
          f"K6 K1 K1 K6) forward K6 "
          f"{' / '.join(f'{v:.4f}' for v in ms['K6', 0])} ms, K1 "
          f"{' / '.join(f'{v:.4f}' for v in ms['K1', 0])} ms; backward K6 "
          f"{' / '.join(f'{v:.4f}' for v in ms['K6', 1])} ms, K1 "
          f"{' / '.join(f'{v:.4f}' for v in ms['K1', 1])} ms", flush=True)
    return stats


# K6's online core alone (ck.flash_online_core: its forward and its
# backward row pass) at ViT-H/14's spq 736 (@384) and 264 (@224), b32, and
# a ragged spq 40 (keys masked past 37), at head_dim 64, 80 and 128 with
# H/14's 1280 columns of heads (ViT-L/16 @384 runs K6 at head_dim 64)
ONLINE_CASES = [(32, 736, 730), (32, 264, 257), (3, 40, 37)]
ONLINE_HEAD_DIMS = (64, 80, 128)


def check_online_core(stats):
    """Phase 3: K6's online core alone against its plain version
    (`flash_online_rows_ref`): the bf16 head outputs and the row pass's dd
    within TOL (the same 64-key tiles and rounding points; sums in another
    order), its m·scale·log2e within 1e-4·max(1, |m|) and 1/l within 1e-4
    relative (ex2.approx and the order of the row sums); the forward timed at b32 spq 736 and the
    row pass at b32 spq 264 at each head_dim."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    stats["online_core"] = times = {}
    for hd in ONLINE_HEAD_DIMS:
        heads = H14[0] // hd
        for i, (batch, spq, seq) in enumerate(ONLINE_CASES):
            g = torch.Generator(device="cuda").manual_seed(180 + 10 * i + hd)
            qkv = torch.randn((batch, spq, 3 * heads * hd), generator=g,
                              device="cuda").to(torch.bfloat16)
            dattn = torch.randn((batch, spq, heads * hd), generator=g,
                                device="cuda").to(torch.bfloat16)
            args = (qkv, seq, heads, hd)
            with torch.no_grad():
                attn = ck.flash_online_core(*args)
                attn2, st = ck.flash_online_core(*args, dattn=dattn)
                torch.cuda.synchronize()
                ref = ck.flash_online_rows_ref(*args)
                ref2, st_ref = ck.flash_online_rows_ref(*args, dattn=dattn)
            errs = []
            for what, a, b in (("out", attn, ref), ("row pass out", attn2,
                                                    ref2),
                               ("dd", st[:, :, 2], st_ref[:, :, 2])):
                err = (a.float() - b.float()).abs().max().item()
                bound = TOL * max(1.0, b.float().abs().max().item())
                if not (err <= bound and bool(torch.isfinite(a).all())):
                    raise AssertionError(f"online core hd {hd} {batch}x{spq}"
                                         f" {what}: {err} > {bound}")
                errs.append(f"{what} {err:.2e}<={bound:.2e}")
            if not torch.equal(attn, attn2):
                raise AssertionError(f"online core hd {hd} {batch}x{spq}: "
                                     "the row pass's out is not the forward's")
            for what, j, floor in (("m", 0, 1.0), ("1/l", 1, 1e-30)):
                rel = ((st[:, :, j] - st_ref[:, :, j]).abs()
                       / st_ref[:, :, j].abs().clamp_min(floor)).max().item()
                if not rel <= 1e-4:
                    raise AssertionError(f"online core hd {hd} {batch}x{spq}"
                                         f" {what}: relative {rel}")
                errs.append(f"{what} rel {rel:.1e}")
            line = (f"  online core hd {hd:3d} b{batch} spq{spq} seq{seq}: "
                    f"[{' '.join(errs)}]: ok")
            if i < 2:
                with torch.no_grad():
                    kw = {} if i == 0 else {"dattn": dattn}
                    ms = _median_ms(lambda: ck.flash_online_core(*args, **kw),
                                    warmup=2, iters=20)
                times[f"{'fwd' if i == 0 else 'row pass'} hd{hd} b{batch} "
                      f"spq{spq}"] = ms
                line += (f"; {'forward' if i == 0 else 'row pass'} "
                         f"{ms:.4f} ms (median of 20)")
            print(line, flush=True)
            del qkv, dattn, attn, attn2, st, ref, ref2, st_ref
            torch.cuda.empty_cache()


H14_LAYERS = 32
# eval_cli at its default 384 px (spq 736), two b32 batches; train_cli at
# 224 px (spq 264), b32, 4 SGD steps (one epoch of 128 images) and an eval
# epoch of 4 batches
H14_EVAL_ARGS = ["--model-arch", "h14", "--dataset", "Synthetic",
                 "--synthetic-samples", "64", "--batch-size", "32",
                 "--num-classes", "10", "--seed", "0"]
H14_TRAIN_ARGS = ["--model-arch", "h14", "--image-size", "224",
                  "--dataset", "Synthetic", "--synthetic-samples", "128",
                  "--batch-size", "32", "--lr", "0.03", "--wd", "0",
                  "--warmup-steps", "2", "--train-steps", "4",
                  "--num-classes", "10", "--seed", "0"]
H14_STEPS = 4


def run_h14_slice(exp_root):
    """Phase 10, ViT-H/14: eval_cli at 384 with exact counts (32 K6 and 32
    K2 a forward, LN once, no K1), the plain run, logits kernel vs plain
    bf16; train_cli at 224 b32 with exact counts per step (K6 and K2
    forward and backward, K2's on the :1610 route), grads of every parameter
    kernel vs plain bf16; device-timed forwards and train steps."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train import param_leaves
    from vitax_torch.utils.memory import named_leaves

    L = H14_LAYERS
    ck.reset_launch_counts()
    result, n_img, rate = _run_eval(H14_EVAL_ARGS)
    counts_eval = ck.launch_counts()
    batches = 2
    expect = _expect(layer_norm=batches,
                     fused_ln_qkvo_attention_flash=L * batches,
                     fused_ln_mlp=L * batches)
    print(f"h14: eval_cli @384 kernels {result} {n_img} images {rate:.1f} "
          f"img/s launches {_nonzero(counts_eval)}", flush=True)
    if n_img != 64 or counts_eval != expect:
        raise AssertionError(f"expected 64 images and launches {expect}")
    ck.reset_launch_counts()
    result_p, _, rate_p = _run_eval(H14_EVAL_ARGS + PLAIN_FLAGS)
    print(f"h14: eval_cli @384 plain {result_p} {rate_p:.1f} img/s launches "
          f"{_nonzero(ck.launch_counts())}", flush=True)
    if any(ck.launch_counts().values()):
        raise AssertionError("the plain path launched a kernel")

    times = {"eval img/s @384": {"kernels": rate, "plain": rate_p}}
    for image in (384, 224):
        cfg = arch_config("h14", image_size=image, num_classes=10,
                          dtype=torch.bfloat16, fused_qkv=True,
                          fused_mlp=True)
        plain = cfg.replace(fused_qkv=False, fused_mlp=False,
                            use_pallas=False)
        params = vit.init_params(set_seed(0), cfg, "cuda")
        batch = next(iter(get_dataloader(
            "Synthetic", split="val" if image == 384 else "train",
            image_size=image, batch_size=32, num_samples=64, seed=0)))
        images = torch.from_numpy(batch.images).cuda().bfloat16()
        labels = torch.from_numpy(batch.labels).cuda()
        with torch.inference_mode():
            ck.reset_launch_counts()
            lk = vit.apply(params, images, cfg)
            if _nonzero(ck.launch_counts()) != {
                    "layer_norm": 1, "fused_ln_qkvo_attention_flash": L,
                    "fused_ln_mlp": L}:
                raise AssertionError(f"h14 @{image}: launches "
                                     f"{_nonzero(ck.launch_counts())}")
            lp = vit.apply(params, images, plain)
            fwd = {n: _median_ms(lambda c=c: vit.apply(params, images, c),
                                 warmup=1, iters=5)
                   for n, c in (("kernels", cfg), ("plain", plain))}
        diff = (lk - lp).abs().max().item()
        band = LOGIT_BAND * max(1.0, lp.abs().max().item())
        print(f"h14: @{image} logits {tuple(lk.shape)} max|kernel-plain_bf16|"
              f" {diff:.3e} <= {band:.3e}; forward b32 (median of 5, CUDA "
              "events): " + ", ".join(f"{k} {ms:.2f} ms = {32e3 / ms:.1f} "
                                      "img/s" for k, ms in fwd.items()),
              flush=True)
        if not (bool(torch.isfinite(lk).all()) and diff <= band):
            raise AssertionError("h14 kernel-path logits outside the bf16 "
                                 "band")
        times[f"forward ms @{image}"] = fwd
        del lk, lp
        if image == 384:
            del params, images
            torch.cuda.empty_cache()
            continue

        # @224: train_cli, then grads and timed steps on these params
        args = H14_TRAIN_ARGS + ["--exp-root", exp_root]
        ck.reset_launch_counts()
        losses, valid, rate_t = _run_train(args, steps=H14_STEPS)
        counts_train = ck.launch_counts()
        ev = math.ceil(128 / 32)
        expect = _expect(
            layer_norm=H14_STEPS + ev,
            fused_ln_qkvo_attention_flash=L * (H14_STEPS + ev),
            fused_ln_mlp=L * (H14_STEPS + ev), layer_norm_bwd=H14_STEPS,
            fused_ln_qkvo_attention_flash_bwd=L * H14_STEPS,
            fused_ln_mlp_bwd_wide=L * H14_STEPS)
        print(f"h14: train_cli @224 b32 losses "
              f"{[round(v, 4) for v in losses]} valid {valid} {rate_t:.1f} "
              f"img/s (epoch loop, host-fed) launches "
              f"{_nonzero(counts_train)}", flush=True)
        if counts_train != expect:
            raise AssertionError(f"expected launches {expect}")

        names = [n for n, _ in named_leaves(params)]
        for p in param_leaves(params):
            p.requires_grad_(True)
        g_k = _grads(params, images, labels, cfg)
        g_p = _grads(params, images, labels, plain)
        rels, key_ratio = _grad_distances(names, g_k, g_p)
        finite = all(bool(torch.isfinite(g).all()) for g in g_k)
        print(f"h14: grads of {len(names)} tensors; worst |g_kernel - "
              f"g_plain_bf16| / |g_plain_bf16|: " + ", ".join(
                  f"{r:.3e} ({n})" for r, n in rels[:3])
              + f" <= {GRAD_BAND}; key biases |g_kernel| / |g_plain query "
              f"bias| <= {key_ratio:.3e}", flush=True)
        if not finite or rels[0][0] > GRAD_BAND or key_ratio > GRAD_BAND:
            raise AssertionError("h14 kernel-path grads outside the bf16 "
                                 "band")
        del g_k, g_p
        torch.cuda.empty_cache()
        runs = _time_steps(params, images, labels,
                           (("plain", plain), ("kernels", cfg),
                            ("kernels", cfg), ("plain", plain)), iters=5)
        times["train step ms @224"] = {
            k: min(ms for n, ms in runs if n == k)
            for k in ("kernels", "plain")}
        times["train_cli img/s @224"] = rate_t
        del params, images
        torch.cuda.empty_cache()
    return counts_eval, counts_train, times


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _run_eval(args):
    from vitax_torch import eval_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        result = eval_cli.main(args)
    m = re.search(r"\((\d+) images in ([\d.]+)s, (\d+) img/s\)",
                  buf.getvalue())
    if m is None:
        raise AssertionError("eval_cli printed no img/s line")
    for k in ("loss", "acc1", "acc5"):
        if not math.isfinite(result[k]):
            raise AssertionError(f"eval metric {k} = {result[k]}")
    return result, int(m.group(1)), float(m.group(3))


def run_slice():
    """Phase 4: the serving path through eval_cli, kernels then plain."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    result, n_img, rate = _run_eval(EVAL_ARGS)
    counts = ck.launch_counts()
    batches = math.ceil(256 / 64)
    expect = _expect(layer_norm=batches,
                     fused_ln_qkvo_attention=12 * batches,
                     fused_ln_mlp=12 * batches)  # inference: no backward
    print(f"slice: eval_cli kernels {result} {n_img} images {rate:.0f} img/s "
          f"launches {counts}", flush=True)
    if n_img != 256 or counts != expect:
        raise AssertionError(f"expected 256 images and launches {expect}")

    ck.reset_launch_counts()
    result_p, _, rate_p = _run_eval(EVAL_ARGS + PLAIN_FLAGS)
    print(f"slice: eval_cli plain {result_p} {rate_p:.0f} img/s "
          f"launches {ck.launch_counts()}", flush=True)
    if any(ck.launch_counts().values()):
        raise AssertionError("the plain path launched a kernel")

    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    batch = next(iter(get_dataloader("Synthetic", split="val", image_size=224,
                                     batch_size=64, num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda()
    with torch.inference_mode():
        lk = vit.apply(params, images.bfloat16(), cfg)
        lp = vit.apply(params, images.bfloat16(),
                       cfg.replace(fused_qkv=False, fused_mlp=False,
                                   use_pallas=False))
        l32 = vit.apply(params, images,
                        cfg.replace(fused_qkv=False, fused_mlp=False,
                                    use_pallas=False, dtype=torch.float32))
    diff = (lk - lp).abs().max().item()
    band = LOGIT_BAND * max(1.0, lp.abs().max().item())
    print(f"slice: logits {tuple(lk.shape)} max|kernel-plain_bf16| {diff:.3e}"
          f" <= {band:.3e}; max|kernel-fp32| {(lk - l32).abs().max().item():.3e}"
          f" max|plain_bf16-fp32| {(lp - l32).abs().max().item():.3e}"
          f" max|fp32| {l32.abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(lk).all() and diff <= band):
        raise AssertionError("kernel-path logits outside the bf16 band")

    # device-timed forward on a resident batch: eval_cli's rate over four
    # batches also counts the host loader
    plain = cfg.replace(fused_qkv=False, fused_mlp=False, use_pallas=False)
    with torch.inference_mode():
        images = images.bfloat16()
        fwd = {name: _median_ms(lambda c=c: vit.apply(params, images, c),
                                warmup=2, iters=10)
               for name, c in (("kernels", cfg), ("plain", plain))}
    print("slice: forward b64 (median of 10, CUDA events): " + ", ".join(
        f"{k} {ms:.2f} ms = {64e3 / ms:.0f} img/s" for k, ms in fwd.items()),
        flush=True)
    return counts, rate, rate_p


def _run_train(args, steps=TRAIN_STEPS):
    from vitax_torch import train_cli
    out = train_cli.main(args)
    losses = [v for e in out["epochs"] for v in e["train"]["losses"]]
    valid = out["epochs"][-1]["valid"]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    if not all(math.isfinite(v) for v in valid.values()):
        raise AssertionError(f"valid metrics {valid}")
    shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)  # ~1.4 GB
    return losses, valid, out["epochs"][-1]["train"]["img_per_s"]


def _grads(params, images, labels, cfg, seed=None):
    """Grads of every parameter for one batch in train mode; `seed`: the
    token dropping's generator (a CPU one, as train_cli's)."""
    import torch
    from vitax_torch.models import vit
    from vitax_torch.train import cross_entropy, param_leaves
    leaves = param_leaves(params)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss = cross_entropy(vit.apply(params, images.to(cfg.dtype), cfg,
                                   train=True, gen=gen), labels)
    return [g.float() for g in torch.autograd.grad(loss, leaves)]


def run_train_slice(exp_root):
    """Phase 5: train_cli with kernels, then plain; grads at full width on
    three paths; a device-timed train step."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train import param_leaves
    from vitax_torch.utils.memory import named_leaves

    args = TRAIN_ARGS + ["--exp-root", exp_root]
    ck.reset_launch_counts()
    losses, valid, rate = _run_train(args)
    counts = ck.launch_counts()
    eval_batches = math.ceil(256 / TRAIN_BATCH)
    expect = _expect(layer_norm=TRAIN_STEPS + eval_batches,
                     fused_ln_qkvo_attention=12 * (TRAIN_STEPS + eval_batches),
                     fused_ln_mlp=12 * (TRAIN_STEPS + eval_batches),
                     layer_norm_bwd=TRAIN_STEPS,
                     fused_ln_qkvo_attention_bwd=12 * TRAIN_STEPS,
                     fused_ln_mlp_bwd=12 * TRAIN_STEPS)
    print(f"train: train_cli kernels losses {[round(v, 4) for v in losses]} "
          f"valid {valid} {rate:.0f} img/s (epoch loop, host-fed) launches "
          f"{counts}", flush=True)
    if counts != expect:
        raise AssertionError(f"expected launches {expect}")

    ck.reset_launch_counts()
    losses_p, valid_p, rate_p = _run_train(args + PLAIN_FLAGS)
    print(f"train: train_cli plain losses {[round(v, 4) for v in losses_p]} "
          f"valid {valid_p} {rate_p:.0f} img/s launches {ck.launch_counts()}",
          flush=True)
    if any(ck.launch_counts().values()):
        raise AssertionError("the plain path launched a kernel")

    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True)
    plain = cfg.replace(fused_qkv=False, fused_mlp=False, use_pallas=False)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    names = [n for n, _ in named_leaves(params)]
    for p in param_leaves(params):
        p.requires_grad_(True)
    batch = next(iter(get_dataloader("Synthetic", split="train",
                                     image_size=224, batch_size=TRAIN_BATCH,
                                     num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda()
    labels = torch.from_numpy(batch.labels).cuda()
    g_k = _grads(params, images, labels, cfg)
    g_p = _grads(params, images, labels, plain)
    g_32 = _grads(params, images, labels, plain.replace(dtype=torch.float32))

    rels, key_ratio = _grad_distances(names, g_k, g_p)
    by_name = dict(zip(names, range(len(names))))
    d_k = max(_rel(g_k[by_name[n]], g_32[by_name[n]]) for _, n in rels)
    d_p = max(_rel(g_p[by_name[n]], g_32[by_name[n]]) for _, n in rels)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    print(f"train: grads of {len(names)} tensors; worst |g_kernel - "
          f"g_plain_bf16| / |g_plain_bf16|: " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels[:3]) + f" <= {GRAD_BAND}; "
          f"key biases (exact grad 0) |g_kernel| / |g_plain query bias| "
          f"<= {key_ratio:.3e}; worst distance to plain fp32: kernel "
          f"{d_k:.3e}, plain bf16 {d_p:.3e}", flush=True)
    if not finite or rels[0][0] > GRAD_BAND or key_ratio > GRAD_BAND:
        raise AssertionError("kernel-path grads outside the bf16 band")
    del g_k, g_p, g_32

    # device-timed train step on a resident batch: forward, backward, SGD
    runs = _time_steps(params, images.bfloat16(), labels,
                       (("plain", plain), ("kernels", cfg), ("kernels", cfg),
                        ("plain", plain)))
    return counts, {k: min(ms for n, ms in runs if n == k)
                    for k in ("kernels", "plain")}


def _grad_distances(names, g_a, g_b):
    """Per-tensor ‖g_a − g_b‖ / ‖g_b‖, worst first, without the key biases;
    and the key biases' worst ‖g_a‖ / ‖g_b of the layer's query bias‖. The
    key biases' exact gradient is 0 (softmax is shift-invariant along the
    keys: Σ_k ds = 0), so both paths return rounding noise there and a
    relative distance means nothing."""
    by_name = dict(zip(names, range(len(names))))
    rels = sorted(((_rel(g_a[i], g_b[i]), n) for n, i in by_name.items()
                   if not n.endswith("attn/key/bias")), reverse=True)
    key_ratio = max(
        (g_a[i].norm() / g_b[by_name[n.replace("/key/", "/query/")]].norm())
        .item() for n, i in by_name.items() if n.endswith("attn/key/bias"))
    return rels, key_ratio


def _time_steps(params, images, labels, paths, iters=10):
    """Median CUDA-event time of a train step (forward, backward, SGD) on a
    resident batch for each (name, cfg, [context]) in run order."""
    import torch
    from vitax_torch.train import (create_train_state, make_train_step,
                                   sgd_momentum)
    runs = []
    for name, c, *ctx in paths:
        opt, sched = sgd_momentum(params, 0.03, 1000, 0.1)
        state = create_train_state(params, opt, sched, torch.Generator())
        step = make_train_step(c, opt, sched)
        with (ctx[0] if ctx else contextlib.nullcontext()):
            runs.append((name, _median_ms(lambda: step(state, images, labels),
                                          warmup=2, iters=iters)))
    print(f"train: step b{len(labels)} (fwd+bwd+SGD, median of {iters}, CUDA "
          "events), in run order: " + ", ".join(
              f"{k} {ms:.2f} ms = {len(labels) * 1e3 / ms:.0f} img/s"
              for k, ms in runs), flush=True)
    return runs


@contextlib.contextmanager
def _int8_twins(ck):
    """The int8 twin path on the card: the int8 wrappers, which the model
    and the autograd Functions call by their module names, are swapped for
    routes to their plain twins; the Functions keep their tier logic (int8
    forward; int8, int8_dw or bf16 backward; K5's block)."""
    rect = ("fused_ln_qkvo_attention_rect_int8",) + RECT_BWD_KERNELS[1:]
    saved = {n: getattr(ck, n) for n in INT8_KERNELS + rect
             + INT8_GQA_KERNELS + SAVE_KERNELS_INT8}

    def route(name, fn_cls, n_tensors, gqa=False):
        ref = getattr(ck, name + "_ref")

        def fwd(*args, int8_grad=False, int8_dw=False, kv_heads=None,
                save_acts=False, **residual):
            tail = (kv_heads,) if gqa else ()
            if ck._needs_grad(*args[:n_tensors]):
                if int8_grad and save_acts:  # K12-int8's Function
                    return ck.FusedLnMlpSaveFn.apply(*args, True, int8_dw)
                return fn_cls.apply(*args, True, int8_grad, int8_dw, *tail)
            return ref(*args, *tail, **residual)
        return fwd

    ck.fused_ln_qkvo_attention_int8 = route("fused_ln_qkvo_attention_int8",
                                            ck.FusedLnQkvoAttentionFn, 7,
                                            gqa=True)
    ck.fused_ln_mlp_int8 = route("fused_ln_mlp_int8", ck.FusedLnMlpFn, 7)
    ck.fused_ln_qkvo_attention_rect_int8 = route(
        "fused_ln_qkvo_attention_rect_int8", ck.FusedLnQkvoAttentionRectFn, 8)
    # the backwards, K5's halves, K7's int8 tier and K12-int8's pair
    for name in (INT8_KERNELS[2:] + RECT_BWD_KERNELS[1:] + INT8_GQA_KERNELS
                 + SAVE_KERNELS_INT8):
        setattr(ck, name, getattr(ck, name + "_ref"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ck, n, f)


def _int8_at_416(ck):
    """Phase 6: ViT-B/16 at 416 px (seq 677, spq 680), where vitax's K1
    gate passes and the first design's whole-row core cannot take the
    shapes (the CLIs' --image-size stops at 384, as vitax's): one b8
    forward through `vit.apply` with `--int8`'s flags, the counters set to
    0 just before and read just after (exact: 12 K3 and 12 K4, the LN kernel
    once; their s8 products, no first-design piece), its logits against
    the int8 twin path's within LOGIT_BAND."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import vit
    cfg = arch_config("b16", image_size=416, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True,
                      int8_mlp=True, int8_attn=True)
    params = vit.init_params(set_seed(1), cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(416)
    images = torch.randn((8, 416, 416, 3), generator=g, device="cuda").to(
        torch.bfloat16)
    with torch.inference_mode():
        ck.reset_launch_counts()
        lk = vit.apply(params, images, cfg)
        torch.cuda.synchronize()
        counts = ck.launch_counts()
        expect = _expect(layer_norm=1, fused_ln_qkvo_attention_int8=12,
                         fused_ln_mlp_int8=12)
        print(f"int8: vit.apply @416 b8 --int8 launches {_nonzero(counts)}",
              flush=True)
        if counts != expect:
            raise AssertionError(f"416 px: expected launches {expect}")
        _check_s8("vit.apply @416 --int8", counts, first_design=True)
        with _int8_twins(ck):
            lt = vit.apply(params, images, cfg)
    d, band = (lk - lt).abs().max().item(), LOGIT_BAND * max(
        1.0, lt.abs().max().item())
    print(f"int8: @416 b8 logits, int8 kernel path vs int8 twin path max|Δ| "
          f"{d:.3e} <= {band:.3e}", flush=True)
    if not (torch.isfinite(lk).all() and d <= band):
        raise AssertionError("416 px: int8 logits outside their band")


def run_int8_slice(exp_root):
    """Phase 6: the W8A8 tiers through train_cli and eval_cli with exact
    launch counts; logits and full-width grads on the int8 kernel path, the
    int8 twin path and the bf16 kernel path; a device-timed train step."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train import param_leaves
    from vitax_torch.utils.memory import named_leaves

    fwd = TRAIN_STEPS + math.ceil(256 / TRAIN_BATCH)  # steps + eval batches
    int8_fwd = dict(layer_norm=fwd, fused_ln_qkvo_attention_int8=12 * fwd,
                    fused_ln_mlp_int8=12 * fwd, layer_norm_bwd=TRAIN_STEPS)
    expects = {
        "--int8-grad": _expect(
            **int8_fwd, fused_ln_qkvo_attention_int8_bwd=12 * TRAIN_STEPS,
            fused_ln_mlp_int8_bwd=12 * TRAIN_STEPS),
        "--int8": _expect(**int8_fwd,
                          fused_ln_qkvo_attention_bwd=12 * TRAIN_STEPS,
                          fused_ln_mlp_bwd=12 * TRAIN_STEPS),
    }
    # the s8 products of both runs' K3 and K4 forwards (two s8_bf16; an
    # s8_gelu_q_f32 and an s8_residual, a layer a forward) and of the
    # --int8-grad run's backwards (K3's two s8_bf16 and one s8_f32, K4's
    # s8_gelu_pair and s8_f32, a layer a step), no gemm.cuh s8 product and
    # no whole-row core in either
    counts = {}
    for flag, expect in expects.items():
        ck.reset_launch_counts()
        losses, valid, rate = _run_train(TRAIN_ARGS + ["--exp-root", exp_root,
                                                       flag])
        counts[flag] = ck.launch_counts()
        print(f"int8: train_cli {flag} losses {[round(v, 4) for v in losses]} "
              f"valid {valid} {rate:.0f} img/s (epoch loop, host-fed) "
              f"launches {_nonzero(counts[flag])}", flush=True)
        if counts[flag] != expect:
            raise AssertionError(f"expected launches {expect}")
        s8 = _check_s8(f"train_cli {flag}", counts[flag], first_design=True)
        if flag == "--int8-grad":
            counts[flag].update(s8)

    ck.reset_launch_counts()
    result, n_img, rate = _run_eval(EVAL_ARGS + ["--int8"])
    batches = math.ceil(256 / 64)
    expect = _expect(layer_norm=batches,
                     fused_ln_qkvo_attention_int8=12 * batches,
                     fused_ln_mlp_int8=12 * batches)
    print(f"int8: eval_cli --int8 {result} {n_img} images {rate:.0f} img/s "
          f"launches {_nonzero(ck.launch_counts())}", flush=True)
    if n_img != 256 or ck.launch_counts() != expect:
        raise AssertionError(f"expected 256 images and launches {expect}")
    _check_s8("eval_cli --int8", ck.launch_counts(), first_design=True)
    _int8_at_416(ck)

    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True,
                      int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                      int8_attn_grad=True)
    bf16 = cfg.replace(int8_mlp=False, int8_attn=False, int8_mlp_grad=False,
                       int8_attn_grad=False)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    batch = next(iter(get_dataloader("Synthetic", split="train",
                                     image_size=224, batch_size=TRAIN_BATCH,
                                     num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda().bfloat16()
    labels = torch.from_numpy(batch.labels).cuda()
    with torch.inference_mode():
        lk = vit.apply(params, images, cfg)
        with _int8_twins(ck):
            lt = vit.apply(params, images, cfg)
        lb = vit.apply(params, images, bf16)
    d_t, d_b = (lk - lt).abs().max().item(), (lk - lb).abs().max().item()
    band_t = LOGIT_BAND * max(1.0, lt.abs().max().item())
    band_b = QUANT_LOGIT_BAND * max(1.0, lb.abs().max().item())
    print(f"int8: logits {tuple(lk.shape)} max|int8 kernel - int8 twin| "
          f"{d_t:.3e} <= {band_t:.3e}; max|int8 kernel - bf16 kernel| "
          f"{d_b:.3e} <= {band_b:.3e}", flush=True)
    if not (torch.isfinite(lk).all() and d_t <= band_t and d_b <= band_b):
        raise AssertionError("int8 logits outside their bands")

    names = [n for n, _ in named_leaves(params)]
    for p in param_leaves(params):
        p.requires_grad_(True)
    g_k = _grads(params, images, labels, cfg)
    with _int8_twins(ck):
        g_t = _grads(params, images, labels, cfg)
    g_b = _grads(params, images, labels, bf16)
    rels_t, key_t = _grad_distances(names, g_k, g_t)
    rels_b, key_b = _grad_distances(names, g_k, g_b)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    print(f"int8: grads of {len(names)} tensors; worst |g_int8_kernel - "
          f"g_int8_twin| / |g_int8_twin|: " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels_t[:3])
          + f" <= {INT8_GRAD_BAND}, "
          f"key biases {key_t:.3e}; worst |g_int8_kernel - g_bf16_kernel| / "
          f"|g_bf16_kernel|: " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels_b[:3])
          + f" <= {QUANT_GRAD_BAND}, key biases {key_b:.3e}", flush=True)
    if (not finite or rels_t[0][0] > INT8_GRAD_BAND or key_t > INT8_GRAD_BAND
            or rels_b[0][0] > QUANT_GRAD_BAND or key_b > QUANT_GRAD_BAND):
        raise AssertionError("int8 grads outside their bands")
    del g_k, g_t, g_b

    # --int8-dw (the int8 weight grads, dense): kernel path vs twin path
    dw = cfg.replace(int8_dw=True)
    ck.reset_launch_counts()
    g_k = _grads(params, images, labels, dw)
    ran = {k: v for k, v in ck.launch_counts().items() if v}
    with _int8_twins(ck):
        g_t = _grads(params, images, labels, dw)
    rels_dw, key_dw = _grad_distances(names, g_k, g_t)
    print(f"int8: --int8-dw grads (launches {ran}); worst |g_kernel - "
          f"g_twin| / |g_twin|: " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels_dw[:3])
          + f" <= {INT8_GRAD_BAND}, key biases {key_dw:.3e}", flush=True)
    if (ran != dict(layer_norm=1, layer_norm_bwd=1,
                    **dict.fromkeys(INT8_KERNELS[:2] + DW_KERNELS, 12))
            or not all(bool(torch.isfinite(g).all()) for g in g_k)
            or rels_dw[0][0] > INT8_GRAD_BAND or key_dw > INT8_GRAD_BAND):
        raise AssertionError("--int8-dw grads outside their band")
    del g_k, g_t

    runs = _time_steps(params, images, labels, (
        ("bf16 kernels", bf16), ("int8 kernels", cfg), ("int8-dw kernels", dw),
        ("int8-dw kernels", dw), ("int8 kernels", cfg), ("bf16 kernels", bf16),
        ("int8 twins", cfg, _int8_twins(ck))))
    return counts["--int8-grad"], {k: min(ms for n, ms in runs if n == k)
                                   for k, _ in runs}


# Phase 7: vitax's fast recipe (scripts/FT_CIFAR100_fast.sh: --int8-dw
# --token-keep 0.5 --token-keep-schedule 0.9 --batch-size 768
# --dense-batch-size 192); train_cli at b32 over one drop and one dense epoch
FAST_STEPS = 16
FAST_ARGS = [str(FAST_STEPS) if prev == "--train-steps" else a
             for prev, a in zip([None] + TRAIN_ARGS, TRAIN_ARGS)] + [
    "--int8-dw", "--token-keep", "0.5", "--token-keep-schedule", "0.5"]
# the recipe's own flags, cut to 1536 Synthetic images and 26 steps (a 500-
# step warmup needs a longer run): 2 steps of b768 an epoch, 8 of b192 in
# the dense tail, so 9 drop epochs and 1 dense (vitax's plan, train_cli's);
# its eval batches (b768, 153600 rows) take the handoff too, as vitax's
# auto gate does at >= 51200 rows
RECIPE_ARGS = ["--model-arch", "b16", "--image-size", "224", "--dataset",
               "Synthetic", "--synthetic-samples", "1536", "--num-classes",
               "100", "--num-workers", "4", "--seed", "0", "--lr", "0.03",
               "--wd", "0.0", "--warmup-steps", "2", "--train-steps", "26",
               "--int8-dw", "--token-keep", "0.5", "--token-keep-schedule",
               "0.9", "--batch-size", "768", "--dense-batch-size", "192"]


@contextlib.contextmanager
def _epoch_launches(ck, log):
    """Records the launches of each train and eval epoch of train_cli.main
    (its module-level train_epoch and valid_epoch, wrapped)."""
    from vitax_torch import train_cli
    saved = train_cli.train_epoch, train_cli.valid_epoch

    def wrap(kind, fn):
        def run(*a, **k):
            before = ck.launch_counts()
            out = fn(*a, **k)
            after = ck.launch_counts()
            log.append((kind, {n: after[n] - before[n] for n in after}))
            return out
        return run

    train_cli.train_epoch = wrap("train", saved[0])
    train_cli.valid_epoch = wrap("valid", saved[1])
    try:
        yield
    finally:
        train_cli.train_epoch, train_cli.valid_epoch = saved


def run_fast_recipe(exp_root):
    """Phase 7: `train_cli --int8-dw --token-keep 0.5 --token-keep-schedule
    0.5` at b32 (a drop epoch at spq 104 through K5, a dense epoch at spq 200
    through K3/K4, int8_dw backwards in both) with exact launch counts per
    epoch; logits and full-width grads of the handoff + int8_dw path against
    its twin path; device-timed steps at the recipe's batches."""
    import torch
    from vitax_torch import train_cli
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train import param_leaves
    from vitax_torch.utils.memory import named_leaves

    log = []
    ck.reset_launch_counts()
    with _epoch_launches(ck, log):
        losses, valid, rate = _run_train(FAST_ARGS + ["--exp-root", exp_root],
                                         steps=FAST_STEPS)
    counts = ck.launch_counts()
    steps, layers, evals = TRAIN_STEPS, 12, math.ceil(256 / TRAIN_BATCH)
    dw = dict(fused_ln_qkvo_attention_int8_dw_bwd=layers * steps,
              fused_ln_mlp_int8_dw_bwd=layers * steps)
    step = dict(layer_norm=steps, layer_norm_bwd=steps, **dw)
    drop = _expect(**step, fused_ln_qkvo_attention_int8_ho=layers * steps,
                   fused_ln_mlp_int8_ho=layers * steps)
    dense = _expect(**step, fused_ln_qkvo_attention_int8=layers * steps,
                    fused_ln_mlp_int8=layers * steps)
    evl = _expect(layer_norm=evals,
                  fused_ln_qkvo_attention_int8=layers * evals,
                  fused_ln_mlp_int8=layers * evals)
    expect = [("train", drop), ("valid", evl), ("train", dense),
              ("valid", evl)]
    print(f"fast: train_cli {' '.join(FAST_ARGS[-5:])} losses "
          f"{[round(v, 4) for v in losses]} valid {valid} {rate:.0f} img/s "
          "(dense epoch loop, host-fed); launches per epoch: " + "; ".join(
              f"{kind} {{{', '.join(f'{k}: {v}' for k, v in c.items() if v)}}}"
              for kind, c in log), flush=True)
    if log != expect or counts != {k: sum(c[k] for _, c in expect)
                                   for k in counts}:
        raise AssertionError(f"expected launches per epoch {expect}")
    # each int8_dw backward folds its two weight grads on gemm_sm90.cuh; the
    # dense epochs' K3 and K4 forwards and the drop epochs' K5 halves run
    # their products there too; no first-design piece launches
    counts.update(_check_s8("fast: train_cli", counts, first_design=True))

    # the recipe's own flags: K5 in every drop-phase step, int8_dw in every
    # backward, the dense tail at b192 through K3/K4
    recipe_log = []
    ck.reset_launch_counts()
    with _epoch_launches(ck, recipe_log):
        out = train_cli.main(RECIPE_ARGS + ["--exp-root", exp_root])
    shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)
    losses = [v for e in out["epochs"] for v in e["train"]["losses"]]

    def per_step(n, k5):
        fwd = ("fused_ln_qkvo_attention_int8_ho", "fused_ln_mlp_int8_ho") \
            if k5 else ("fused_ln_qkvo_attention_int8", "fused_ln_mlp_int8")
        return _expect(layer_norm=n, layer_norm_bwd=n,
                       **dict.fromkeys(fwd + DW_KERNELS, layers * n))

    recipe_eval = _expect(layer_norm=2, fused_ln_qkvo_attention_int8_ho=24,
                          fused_ln_mlp_int8_ho=24)
    expect = ([("train", per_step(2, True)), ("valid", recipe_eval)] * 9
              + [("train", per_step(8, False)), ("valid", recipe_eval)])
    print("fast: train_cli with the recipe's flags (" + " ".join(
        RECIPE_ARGS[-9:]) + f") {len(losses)} steps, losses finite "
          f"{all(map(math.isfinite, losses))}; img/s per epoch (host-fed) "
          + ", ".join(f"{e['train']['img_per_s']:.0f}" for e in out["epochs"])
          + f"; launches per epoch as expected {recipe_log == expect}",
          flush=True)
    if (recipe_log != expect or len(losses) != 26
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"the recipe's run: launches {recipe_log}")

    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True,
                      int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                      int8_attn_grad=True, int8_dw=True, token_keep=0.5)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    batch = next(iter(get_dataloader("Synthetic", split="train",
                                     image_size=224, batch_size=TRAIN_BATCH,
                                     num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda().bfloat16()
    labels = torch.from_numpy(batch.labels).cuda()
    with torch.inference_mode():
        ck.reset_launch_counts()
        lk = vit.apply(params, images, cfg, train=True,
                       gen=torch.Generator().manual_seed(3))
        if ck.launch_counts()["fused_ln_mlp_int8_ho"] != 12:
            raise AssertionError("the drop phase did not run K5")
        with _int8_twins(ck):
            lt = vit.apply(params, images, cfg, train=True,
                           gen=torch.Generator().manual_seed(3))
    d_t = (lk - lt).abs().max().item()
    band_t = LOGIT_BAND * max(1.0, lt.abs().max().item())
    print(f"fast: logits (keep 0.5, handoff) {tuple(lk.shape)} max|kernel - "
          f"twin| {d_t:.3e} <= {band_t:.3e}", flush=True)
    if not (torch.isfinite(lk).all() and d_t <= band_t):
        raise AssertionError("fast-recipe logits outside the bf16 band")
    names = [n for n, _ in named_leaves(params)]
    for p in param_leaves(params):
        p.requires_grad_(True)
    ck.reset_launch_counts()
    g_k = _grads(params, images, labels, cfg, seed=3)
    ran = {k: v for k, v in ck.launch_counts().items() if v}
    with _int8_twins(ck):
        g_t = _grads(params, images, labels, cfg, seed=3)
    rels, key_t = _grad_distances(names, g_k, g_t)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    print(f"fast: grads of {len(names)} tensors (launches {ran}); worst "
          f"|g_kernel - g_twin| / |g_twin|: " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels[:3])
          + f" <= {INT8_GRAD_BAND}, key biases {key_t:.3e}", flush=True)
    if (ran != dict(layer_norm=1, layer_norm_bwd=1,
                    **dict.fromkeys(HO_KERNELS + DW_KERNELS, 12))
            or not finite or rels[0][0] > INT8_GRAD_BAND
            or key_t > INT8_GRAD_BAND):
        raise AssertionError("fast-recipe grads outside their band")
    del g_k, g_t

    # device-timed steps on a resident batch at the recipe's own batches:
    # b768 in the drop phase, b192 in the dense tail; int8_dw against the
    # int8_grad backward, in turns
    g = torch.Generator(device="cuda").manual_seed(5)
    grad_tier = dict(int8_dw=False)
    times = {}
    for b, keep, iters in ((768, 0.5, 5), (192, 1.0, 10)):
        imgs = torch.randn((b, 224, 224, 3), generator=g, device="cuda",
                           dtype=torch.bfloat16)
        labs = torch.randint(0, 10, (b,), generator=g, device="cuda")
        c = cfg.replace(token_keep=keep)
        runs = _time_steps(params, imgs, labs, (
            ("int8-dw", c), ("int8-grad", c.replace(**grad_tier)),
            ("int8-grad", c.replace(**grad_tier)), ("int8-dw", c)),
            iters=iters)
        for name in ("int8-dw", "int8-grad"):
            times[f"b{b} keep {keep} {name}"] = min(
                ms for n, ms in runs if n == name)
        del imgs, labs
        torch.cuda.empty_cache()
    return counts, times


# Phase 8: Res-ViT serving with scripts/ft_resvit.sh's model flags
RESVIT_ARGS = ["--model-arch", "b16", "--image-size", "224", "--dataset",
               "Synthetic", "--synthetic-samples", "256", "--batch-size",
               "64", "--num-workers", "4", "--seed", "0", "--use_lora",
               "True", "--lora_rank", "48", "--use_reslr", "True",
               "--block_size", "4", "--dynamic_start_layer", "1",
               "--dynamic_reserve_initials", "2", "--dynamic_active_target",
               "0.4"]
RESVIT_LAYERS, RESVIT_ROUTERS = 12, 3  # routers at layers 1, 5 and 9


@contextlib.contextmanager
def _random_router_biases():
    """resvit.init_params with each router's final bias drawn from ±0.3
    (`randomize_router_biases`): the init's keep bias 5.0 would route every
    token active, and compaction would then test only overflow."""
    from vitax_torch.models import resvit
    from vitax_torch.scripts.profile_resvit import randomize_router_biases
    init = resvit.init_params

    def randomized(gen, cfg, device="cpu"):
        params = init(gen, cfg, device)
        randomize_router_biases(params)
        return params

    resvit.init_params = randomized
    try:
        yield
    finally:
        resvit.init_params = init


def _run_resvit_eval(args):
    from vitax_torch import resvit_eval_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        result = resvit_eval_cli.main(args)
    m = re.search(r"\((\d+) images in ([\d.]+)s, (\d+) img/s\)",
                  buf.getvalue())
    if m is None or int(m.group(1)) != 256:
        raise AssertionError("resvit_eval_cli did not report 256 images")
    for k in ("loss", "acc1", "acc5", "non_low_rank_ratio",
              "router_entropy"):
        if not math.isfinite(result[k]):
            raise AssertionError(f"res-vit eval metric {k} = {result[k]}")
    return result, float(m.group(3))


class _RouterLog:
    """Records router_forward's outputs on one path and replays them, in
    order, on another (tests/test_resvit_compact.py's forced router)."""

    def __init__(self, resvit):
        self.resvit, self.real, self.calls = resvit, resvit.router_forward, []

    @contextlib.contextmanager
    def record(self):
        def rec(*a, **k):
            out = self.real(*a, **k)
            self.calls.append(out)
            return out
        self.resvit.router_forward = rec
        try:
            yield
        finally:
            self.resvit.router_forward = self.real

    @contextlib.contextmanager
    def replay(self):
        calls = iter(self.calls)
        self.resvit.router_forward = lambda *a, **k: next(calls)
        try:
            yield
        finally:
            self.resvit.router_forward = self.real


def run_resvit_slice():
    """Phase 8: resvit_eval_cli dense, compacted, --int8, GQA and plain with
    exact launch counts; routing maps and replayed-routing logits against
    the plain path; device-timed forwards at b64."""
    import torch
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import resvit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.resvit_eval_cli import get_eval_config
    from vitax_torch.resvit_train_cli import config_to_model_args

    batches = math.ceil(256 / 64)
    layers, routers = RESVIT_LAYERS, RESVIT_ROUTERS
    ln_bf16 = (routers + 1 + layers) * batches  # routers, final norm, MLPs
    ln_int8 = (routers + 1) * batches  # the MLP halves are K4's
    compact = ["--compact-capacity", "0.625"]
    bf16 = dict(layer_norm=ln_bf16)
    int8 = dict(layer_norm=ln_int8, fused_ln_mlp_int8=layers * batches)
    # a compacted model: the plain layer 0 takes the square kernel, the 11
    # routed layers the rect one
    rect = dict(fused_ln_qkvo_attention=batches,
                fused_ln_qkvo_attention_rect=(layers - 1) * batches)
    rect8 = dict(fused_ln_qkvo_attention_int8=batches,
                 fused_ln_qkvo_attention_rect_int8=(layers - 1) * batches)
    runs = [
        ("dense", [], _expect(**bf16,
                              fused_ln_qkvo_attention=layers * batches)),
        ("dense --int8", ["--int8"], _expect(
            **int8, fused_ln_qkvo_attention_int8=layers * batches)),
        ("compact 0.625", compact, _expect(**bf16, **rect)),
        ("compact 0.625 --int8", compact + ["--int8"],
         _expect(**int8, **rect8)),
        ("compact 0.5", ["--compact-capacity", "0.5"],
         _expect(**bf16, **rect)),
        ("compact 0.5 --int8", ["--compact-capacity", "0.5", "--int8"],
         _expect(**int8, **rect8)),
        ("compact 0.625 --n_kv_heads 4", compact + ["--n_kv_heads", "4"],
         _expect(**bf16, fused_ln_qkvo_attention_gqa=layers * batches)),
        ("plain", ["--no-pallas", "--no-fused-qkv"], _expect()),
    ]
    counts, rates, results = {}, {}, {}
    with _random_router_biases():
        for label, extra, expect in runs:
            ck.reset_launch_counts()
            result, rate = _run_resvit_eval(RESVIT_ARGS + extra)
            counts[label] = ck.launch_counts()
            rates[label], results[label] = rate, result
            print(f"resvit: resvit_eval_cli {label}: acc1 {result['acc1']:.4f}"
                  f" loss {result['loss']:.4f} active "
                  f"{result['non_low_rank_ratio']:.4f} entropy "
                  f"{result['router_entropy']:.4f}; {rate:.0f} img/s "
                  "(host-fed); launches {" + ", ".join(
                      f"{k}: {v}" for k, v in counts[label].items() if v)
                  + "}", flush=True)
            if counts[label] != expect:
                raise AssertionError(f"expected launches {expect}")
            # every run but GQA's (K7's forward keeps the first design)
            # launches no first-design piece: K1, K2, K3, K4 and K8 in both
            # tiers
            _check_s8(f"resvit_eval_cli {label}", counts[label],
                      first_design="--n_kv_heads" not in label)

        cfg = config_to_model_args(get_eval_config(RESVIT_ARGS), "cuda")
        params = resvit.init_params(set_seed(0), cfg, "cuda")
    plain = cfg.replace(fused_qkv=False, fused_qkvo=False, fused_mlp=False,
                        use_pallas=False)
    batch = next(iter(get_dataloader("Synthetic", split="val", image_size=224,
                                     batch_size=64, num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda().bfloat16()
    log = _RouterLog(resvit)
    agree = {}
    with torch.inference_mode():
        for label, c in (("dense", cfg),
                         ("compact 0.625", cfg.replace(compact_capacity=0.625))):
            _, aux_k = resvit.apply(params, images, c)
            _, aux_p = resvit.apply(params, images, plain.replace(
                compact_capacity=c.compact_capacity))
            same = [(aux_k["routing_maps"][b] == aux_p["routing_maps"][b])
                    .float().mean().item() for b in aux_k["routing_maps"]]
            agree[label] = sum(same) / len(same)
        c = cfg.replace(compact_capacity=0.625)
        log.calls.clear()
        with log.record():
            lk, aux = resvit.apply(params, images, c)
        with log.replay():
            lp, _ = resvit.apply(params, images, plain.replace(
                compact_capacity=0.625))
        with log.replay():
            l32, _ = resvit.apply(params, images.float(), plain.replace(
                compact_capacity=0.625, dtype=torch.float32))
    diff = (lk - lp).abs().max().item()
    band = LOGIT_BAND * max(1.0, lp.abs().max().item())
    active = aux["acts"][:, 2:, 1:].mean().item()
    print("resvit: routing maps, kernel path vs plain path, share of keep "
          "bits that agree: " + ", ".join(f"{k} {v:.5f}"
                                          for k, v in agree.items())
          + f"; compact 0.625 with the kernel path's routing replayed on the "
          f"plain path: logits {tuple(lk.shape)} max|kernel - plain_bf16| "
          f"{diff:.3e} <= {band:.3e}, max|kernel - fp32| "
          f"{(lk - l32).abs().max().item():.3e}, max|plain_bf16 - fp32| "
          f"{(lp - l32).abs().max().item():.3e}; active share of the routed "
          f"layers {active:.4f}", flush=True)
    if not (torch.isfinite(lk).all() and diff <= band):
        raise AssertionError("res-vit kernel-path logits outside the band")
    if min(agree.values()) < 0.9:
        raise AssertionError(f"routing maps agree on {agree} only")

    # device-timed forward on a resident batch: the eval rate above also
    # counts the host loader
    tier8 = dict(int8_attn=True, int8_mlp=True, fused_mlp=True)
    gqa_cfg = cfg.replace(n_kv_heads=4)
    with _random_router_biases():
        gqa_params = resvit.init_params(set_seed(0), gqa_cfg, "cuda")
    paths = [("dense", cfg, params), ("dense --int8", cfg.replace(**tier8),
                                      params)]
    for cap in (0.625, 0.5):
        c = cfg.replace(compact_capacity=cap)
        paths += [(f"compact {cap}", c, params),
                  (f"compact {cap} --int8", c.replace(**tier8), params)]
    paths += [("compact 0.625 --n_kv_heads 4",
               gqa_cfg.replace(compact_capacity=0.625), gqa_params),
              ("plain dense", plain, params)]
    fwd = {}
    with torch.inference_mode():
        for label, c, p in paths:
            fwd[label] = _median_ms(lambda: resvit.apply(p, images, c),
                                    warmup=2, iters=10)
    print("resvit: forward b64 (median of 10, CUDA events): " + ", ".join(
        f"{k} {ms:.2f} ms = {64e3 / ms:.0f} img/s" for k, ms in fwd.items()),
        flush=True)
    return counts, rates, fwd


# Phase 9: Res-ViT training with scripts/ft_resvit.sh's model and loss flags
RESVIT_MODEL = ["--model-arch", "b16", "--image-size", "224", "--use_lora",
                "True", "--lora_rank", "48", "--use_reslr", "True",
                "--block_size", "4", "--dynamic_start_layer", "1",
                "--dynamic_reserve_initials", "2", "--dynamic_active_target",
                "0.4"]
RESVIT_TRAIN_ARGS = RESVIT_MODEL + [
    "--dataset", "Synthetic", "--num-workers", "4", "--seed", "0", "--lr",
    "1e-4", "--wd", "0.05", "--lr-scheduler", "cosine_with_warmup",
    "--warmup-steps", "2", "--initial-lambda-active", "10",
    "--initial-lambda-distill", "1", "--print-freq", "1"]
COMPACT = ["--compact-capacity", "0.625"]
# (label, batch, steps, flags): one epoch of `steps` full batches each
RESVIT_TRAIN_RUNS = [
    ("(a) ft_resvit.sh", 32, 4, ["--save-routing-viz"]),
    ("(b) compact 0.625, warmup 2", 32, 4, COMPACT + ["--compact-warmup",
                                                      "2"]),
    ("(c) ft_resvit_fast.sh", 192, 3, ["--int8-dw"] + COMPACT + [
        "--compact-warmup", "2", "--token-keep", "0.5"]),
    ("(d) --int8-grad compact", 32, 4, ["--int8-grad"] + COMPACT + [
        "--compact-warmup", "0"]),
    ("(e) --n_kv_heads 4 compact", 32, 4, ["--n_kv_heads", "4"] + COMPACT + [
        "--compact-warmup", "0"]),
    ("(f) plain", 32, 2, ["--no-pallas", "--no-fused-qkv"]),
]
RESVIT_LAMBDAS = (1.0, 10.0, 1.0)  # λc, λa, λd of ft_resvit.sh


def _resvit_launches(cfg, train):
    """The launches of one Res-ViT train step (teacher + student forward,
    the student's backward) or eval forward at `cfg`, derived from its layer
    roles: the plain layers and the block heads' routers, each routed
    layer's student (K8 on the compacted rows, else the square kernel) and,
    in training, its teacher (the square kernel, forward only); every MLP
    half through K4 on the int8 tier, K2 with --fused-mlp, else the LN
    kernel, and under --save-acts the student's through K12 (the teacher
    keeps no graph: K2's or K4's forward); the routers' and the final norm's
    LN. Without fused_qkvo each attention half is the LN kernel and K10 (its
    backward in the student's backward), the teacher's too."""
    from collections import Counter
    from vitax_torch.models import resvit
    if cfg.use_pallas is False:
        return _expect()
    roles = resvit.layer_roles(cfg)
    plain = sum(not r["routed"] for r in roles)
    routed = len(roles) - plain
    routers = sum(bool(r.get("is_block_head")) for r in roles)
    if not cfg.fused_qkv:
        return _k13_resvit_launches(plain, routed, routers, train)
    gqa = (cfg.n_kv_heads or cfg.n_heads) != cfg.n_heads
    # fused_qkv without fused_qkvo: vitax's `attention` (vitax/models/
    # resvit.py:278) runs every attention half, the compacted blocks' on all
    # rows, as the LN kernel and K10, whatever int8_attn says (no GQA here:
    # vitax's fused branch declines it)
    k10 = not cfg.fused_qkvo
    if k10 and gqa:
        raise ValueError("no K10 with GQA: vitax runs its plain attention")
    int8 = cfg.int8_attn
    grad8 = int8 and cfg.int8_attn_grad
    # vitax's int4 dispatch (vitax/models/resvit.py:340-415): int4_attn
    # picks the A4W4 forward, its backward A4W4 only under int8_grad and
    # int4_grad; int4_mlp the A4W4 MLP half ahead of save-acts and int8,
    # its backward A4W4 under int4_grad
    int4, grad4 = cfg.int4_attn, grad8 and cfg.int4_grad and cfg.int4_attn
    rect = cfg.compact_capacity is not None and not gqa and not k10
    base = "fused_ln_qkvo_attention"
    tier = "_int4" if int4 else "_int8"
    gq = f"{base}{tier}_gqa" if gqa else f"{base}{tier}"
    attn = gq if int8 or int4 else f"{base}_gqa" if gqa else base
    gb = f"{base}_int4_gqa" if gqa and grad4 else f"{base}_int4" if grad4 \
        else f"{base}_int8_gqa" if gqa else f"{base}_int8"
    attn_bwd = (f"{gb}_dw_bwd" if grad8 and cfg.int8_dw
                else f"{gb}_bwd" if grad8
                else f"{base}_gqa_bwd" if gqa else f"{base}_bwd")
    rect_fwd = (f"{base}_rect{tier}" if int8 or int4 else f"{base}_rect")
    rb = f"{base}_rect_int4" if grad4 else f"{base}_rect_int8"
    rect_bwd = (f"{rb}_dw_bwd" if grad8 and cfg.int8_dw
                else f"{rb}_bwd" if grad8 else f"{base}_rect_bwd")
    if k10:
        attn, attn_bwd = "fused_qkv_attention", "fused_qkv_attention_bwd"
    mlp4 = cfg.fused_mlp and cfg.int4_mlp
    mlp8 = cfg.fused_mlp and cfg.int8_mlp and not mlp4
    save = cfg.fused_mlp and cfg.fused_mlp_save and not mlp4 and (
        not mlp8 or cfg.int8_mlp_grad)
    mlp_fwd = ("fused_ln_mlp_int4" if mlp4 else "fused_ln_mlp_int8" if mlp8
               else "fused_ln_mlp" if cfg.fused_mlp else "layer_norm")
    mlp_bwd = ("layer_norm_bwd" if not cfg.fused_mlp
               else "fused_ln_mlp_int4_dw_bwd" if mlp4 and cfg.int4_grad
               and cfg.int8_dw
               else "fused_ln_mlp_int4_bwd" if mlp4 and cfg.int4_grad
               else "fused_ln_mlp_int8_dw_bwd" if mlp4 and cfg.int8_mlp_grad
               and cfg.int8_dw
               else "fused_ln_mlp_int8_bwd" if mlp4 and cfg.int8_mlp_grad
               else "fused_ln_mlp_bwd" if mlp4
               else "fused_ln_mlp_bwd_fast" if save and not mlp8
               else "fused_ln_mlp_int8_save_dw_bwd" if save and cfg.int8_dw
               else "fused_ln_mlp_int8_save_bwd" if save
               else "fused_ln_mlp_int8_dw_bwd" if mlp8 and cfg.int8_mlp_grad
               and cfg.int8_dw else "fused_ln_mlp_int8_bwd"
               if mlp8 and cfg.int8_mlp_grad else "fused_ln_mlp_bwd")
    c = Counter()
    c[attn] += plain + (0 if rect else routed)
    c[rect_fwd] += routed if rect else 0
    student, teacher = plain + routed, (routed if train else 0)
    if train and save:
        c["fused_ln_mlp_int8_save" if mlp8 else "fused_ln_mlp_save"] += student
        c[mlp_fwd] += teacher
    else:
        c[mlp_fwd] += student + teacher
    c["layer_norm"] += routers + 1 + (student + teacher if k10 else 0)
    if train:
        c[attn] += routed  # the teacher
        c[attn_bwd] += plain + (0 if rect else routed)
        c[rect_bwd] += routed if rect else 0
        c[mlp_bwd] += plain + routed
        c["layer_norm_bwd"] += routers + 1 + (student if k10 else 0)
    return _expect(**{k: v for k, v in c.items() if v})


def _k13_resvit_launches(plain, routed, routers, train, compact=False):
    """The launches of a Res-ViT forward (or train step) with the fused
    attention half off and the kernels on (--no-fused-qkv, bf16): each
    layer's attention half is the LN kernel, plain projections and K13,
    its MLP half the LN kernel and the plain FFN; the routers' and the final
    norm's LN. A train step adds the teacher's routed layers (forward) and
    the student's backwards. The same with the legacy compaction
    (apply_compact), whose routed layers run their attention in plain ops
    (Q from the kept rows): K13 in the plain layers only."""
    layers = plain + routed
    if train:
        return _expect(flash_attention=layers + routed,
                       layer_norm=2 * (layers + routed) + routers + 1,
                       flash_attention_bwd=layers,
                       layer_norm_bwd=2 * layers + routers + 1)
    return _expect(flash_attention=plain if compact else layers,
                   layer_norm=2 * layers + routers + 1)


@contextlib.contextmanager
def _step_launches(ck, log):
    """Records the launches of every train step and eval forward that
    resvit_train_cli.main runs (its step factories, wrapped), with the
    config each one ran."""
    from vitax_torch import resvit_train_cli as cli
    saved = cli.make_train_step, cli.make_eval_step

    def wrap(kind, factory):
        def make(cfg, *a, **k):
            fn = factory(cfg, *a, **k)

            def run(*args, **kw):
                before = ck.launch_counts()
                out = fn(*args, **kw)
                after = ck.launch_counts()
                log.append((kind, cfg, {n: after[n] - before[n]
                                        for n in after}))
                return out
            return run
        return make

    cli.make_train_step = wrap("train", saved[0])
    cli.make_eval_step = wrap("eval", saved[1])
    try:
        yield
    finally:
        cli.make_train_step, cli.make_eval_step = saved


class _RoutingReplay:
    """Records router_forward's decisions on one path and replays them on
    another with the other path's own gradients: the replayed hard and soft
    routing are t − t.detach() + the recorded t (this path's gradient, the
    recorded value), the path ids the recorded ones. So two paths route
    every token alike, and compaction ranks the overflow of a capacity by
    the same keep scores (bf16 noise in the soft probabilities would move
    which tokens near the cut are demoted, and with them the approximators'
    grads)."""

    def __init__(self, resvit):
        self.resvit, self.real, self.calls = resvit, resvit.router_forward, []

    @contextlib.contextmanager
    def record(self):
        def rec(*a, **k):
            out = self.real(*a, **k)
            self.calls.append((out[0].detach(), out[1], out[3].detach()))
            return out
        self.resvit.router_forward = rec
        try:
            yield
        finally:
            self.resvit.router_forward = self.real

    @contextlib.contextmanager
    def replay(self):
        calls = iter(self.calls)

        def rep(*a, **k):
            hard, _, ent, soft, rows = self.real(*a, **k)
            h, ids, sp = next(calls)
            return (hard - hard.detach() + h, ids, ent,
                    soft - soft.detach() + sp, rows)
        self.resvit.router_forward = rep
        try:
            yield
        finally:
            self.resvit.router_forward = self.real


def _train_noise(cfg, batch, seed):
    """Gumbel noise for every block head and, at token_keep < 1, the kept
    token positions (pins first), drawn on the card, to inject into both
    paths of a grad comparison."""
    import torch
    from vitax_torch.models import resvit
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = cfg.num_patches + 1
    noise = {}
    if cfg.token_keep < 1.0:
        pins = max(1, cfg.dynamic_reserve_initials)
        k = int(round(cfg.token_keep * (n - pins)))
        rnd = torch.rand((batch, n - pins), generator=g, device="cuda")
        kept = torch.sort(torch.argsort(rnd, dim=1)[:, :k], dim=1).values
        noise["token_idx"] = torch.cat(
            [torch.arange(pins, device="cuda").expand(batch, pins),
             kept + pins], dim=1)
        n = pins + k
    noise["gumbel"] = {
        lid: -torch.log(torch.empty((batch, n, cfg.block_size, 2),
                                    device="cuda").exponential_(generator=g))
        for lid, r in enumerate(resvit.layer_roles(cfg))
        if r.get("is_block_head")}
    return noise


def _resvit_grads(params, images, labels, cfg, noise, ctx, mesh=None):
    """(logits, grads of the 3-term loss for every trainable leaf) of one
    train-mode forward with `noise` injected, under `ctx` (routing record or
    replay), under `mesh` (a one-rank one: the loss is the one process's)."""
    import torch
    from vitax_torch.models import resvit
    from vitax_torch.train.optim import param_leaves, tree_leaves
    from vitax_torch.train.steps import cross_entropy
    leaves = [t for t, m in zip(param_leaves(params), tree_leaves(
        resvit.trainable_mask(params, cfg))) if m]
    lc, la, ld = RESVIT_LAMBDAS
    with ctx:
        logits, aux = resvit.apply(params, images, cfg, train=True,
                                   noise=noise, mesh=mesh)
    loss = (lc * cross_entropy(logits, labels) + la * resvit.active_loss(
        aux["soft_probs"], cfg.dynamic_active_target,
        cfg.dynamic_reserve_initials) + ld * aux["d_loss"])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return logits.detach(), [torch.zeros_like(t, dtype=torch.float32)
                             if g is None else g.float()
                             for t, g in zip(leaves, grads)]


def run_resvit_train_slice(exp_root):
    """Phase 9: resvit_train_cli (a)-(f) with exact launch counts per step
    and per eval batch; full-width grads of (a), (b), (c) and (e) against
    the plain or twin path with the same noise and routing; device-timed
    train steps of (a)-(e) on a resident batch."""
    import torch
    from vitax_torch import resvit_train_cli
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import resvit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train.optim import param_leaves, tree_leaves
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_train_step)
    from vitax_torch.utils.memory import named_leaves

    counts, results = {}, {}
    with _random_router_biases():
        for label, batch, steps, extra in RESVIT_TRAIN_RUNS:
            log = []
            args = RESVIT_TRAIN_ARGS + extra + [
                "--batch-size", str(batch), "--synthetic-samples",
                str(batch * steps), "--train-steps", str(steps),
                "--exp-root", exp_root]
            ck.reset_launch_counts()
            with _step_launches(ck, log), \
                    contextlib.redirect_stdout(io.StringIO()):
                out = resvit_train_cli.main(args)
            counts[label] = ck.launch_counts()
            train_log = [e for e in log if e[0] == "train"]
            bad = [(kind, {k: v for k, v in got.items() if v})
                   for kind, c, got in log
                   if got != _resvit_launches(c, kind == "train")]
            viz = len(list(__import__("pathlib").Path(
                out["result_dir"]).glob("routing_viz/*.png")))
            valid = out["epochs"][-1]
            phases = [("warm" if c.compact_capacity is None
                       and "--compact-capacity" in extra else
                       f"C {c.compact_capacity}" if c.compact_capacity
                       else "dense") + (f" keep {c.token_keep}"
                                        if c.token_keep < 1 else "")
                      for _, c, _ in train_log]
            print(f"resvit-train: {label} b{batch}: steps {phases}; valid "
                  f"acc1 {valid['acc1']:.4f} loss {valid['loss']:.4f} active "
                  f"{valid['non_low_rank_ratio']:.4f}; launches a step as "
                  f"derived: {not bad} (" + "; ".join(
                      "{" + ", ".join(f"{k}: {v}" for k, v in got.items() if v)
                      + "}" for _, _, got in train_log[-1:]) + ")"
                  + (f"; routing viz {viz} PNGs" if viz else ""), flush=True)
            shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)
            if label.startswith(("(b)", "(c)", "(d)")):
                # the compacted bf16 run and the int8 tiers' runs: the s8
                # products by kind against the launches, and no
                # first-design piece (K8 in both tiers, K1, K2, K3, K4 on
                # the Hopper designs)
                _check_s8(f"resvit_train_cli {label}", counts[label],
                          first_design=True)
            results[label] = valid
            if (bad or len(train_log) != steps
                    or not all(math.isfinite(v) for v in valid.values())):
                raise AssertionError(f"{label}: launches {bad}, "
                                     f"{len(train_log)} steps, valid {valid}")
            if extra == ["--save-routing-viz"] and viz == 0:
                raise AssertionError("no routing visualization written")

        from vitax_torch.resvit_train_cli import (config_to_model_args,
                                                  get_train_config)
        base = config_to_model_args(get_train_config(
            RESVIT_TRAIN_ARGS + ["--exp-root", exp_root]), "cuda")
        params = resvit.init_params(set_seed(0), base, "cuda")
        gqa = base.replace(n_kv_heads=4)
        gqa_params = resvit.init_params(set_seed(0), gqa, "cuda")
    shutil.rmtree(exp_root, ignore_errors=True)
    tier = dict(int8_attn=True, int8_mlp=True, fused_mlp=True,
                int8_attn_grad=True, int8_mlp_grad=True)
    plain = dict(fused_qkv=False, fused_qkvo=False, fused_mlp=False,
                 use_pallas=False)
    cfgs = {
        "(a)": (base, params, 32),
        "(b)": (base.replace(compact_capacity=0.625), params, 32),
        "(c)": (base.replace(**tier, int8_dw=True, compact_capacity=0.625,
                             token_keep=0.5), params, 192),
        "(d)": (base.replace(**tier, compact_capacity=0.625), params, 32),
        "(e)": (gqa.replace(compact_capacity=0.625), gqa_params, 32),
    }
    for p in (params, gqa_params):
        for t, m in zip(param_leaves(p), tree_leaves(
                resvit.trainable_mask(p, base))):
            t.requires_grad_(m)

    # full-width grads against the plain path (bf16) or the twin path (int8)
    g = torch.Generator(device="cuda").manual_seed(7)
    grad_rows = []
    for key, band in (("(a)", GRAD_BAND), ("(b)", GRAD_BAND),
                      ("(c)", INT8_GRAD_BAND), ("(e)", GRAD_BAND)):
        cfg, p, batch = cfgs[key]
        batch = min(batch, 64)
        images = torch.randn((batch, 224, 224, 3), generator=g, device="cuda",
                             dtype=torch.bfloat16)
        labels = torch.randint(0, 10, (batch,), generator=g, device="cuda")
        noise = _train_noise(cfg, batch, seed=11)
        replay = _RoutingReplay(resvit)
        ck.reset_launch_counts()
        lk, g_k = _resvit_grads(p, images, labels, cfg, noise,
                                replay.record())
        ran = {k: v for k, v in ck.launch_counts().items() if v}
        if key == "(c)":
            with _int8_twins(ck):
                lo, g_o = _resvit_grads(p, images, labels, cfg, noise,
                                        replay.replay())
            other = "int8 twin"
        else:
            lo, g_o = _resvit_grads(p, images, labels, cfg.replace(**plain),
                                    noise, replay.replay())
            other = "plain bf16"
        names = [n for (n, _), m in zip(named_leaves(p), tree_leaves(
            resvit.trainable_mask(p, cfg))) if m]
        rels = sorted(((_rel(a, b), n) for a, b, n in zip(g_k, g_o, names)
                       if b.norm() > 0), reverse=True)
        d_log = (lk - lo).abs().max().item()
        finite = all(bool(torch.isfinite(t).all()) for t in g_k)
        print(f"resvit-train: grads {key} b{batch} of {len(names)} trainable "
              f"tensors (kernel launches {ran}); worst |g_kernel - g_{other}|"
              f" / |g_{other}|: " + ", ".join(
                  f"{r:.3e} ({n})" for r, n in rels[:3])
              + f" <= {band}; logits max|kernel - {other}| {d_log:.3e}",
              flush=True)
        grad_rows.append((key, rels[0][0]))
        if not finite or rels[0][0] > band or not ran:
            raise AssertionError(f"{key}: grads outside the band")
        del g_k, g_o, images
        torch.cuda.empty_cache()

    # device-timed train steps (forward teacher + student, backward, AdamW)
    # on a resident batch
    step_ms = {}
    lam = Lambdas(*RESVIT_LAMBDAS)
    for key, (cfg, p, batch) in cfgs.items():
        images = torch.randn((batch, 224, 224, 3), generator=g, device="cuda",
                             dtype=torch.bfloat16)
        labels = torch.randint(0, 10, (batch,), generator=g, device="cuda")
        tx = make_adamw_for(cfg, p, lambda s: 1e-4)
        state = create_state(p, tx, torch.Generator(device="cuda")
                             .manual_seed(3))
        step = make_train_step(cfg, tx, lam)
        step_ms[key] = _median_ms(lambda: step(state, images, labels),
                                  warmup=2, iters=5)
        del images, labels, tx, state
        torch.cuda.empty_cache()
    print("resvit-train: step (teacher + student forward, backward, AdamW; "
          "median of 5, CUDA events): " + ", ".join(
              f"{k} b{cfgs[k][2]} {ms:.2f} ms = "
              f"{cfgs[k][2] * 1e3 / ms:.0f} img/s"
              for k, ms in step_ms.items()), flush=True)
    return counts, step_ms, grad_rows


# ---------------------------------------------------------------- phase 11
# K13, the standalone attention core, against its twin: (label, batch,
# heads, seq, head_dim, memory layout). train_cli's b32 seq 197 in the
# einsums' [B, S, H, Hd] memory and in vitax's [B, H, S, Hd]; eval_cli's
# default 384 px (b64 seq 577); H/14 at 384 (hd 80, seq 730); seq 1024 at
# hd 128; hd 40 (zero-padded to 48) and 48; a ragged seq 21 (the last query
# and key tiles run past the tensor)
K13_CASES = [("b32 S197 (train_cli)", 32, 12, 197, 64, "bshd"),
             ("b32 S197 [B,H,S,Hd]", 32, 12, 197, 64, "bhsd"),
             ("b64 S577 (eval_cli)", 64, 12, 577, 64, "bshd"),
             ("b8 S730 hd80 (H/14)", 8, 16, 730, 80, "bshd"),
             ("b2 S1024 hd128", 2, 8, 1024, 128, "bhsd"),
             ("b8 S197 hd40", 8, 12, 197, 40, "bshd"),
             ("b8 S197 hd48", 8, 12, 197, 48, "bshd"),
             ("b2 S21 (ragged)", 2, 3, 21, 64, "bshd"),
             ("b4 S65 [B,H,S,Hd] (one key in the last tile)", 4, 12, 65, 64,
              "bhsd")]
K13_FWD_TIMED = ("b64 S577 (eval_cli)", "b32 S197 (train_cli)")
K13_BWD_TIMED = "b32 S197 (train_cli)"
# K7's int8 tier at Res-ViT serving's b64 spq 200 with 4 kv heads
INT8_GQA_CASE = ("b64 spq200 kv4", 64, 200, 197, 4)


def _k13_inputs(batch, heads, seq, hd, layout, seed):
    """q, k, v, dO: [B, H, S, Hd] views of bf16 memory in `layout`."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, seq, heads, hd) if layout == "bshd" else \
        (batch, heads, seq, hd)
    ts = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
          for _ in range(4)]
    return [t.transpose(1, 2) if layout == "bshd" else t for t in ts]


def _batch_ms(fn, launches=50):
    """Device time of one call: CUDA events around `launches` back-to-back
    calls, over their count (the host queues ahead of the card, so what a
    call costs the host between launches does not count, as it does in
    _median_ms's synchronised single calls)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def _k13_in_turns(kernel, library):
    """(kernel ms, library ms), each the lower of two _batch_ms turns taken
    in the order kernel, library, library, kernel."""
    turns = [_batch_ms(f) for f in (kernel, library, library, kernel)]
    return min(turns[0], turns[3]), min(turns[1], turns[2])


def check_core_kernels(stats):
    """Phase 11, kernels: K13 forward and every output of its backward
    against the twins at K13_CASES (TOL), timed with the twin and
    scaled_dot_product_attention at the main paths' shapes; K7's int8 tier
    (forward, int8_grad and int8_dw backwards) against its twins as phase 3
    holds K3 (codes, INT8_REL, the bf16 stand-in), timed."""
    import torch
    import torch.nn.functional as F
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.scripts.turns import k6_checksum
    for name in K13_KERNELS + INT8_GQA_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, b, h, seq, hd, layout) in enumerate(K13_CASES):
        q, k, v, do = _k13_inputs(b, h, seq, hd, layout, seed=40 + i)
        with torch.no_grad():
            out = ck.flash_attention_bhsd(q, k, v)
            grads = ck.flash_attention_bwd(q, k, v, out, do)
            torch.cuda.synchronize()
            pairs = [("flash_attention", out,
                      ck.flash_attention_bhsd_ref(q, k, v))]
            pairs += [("flash_attention_bwd", g, r) for g, r in zip(
                grads, ck.flash_attention_bwd_ref(q, k, v, out, do))]
        errs = []
        for name, o, r in pairs:
            err = (o.float() - r.float()).abs().max().item()
            bound = TOL * max(1.0, r.float().abs().max().item())
            if not (bool(torch.isfinite(o).all()) and err <= bound):
                raise AssertionError(f"{name} {label}: max error {err} "
                                     f"exceeds {bound}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            errs.append(f"{err:.3e}/{bound:.3e}")
        print(f"  K13 {label:45s} max|k-ref| out, dq, dk, dv "
              f"{' '.join(errs)}: ok", flush=True)
        timed = []
        if label in K13_FWD_TIMED:
            with torch.no_grad():
                k_ms, lib = _k13_in_turns(
                    lambda: ck.flash_attention_bhsd(q, k, v),
                    lambda: F.scaled_dot_product_attention(q, k, v))
                p_ms = _median_ms(lambda: ck.flash_attention_bhsd_ref(q, k, v),
                                  warmup=1, iters=5)
            timed.append(("flash_attention", k_ms, p_ms, lib))
        if label == K13_BWD_TIMED:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*leaves)
            with torch.no_grad():
                k_ms, lib = _k13_in_turns(
                    lambda: ck.flash_attention_bwd(q, k, v, out, do),
                    lambda: torch.autograd.grad(lib_out, leaves, do,
                                                retain_graph=True))
                p_ms = _median_ms(lambda: ck.flash_attention_bwd_ref(
                    q, k, v, out, do), warmup=1, iters=5)
            timed.append(("flash_attention_bwd", k_ms, p_ms, lib))
            del leaves, lib_out
        for name, k_ms, p_ms, lib in timed:
            bound_ms, bound_by = _bound(name, (b, seq))
            if label in (K13_FWD_TIMED[0], K13_BWD_TIMED):
                stats[name].update(ms=k_ms, plain_ms=p_ms, library_ms=lib,
                                   shape=(b, seq))
            print(f"  {name:20s} {label:22s} kernel {k_ms:.4f} ms "
                  f"({100 * bound_ms / k_ms:.1f} % of its bound {bound_ms:.4f}"
                  f" by {bound_by}), scaled_dot_product_attention {lib:.4f} "
                  f"ms (lower of two turns each, events around 50 launches); "
                  f"plain {p_ms:.4f} ms (median)", flush=True)
        del q, k, v, do, out, grads, pairs
        torch.cuda.empty_cache()

    # K6's bits must not move with K13's kernels: the same line on the
    # parent commit (vitax_torch/scripts/turns.py runs it for any
    # checkout)
    print(f"  K6 checksum (forward; dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo): "
          f"{k6_checksum()}", flush=True)

    label, batch, spq, seq, hkv = INT8_GQA_CASE
    t = _inputs(batch, spq, seed=60)
    width = (HEADS + 2 * hkv) * HEAD_DIM
    g = torch.Generator(device="cuda").manual_seed(61)
    wqkv = (torch.randn((D, width), generator=g, device="cuda")
            * D ** -0.5).to(torch.bfloat16)
    bqkv = 0.02 * torch.randn(width, generator=g, device="cuda")
    do = torch.randn(t["x"].shape, generator=g, device="cuda").to(
        torch.bfloat16)
    head = (t["x"], t["gamma"], t["beta"], wqkv, bqkv, t["wo"])
    tail = (EPS, seq, HEADS, HEAD_DIM, hkv)
    calls = {"fused_ln_qkvo_attention_int8_gqa": head + (t["bo"],) + tail,
             "fused_ln_qkvo_attention_int8_gqa_bwd": head + (do,) + tail,
             "fused_ln_qkvo_attention_int8_gqa_dw_bwd": head + (do,) + tail}
    for name, args in calls.items():
        kern = getattr(ck, name)
        twin = getattr(ck, name + "_ref")
        with torch.inference_mode():
            ck.reset_launch_counts()
            outs = kern(*args)
            torch.cuda.synchronize()
            if name.endswith("_bwd"):
                # the backward on its Hopper design: K3's s8 products, no
                # first-design piece
                _check_s8(f"{name} {label}", {name: 1}, first_design=True)
            refs = twin(*args)
            if not isinstance(outs, tuple):
                outs, refs = (outs,), (refs,)
            _check_int8(ck, name, label, args, outs, refs, stats)
            err = max((o.float() - r.float()).abs().max().item()
                      / max(1.0, r.float().abs().max().item())
                      for o, r in zip(outs, refs))
            if err > TOL:
                raise AssertionError(f"{name} {label}: {err} > {TOL}")
            k_ms = _median_ms(lambda: kern(*args))
            p_ms = _median_ms(lambda: twin(*args), warmup=1, iters=5)
        stats[name].update(
            max_abs_err=max((o.float() - r.float()).abs().max().item()
                            for o, r in zip(outs, refs)),
            ms=k_ms, plain_ms=p_ms, library_ms=None,
            shape=(batch, spq, hkv))
        print(f"  {name:40s} {label:16s} kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.4f} ms (medians)", flush=True)
        del outs, refs
    del t, do
    torch.cuda.empty_cache()


# The six paths: ViT-B/16 through eval_cli at its default 384 px and
# train_cli at 224 b32 with --no-fused-qkv; Res-ViT (ft_resvit.sh's model)
# through resvit_eval_cli --no-fused-qkv, dense and compacted (the legacy
# apply_compact route), and resvit_train_cli --no-fused-qkv at b32; K7's
# int8 tier through resvit_eval_cli --int8 --n_kv_heads 4 (dense, 0.625)
# and resvit_train_cli --int8-grad --n_kv_heads 4 and ft_resvit_fast.sh's
# flags with --n_kv_heads 4, at b32
K13_EVAL_ARGS = ["--model-arch", "b16", "--dataset", "Synthetic",
                 "--synthetic-samples", "128", "--batch-size", "64",
                 "--num-classes", "10", "--seed", "0", "--no-fused-qkv"]
K13_TRAIN_ARGS = ["--model-arch", "b16", "--image-size", "224",
                  "--dataset", "Synthetic", "--synthetic-samples", "128",
                  "--batch-size", "32", "--lr", "0.03", "--wd", "0",
                  "--warmup-steps", "2", "--train-steps", "4",
                  "--num-classes", "10", "--seed", "0", "--no-fused-qkv"]
K13_STEPS = 4
RESVIT11_EVAL = [
    ("--no-fused-qkv dense", ["--no-fused-qkv"]),
    ("--no-fused-qkv compact 0.625", ["--no-fused-qkv"] + COMPACT),
    ("--int8 --n_kv_heads 4 dense", ["--int8", "--n_kv_heads", "4"]),
    ("--int8 --n_kv_heads 4 compact 0.625",
     ["--int8", "--n_kv_heads", "4"] + COMPACT)]
RESVIT11_TRAIN = [
    ("(g) --no-fused-qkv", ["--no-fused-qkv"]),
    ("(h) --int8-grad --n_kv_heads 4", ["--int8-grad", "--n_kv_heads", "4"]),
    ("(i) ft_resvit_fast.sh --n_kv_heads 4",
     ["--int8-dw"] + COMPACT + ["--compact-warmup", "1", "--token-keep",
                                "0.5", "--n_kv_heads", "4"])]


def _vit_no_fused_qkv(exp_root, times):
    """Paths 1 and 2: eval_cli @384 and train_cli @224 b32 with
    --no-fused-qkv, exact counts; logits and grads against the plain path;
    timed forward and step."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train import param_leaves
    from vitax_torch.utils.memory import named_leaves

    ck.reset_launch_counts()
    result, n_img, rate = _run_eval(K13_EVAL_ARGS)
    counts = {"eval_cli": ck.launch_counts()}
    batches = 2  # the final LN once, each layer's LN1, K13 and K2
    expect = _expect(layer_norm=13 * batches, flash_attention=12 * batches,
                     fused_ln_mlp=12 * batches)
    print(f"k13: eval_cli @384 --no-fused-qkv {result} {n_img} images "
          f"{rate:.0f} img/s launches {_nonzero(counts['eval_cli'])}",
          flush=True)
    if n_img != 128 or counts["eval_cli"] != expect:
        raise AssertionError(f"expected 128 images and launches {expect}")
    args = K13_TRAIN_ARGS + ["--exp-root", exp_root]
    ck.reset_launch_counts()
    losses, valid, rate_t = _run_train(args, steps=K13_STEPS)
    counts["train_cli"] = ck.launch_counts()
    fwd = K13_STEPS + math.ceil(128 / 32)
    expect = _expect(layer_norm=13 * fwd, flash_attention=12 * fwd,
                     fused_ln_mlp=12 * fwd, layer_norm_bwd=13 * K13_STEPS,
                     flash_attention_bwd=12 * K13_STEPS,
                     fused_ln_mlp_bwd=12 * K13_STEPS)
    print(f"k13: train_cli @224 b32 --no-fused-qkv losses "
          f"{[round(v, 4) for v in losses]} valid {valid} {rate_t:.0f} img/s "
          f"launches {_nonzero(counts['train_cli'])}", flush=True)
    if counts["train_cli"] != expect:
        raise AssertionError(f"expected launches {expect}")

    for image, batch in ((384, 64), (224, 32)):
        cfg = arch_config("b16", image_size=image, num_classes=10,
                          dtype=torch.bfloat16, fused_qkv=False,
                          fused_mlp=True)
        plain = cfg.replace(fused_mlp=False, use_pallas=False)
        params = vit.init_params(set_seed(0), cfg, "cuda")
        data = next(iter(get_dataloader(
            "Synthetic", split="val" if image == 384 else "train",
            image_size=image, batch_size=batch, num_samples=128, seed=0)))
        images = torch.from_numpy(data.images).cuda().bfloat16()
        labels = torch.from_numpy(data.labels).cuda()
        if image == 384:
            with torch.inference_mode():
                lk = vit.apply(params, images, cfg)
                lp = vit.apply(params, images, plain)
                fwd_ms = {n: _median_ms(lambda c=c: vit.apply(params, images,
                                                              c),
                                        warmup=1, iters=5)
                          for n, c in (("kernels", cfg), ("plain", plain))}
            diff = (lk - lp).abs().max().item()
            band = LOGIT_BAND * max(1.0, lp.abs().max().item())
            print(f"k13: eval @384 logits {tuple(lk.shape)} max|kernel - "
                  f"plain_bf16| {diff:.3e} <= {band:.3e}; forward b64 "
                  "(median of 5, CUDA events): " + ", ".join(
                      f"{k} {ms:.2f} ms = {64e3 / ms:.0f} img/s"
                      for k, ms in fwd_ms.items()), flush=True)
            if not (bool(torch.isfinite(lk).all()) and diff <= band):
                raise AssertionError("--no-fused-qkv logits outside the band")
            times["ViT eval fwd b64 @384"] = fwd_ms
            continue
        names = [n for n, _ in named_leaves(params)]
        for p in param_leaves(params):
            p.requires_grad_(True)
        g_k = _grads(params, images, labels, cfg)
        g_p = _grads(params, images, labels, plain)
        rels, key_ratio = _grad_distances(names, g_k, g_p)
        print(f"k13: train grads of {len(names)} tensors; worst |g_kernel - "
              f"g_plain_bf16| / |g_plain_bf16|: " + ", ".join(
                  f"{r:.3e} ({n})" for r, n in rels[:3])
              + f" <= {GRAD_BAND}; key biases {key_ratio:.3e}", flush=True)
        if (not all(bool(torch.isfinite(g).all()) for g in g_k)
                or rels[0][0] > GRAD_BAND or key_ratio > GRAD_BAND):
            raise AssertionError("--no-fused-qkv grads outside the band")
        times["ViT worst grad distance"] = rels[0][0]
        del g_k, g_p
        runs = _time_steps(params, images, labels,
                           (("plain", plain), ("kernels", cfg),
                            ("kernels", cfg), ("plain", plain)), iters=5)
        times["ViT train step b32 @224"] = {
            k: min(ms for n, ms in runs if n == k)
            for k in ("kernels", "plain")}
        del params, images
        torch.cuda.empty_cache()
    return counts


def _resvit_no_fused_qkv(exp_root, times):
    """Paths 3-6: resvit_eval_cli and resvit_train_cli on K13 and on K7's
    int8 tier with exact counts a batch and a step; logits (routing
    replayed) and grads (noise and routing replayed) against the plain
    path or the int8 twin path; timed forwards and steps."""
    import torch
    from vitax_torch import resvit_train_cli
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import resvit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.resvit_eval_cli import get_eval_config
    from vitax_torch.resvit_train_cli import config_to_model_args
    from vitax_torch.train.optim import param_leaves, tree_leaves
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_train_step)
    from vitax_torch.utils.memory import named_leaves

    counts = {}
    batches = math.ceil(256 / 64)
    with _random_router_biases():
        base = config_to_model_args(get_eval_config(RESVIT_ARGS), "cuda")
        roles = resvit.layer_roles(base)
        plain_n = sum(not r["routed"] for r in roles)
        routers = sum(bool(r.get("is_block_head")) for r in roles)
        for label, extra in RESVIT11_EVAL:
            if "--int8" in extra:
                per = _resvit_launches(config_to_model_args(
                    get_eval_config(RESVIT_ARGS + extra), "cuda"), False)
            else:
                per = _k13_resvit_launches(plain_n, len(roles) - plain_n,
                                           routers, False,
                                           compact="--compact-capacity"
                                           in extra)
            expect = {k: v * batches for k, v in per.items()}
            ck.reset_launch_counts()
            result, rate = _run_resvit_eval(RESVIT_ARGS + extra)
            counts[label] = ck.launch_counts()
            print(f"k13: resvit_eval_cli {label}: acc1 {result['acc1']:.4f} "
                  f"loss {result['loss']:.4f} active "
                  f"{result['non_low_rank_ratio']:.4f}; {rate:.0f} img/s; "
                  f"launches {_nonzero(counts[label])}", flush=True)
            if counts[label] != expect:
                raise AssertionError(f"expected launches {_nonzero(expect)}")
        for label, batch_steps, extra in ((l, 4, e) for l, e in RESVIT11_TRAIN):
            log = []
            args = RESVIT_TRAIN_ARGS + extra + [
                "--batch-size", "32", "--synthetic-samples",
                str(32 * batch_steps), "--train-steps", str(batch_steps),
                "--exp-root", exp_root]
            ck.reset_launch_counts()
            with _step_launches(ck, log), \
                    contextlib.redirect_stdout(io.StringIO()):
                out = resvit_train_cli.main(args)
            counts[label] = ck.launch_counts()
            bad = [(kind, _nonzero(got)) for kind, c, got in log
                   if got != _resvit_launches(c, kind == "train")]
            valid = out["epochs"][-1]
            print(f"k13: resvit_train_cli {label} b32: valid acc1 "
                  f"{valid['acc1']:.4f} loss {valid['loss']:.4f}; launches a "
                  f"step as derived: {not bad} ({_nonzero(log[0][2])})",
                  flush=True)
            shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)
            if (bad or sum(e[0] == "train" for e in log) != batch_steps
                    or not all(math.isfinite(v) for v in valid.values())):
                raise AssertionError(f"{label}: launches {bad}, valid {valid}")
            if "--n_kv_heads" in extra:
                # K7's int8 backward on its Hopper design: the s8 products
                # by kind, and first-design pieces only from K7's int8
                # forward
                _check_s8(f"resvit_train_cli {label}", counts[label],
                          first_design=True)
        params = resvit.init_params(set_seed(0), base, "cuda")
        gqa = base.replace(n_kv_heads=4)
        gqa_params = resvit.init_params(set_seed(0), gqa, "cuda")
    shutil.rmtree(exp_root, ignore_errors=True)

    # logits, routing replayed: K13 against the plain path, K7's int8 tier
    # against its int8 twin path; timed b64 forwards
    k13 = base.replace(fused_qkv=False, fused_qkvo=False)
    plain = k13.replace(use_pallas=False)
    tier = dict(int8_attn=True, int8_mlp=True, fused_mlp=True)
    g8 = gqa.replace(**tier)
    g = torch.Generator(device="cuda").manual_seed(13)
    images = torch.randn((64, 224, 224, 3), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    log = _RouterLog(resvit)
    fwd_ms = {}
    with torch.inference_mode():
        for label, cfg, p, other in (
                ("--no-fused-qkv", k13, params, "plain"),
                ("--int8 --n_kv_heads 4", g8, gqa_params, "int8 twin")):
            log.calls.clear()
            with log.record():
                lk, _ = resvit.apply(p, images, cfg)
            with log.replay():
                if other == "plain":
                    lo, _ = resvit.apply(p, images, plain)
                else:
                    with _int8_twins(ck):
                        lo, _ = resvit.apply(p, images, cfg)
            diff = (lk - lo).abs().max().item()
            band = LOGIT_BAND * max(1.0, lo.abs().max().item())
            fwd_ms[label] = _median_ms(lambda: resvit.apply(p, images, cfg),
                                       warmup=2, iters=5)
            print(f"k13: resvit {label} logits max|kernel - {other}| "
                  f"{diff:.3e} <= {band:.3e}; forward b64 "
                  f"{fwd_ms[label]:.2f} ms", flush=True)
            if not (bool(torch.isfinite(lk).all()) and diff <= band):
                raise AssertionError(f"resvit {label} logits outside the band")
        fwd_ms["plain"] = _median_ms(lambda: resvit.apply(params, images,
                                                          plain),
                                     warmup=1, iters=5)
    times["Res-ViT fwd b64"] = fwd_ms
    del images

    # grads, noise and routing replayed, and timed train steps at b32
    cfgs = {"(g)": (k13, params, plain, GRAD_BAND),
            "(h)": (g8.replace(int8_attn_grad=True, int8_mlp_grad=True),
                    gqa_params, None, INT8_GRAD_BAND),
            "(i)": (g8.replace(int8_attn_grad=True, int8_mlp_grad=True,
                               int8_dw=True, compact_capacity=0.625,
                               token_keep=0.5), gqa_params, None,
                    INT8_GRAD_BAND)}
    for p in (params, gqa_params):
        for t, m in zip(param_leaves(p), tree_leaves(
                resvit.trainable_mask(p, base))):
            t.requires_grad_(m)
    step_ms, worst = {}, {}
    lam = Lambdas(*RESVIT_LAMBDAS)
    for key, (cfg, p, other, band) in cfgs.items():
        images = torch.randn((32, 224, 224, 3), generator=g, device="cuda",
                             dtype=torch.bfloat16)
        labels = torch.randint(0, 10, (32,), generator=g, device="cuda")
        noise = _train_noise(cfg, 32, seed=17)
        replay = _RoutingReplay(resvit)
        lk, g_k = _resvit_grads(p, images, labels, cfg, noise,
                                replay.record())
        if other is None:
            with _int8_twins(ck):
                lo, g_o = _resvit_grads(p, images, labels, cfg, noise,
                                        replay.replay())
        else:
            lo, g_o = _resvit_grads(p, images, labels, other, noise,
                                    replay.replay())
        names = [n for (n, _), m in zip(named_leaves(p), tree_leaves(
            resvit.trainable_mask(p, cfg))) if m]
        rels = sorted(((_rel(a, b), n) for a, b, n in zip(g_k, g_o, names)
                       if b.norm() > 0), reverse=True)
        worst[key] = rels[0][0]
        print(f"k13: resvit-train grads {key} of {len(names)} tensors; worst "
              f"|g_kernel - g_{'plain' if other else 'int8 twin'}| / |g|: "
              + ", ".join(f"{r:.3e} ({n})" for r, n in rels[:3])
              + f" <= {band}; logits max diff "
              f"{(lk - lo).abs().max().item():.3e}", flush=True)
        if (not all(bool(torch.isfinite(t).all()) for t in g_k)
                or rels[0][0] > band):
            raise AssertionError(f"{key}: grads outside the band")
        del g_k, g_o
        tx = make_adamw_for(cfg, p, lambda s: 1e-4)
        state = create_state(p, tx, torch.Generator(device="cuda")
                             .manual_seed(3))
        step = make_train_step(cfg, tx, lam)
        step_ms[key] = _median_ms(lambda: step(state, images, labels),
                                  warmup=2, iters=5)
        del images, labels, tx, state
        torch.cuda.empty_cache()
    times["Res-ViT step b32"] = step_ms
    times["Res-ViT worst grad distance"] = worst
    print("k13: resvit-train step b32 (median of 5, CUDA events): "
          + ", ".join(f"{k} {ms:.2f} ms" for k, ms in step_ms.items()),
          flush=True)
    return counts


def run_no_fused_qkv_slice(exp_root):
    """Phase 11, paths: the six paths of --no-fused-qkv (K13) and of K7's
    int8 tier through their CLIs."""
    times = {}
    counts = _vit_no_fused_qkv(exp_root, times)
    counts.update(_resvit_no_fused_qkv(exp_root, times))
    return counts, times


# ---------------------------------------------------------------- phase 12
# --save-acts (K12): the save pair of the MLP half, bf16 and int8, against
# its twins at train_cli's b32 spq 200, b8 on ragged rows (8 x 197) and, for
# the int8 pair, the drop phase's b32 spq 104; the first case timed beside
# K2's and K4's forwards and backwards
SAVE_CASES = [("b32 spq200 (train_cli)", 32, 200, None),
              ("b8 ragged (8 x 197)", 8, 200, 197),
              (DROP_CASE, 32, 104, None)]
SAVE_RECOMPUTE = ("fused_ln_mlp", "fused_ln_mlp_bwd", "fused_ln_mlp_int8",
                  "fused_ln_mlp_int8_bwd", "fused_ln_mlp_int8_dw_bwd")
SAVE_STEPS, SAVE_SAMPLES = 4, 128
SAVE_TRAIN_ARGS = [{"--train-steps": str(SAVE_STEPS),
                    "--synthetic-samples": str(SAVE_SAMPLES)}.get(prev, a)
                   for prev, a in zip([None] + TRAIN_ARGS, TRAIN_ARGS)]
# the fast recipe's flags at b32 with --save-acts: one drop epoch (spq 104)
# and one dense, 4 steps each; save-acts keeps K5 off (vitax's handoff gate)
SAVE_FAST_ARGS = [{"--train-steps": str(2 * SAVE_STEPS)}.get(prev, a)
                  for prev, a in zip([None] + SAVE_TRAIN_ARGS,
                                     SAVE_TRAIN_ARGS)] + [
    "--int8-dw", "--token-keep", "0.5", "--token-keep-schedule", "0.5",
    "--save-acts"]
# Res-ViT with --save-acts (label, batch, steps, flags): ft_resvit.sh's
# flags (the bf16 MLP half is fused only with --fused-mlp: vitax's Res-ViT
# default keeps it off in bf16), (h) --int8-grad --n_kv_heads 4, and
# ft_resvit_fast.sh's flags at b32 (2 dense warmup steps, then compacted)
RESVIT_SAVE_RUNS = [
    ("(a) ft_resvit.sh --fused-mlp --save-acts", 32, 2,
     ["--fused-mlp", "--save-acts"]),
    ("(h) --int8-grad --n_kv_heads 4 --save-acts", 32, 2,
     ["--int8-grad", "--n_kv_heads", "4", "--save-acts"]),
    ("ft_resvit_fast.sh --save-acts", 32, 3,
     ["--int8-dw"] + COMPACT + ["--compact-warmup", "2", "--token-keep",
                                "0.5", "--save-acts"]),
]


def _save_inputs(batch, rows, ragged, seed):
    import torch
    t = _inputs(batch, rows, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 50)
    t["do"] = torch.randn(t["x"].shape, generator=g,
                          device="cuda").to(torch.bfloat16)
    if ragged:
        t["x"] = t["x"][:, :ragged].contiguous()
        t["do"] = t["do"][:, :ragged].contiguous()
    return t


def _hold_outputs(name, label, outs, refs, stats):
    """Every output of `name` within TOL of its twin's, finite, of its
    shape and dtype."""
    import torch
    errs = []
    for out, ref in zip(outs, refs):
        err = (out.float() - ref.float()).abs().max().item()
        bound = TOL * max(1.0, ref.float().abs().max().item())
        if not (bool(torch.isfinite(out).all()) and err <= bound
                and out.shape == ref.shape and out.dtype == ref.dtype):
            raise AssertionError(
                f"{name} {label} output {len(errs)}: max error {err} over "
                f"{bound} ({tuple(out.shape)} {out.dtype} vs "
                f"{tuple(ref.shape)} {ref.dtype})")
        errs.append(f"{err:.2e}<={bound:.2e}")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    return errs


def check_save_kernels(stats):
    """Phase 12, kernels: K12's four kernels (and :2066's int8_dw branch)
    against their twins on every output, the int8 ones also by their codes
    and INT8_REL (and the bf16 stand-in outside it); each save forward's out
    the same bits as K2's or K4's (K4 on gemm_sm90.cuh's epilogues, K12-int8
    on gemm.cuh's, both in the twin's order); CUDA-event times of the pairs beside K2's and K4's forwards and
    backwards at b32 spq 200."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in SAVE_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, batch, rows, ragged) in enumerate(SAVE_CASES):
        t = _save_inputs(batch, rows, ragged, seed=60 + i)
        mlp = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
               t["b2"], EPS)
        head = (t["x"], t["gamma"], t["beta"], t["w1"], t["w2"])
        calls = {}
        with torch.no_grad():
            if label != DROP_CASE:  # the bf16 pair
                saved = ck.fused_ln_mlp_save(*mlp)
                torch.cuda.synchronize()
                if not torch.equal(saved[0], ck.fused_ln_mlp(*mlp)):
                    raise AssertionError(f"{label}: the save forward's out "
                                         "is not K2's")
                errs = _hold_outputs("fused_ln_mlp_save", label, saved,
                                     ck.fused_ln_mlp_save_ref(*mlp), stats)
                print(f"  fused_ln_mlp_save {label:22s} out == K2's out; "
                      f"max|k-ref| out, h1, g' [{' '.join(errs)}]: ok",
                      flush=True)
                calls["fused_ln_mlp_save"] = mlp
                calls["fused_ln_mlp_bwd_fast"] = (*head, *saved[1:], t["do"],
                                                  EPS)
            saved = ck.fused_ln_mlp_int8_save(*mlp)
            torch.cuda.synchronize()
            if not torch.equal(saved[0], ck.fused_ln_mlp_int8(*mlp)):
                raise AssertionError(f"{label}: the int8 save forward's out "
                                     "is not K4's")
            ref = ck.fused_ln_mlp_int8_save_ref(*mlp)
            _hold_outputs("fused_ln_mlp_int8_save", label, saved[:1],
                          ref[:1], stats)
            _check_int8(ck, "fused_ln_mlp_int8_save", label, mlp,
                        saved[:1], ref[:1], stats)
            b8 = (*head, *saved[1:], t["do"], EPS)
            calls["fused_ln_mlp_int8_save_bwd"] = b8
            calls["fused_ln_mlp_int8_save_dw_bwd"] = b8
            for name, args in calls.items():
                if name == "fused_ln_mlp_save":
                    continue
                outs = getattr(ck, name)(*args)
                torch.cuda.synchronize()
                refs = getattr(ck, name + "_ref")(*args)
                errs = _hold_outputs(name, label, outs, refs, stats)
                if name in SAVE_KERNELS_INT8:
                    _check_int8(ck, name, label, args, outs, refs, stats)
                print(f"  {name:32s} {label:22s} max|k-ref| per output "
                      f"[{' '.join(errs)}]: ok", flush=True)
                del outs, refs
        if i == 0:  # times, the recompute kernels in the same turns
            k4 = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
                  t["do"], EPS)
            timed = {
                "fused_ln_mlp_save": (lambda: ck.fused_ln_mlp_save(*mlp),
                                      lambda: ck.fused_ln_mlp_save_ref(*mlp)),
                "fused_ln_mlp_int8_save": (
                    lambda: ck.fused_ln_mlp_int8_save(*mlp),
                    lambda: ck.fused_ln_mlp_int8_save_ref(*mlp)),
                **{n: (lambda n=n: getattr(ck, n)(*calls[n]),
                       lambda n=n: getattr(ck, n + "_ref")(*calls[n]))
                   for n in SAVE_KERNELS[1::2] + SAVE_KERNELS[4:]},
                "fused_ln_mlp": (lambda: ck.fused_ln_mlp(*mlp), None),
                "fused_ln_mlp_int8": (lambda: ck.fused_ln_mlp_int8(*mlp),
                                      None),
                **{n: (lambda n=n: getattr(ck, n)(*k4), None)
                   for n in SAVE_RECOMPUTE[1::2] + SAVE_RECOMPUTE[4:]}}
            ms = {n: [] for n in timed}
            with torch.no_grad():
                for turn in range(2):
                    for n, (kern, _) in (timed.items() if turn == 0 else
                                         reversed(timed.items())):
                        ms[n].append(_median_ms(kern, warmup=2, iters=10))
                for n in SAVE_KERNELS:
                    stats[n].update(
                        ms=min(ms[n]), shape=(batch, rows),
                        plain_ms=_median_ms(timed[n][1], warmup=1, iters=3))
            print("  save-acts kernels b32 spq200 (CUDA events, medians of 10,"
                  " two turns, the second in reverse order): " + ", ".join(
                      f"{n} {' / '.join(f'{v:.4f}' for v in ms[n])} ms"
                      for n in timed) + "; plain " + ", ".join(
                      f"{n} {stats[n]['plain_ms']:.4f}" for n in SAVE_KERNELS),
                  flush=True)
        del t, calls
        torch.cuda.empty_cache()
    return stats


def _save_epoch_expect(steps, evals, int8, bwd):
    """train_cli's launches of a train epoch of `steps` save-acts steps and a
    valid epoch of `evals` batches: per step 12 of the attention half and
    its backward, 12 of the save pair, one LN and LN backward; an eval batch
    K1/K3 and K2/K4 (no grad: K2's or K4's forward), one LN."""
    attn = "fused_ln_qkvo_attention_int8" if int8 else \
        "fused_ln_qkvo_attention"
    attn_bwd = {"fused_ln_mlp_int8_save_dw_bwd":
                "fused_ln_qkvo_attention_int8_dw_bwd",
                "fused_ln_mlp_int8_save_bwd":
                "fused_ln_qkvo_attention_int8_bwd"}.get(
        bwd, "fused_ln_qkvo_attention_bwd")
    save = "fused_ln_mlp_int8_save" if int8 else "fused_ln_mlp_save"
    train = _expect(layer_norm=steps, layer_norm_bwd=steps,
                    **{attn: 12 * steps, attn_bwd: 12 * steps,
                       save: 12 * steps, bwd: 12 * steps})
    valid = _expect(layer_norm=evals, **{
        attn: 12 * evals,
        ("fused_ln_mlp_int8" if int8 else "fused_ln_mlp"): 12 * evals})
    return train, valid


def run_save_acts_slice(exp_root):
    """Phase 12, paths: train_cli --save-acts, --int8-grad --save-acts and
    the fast recipe's flags with --save-acts at b32, exact launches per
    epoch; full-width grads of the bf16 and int8 save paths against the
    plain and int8 twin paths; resident ViT-B/16 b32 steps with and without
    --save-acts in three tiers; resvit_train_cli with --save-acts three
    ways, exact launches per step and eval batch; Res-ViT steps (a) and (h)
    with and without it, and (a) with the bf16 MLP half fused but no
    save-acts, which (a) --fused-mlp --save-acts changes in two ways; their
    grads against the plain and int8 twin paths, routing replayed."""
    import torch
    from vitax_torch import resvit_train_cli
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import resvit, vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train import param_leaves
    from vitax_torch.train.optim import tree_leaves
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_train_step)
    from vitax_torch.utils.memory import named_leaves

    evals = math.ceil(SAVE_SAMPLES / TRAIN_BATCH)
    runs = {
        "--save-acts": (SAVE_TRAIN_ARGS + ["--save-acts"], SAVE_STEPS, [
            *_save_epoch_expect(SAVE_STEPS, evals, False,
                                "fused_ln_mlp_bwd_fast")]),
        "--int8-grad --save-acts": (
            SAVE_TRAIN_ARGS + ["--int8-grad", "--save-acts"], SAVE_STEPS, [
                *_save_epoch_expect(SAVE_STEPS, evals, True,
                                    "fused_ln_mlp_int8_save_bwd")]),
        "fast flags --save-acts": (
            SAVE_FAST_ARGS, 2 * SAVE_STEPS, 2 * [
                *_save_epoch_expect(SAVE_STEPS, evals, True,
                                    "fused_ln_mlp_int8_save_dw_bwd")]),
    }
    counts = {}
    for label, (args, steps, expect) in runs.items():
        log = []
        ck.reset_launch_counts()
        with _epoch_launches(ck, log):
            losses, valid, rate = _run_train(args + ["--exp-root", exp_root],
                                             steps=steps)
        counts[label] = ck.launch_counts()
        got = [c for _, c in log]
        print(f"save-acts: train_cli {label} b32 losses "
              f"{[round(v, 4) for v in losses]} valid {valid} {rate:.0f} "
              "img/s (last epoch, host-fed); launches per epoch: " + "; ".join(
                  f"{kind} {{{', '.join(f'{k}: {v}' for k, v in c.items() if v)}}}"
                  for kind, c in log), flush=True)
        if got != expect:
            raise AssertionError(f"{label}: expected launches per epoch "
                                 f"{expect}")

    # full-width grads: the bf16 save path against the plain path, the int8
    # save paths against their twin paths
    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True,
                      fused_mlp_save=True)
    tier8 = dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                 int8_attn_grad=True)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    names = [n for n, _ in named_leaves(params)]
    for p in param_leaves(params):
        p.requires_grad_(True)
    batch = next(iter(get_dataloader("Synthetic", split="train",
                                     image_size=224, batch_size=TRAIN_BATCH,
                                     num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda().bfloat16()
    labels = torch.from_numpy(batch.labels).cuda()
    plain = cfg.replace(fused_qkv=False, fused_mlp=False, use_pallas=False)
    grad_rows = []
    for key, c, other, band in (
            ("bf16", cfg, "plain", GRAD_BAND),
            ("int8-grad", cfg.replace(**tier8), "int8 twin", INT8_GRAD_BAND),
            ("int8-dw", cfg.replace(**tier8, int8_dw=True), "int8 twin",
             INT8_GRAD_BAND)):
        ck.reset_launch_counts()
        g_k = _grads(params, images, labels, c)
        ran = _nonzero(ck.launch_counts())
        if other == "plain":
            g_o = _grads(params, images, labels, plain)
        else:
            with _int8_twins(ck):
                g_o = _grads(params, images, labels, c)
        rels, key_r = _grad_distances(names, g_k, g_o)
        finite = all(bool(torch.isfinite(g).all()) for g in g_k)
        print(f"save-acts: grads {key} --save-acts b32 of {len(names)} "
              f"tensors (launches {ran}); worst |g_kernel - g_{other}| / "
              f"|g_{other}|: " + ", ".join(f"{r:.3e} ({n})"
                                           for r, n in rels[:3])
              + f" <= {band}, key biases {key_r:.3e}", flush=True)
        grad_rows.append((f"ViT {key}", rels[0][0]))
        save = [n for n in ran if n in SAVE_KERNELS]
        if (not finite or rels[0][0] > band or key_r > band
                or len(save) != 2 or any(ran[n] != 12 for n in save)):
            raise AssertionError(f"save-acts {key}: grads or launches")
        del g_k, g_o
    torch.cuda.empty_cache()

    # resident ViT-B/16 b32 steps, with and without --save-acts, in turns
    paths = []
    for key, c in (("bf16", cfg), ("int8-grad", cfg.replace(**tier8)),
                   ("int8-dw", cfg.replace(**tier8, int8_dw=True))):
        paths += [(f"{key}", c.replace(fused_mlp_save=False)),
                  (f"{key} --save-acts", c)]
    runs_ms = _time_steps(params, images, labels,
                          paths + paths[::-1])
    step_ms = {k: [ms for n, ms in runs_ms if n == k] for k, _ in paths}
    del params
    torch.cuda.empty_cache()

    # Res-ViT through resvit_train_cli, exact launches per step and batch
    with _random_router_biases():
        for label, batch_size, steps, extra in RESVIT_SAVE_RUNS:
            log = []
            args = RESVIT_TRAIN_ARGS + extra + [
                "--batch-size", str(batch_size), "--synthetic-samples",
                str(batch_size * steps), "--train-steps", str(steps),
                "--exp-root", exp_root]
            ck.reset_launch_counts()
            with _step_launches(ck, log), \
                    contextlib.redirect_stdout(io.StringIO()):
                out = resvit_train_cli.main(args)
            shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)
            train_log = [e for e in log if e[0] == "train"]
            bad = [(kind, _nonzero(got)) for kind, c, got in log
                   if got != _resvit_launches(c, kind == "train")]
            ran = set().union(*(_nonzero(got) for _, _, got in train_log))
            valid = out["epochs"][-1]
            print(f"save-acts: resvit_train_cli {label} b{batch_size}: "
                  f"{len(train_log)} steps (" + ", ".join(
                      f"C {c.compact_capacity}" if c.compact_capacity
                      else "dense" for _, c, _ in train_log)
                  + f"); valid acc1 {valid['acc1']:.4f} loss "
                  f"{valid['loss']:.4f}; launches as derived: {not bad} ("
                  + "; ".join("{" + ", ".join(f"{k}: {v}" for k, v in
                                              _nonzero(got).items()) + "}"
                              for _, _, got in train_log[-1:]) + ")",
                  flush=True)
            if (bad or len(train_log) != steps or not ran & set(SAVE_KERNELS)
                    or not all(math.isfinite(v) for v in valid.values())):
                raise AssertionError(f"{label}: launches {bad}, "
                                     f"{len(train_log)} steps, valid {valid}")
        from vitax_torch.resvit_train_cli import (config_to_model_args,
                                                  get_train_config)
        base = config_to_model_args(get_train_config(
            RESVIT_TRAIN_ARGS + ["--exp-root", exp_root]), "cuda")
        gqa = base.replace(n_kv_heads=4)
        rv_params = {"(a)": resvit.init_params(set_seed(0), base, "cuda"),
                     "(h)": resvit.init_params(set_seed(0), gqa, "cuda")}
    shutil.rmtree(exp_root, ignore_errors=True)
    h_tier = dict(tier8, fused_mlp=True)
    rv_cfgs = [("(a)", base), ("(a) --fused-mlp",
                               base.replace(fused_mlp=True)),
               ("(a) --fused-mlp --save-acts",
                base.replace(fused_mlp=True, fused_mlp_save=True)),
               ("(h)", gqa.replace(**h_tier)),
               ("(h) --save-acts", gqa.replace(**h_tier,
                                               fused_mlp_save=True))]
    for p in rv_params.values():
        for t, m in zip(param_leaves(p), tree_leaves(
                resvit.trainable_mask(p, base))):
            t.requires_grad_(m)
    g = torch.Generator(device="cuda").manual_seed(9)
    rv_images = torch.randn((32, 224, 224, 3), generator=g, device="cuda",
                            dtype=torch.bfloat16)
    rv_labels = torch.randint(0, 10, (32,), generator=g, device="cuda")
    # Res-ViT grads of every trainable tensor with --save-acts, the Gumbel
    # noise and the routing replayed, before the timed AdamW steps move the
    # params: (a) --fused-mlp --save-acts against the plain path, (h)
    # --save-acts against the int8 twin path
    plain_rv = dict(fused_qkv=False, fused_qkvo=False, fused_mlp=False,
                    use_pallas=False)
    for (key, c), band in ((rv_cfgs[2], GRAD_BAND),
                           (rv_cfgs[4], INT8_GRAD_BAND)):
        p = rv_params[key[:3]]
        noise = _train_noise(c, 32, seed=13)
        replay = _RoutingReplay(resvit)
        ck.reset_launch_counts()
        _, g_k = _resvit_grads(p, rv_images, rv_labels, c, noise,
                               replay.record())
        ran = _nonzero(ck.launch_counts())
        if band == GRAD_BAND:
            other = "plain"
            _, g_o = _resvit_grads(p, rv_images, rv_labels,
                                   c.replace(**plain_rv), noise,
                                   replay.replay())
        else:
            other = "int8 twin"
            with _int8_twins(ck):
                _, g_o = _resvit_grads(p, rv_images, rv_labels, c, noise,
                                       replay.replay())
        names = [n for (n, _), m in zip(named_leaves(p), tree_leaves(
            resvit.trainable_mask(p, c))) if m]
        rels = sorted(((_rel(u, v), n) for u, v, n in zip(g_k, g_o, names)
                       if v.norm() > 0), reverse=True)
        finite = all(bool(torch.isfinite(t).all()) for t in g_k)
        print(f"save-acts: Res-ViT grads {key} b32 of {len(g_k)} trainable "
              f"tensors (launches {ran}); worst |g_kernel - g_{other}| / "
              f"|g_{other}|: " + ", ".join(f"{r:.3e} ({n})"
                                           for r, n in rels[:3])
              + f" <= {band}", flush=True)
        grad_rows.append((f"Res-ViT {key}", rels[0][0]))
        if (not finite or rels[0][0] > band
                or not set(ran) & set(SAVE_KERNELS)):
            raise AssertionError(f"Res-ViT {key}: grads outside the band")
        del g_k, g_o
        torch.cuda.empty_cache()
    lam = Lambdas(*RESVIT_LAMBDAS)
    rv_ms = {k: [] for k, _ in rv_cfgs}
    for key, c in rv_cfgs + rv_cfgs[::-1]:
        p = rv_params[key[:3]]
        tx = make_adamw_for(c, p, lambda s: 1e-4)
        state = create_state(p, tx, torch.Generator(device="cuda")
                             .manual_seed(3))
        step = make_train_step(c, tx, lam)
        rv_ms[key].append(_median_ms(
            lambda: step(state, rv_images, rv_labels), warmup=2, iters=5))
        del tx, state
        torch.cuda.empty_cache()

    print("save-acts: steps b32 (resident batch, CUDA-event medians, in "
          "turns, the second in reverse order): ViT-B/16 " + ", ".join(
              f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
              for k, ms in step_ms.items()) + "; Res-ViT " + ", ".join(
              f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
              for k, ms in rv_ms.items()), flush=True)
    return counts, {**step_ms, **{f"Res-ViT {k}": v
                                  for k, v in rv_ms.items()}}, grad_rows


# ---------------------------------------------------------------- phase 13
# int4 (K11, the A4W4 tiers of the plain ViT): the four kernels (the MLP
# backward and the attention backward each with and without int8_dw) against
# their twins at train_cli's b32 spq 200, the drop geometry b32 spq 104 and
# a ragged row count (the MLP half on 3 x 197 rows, the attention half on
# b3 spq 200 with 197 keys); the first case timed beside the int8
# counterparts
INT4_CASES = [("b32 spq200 (train_cli)", 32, 200, 197),
              (DROP_CASE, 32, 104, 99),
              ("ragged", 3, 200, 197)]
# kernel -> (its int8 counterpart, timed in the same turns; the bf16 kernel
# whose output stands in for one that skipped quantization)
INT4_PAIRS = {
    "fused_ln_mlp_int4": ("fused_ln_mlp_int8", "fused_ln_mlp"),
    "fused_ln_mlp_int4_bwd": ("fused_ln_mlp_int8_bwd", "fused_ln_mlp_bwd"),
    "fused_ln_mlp_int4_dw_bwd": ("fused_ln_mlp_int8_dw_bwd",
                                 "fused_ln_mlp_bwd"),
    "fused_ln_qkvo_attention_int4": ("fused_ln_qkvo_attention_int8",
                                     "fused_ln_qkvo_attention"),
    "fused_ln_qkvo_attention_int4_bwd": ("fused_ln_qkvo_attention_int8_bwd",
                                         "fused_ln_qkvo_attention_bwd"),
    "fused_ln_qkvo_attention_int4_dw_bwd": (
        "fused_ln_qkvo_attention_int8_dw_bwd", "fused_ln_qkvo_attention_bwd"),
}
INT4_KERNELS = tuple(INT4_PAIRS)
# int4 kernel vs twin, per output: ‖k − t‖/‖t‖ <= INT4_REL, and the bf16
# kernel on the same inputs at least INT4_STAND_IN times farther from the
# twin on every output a quantizer reaches (all but Σ do), or the check
# does not tell a kernel that skipped quantization apart
INT4_REL, INT4_STAND_IN = 2e-2, 3.0
# codes moved from the twin's, (largest step, share): the int4 activation
# codes move one step where an ulp of their input sits next to a .5 tie (a
# step is 1/7 of the row's largest value); do's codes quantize the same bf16
# input, the same bits; the int8_dw column codes (8 bits) as CODE_BAND's,
# but one moved xq code of K11-D's recompute moves the keys and values of
# its whole image, so attn's and dqkv's column codes in that image's group
# move up to 3 steps (a card test: one xq code of 2.6e6 at b32 spq 104
# moved 1.6e-3 of atc's and 1.7e-3 of dqc's codes)
INT4_CODE_BAND = {"xq": (1, 1e-3), "h1q": (1, 1e-3), "dh1q": (1, 1e-3),
                  "aq": (1, 1e-3), "dqq": (1, 1e-3), "doq": (0, 0.0),
                  "doc": (0, 0.0), "h1c": (2, 1e-3), "xnc": (2, 1e-3),
                  "dh1c": (2, 1e-3), "atc": (4, 5e-3), "dqc": (4, 5e-3)}
# the tiers of train_cli: each int4 flag set, with the per-step launches of
# vitax's dispatch; the first two for TRAIN_STEPS steps, the others for
# INT4_SHORT steps
INT4_SHORT, INT4_SHORT_SAMPLES = 2, 64
_T4 = {"attn": "fused_ln_qkvo_attention", "mlp": "fused_ln_mlp"}
INT4_RUNS = {
    "--int4": (TRAIN_STEPS, dict(attn="_int8", mlp="_int4"),
               dict(attn="_bwd", mlp="_bwd")),
    "--int4-attn --int4-grad --int8-dw": (
        TRAIN_STEPS, dict(attn="_int4", mlp="_int4"),
        dict(attn="_int4_dw_bwd", mlp="_int4_dw_bwd")),
    "--int4-attn --int4-grad --int8-grad": (
        INT4_SHORT, dict(attn="_int4", mlp="_int4"),
        dict(attn="_int4_bwd", mlp="_int4_bwd")),
    "--int4-attn --int4-grad": (INT4_SHORT, dict(attn="_int4", mlp="_int4"),
                                dict(attn="_bwd", mlp="_int4_bwd")),
    "--int4-grad": (INT4_SHORT, dict(attn="_int8", mlp="_int4"),
                    dict(attn="_bwd", mlp="_int4_bwd")),
    "--int4-attn": (INT4_SHORT, dict(attn="_int4", mlp="_int4"),
                    dict(attn="_bwd", mlp="_bwd")),
}


def _int4_calls(ck, t, seq_len, ragged):
    """int4 kernel name -> its arguments (the ragged MLP rows cut to
    seq_len a image)."""
    x, do = t["x"], t["do"]
    if ragged:
        x, do = x[:, :seq_len].contiguous(), do[:, :seq_len].contiguous()
    mlp = (x, t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"])
    qkvo = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"])
    tail = (EPS, seq_len, HEADS, HEAD_DIM)
    return {"fused_ln_mlp_int4": (*mlp, t["b2"], EPS),
            "fused_ln_mlp_int4_bwd": (*mlp, do, EPS),
            "fused_ln_mlp_int4_dw_bwd": (*mlp, do, EPS),
            "fused_ln_qkvo_attention_int4": (*qkvo, t["bo"], *tail),
            "fused_ln_qkvo_attention_int4_bwd": (*qkvo, t["do"], *tail),
            "fused_ln_qkvo_attention_int4_dw_bwd": (*qkvo, t["do"], *tail)}


def _check_int4(ck, name, label, args, stats):
    """One int4 kernel against its twin on the same inputs: the codes (the
    weights' and do's the same bits, the rest within INT4_CODE_BAND), every
    output finite, of the twin's shape and dtype and within INT4_REL of it,
    the bf16 kernel at least INT4_STAND_IN times farther on every output a
    quantizer reaches; all but K11-A (K11-C, K11-D on K3's Hopper sequences,
    K11-B on K4's) also two launches the same bits and no first-design
    piece launched by them."""
    import torch
    sk, st = {}, {}
    hopper = name != "fused_ln_mlp_int4"
    ck.first_design_launch_counts(reset=True)
    outs = getattr(ck, name)(*args, scratch=sk)
    again = getattr(ck, name)(*args) if hopper else outs
    torch.cuda.synchronize()
    fd = ck.first_design_launch_counts(reset=True)
    refs = getattr(ck, name + "_ref")(*args, scratch=st)
    stand = getattr(ck, INT4_PAIRS[name][1])(*args)
    if not isinstance(outs, tuple):
        outs, again, refs, stand = (outs,), (again,), (refs,), (stand,)
    if hopper and (any(fd.values()) or not all(
            torch.equal(a, b) for a, b in zip(outs, again))):
        raise AssertionError(f"{name} {label}: first-design pieces {fd}, "
                             "or two launches differ")
    if sk.keys() != st.keys():
        raise AssertionError(f"{name} {label}: codes {sorted(sk)} vs "
                             f"{sorted(st)}")
    moves = {}
    for key, (q, s) in st.items():
        qk, s_k = sk[key]
        if key.startswith("w"):
            if not (torch.equal(qk, q) and torch.equal(s_k, s)):
                raise AssertionError(f"{name} {label}: weight codes {key} "
                                     "differ from the twin's")
            continue
        d = (qk.long() - q.long()).abs()
        moves[key] = (d.max().item(), d.float().mean().item())
    for out, ref in zip(outs, refs):
        if not (bool(torch.isfinite(out).all()) and out.shape == ref.shape
                and out.dtype == ref.dtype):
            raise AssertionError(f"{name} {label}: {tuple(out.shape)} "
                                 f"{out.dtype} vs {tuple(ref.shape)} "
                                 f"{ref.dtype}, or not finite")
    r_k = [_rel(o, r) for o, r in zip(outs, refs)]
    r_s = [_rel(o, r) for o, r in zip(stand, refs)]
    # Σ do (the last backward output) is reached by no quantizer
    reached = range(len(r_k) - 1 if name.endswith("_bwd") else len(r_k))
    ratio = min(r_s[i] / max(r_k[i], 1e-30) for i in reached)
    print(f"  {name:36s} {label:22s} codes moved (max step, share) "
          + " ".join(f"{k} {m[0]} {m[1]:.2e}" for k, m in moves.items())
          + ("; two launches the same bits, no first-design piece"
             if hopper else "")
          + f"; ‖k−t‖/‖t‖ per output [{' '.join(f'{r:.2e}' for r in r_k)}]"
          f" <= {INT4_REL}; bf16 kernel (stand-in) [{' '.join(f'{r:.2e}' for r in r_s)}]"
          f", >= {INT4_STAND_IN}x: {ratio:.1f}x", flush=True)
    st_ = stats[name]
    st_["max_abs_err"] = max(st_["max_abs_err"], *(
        (o.float() - r.float()).abs().max().item()
        for o, r in zip(outs, refs)))
    st_["worst_rel"] = max(st_.get("worst_rel", 0.0), *r_k)
    st_["stand_in_ratio"] = min(st_.get("stand_in_ratio", 1e30), ratio)
    for key, (top, share) in moves.items():
        max_step, max_share = INT4_CODE_BAND[key]
        if top > max_step or share > max_share:
            raise AssertionError(f"{name} {label}: codes {key} moved {share} "
                                 f"(largest step {top})")
    if max(r_k) > INT4_REL:
        raise AssertionError(f"{name} {label}: {max(r_k)} from the twin")
    if ratio < INT4_STAND_IN:
        raise AssertionError(f"{name} {label}: the bf16 kernel lands only "
                             f"{ratio:.2f}x as far from the twin")


def check_int4_kernels(stats):
    """Phase 13, kernels: K11's four kernels (six wrappers) against their
    twins at INT4_CASES, every output; at b32 spq 200 their CUDA-event
    times beside their int8 counterparts', two turns (the second in reverse
    order), and their twins' times."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in INT4_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, batch, rows, seq_len) in enumerate(INT4_CASES):
        t = _save_inputs(batch, rows, None, seed=80 + i)
        calls = _int4_calls(ck, t, seq_len, label == "ragged")
        with torch.no_grad():
            for name, args in calls.items():
                _check_int4(ck, name, label, args, stats)
            if i == 0:
                timed = {}
                for name, args in calls.items():
                    timed[name] = lambda n=name, a=args: getattr(ck, n)(*a)
                    int8 = INT4_PAIRS[name][0]
                    timed[int8] = lambda n=int8, a=args: getattr(ck, n)(*a)
                ms = {n: [] for n in timed}
                for turn in range(2):
                    for n, fn in (timed.items() if turn == 0
                                  else reversed(timed.items())):
                        ms[n].append(_median_ms(fn, warmup=2, iters=10))
                for name, args in calls.items():
                    stats[name].update(
                        ms=min(ms[name]), shape=(batch, rows),
                        int8_ms=min(ms[INT4_PAIRS[name][0]]),
                        plain_ms=_median_ms(
                            lambda n=name, a=args: getattr(ck, n + "_ref")(*a),
                            warmup=1, iters=3))
                print("  int4 kernels b32 spq200 (CUDA events, medians of 10, "
                      "two turns, the second in reverse order): " + ", ".join(
                          f"{n} {' / '.join(f'{v:.4f}' for v in ms[n])} ms"
                          for n in timed) + "; twins " + ", ".join(
                          f"{n} {stats[n]['plain_ms']:.4f}"
                          for n in INT4_KERNELS), flush=True)
        del t, calls
        torch.cuda.empty_cache()
    return stats


def _int4_expect(steps, evals, attn, mlp, attn_bwd, mlp_bwd):
    """train_cli's launches of `steps` train steps and `evals` eval batches:
    per step 12 of each half's forward and backward, one LN and LN
    backward; an eval batch 12 of each forward and one LN."""
    fwd = {_T4["attn"] + attn: 12 * (steps + evals),
           _T4["mlp"] + mlp: 12 * (steps + evals)}
    return _expect(layer_norm=steps + evals, layer_norm_bwd=steps, **fwd,
                   **{_T4["attn"] + attn_bwd: 12 * steps,
                      _T4["mlp"] + mlp_bwd: 12 * steps})


@contextlib.contextmanager
def _int4_twins(ck):
    """The int4 twin path of both models on the card: the int4 forward
    wrappers, which the models and the autograd Functions call by their
    module names, swapped for routes to their plain twins (the Functions
    keep vitax's tier logic; GQA through kv_heads), every int4 backward for
    its twin."""
    names = INT4_KERNELS + RESVIT_INT4_KERNELS
    saved = {n: getattr(ck, n) for n in names}

    def mlp(*args, int8_grad=False, int8_dw=False, int4_grad=False,
            residual=True):
        if ck._needs_grad(*args[:7]):
            return ck.FusedLnMlpFn.apply(*args, True, int8_grad, int8_dw,
                                         True, int4_grad, residual)
        return ck.fused_ln_mlp_int4_ref(*args, residual=residual)

    def attn(*args, int8_grad=False, int8_dw=False, int4_grad=False,
             kv_heads=None):
        if ck._needs_grad(*args[:7]):
            return ck.FusedLnQkvoAttentionFn.apply(
                *args, True, int8_grad, int8_dw, kv_heads, True, int4_grad)
        return ck.fused_ln_qkvo_attention_int4_ref(*args, kv_heads)

    def rect(*args, int8_grad=False, int8_dw=False, int4_grad=False):
        if ck._needs_grad(*args[:8]):
            return ck.FusedLnQkvoAttentionRectFn.apply(
                *args, True, int8_grad, int8_dw, True, int4_grad)
        return ck.fused_ln_qkvo_attention_rect_int4_ref(*args)

    ck.fused_ln_mlp_int4, ck.fused_ln_qkvo_attention_int4 = mlp, attn
    ck.fused_ln_qkvo_attention_rect_int4 = rect
    for name in names:
        if name.endswith("_bwd"):
            setattr(ck, name, getattr(ck, name + "_ref"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ck, n, f)


def run_int4_slice(exp_root):
    """Phase 13, paths: train_cli with each int4 flag set (exact launches);
    logits and the grads of every parameter for one batch on the int4
    kernel path against the int4 twin path; resident-batch steps of the
    bf16, int8-dw, int4 and int4-grad tiers in two turns."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.train import param_leaves
    from vitax_torch.utils.memory import named_leaves

    counts = {}
    for flags, (steps, fwd, bwd) in INT4_RUNS.items():
        samples = 256 if steps == TRAIN_STEPS else INT4_SHORT_SAMPLES
        args = [{"--train-steps": str(steps),
                 "--synthetic-samples": str(samples)}.get(prev, a)
                for prev, a in zip([None] + TRAIN_ARGS, TRAIN_ARGS)]
        expect = _int4_expect(steps, math.ceil(samples / TRAIN_BATCH),
                              fwd["attn"], fwd["mlp"], bwd["attn"], bwd["mlp"])
        ck.reset_launch_counts()
        losses, valid, rate = _run_train(
            args + ["--exp-root", exp_root] + flags.split(), steps=steps)
        counts[flags] = ck.launch_counts()
        print(f"int4: train_cli {flags} b32 losses "
              f"{[round(v, 4) for v in losses]} valid {valid} {rate:.0f} "
              f"img/s (host-fed) launches {_nonzero(counts[flags])}",
              flush=True)
        if counts[flags] != expect:
            raise AssertionError(f"{flags}: expected launches "
                                 f"{_nonzero(expect)}")
        # the s8 products of K3's, K4's and K11's halves by kind, and the
        # first design's pieces: K11-A's forward alone launches them (K11-B
        # and K11-D, the backwards, none)
        counts[flags].update(_check_s8(f"train_cli {flags}", counts[flags],
                                       first_design=True))

    tier8 = dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                 int8_attn_grad=True, int8_dw=True)
    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True,
                      **tier8, int4_mlp=True, int4_attn=True, int4_grad=True)
    bf16 = cfg.replace(int4_mlp=False, int4_attn=False, int4_grad=False,
                       **{k: False for k in tier8})
    params = vit.init_params(set_seed(0), cfg, "cuda")
    names = [n for n, _ in named_leaves(params)]
    for p in param_leaves(params):
        p.requires_grad_(True)
    batch = next(iter(get_dataloader("Synthetic", split="train",
                                     image_size=224, batch_size=TRAIN_BATCH,
                                     num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda().bfloat16()
    labels = torch.from_numpy(batch.labels).cuda()
    # the int4 kernel path against the int4 twin path (logits, and the
    # grads of every parameter for one batch), and the bf16 path against
    # the same twin path, at full width: cut to one layer, where the two
    # int4 paths differ only where a code sits on a .5 tie, within the
    # int8 bands; at all 12, where such a moved code (1/7 of its row's
    # largest value) moves the next layers' codes in turn, held nearer to
    # the twin path than the bf16 path is (on an H100: 1 layer 1.0e-4
    # against 0.41 in logits, 12 layers 0.21 against 0.47; PERF.md)
    dist = {}
    for depth in (1, 12):
        p_d = dict(params, layers=params["layers"][:depth])
        n_d = [n for n in names if not n.startswith("layers/")
               or int(n.split("/")[1]) < depth]
        with torch.inference_mode():
            lk = vit.apply(p_d, images, cfg)
            with _int4_twins(ck):
                lt = vit.apply(p_d, images, cfg)
            lb = vit.apply(p_d, images, bf16)
        ck.reset_launch_counts()
        g_k = _grads(p_d, images, labels, cfg)
        ran = _nonzero(ck.launch_counts())
        with _int4_twins(ck):
            g_t = _grads(p_d, images, labels, cfg)
        g_b = _grads(p_d, images, labels, bf16)
        rels, key_r = _grad_distances(n_d, g_k, g_t)
        rels_b, _ = _grad_distances(n_d, g_b, g_t)
        med = [statistics.median(r for r, _ in x) for x in (rels, rels_b)]
        d_t = (lk - lt).abs().max().item()
        band_t = LOGIT_BAND * max(1.0, lt.abs().max().item())
        dist[depth] = (_rel(lk, lt), _rel(lb, lt), rels[0][0], *med)
        finite = (bool(torch.isfinite(lk).all())
                  and all(bool(torch.isfinite(g).all()) for g in g_k))
        print(f"int4: --int4-attn --int4-grad --int8-dw b32, {depth} "
              f"layer(s): logits max|kernel - twin| {d_t:.3e} (band "
              f"{band_t:.3e}), ‖kernel − twin‖/‖twin‖ {dist[depth][0]:.3e}, "
              f"bf16 path {dist[depth][1]:.3e}; grads of {len(n_d)} tensors "
              f"(launches {ran}), worst |g_kernel - g_twin| / |g_twin|: "
              + ", ".join(f"{r:.3e} ({n})" for r, n in rels[:3])
              + f", median {med[0]:.3e} (bf16 path {med[1]:.3e}), key "
              f"biases {key_r:.3e}", flush=True)
        if (not finite or any(ran.get(n) != depth for n in INT4_KERNELS
                              if "dw" in n or not n.endswith("_bwd"))):
            raise AssertionError(f"int4 path, {depth} layers: launches or "
                                 "values")
        if depth == 1 and (d_t > band_t or rels[0][0] > INT8_GRAD_BAND
                           or key_r > INT8_GRAD_BAND):
            raise AssertionError("int4 kernel path outside its twin's band")
        if depth == 12 and not (dist[12][0] < dist[12][1]
                                and med[0] < med[1]):
            raise AssertionError("int4 kernel path as far from its twin as "
                                 "the bf16 path")
        del g_k, g_t, g_b
    torch.cuda.empty_cache()

    # the 12 layers one by one: each block of the twin path fed the kernel
    # path's input to it, its output and grads held to the int8 bands
    weights = list(param_leaves(params))
    feed_k = _LayerFeed(vit, ("_block",), rows=197)
    with feed_k.run(False):
        vit.apply(params, images, cfg, train=True)
    g_k = _feed_grads(feed_k, weights)
    feed_t = _LayerFeed(vit, ("_block",), rows=197)
    feed_t.inputs = feed_k.inputs
    with _int4_twins(ck), feed_t.run(True):
        vit.apply(params, images, cfg, train=True)
        g_t = _feed_grads(feed_t, weights)
    rows = _layer_hold(feed_k, feed_t, g_k, g_t, names)
    dist["12, fed"] = rows
    print("int4: 12 layers b32, each fed the kernel path's input, per layer "
          f"(its contribution ‖Δ‖/‖t‖ <= {LOGIT_BAND}, max|Δ| / max|t|; "
          f"worst grad ‖Δ‖/‖t‖ <= {INT8_GRAD_BAND}): " + "; ".join(
              f"{l} {o:.2e} {m:.2e} {r:.2e} ({n})"
              for l, (o, m, r, n) in enumerate(rows)), flush=True)
    del feed_k, feed_t, g_k, g_t
    torch.cuda.empty_cache()

    no_int4 = dict(int4_mlp=False, int4_attn=False, int4_grad=False)
    paths = [("bf16", cfg.replace(**no_int4, **{k: False for k in tier8})),
             ("--int8-dw", cfg.replace(**no_int4)),
             ("--int4-attn --int8-dw", cfg.replace(int4_grad=False)),
             ("--int4-attn --int4-grad --int8-dw", cfg)]
    runs = _time_steps(params, images, labels, paths + paths[::-1], iters=5)
    del params
    torch.cuda.empty_cache()
    return counts, {k: [ms for n, ms in runs if n == k] for k, _ in paths}, \
        dist


# ---------------------------------------------------------------- phase 14
# Res-ViT's int4 (the rect half's A4W4 forward R-F and int4_grad backward
# R-B, R-B dw; K11's kv_heads branches G-F, G-B): each kernel against its
# twin at the main path's shapes (Res-ViT b16 serving at b64 and training at
# b32, spq 200, C 0.625's cpq 128, 4 kv heads), held to K11's band
# (INT4_REL; the bf16 stand-in must miss it), its codes to
# RESVIT_INT4_CODE_BAND (K11's, with x's rows' xqk and dkvq as xq and dqq,
# dK/dV's column pack dkvc as dqc); each timed beside its int8 counterpart
# in the same turns
RESVIT_INT4_PAIRS = {
    "fused_ln_qkvo_attention_rect_int4": "fused_ln_qkvo_attention_rect_int8",
    "fused_ln_qkvo_attention_rect_int4_bwd":
        "fused_ln_qkvo_attention_rect_int8_bwd",
    "fused_ln_qkvo_attention_rect_int4_dw_bwd":
        "fused_ln_qkvo_attention_rect_int8_dw_bwd",
    "fused_ln_qkvo_attention_int4_gqa": "fused_ln_qkvo_attention_int8_gqa",
    "fused_ln_qkvo_attention_int4_gqa_bwd":
        "fused_ln_qkvo_attention_int8_gqa_bwd",
    "fused_ln_qkvo_attention_int4_gqa_dw_bwd":
        "fused_ln_qkvo_attention_int8_gqa_dw_bwd",
}
RESVIT_INT4_KERNELS = tuple(RESVIT_INT4_PAIRS)
# one xq code moved one int4 step (on a .5 tie) moves its image's q, k and
# v, and with them the column packs of that image's attn, dq and dK/dV: R-B
# dw at b32 cpq 128 moved one xq code of 3.1e6 and 1.6e-3–2.1e-3 of those
# column codes by up to 5 steps (an H100); K11-D's moved up to 3
RESVIT_INT4_CODE_BAND = dict(INT4_CODE_BAND, xqk=(1, 1e-3), dkvq=(1, 1e-3),
                             xnk=(2, 1e-3), atc=(6, 5e-3), dqc=(6, 5e-3),
                             dkvc=(6, 5e-3))
# (label, batch, rows, seq_len, cap or kv heads, kernels)
RESVIT_INT4_CASES = [
    ("b64 cap124 cpq128 (C 0.625)", 64, 200, 197, 124,
     RESVIT_INT4_KERNELS[:1]),
    ("b32 cap124 cpq128 (C 0.625)", 32, 200, 197, 124,
     RESVIT_INT4_KERNELS[1:3]),
    ("b64 spq200 kv4", 64, 200, 197, 4, RESVIT_INT4_KERNELS[3:4]),
    ("b32 spq200 kv4", 32, 200, 197, 4, RESVIT_INT4_KERNELS[4:]),
]
# resvit_train_cli: each int4 flag set of the CPU tests, compacted (the rect
# half) and with 4 kv heads (G-F, G-B and a gather), RESVIT_INT4_STEPS steps
# of b32 and an eval epoch, exact launches a step and eval batch
RESVIT_INT4_FLAGS = ["--int4", "--int4-attn",
                     "--int4-attn --int4-grad --int8-grad",
                     "--int4-attn --int4-grad --int8-dw"]
RESVIT_INT4_STEPS = 2
RESVIT_INT4_RUNS = [(f"{f} C 0.625", f.split() + COMPACT
                     + ["--compact-warmup", "0"]) for f in RESVIT_INT4_FLAGS] \
    + [(f"{f} kv4 C 0.625", f.split() + ["--n_kv_heads", "4"] + COMPACT
        + ["--compact-warmup", "0"]) for f in RESVIT_INT4_FLAGS]


def check_resvit_int4_kernels(stats):
    """Phase 14, kernels: R-F, R-B, R-B dw, G-F and G-B (both dw tiers)
    against their twins on every output (`_check_int8` with the int4 code
    band: codes, INT4_REL, the bf16 stand-in), two launches the same bits;
    CUDA-event times beside their int8 counterparts (K8 int8, K7's int8
    tier), two turns, the second in reverse order."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in RESVIT_INT4_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    for i, (label, batch, rows, seq_len, extra, names) in enumerate(
            RESVIT_INT4_CASES):
        t = _inputs(batch, rows, seed=140 + i)
        g = torch.Generator(device="cuda").manual_seed(150 + i)
        if "kv" in label:
            width = (HEADS + 2 * extra) * HEAD_DIM
            t["wqkv"] = (torch.randn((D, width), generator=g, device="cuda")
                         * D ** -0.5).to(torch.bfloat16)
            t["bqkv"] = 0.02 * torch.randn(width, generator=g, device="cuda")
            head = (t["x"],)
            do = torch.randn(t["x"].shape, generator=g, device="cuda").to(
                torch.bfloat16)
            tail = (EPS, seq_len, HEADS, HEAD_DIM, extra)
        else:
            xc, _ = _rect_inputs(t, extra, seq_len, seed=160 + i)
            head = (xc, t["x"])
            do = torch.randn(xc.shape, generator=g, device="cuda").to(
                torch.bfloat16)
            do[:, extra:] = 0  # the caller cuts the pad rows off
            tail = (EPS, seq_len, HEADS, HEAD_DIM)
        w = (t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"])
        calls = {n: (*head, *w, do if n.endswith("_bwd") else t["bo"], *tail)
                 for n in names}
        timed = {}
        for name, args in calls.items():
            with torch.no_grad():
                ck.first_design_launch_counts(reset=True)
                outs = getattr(ck, name)(*args)
                again = getattr(ck, name)(*args)
                torch.cuda.synchronize()
                # G-F and G-B run K3's Hopper sequences and R-B K8's int8
                # one: no first-design piece (R-F keeps the first design)
                fd = ck.first_design_launch_counts(reset=True)
                if name != RESVIT_INT4_KERNELS[0] and any(fd.values()):
                    raise AssertionError(f"{name}: first-design pieces {fd}")
                refs = getattr(ck, name + "_ref")(*args)
                if not isinstance(outs, tuple):
                    outs, again, refs = (outs,), (again,), (refs,)
                if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                    raise AssertionError(f"{name}: two launches differ")
                for o, r in zip(outs, refs):
                    if not (bool(torch.isfinite(o).all())
                            and o.shape == r.shape and o.dtype == r.dtype):
                        raise AssertionError(f"{name} {label}: "
                                             f"{tuple(o.shape)} {o.dtype}, "
                                             "or not finite")
                errs = [(o.float() - r.float()).abs().max().item()
                        for o, r in zip(outs, refs)]
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 *errs)
                # codes, ‖k − t‖/‖t‖ and the stand-in, at K11's INT4_REL: a
                # code moved one int4 step moves its element by 1/7 of its
                # row's largest value, past the bf16 per-element tolerance,
                # and R-B's dx-path past INT8_REL (6.0e-3 measured on an
                # H100, its dqq codes 1.2e-4 moved, one step)
                _check_int8(ck, name, label, args, outs, refs, stats,
                            RESVIT_INT4_CODE_BAND, INT4_REL)
            print(f"  {name:40s} {label:28s} max|k-ref| per output "
                  f"[{' '.join(f'{e:.2e}' for e in errs)}]; two launches "
                  f"the same bits; first-design pieces {_nonzero(fd)}",
                  flush=True)
            del outs, again, refs
            int8 = RESVIT_INT4_PAIRS[name]
            timed[name] = lambda n=name, a=args: getattr(ck, n)(*a)
            timed[int8] = lambda n=int8, a=args: getattr(ck, n)(*a)
        ms = {n: [] for n in timed}
        with torch.no_grad():
            for turn in range(2):
                for n, fn in (timed.items() if turn == 0
                              else reversed(timed.items())):
                    ms[n].append(_median_ms(fn, warmup=2, iters=10))
            for name, args in calls.items():
                stats[name].update(
                    ms=min(ms[name]), int8_ms=min(ms[RESVIT_INT4_PAIRS[name]]),
                    ms_turns=ms[name],
                    int8_ms_turns=ms[RESVIT_INT4_PAIRS[name]],
                    shape=(batch, rows, head[0].shape[1] if len(head) == 2
                           else extra),
                    plain_ms=_median_ms(
                        lambda n=name, a=args: getattr(ck, n + "_ref")(*a),
                        warmup=1, iters=3))
        print(f"  {label} (CUDA events, medians of 10, two turns, the second "
              "in reverse order): " + ", ".join(
                  f"{n} {' / '.join(f'{v:.4f}' for v in ms[n])} ms"
                  for n in timed) + "; twins " + ", ".join(
                  f"{n} {stats[n]['plain_ms']:.4f}" for n in names),
              flush=True)
        del t, calls, do
        torch.cuda.empty_cache()
    return stats


class _LayerFeed:
    """Runs a model with each of its blocks cut from the one before: the
    block functions `names` of `module` (the student's calls, under
    autograd) take a leaf input. Recording, the input is the model's own;
    feeding, it is the recorded one, so a second path gets the first path's
    input at every layer. `loss()` is Σ_l <out_l, r_l> over the real rows
    (seeded random r_l), whose grads of a layer's weights and of its input
    come from that layer alone."""

    def __init__(self, module, names, rows=None):
        self.module, self.names, self.rows = module, names, rows
        self.inputs, self.leaves, self.outs = [], [], []

    @contextlib.contextmanager
    def run(self, feed):
        import torch
        saved = {n: getattr(self.module, n) for n in self.names}
        self.leaves, self.outs = [], []

        def wrap(fn):
            def block(x, *a, **k):
                if not torch.is_grad_enabled():  # Res-ViT's teacher
                    return fn(x, *a, **k)
                if not feed:
                    self.inputs.append(x.detach())
                leaf = self.inputs[len(self.leaves)].clone().requires_grad_()
                out = fn(leaf, *a, **k)
                self.leaves.append(leaf)
                self.outs.append(out)
                return out
            return block

        for n, f in saved.items():
            setattr(self.module, n, wrap(f))
        try:
            yield self
        finally:
            for n, f in saved.items():
                setattr(self.module, n, f)

    def loss(self):
        import torch
        dev = self.outs[0].device
        g = torch.Generator(device=dev).manual_seed(5)
        total = 0.0
        for out in self.outs:
            o = out[:, :self.rows] if self.rows else out
            r = torch.randn(o.shape, generator=g, device=dev)
            total = total + (o.float() * r).sum()
        return total


def _feed_grads(feed, weights):
    """The grads of `feed.loss()` of each block's input leaf, then of each
    of `weights` (None where a weight is not in any block)."""
    import torch
    return torch.autograd.grad(feed.loss(), feed.leaves + weights,
                               allow_unused=True)


def _layer_hold(feed_k, feed_t, g_k, g_t, names):
    """Per layer, the kernel path against the twin path fed the kernel
    path's input: the layer's own contribution to the stream (output −
    input, real rows; K5's check holds a half the same way), ‖Δ‖/‖t‖
    against LOGIT_BAND, the int8 logit band as a relative distance (one
    int4 code moved on a .5 tie moves its element by 1/7 of its row's
    largest value, so the largest element error over millions is no
    measure); the grads (`_feed_grads`) of its input and of each weight
    `names` puts in the layer, ‖Δ‖/‖t‖ against INT8_GRAD_BAND (the key
    biases, whose exact grad is 0, as a ratio to their layer's query bias).
    Returns per layer (contribution distance, its max|Δ| over max|t|, worst
    grad distance, its tensor)."""
    n_layers = len(feed_k.leaves)
    rows = []
    for l in range(n_layers):
        x = feed_k.inputs[l]
        ok, ot = feed_k.outs[l] - x, feed_t.outs[l] - x
        if feed_k.rows:
            ok, ot = ok[:, :feed_k.rows], ot[:, :feed_k.rows]
        err = _rel(ok, ot)
        top = ((ok.float() - ot.float()).abs().max()
               / ot.float().abs().max().clamp_min(1e-30)).item()
        rels = [(_rel(g_k[l], g_t[l]), "input")]
        for j, n in enumerate(names):
            if not n.startswith(f"layers/{l}/") or g_t[n_layers + j] is None:
                continue
            a, b = g_k[n_layers + j], g_t[n_layers + j]
            if n.endswith("attn/key/bias"):
                q = g_t[n_layers + names.index(n.replace("/key/", "/query/"))]
                rels.append((a.norm().item() / max(q.norm().item(), 1e-30),
                             n))
            elif b.norm() > 0:
                rels.append((_rel(a, b), n))
        worst = max(rels)
        rows.append((err, top, worst[0], worst[1]))
        if err > LOGIT_BAND or worst[0] > INT8_GRAD_BAND:
            raise AssertionError(f"layer {l}: contribution {err}, grad "
                                 f"{worst}")
    return rows


def _resvit_int4_launch_runs(exp_root):
    """resvit_train_cli with RESVIT_INT4_RUNS: vitax's int4 warning, finite
    losses and metrics, the launches of every step and eval batch as
    `_resvit_launches` derives vitax's dispatch."""
    import torch
    from vitax_torch import resvit_train_cli
    from vitax_torch.ops import cuda_kernels as ck
    counts = {}
    for label, extra in RESVIT_INT4_RUNS:
        log, buf = [], io.StringIO()
        args = RESVIT_TRAIN_ARGS + extra + [
            "--batch-size", str(TRAIN_BATCH), "--synthetic-samples",
            str(TRAIN_BATCH * RESVIT_INT4_STEPS), "--train-steps",
            str(RESVIT_INT4_STEPS), "--exp-root", exp_root]
        ck.reset_launch_counts()
        with _step_launches(ck, log), contextlib.redirect_stdout(buf):
            out = resvit_train_cli.main(args)
        counts[label] = ck.launch_counts()
        # the s8 products by kind and, but where K7's bf16 pair runs (the
        # kv4 runs without int8_grad), the first design's pieces: R-F's,
        # K7's int8 forward's and K11-A's alone (R-B, G-B, K11-B and
        # K11-D, the backwards, launch none)
        k7 = any(counts[label].get(n) for n in (
            "fused_ln_qkvo_attention_gqa", "fused_ln_qkvo_attention_gqa_bwd"))
        _check_s8(f"resvit_train_cli {label}", counts[label],
                  first_design=not k7)
        shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)
        bad = [(kind, {k: v for k, v in got.items() if v})
               for kind, c, got in log
               if got != _resvit_launches(c, kind == "train")]
        steps = [got for kind, _, got in log if kind == "train"]
        valid = out["epochs"][-1]
        print(f"resvit-int4: resvit_train_cli {label} b{TRAIN_BATCH}: valid "
              f"acc1 {valid['acc1']:.4f} loss {valid['loss']:.4f}; launches "
              f"as vitax's dispatch picks: {not bad} (a step: " + ", ".join(
                  f"{k} {v}" for k, v in steps[-1].items() if v) + ")",
              flush=True)
        if (bad or len(steps) != RESVIT_INT4_STEPS
                or "MEASURED DIVERGENT" not in buf.getvalue()
                or not all(math.isfinite(v) for v in valid.values())):
            raise AssertionError(f"{label}: launches {bad}, {len(steps)} "
                                 f"steps, valid {valid}")
    torch.cuda.empty_cache()
    return counts


def run_resvit_int4_slice(exp_root):
    """Phase 14, paths: resvit_train_cli with each int4 flag set (exact
    launches); the b16 Res-ViT with --int4-attn --int4-grad --int8-dw at C
    0.625 against its int4 twin path (one routed layer end to end; the
    12-layer model layer by layer, each layer fed the kernel path's input
    and keep bits); resident b32 steps of (d) and (e) beside their int4
    tiers; eval_cli at ViT-L/16 @384 (K6, not K1; --int8 raises)."""
    import torch
    from vitax_torch import eval_cli
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import resvit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.resvit_train_cli import (config_to_model_args,
                                              get_train_config)
    from vitax_torch.train.optim import param_leaves, tree_leaves
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_train_step)
    from vitax_torch.utils.memory import named_leaves

    with _random_router_biases():
        counts = _resvit_int4_launch_runs(exp_root)
        base = config_to_model_args(get_train_config(
            RESVIT_TRAIN_ARGS + ["--exp-root", exp_root, "--int4-attn",
                                 "--int4-grad", "--int8-dw",
                                 "--compact-capacity", "0.625"]), "cuda")
        params = resvit.init_params(set_seed(0), base, "cuda")
        one = base.replace(n_layers=1, dynamic_start_layer=0)
        p_one = resvit.init_params(set_seed(1), one, "cuda")
    shutil.rmtree(exp_root, ignore_errors=True)
    dist = {}
    g = torch.Generator(device="cuda").manual_seed(13)
    batch = 16
    images = torch.randn((batch, 224, 224, 3), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.randint(0, 10, (batch,), generator=g, device="cuda")

    # one routed layer end to end (its router, the rect half R-F / R-B dw,
    # the MLP half K11-A / K11-B dw, the teacher's K11-C), kernel path
    # against twin path, the noise injected and the routing replayed
    for t, m in zip(param_leaves(p_one), tree_leaves(
            resvit.trainable_mask(p_one, one))):
        t.requires_grad_(m)
    noise = _train_noise(one, batch, seed=17)
    replay = _RoutingReplay(resvit)
    ck.reset_launch_counts()
    lk, g_k = _resvit_grads(p_one, images, labels, one, noise,
                            replay.record())
    ran = _nonzero(ck.launch_counts())
    with _int4_twins(ck):
        lt, g_t = _resvit_grads(p_one, images, labels, one, noise,
                                replay.replay())
    names = [n for (n, _), m in zip(named_leaves(p_one), tree_leaves(
        resvit.trainable_mask(p_one, one))) if m]
    rels = sorted(((_rel(a, b), n) for a, b, n in zip(g_k, g_t, names)
                   if b.norm() > 0), reverse=True)
    d_log = (lk - lt).abs().max().item()
    band = LOGIT_BAND * max(1.0, lt.abs().max().item())
    dist["1 routed layer"] = (d_log, rels[0][0], rels[0][1])
    print(f"resvit-int4: one routed layer b{batch} C 0.625, --int4-attn "
          f"--int4-grad --int8-dw, kernel vs twin path (launches {ran}): "
          f"logits max|Δ| {d_log:.3e} (band {band:.3e}); worst grad of "
          f"{len(names)} trainable tensors " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels[:3])
          + f" <= {INT8_GRAD_BAND}", flush=True)
    if (d_log > band or rels[0][0] > INT8_GRAD_BAND
            or not all(ran.get(n) for n in (
                "fused_ln_qkvo_attention_rect_int4",
                "fused_ln_qkvo_attention_rect_int4_dw_bwd"))):
        raise AssertionError("one routed int4 layer outside the int8 bands")
    del p_one, g_k, g_t

    # the 12-layer model, layer by layer: each block of the twin path fed
    # the kernel path's input to it, the keep bits replayed
    cfg = base
    names = [n for n, _ in named_leaves(params)]
    weights = list(param_leaves(params))
    for t, m in zip(weights, tree_leaves(resvit.trainable_mask(params,
                                                                cfg))):
        t.requires_grad_(m)
    pick = [j for j, t in enumerate(weights) if t.requires_grad]
    names, weights = [names[j] for j in pick], [weights[j] for j in pick]
    noise = _train_noise(cfg, batch, seed=19)
    replay = _RoutingReplay(resvit)
    blocks = ("plain_block", "compact_routed_block")
    feed_k = _LayerFeed(resvit, blocks)
    with feed_k.run(False), replay.record():
        resvit.apply(params, images, cfg, train=True, noise=noise)
    g_k = _feed_grads(feed_k, weights)
    feed_t = _LayerFeed(resvit, blocks)
    feed_t.inputs = feed_k.inputs
    with _int4_twins(ck), feed_t.run(True), replay.replay():
        resvit.apply(params, images, cfg, train=True, noise=noise)
        g_t = _feed_grads(feed_t, weights)
    rows = _layer_hold(feed_k, feed_t, g_k, g_t, names)
    dist["12 layers, fed"] = rows
    print("resvit-int4: 12 layers b16, each fed the kernel path's input and "
          f"keep bits, per layer (its contribution ‖Δ‖/‖t‖ <= {LOGIT_BAND}, "
          f"max|Δ| / max|t|; worst grad ‖Δ‖/‖t‖ <= {INT8_GRAD_BAND}): "
          + "; ".join(f"{l} {o:.2e} {m:.2e} {r:.2e} ({n})"
                      for l, (o, m, r, n) in enumerate(rows)), flush=True)
    del feed_k, feed_t, g_k, g_t
    torch.cuda.empty_cache()

    # resident b32 steps: (d) --int8-grad C 0.625 and (e) GQA C 0.625
    # (--int8-grad) beside their --int4-attn --int4-grad tiers, in turns
    gqa = cfg.replace(n_kv_heads=4)
    with _random_router_biases():
        gqa_params = resvit.init_params(set_seed(0), gqa, "cuda")
    int8 = dict(int4_mlp=False, int4_attn=False, int4_grad=False,
                int8_dw=False)
    paths = {"(d) --int8-grad C 0.625": (cfg.replace(**int8), params),
             "(d) --int4-attn --int4-grad": (cfg.replace(int8_dw=False),
                                             params),
             "(e) kv4 --int8-grad C 0.625": (gqa.replace(**int8),
                                             gqa_params),
             "(e) kv4 --int4-attn --int4-grad": (gqa.replace(int8_dw=False),
                                                 gqa_params)}
    images = torch.randn((TRAIN_BATCH, 224, 224, 3), generator=g,
                         device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 10, (TRAIN_BATCH,), generator=g, device="cuda")
    lam = Lambdas(*RESVIT_LAMBDAS)
    steps = {k: [] for k in paths}
    for turn in range(2):
        for key, (c, p) in (paths.items() if turn == 0
                            else reversed(paths.items())):
            tx = make_adamw_for(c, p, lambda s: 1e-4)
            state = create_state(p, tx, torch.Generator(device="cuda")
                                 .manual_seed(3))
            step = make_train_step(c, tx, lam)
            steps[key].append(_median_ms(lambda: step(state, images, labels),
                                         warmup=2, iters=5))
            del tx, state
    del params, gqa_params
    torch.cuda.empty_cache()
    print("resvit-int4: steps b32 (teacher + student forward, backward, "
          "AdamW; medians of 5, two turns, the second in reverse order): "
          + "; ".join(f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
                      for k, ms in steps.items()), flush=True)

    # ViT-L/16 at eval_cli's default 384 px: vitax's K1 gate rejects it,
    # so K6 runs (24 a forward, with 24 K2 and one LN) and --int8 raises
    l16 = ["--model-arch", "l16", "--image-size", "384", "--dataset",
           "Synthetic", "--synthetic-samples", "16", "--batch-size", "8",
           "--num-classes", "10", "--seed", "0"]
    ck.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        eval_cli.main(l16)
    counts["eval_cli l16 @384"] = ck.launch_counts()
    expect = _expect(fused_ln_qkvo_attention_flash=48, fused_ln_mlp=48,
                     layer_norm=2)
    raised = ""
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            eval_cli.main(l16 + ["--int8"])
    except NotImplementedError as e:
        raised = str(e)
    print(f"resvit-int4: eval_cli --model-arch l16 --image-size 384 b8, 2 "
          f"batches: launches {_nonzero(counts['eval_cli l16 @384'])}; "
          f"--int8 raises: {raised[:90]}...", flush=True)
    if (counts["eval_cli l16 @384"] != expect
            or "Queue 1 item 8" not in raised):
        raise AssertionError("l16 @384: not K6, or --int8 did not raise")
    torch.cuda.empty_cache()
    return counts, steps, dist


# ---------------------------------------------------------------- phase 15
# K10 (fused_qkv_attention, forward and backward): the attention half of the
# b16 Res-ViT built from ft_resvit.sh's flags with fused_qkvo off in code
# (both CLIs tie fused_qkvo to fused_qkv, as vitax's)
K10_KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd")
D640 = 640, 8, 80, 2560  # head dim 80 (d 640 with 8 heads)
# (label, batch, spq, seq_len, dims, timed): serving's b64 (the table's
# forward time), training's b32 (the backward's), and two shapes only K13's
# core takes (the first design refused them): B/16 @416 (seq 677 in spq
# 680) and head dim 80; each has D = H·Hd, so K9's inputs (`_k9_inputs`)
# serve, their dY as K10's dO on the heads' outputs
K10_CASES = [("b64 spq200 (serving)", 64, 200, 197, B16, True),
             ("b8 spq680 (B/16 @416)", 8, 680, 677, B16, False),
             ("b32 spq200 Hd80 (d640)", 32, 200, 197, D640, False)]
K10_BWD_CASES = [("b32 spq200 (training)", 32, 200, 197, B16, True),
                 ("b8 spq680 (B/16 @416)", 8, 680, 677, B16, False),
                 ("b32 spq200 Hd80 (d640)", 32, 200, 197, D640, False)]
# routing maps of the K10 path against the plain (or twin) path, share of
# keep bits that agree: both round at the same points, so only a token whose
# keep and skip logits sit within a few bf16 ulps of each other can flip:
# 0.99962-0.99970 measured on the card at b64 (K1's path 0.99989, phase 8);
# the band leaves 5x the flips measured
ROUTING_AGREE = 0.998


def check_k10_kernels(stats):
    """Phase 15, kernels: K10's forward (b64 spq 200, B/16 @416's spq 680,
    head dim 80) and every output of its backward (b32 spq 200, spq 680,
    head dim 80) against the twins (TOL, as phase 3 holds K1 and its
    backward), two backward launches the same bits, no first-design piece
    in K10's launches; K10's forward against K9's with Wo = I and bo = 0
    (an exact out-projection) to the bit; CUDA-event medians of kernel and
    twin."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in K10_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    name = "fused_qkv_attention"
    for label, batch, rows, seq, dims, timed in K10_CASES:
        x, t, _ = _k9_inputs(batch, rows, seq, dims, seed=150)
        args = (x, t["wqkv"], t["bqkv"], seq, dims[1], dims[2])
        with torch.inference_mode():
            ck.first_design_launch_counts(reset=True)
            out = ck.fused_qkv_attention(*args)
            torch.cuda.synchronize()
            _no_first_design(name, label)
            err, bound = _hold(name, label, out,
                               ck.fused_qkv_attention_ref(*args), stats)
            eye = torch.eye(dims[0], device="cuda", dtype=torch.bfloat16)
            k9 = ck.fused_qkvo_attention(*args[:3], eye,
                                         torch.zeros(dims[0], device="cuda"),
                                         *args[3:])
            if not torch.equal(out, k9):
                raise AssertionError(f"{name} {label}: not K9's output with "
                                     "Wo = I, bo = 0")
            line = ""
            if timed:
                k_ms = _median_ms(lambda: ck.fused_qkv_attention(*args))
                _no_first_design(name, label)
                p_ms = _median_ms(lambda: ck.fused_qkv_attention_ref(*args))
                stats[name].update(ms=k_ms, plain_ms=p_ms,
                                   shape=(batch, rows))
                line = (f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms "
                        "(median of 25)")
        print(f"  {name:32s} {label:22s} {tuple(out.shape)} max|k-ref| "
              f"{err:.3e} <= {bound:.3e}, K9 with Wo = I to the bit, no "
              f"first-design piece: ok{line}", flush=True)
        del x, t, out, k9
        torch.cuda.empty_cache()
    name = "fused_qkv_attention_bwd"
    for label, batch, rows, seq, dims, timed in K10_BWD_CASES:
        x, t, do = _k9_inputs(batch, rows, seq, dims, seed=151)
        args = (x, t["wqkv"], t["bqkv"], do, seq, dims[1], dims[2])
        with torch.no_grad():
            ck.first_design_launch_counts(reset=True)
            outs = ck.fused_qkv_attention_bwd(*args)
            again = ck.fused_qkv_attention_bwd(*args)
            torch.cuda.synchronize()
            _no_first_design(name, label)
            errs = _hold_all(name, label, outs,
                             ck.fused_qkv_attention_bwd_ref(*args), stats)
            if not all(torch.equal(o, a) for o, a in zip(outs, again)):
                raise AssertionError(f"{name} {label}: two launches differ")
            del outs, again
            line = ""
            if timed:
                k_ms = _median_ms(lambda: ck.fused_qkv_attention_bwd(*args),
                                  warmup=2, iters=10)
                _no_first_design(name, label)
                p_ms = _median_ms(
                    lambda: ck.fused_qkv_attention_bwd_ref(*args), warmup=1,
                    iters=5)
                stats[name].update(ms=k_ms, plain_ms=p_ms,
                                   shape=(batch, rows))
                line = (f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms "
                        "(medians of 10 / 5)")
        print(f"  {name:32s} {label:22s} max|k-ref| per output (dx, dW, db) "
              f"[{' '.join(errs)}]: ok, two launches the same bits, no "
              f"first-design piece{line}", flush=True)
        del x, t, do
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _k10_twin(ck):
    """K10's wrapper routed to its twin (inference only), by the module name
    the model calls."""
    saved = ck.fused_qkv_attention
    ck.fused_qkv_attention = ck.fused_qkv_attention_ref
    try:
        yield
    finally:
        ck.fused_qkv_attention = saved


def run_k10_slice(exp_root):
    """Phase 15, paths: the b16 Res-ViT of ft_resvit.sh's flags with
    fused_qkvo off (config_to_model_args, then .replace), serving b64 dense
    and at C 0.625, bf16 and --int8, through make_eval_step with exact
    launches a forward and no first-design piece (`_check_s8`); logits (the routing replayed) within LOGIT_BAND of
    the plain path (the twin path for --int8) and the routing maps; two b32
    train steps of (a) through make_train_step with exact launches a step
    and no first-design piece;
    the grads of every trainable tensor against the plain path (noise
    injected, routing replayed); resident b64 forwards and b32 steps beside
    the K1 path (fused_qkvo on), in turns."""
    import torch
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import resvit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.resvit_eval_cli import get_eval_config
    from vitax_torch.resvit_train_cli import (config_to_model_args,
                                              get_train_config)
    from vitax_torch.train.optim import tree_leaves
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_eval_step,
                                                make_train_step)
    from vitax_torch.utils.memory import named_leaves

    serve = {tier: config_to_model_args(get_eval_config(RESVIT_ARGS + extra),
                                        "cuda").replace(fused_qkvo=False)
             for tier, extra in (("bf16", []), ("--int8", ["--int8"]))}
    with _random_router_biases():
        params = resvit.init_params(set_seed(0), serve["bf16"], "cuda")
    data = next(iter(get_dataloader("Synthetic", split="val", image_size=224,
                                    batch_size=64, num_samples=64, seed=0)))
    images = torch.from_numpy(data.images).cuda().bfloat16()
    labels = torch.from_numpy(data.labels).cuda()
    weight = torch.from_numpy(data.weight).cuda()
    plain = dict(fused_qkv=False, fused_qkvo=False, fused_mlp=False,
                 use_pallas=False)
    counts, dist = {}, {}
    for tier, base in serve.items():
        for cap in (None, 0.625):
            cfg = base.replace(compact_capacity=cap)
            label = f"{tier} " + (f"C {cap}" if cap else "dense")
            ck.reset_launch_counts()
            metrics, _ = make_eval_step(cfg)(params, images, labels, weight)
            counts[label] = ck.launch_counts()
            _check_s8(f"k10 {label}", counts[label], first_design=True)
            expect = _resvit_launches(cfg, False)
            log = _RouterLog(resvit)
            with torch.inference_mode():
                with log.record():
                    lk, aux_k = resvit.apply(params, images, cfg)
                if tier == "bf16":
                    other, ref, twins = "plain", cfg.replace(**plain), None
                else:
                    other, ref, twins = "twin", cfg, _int8_twins(ck)
                with twins or contextlib.nullcontext(), _k10_twin(ck):
                    _, aux_r = resvit.apply(params, images, ref)
                    with log.replay():
                        lr, _ = resvit.apply(params, images, ref)
            agree = [(aux_k["routing_maps"][k] == aux_r["routing_maps"][k])
                     .float().mean().item() for k in aux_k["routing_maps"]]
            d_log = (lk - lr).abs().max().item()
            band = LOGIT_BAND * max(1.0, lr.abs().max().item())
            dist[label] = (d_log, min(agree))
            print(f"k10: make_eval_step {label} b64: loss "
                  f"{float(metrics['loss']):.4f} active "
                  f"{float(metrics['non_low_rank_ratio']):.4f}; launches "
                  f"{_nonzero(counts[label])} (as derived: "
                  f"{counts[label] == expect}); logits max|k10 - {other}| "
                  f"(routing replayed) {d_log:.3e} <= {band:.3e}; routing "
                  f"maps agree {min(agree):.5f} >= {ROUTING_AGREE}",
                  flush=True)
            if (counts[label] != expect or not torch.isfinite(lk).all()
                    or d_log > band or min(agree) < ROUTING_AGREE):
                raise AssertionError(f"k10 serving {label} failed")

    # training: ft_resvit.sh's flags at b32, two steps
    cfg = config_to_model_args(get_train_config(
        RESVIT_TRAIN_ARGS + ["--exp-root", exp_root]),
        "cuda").replace(fused_qkvo=False)
    with _random_router_biases():
        tparams = resvit.init_params(set_seed(0), cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(15)
    images = torch.randn((TRAIN_BATCH, 224, 224, 3), generator=g,
                         device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 10, (TRAIN_BATCH,), generator=g, device="cuda")
    lam = Lambdas(*RESVIT_LAMBDAS)
    tx = make_adamw_for(cfg, tparams, lambda s: 1e-4)
    state = create_state(tparams, tx, torch.Generator(device="cuda")
                         .manual_seed(3))
    step = make_train_step(cfg, tx, lam)
    expect = _resvit_launches(cfg, True)
    for i in range(2):
        ck.reset_launch_counts()
        state, m = step(state, images, labels)
        got = ck.launch_counts()
        counts[f"train step {i}"] = got
        _check_s8(f"k10 train step {i}", got, first_design=True)
        print(f"k10: train step {i} b{TRAIN_BATCH} (a): loss "
              f"{float(m['loss']):.4f}; launches {_nonzero(got)} (as "
              f"derived: {got == expect})", flush=True)
        if got != expect or not math.isfinite(float(m["loss"])):
            raise AssertionError(f"k10 train step {i}: expected {expect}")
    del tx, state
    noise = _train_noise(cfg, TRAIN_BATCH, seed=16)
    replay = _RoutingReplay(resvit)
    lk, g_k = _resvit_grads(tparams, images, labels, cfg, noise,
                            replay.record())
    lp, g_p = _resvit_grads(tparams, images, labels, cfg.replace(**plain),
                            noise, replay.replay())
    names = [n for (n, _), m in zip(named_leaves(tparams), tree_leaves(
        resvit.trainable_mask(tparams, cfg))) if m]
    rels = sorted(((_rel(a, b), n) for a, b, n in zip(g_k, g_p, names)
                   if b.norm() > 0), reverse=True)
    d_log = (lk - lp).abs().max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in g_k)
    dist["grads"] = (rels[0][0], rels[0][1], d_log)
    print(f"k10: grads b{TRAIN_BATCH} of {len(names)} trainable tensors, "
          f"worst |g_k10 - g_plain| / |g_plain|: " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels[:3])
          + f" <= {GRAD_BAND}; logits max|k10 - plain| {d_log:.3e}",
          flush=True)
    if not finite or rels[0][0] > GRAD_BAND or len(g_k) != len(names):
        raise AssertionError("k10 grads outside the band")
    del g_k, g_p
    torch.cuda.empty_cache()

    # resident b64 forwards and b32 steps, K10's path and K1's, in turns
    times = {"forward b64 k10": [], "forward b64 k1": [],
             "step b32 k10": [], "step b32 k1": []}
    fwd_images = torch.randn((64, 224, 224, 3), generator=g, device="cuda",
                             dtype=torch.bfloat16)
    for turn in range(2):
        for path in (("k10", "k1") if turn == 0 else ("k1", "k10")):
            c = cfg.replace(fused_qkvo=path == "k1")
            with torch.inference_mode():
                times[f"forward b64 {path}"].append(_median_ms(
                    lambda: resvit.apply(params, fwd_images, c), warmup=2,
                    iters=5))
            tx = make_adamw_for(c, tparams, lambda s: 1e-4)
            state = create_state(tparams, tx, torch.Generator(device="cuda")
                                 .manual_seed(3))
            step = make_train_step(c, tx, lam)
            times[f"step b32 {path}"].append(_median_ms(
                lambda: step(state, images, labels), warmup=2, iters=5))
            del tx, state
    print("k10: resident b64 forwards (dense) and b32 steps (a), medians of "
          "5, two turns, the second in reverse order: " + "; ".join(
              f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
              for k, ms in times.items()), flush=True)
    del params, tparams
    torch.cuda.empty_cache()
    return counts, times, dist


# ---------------------------------------------------------------- phase 16
# K9 (fused_qkvo_attention, forward and backward), K2 without its residual
# (fused_ln_mlp_partial, forward and backward) and the parallel layer:
# Res-ViT under a (1, 1) NCCL mesh (vitax's dispatch under any mesh: the LN
# kernel, then K9), train_cli --n-gpu 1 under that group, train_cli
# --n-model 2 in two gloo processes on the one card
K9_KERNELS = ("fused_qkvo_attention", "fused_qkvo_attention_bwd")
PARTIAL_KERNELS = ("fused_ln_mlp_partial", "fused_ln_mlp_partial_bwd")
TP_SHARD = (768, 6, 64, 1536)  # a rank's shard of ViT-B/16 at --n-model 2
# (label, batch, spq, seq_len, dims, timed): serving's b64 (the table's
# time), training's b32 (the backward's), a ragged spq 40 (not a multiple of
# the 16-row tiles; keys masked past 33), the TP shard width, and two shapes
# only K13's core takes (the first design refused them): B/16 @416 (seq 677
# in spq 680) and head dim 80
K9_CASES = [("b64 spq200 (serving)", 64, 200, 197, B16, True),
            ("b4 spq40 (ragged)", 4, 40, 33, B16, False),
            ("b32 spq200 (TP shard)", 32, 200, 197, TP_SHARD, False),
            ("b8 spq680 (B/16 @416)", 8, 680, 677, B16, False),
            ("b32 spq200 Hd80 (d640)", 32, 200, 197, D640, False)]
K9_BWD_CASES = [("b32 spq200 (training)", 32, 200, 197, B16, True),
                ("b4 spq40 (ragged)", 4, 40, 33, B16, False),
                ("b32 spq200 (TP shard)", 32, 200, 197, TP_SHARD, False),
                ("b8 spq680 (B/16 @416)", 8, 680, 677, B16, False),
                ("b32 spq200 Hd80 (d640)", 32, 200, 197, D640, False)]
# where K9 on LN(x) is held to K1 on x to the bit: training's b32 and the TP
# shard width
K9_K1_BITS = ("b32 spq200 (training)", "b32 spq200 (TP shard)")
# K2 without its residual at M 3072 (the table's: forward b64, backward
# b32, K2's shapes in phase 3) and at the TP shard's M 1536
PARTIAL_CASES = [("b64 spq200 M3072", 64, 200, B16, True),
                 ("b32 spq200 M1536 (TP shard)", 32, 200, TP_SHARD, False)]
PARTIAL_BWD_CASES = [("b32 spq200 M3072", 32, 200, B16, True),
                     ("b32 spq200 M1536 (TP shard)", 32, 200, TP_SHARD,
                      False)]
# ViT-B/16 through train_cli for phase 16 (c) and (d): one epoch of 4 b32
# steps on 128 Synthetic images and its 4 eval batches
MESH_TRAIN_ARGS = [{"--synthetic-samples": "128", "--train-steps": "4"}.get(
    prev, a) for prev, a in zip([None] + TRAIN_ARGS, TRAIN_ARGS)]
MESH_STEPS, MESH_EVALS = 4, 4
TP_TIMEOUT = 240  # seconds the two gloo processes of (d) may take


def _k9_inputs(batch, rows, seq_len, dims, seed):
    """K9's x̂ (an LN output's scale, zero pad rows past seq_len), the
    weights of `_inputs` at `dims`, and dY zero on the pad rows."""
    import torch
    t = _inputs(batch, rows, seed, dims)
    x = t["x"].clone()
    x[:, seq_len:] = 0
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn((batch, rows, dims[0]), generator=g,
                     device="cuda").to(torch.bfloat16)
    do[:, seq_len:] = 0
    return x, t, do


def _no_first_design(name, label):
    """Raises if a first-design piece launched since the last reset (K9's
    launches run K1's Hopper sequence, none of them)."""
    from vitax_torch.ops import cuda_kernels as ck
    fd = ck.first_design_launch_counts(reset=True)
    if any(fd.values()):
        raise AssertionError(f"{name} {label}: first-design pieces {fd}")


def _mha_library(x, t, seq_len, heads):
    """One PyTorch call computing K9's function:
    `multi_head_attention_forward` on x̂ as (S, B, D), the packed
    in-projection (wqkvᵀ), scaled_dot_product_attention with the keys >=
    seq_len masked, the out-projection (woᵀ); need_weights off. Returns the
    call, its leaves (for the autograd backward) and its output as [B, S,
    D]."""
    import torch
    import torch.nn.functional as F
    b, spq, d = x.shape
    mask = torch.arange(spq, device="cuda")[None, :].expand(b, -1) >= seq_len
    bf = torch.bfloat16
    leaves = [x.transpose(0, 1).contiguous(), t["wqkv"].t().contiguous(),
              t["bqkv"].to(bf), t["wo"].t().contiguous(), t["bo"].to(bf)]

    def call(xs, w_in, b_in, w_out, b_out):
        return F.multi_head_attention_forward(
            xs, xs, xs, d, heads, w_in, b_in, None, None, False, 0.0, w_out,
            b_out, training=False, key_padding_mask=mask,
            need_weights=False)[0]

    with torch.no_grad():
        out = call(*leaves).transpose(0, 1)
    return call, leaves, out


def check_k9_kernels(stats):
    """Phase 16, kernels: K9's forward (b64 spq 200, ragged, TP shard, B/16
    @416's spq 680, head dim 80) and every output of its backward (b32,
    ragged, TP shard, spq 680, head dim 80), K1 forward and backward at the
    TP shard width, K2 without its residual forward (b64 M 3072, b32 M 1536)
    and backward (b32 at both), against their twins (TOL), two backward
    launches the same bits, no first-design piece in K9's launches; K9 on
    x̂ = LN(x) against K1 on x to the bit (the forward out, dWqkv, dbqkv,
    dWo, dbo) at b32 and the TP shard width; CUDA-event medians of kernel
    and twin; K9 timed beside K10, K1 and the library call
    (`multi_head_attention_forward`, held within TOL of the twin on the
    real rows), K2's partial beside K2, at the same shapes in one call."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in K9_KERNELS + PARTIAL_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    beside = {}
    for label, batch, rows, seq, dims, timed in K9_CASES:
        x, t, _ = _k9_inputs(batch, rows, seq, dims, seed=160)
        meta = (seq, dims[1], dims[2])
        args = (x, t["wqkv"], t["bqkv"], t["wo"], t["bo"], *meta)
        name = "fused_qkvo_attention"
        with torch.inference_mode():
            ck.first_design_launch_counts(reset=True)
            out = ck.fused_qkvo_attention(*args)
            torch.cuda.synchronize()
            _no_first_design(name, label)
            ref = ck.fused_qkvo_attention_ref(*args)
            err, bound = _hold(name, label, out, ref, stats)
            line = ""
            if timed:
                k_ms = _median_ms(lambda: ck.fused_qkvo_attention(*args))
                _no_first_design(name, label)
                p_ms = _median_ms(lambda: ck.fused_qkvo_attention_ref(*args))
                call, leaves, lib = _mha_library(x, t, seq, dims[1])
                l_err, l_bound = _hold(f"{name} library", label,
                                       lib[:, :seq], ref[:, :seq],
                                       {f"{name} library": {
                                           "max_abs_err": 0.0}})
                l_ms = _median_ms(lambda: call(*leaves))
                stats[name].update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                   shape=(batch, rows))
                qkv = (x, t["wqkv"], t["bqkv"], *meta)
                k1 = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                      t["wo"], t["bo"], EPS, *meta)
                beside["forward"] = (
                    k_ms, _median_ms(lambda: ck.fused_qkv_attention(*qkv)),
                    _median_ms(lambda: ck.fused_ln_qkvo_attention(*k1)))
                beside["library forward"] = (l_ms, l_err, l_bound)
                line = (f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms; K10 "
                        f"{beside['forward'][1]:.4f}, K1 "
                        f"{beside['forward'][2]:.4f}, library "
                        f"(multi_head_attention_forward) {l_ms:.4f}, its "
                        f"real rows {l_err:.3e} <= {l_bound:.3e} from the "
                        "twin (medians of 25)")
                del call, leaves, lib
        print(f"  {name:32s} {label:22s} {tuple(out.shape)} max|k-ref| "
              f"{err:.3e} <= {bound:.3e}, no first-design piece: ok{line}",
              flush=True)
        if dims == TP_SHARD:  # K1 per model shard at the same width
            k1 = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                  t["wo"], t["bo"], EPS, *meta)
            with torch.inference_mode():
                out = ck.fused_ln_qkvo_attention(*k1)
                torch.cuda.synchronize()
                err, bound = _hold("fused_ln_qkvo_attention", label, out,
                                   ck.fused_ln_qkvo_attention_ref(*k1), stats)
            print(f"  {'fused_ln_qkvo_attention':32s} {label:22s} "
                  f"{tuple(out.shape)} max|k-ref| {err:.3e} <= {bound:.3e}: "
                  "ok", flush=True)
        del x, t, out, ref
        torch.cuda.empty_cache()
    for label, batch, rows, seq, dims, timed in K9_BWD_CASES:
        x, t, do = _k9_inputs(batch, rows, seq, dims, seed=161)
        meta = (seq, dims[1], dims[2])
        args = (x, t["wqkv"], t["bqkv"], t["wo"], do, *meta)
        name = "fused_qkvo_attention_bwd"
        with torch.no_grad():
            ck.first_design_launch_counts(reset=True)
            outs = ck.fused_qkvo_attention_bwd(*args)
            again = ck.fused_qkvo_attention_bwd(*args)
            torch.cuda.synchronize()
            _no_first_design(name, label)
            errs = _hold_all(name, label, outs,
                             ck.fused_qkvo_attention_bwd_ref(*args), stats)
            if not all(torch.equal(o, a) for o, a in zip(outs, again)):
                raise AssertionError(f"{name} {label}: two launches differ")
            del outs, again
            line = ""
            if timed:
                k_ms = _median_ms(lambda: ck.fused_qkvo_attention_bwd(*args),
                                  warmup=2, iters=10)
                _no_first_design(name, label)
                p_ms = _median_ms(
                    lambda: ck.fused_qkvo_attention_bwd_ref(*args),
                    warmup=1, iters=5)
                dh = torch.zeros((batch, rows, dims[1] * dims[2]),
                                 device="cuda", dtype=torch.bfloat16)
                qkv = (x, t["wqkv"], t["bqkv"], dh, *meta)
                k1 = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                      t["wo"], do, EPS, *meta)
                beside["backward"] = (
                    k_ms, _median_ms(lambda: ck.fused_qkv_attention_bwd(*qkv),
                                     warmup=2, iters=10),
                    _median_ms(lambda: ck.fused_ln_qkvo_attention_bwd(*k1),
                               warmup=2, iters=10))
        if timed:  # the library's autograd backward of the same function
            call, leaves, _ = _mha_library(x, t, seq, dims[1])
            leaves = [v.requires_grad_() for v in leaves]
            dy = do.transpose(0, 1).contiguous()
            y = call(*leaves)
            l_ms = _median_ms(lambda: y.backward(dy, retain_graph=True),
                              warmup=2, iters=10)
            stats[name].update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                               shape=(batch, rows))
            beside["library backward"] = l_ms
            del call, leaves, y, dy
            line = (f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms; K10 "
                    f"bwd {beside['backward'][1]:.4f}, K1 bwd "
                    f"{beside['backward'][2]:.4f}, library (autograd of "
                    f"multi_head_attention_forward) {l_ms:.4f} (medians of "
                    "10 / 5)")
        print(f"  {name:32s} {label:22s} max|k-ref| per output (dx, dW, db, "
              f"dWo, dbo) [{' '.join(errs)}]: ok, two launches the same "
              f"bits, no first-design piece{line}", flush=True)
        if label in K9_K1_BITS:  # K9 on LN(x) is K1 on x, to the bit
            k1 = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                  t["wo"])
            with torch.no_grad():
                xh = ck.layer_norm(t["x"], t["gamma"], t["beta"], EPS)
                same = [torch.equal(
                    ck.fused_qkvo_attention(xh, *k1[3:], t["bo"], *meta),
                    ck.fused_ln_qkvo_attention(*k1, t["bo"], EPS, *meta))]
                k9g = ck.fused_qkvo_attention_bwd(xh, *k1[3:], do, *meta)
                k1g = ck.fused_ln_qkvo_attention_bwd(*k1, do, EPS, *meta)
                same += [torch.equal(a, b) for a, b in zip(k9g[1:], k1g[3:])]
            if not all(same):
                raise AssertionError(f"K9 on LN(x) vs K1 {label}: out, dW, "
                                     f"db, dWo, dbo the same bits: {same}")
            print(f"  {'K9 on LN(x) vs K1':32s} {label:22s} the forward out "
                  "and dWqkv, dbqkv, dWo, dbo: the same bits", flush=True)
            del xh, k9g, k1g
        if dims == TP_SHARD:
            k1 = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                  t["wo"], do, EPS, *meta)
            with torch.no_grad():
                outs = ck.fused_ln_qkvo_attention_bwd(*k1)
                torch.cuda.synchronize()
                errs = _hold_all("fused_ln_qkvo_attention_bwd", label, outs,
                                 ck.fused_ln_qkvo_attention_bwd_ref(*k1),
                                 stats)
            print(f"  {'fused_ln_qkvo_attention_bwd':32s} {label:22s} "
                  f"max|k-ref| per output [{' '.join(errs)}]: ok", flush=True)
            del outs
        del x, t, do
        torch.cuda.empty_cache()
    for fwd, cases in ((True, PARTIAL_CASES), (False, PARTIAL_BWD_CASES)):
        for label, batch, rows, dims, timed in cases:
            t = _inputs(batch, rows, 162, dims)
            g = torch.Generator(device="cuda").manual_seed(163)
            do = torch.randn(t["x"].shape, generator=g,
                             device="cuda").to(torch.bfloat16)
            mlp = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
                   t["b2"], EPS)
            bwd = (*mlp[:6], do, EPS)
            name = PARTIAL_KERNELS[0 if fwd else 1]
            with torch.no_grad():
                if fwd:
                    out = ck.fused_ln_mlp_partial(*mlp)
                    torch.cuda.synchronize()
                    errs = ["{:.2e}<={:.2e}".format(*_hold(
                        name, label, out, ck.fused_ln_mlp_partial_ref(*mlp),
                        stats))]
                    same = torch.equal(t["x"] + out, ck.fused_ln_mlp(*mlp))
                    run = (lambda: ck.fused_ln_mlp_partial(*mlp),
                           lambda: ck.fused_ln_mlp_partial_ref(*mlp),
                           lambda: ck.fused_ln_mlp(*mlp))
                else:
                    outs = ck.fused_ln_mlp_partial_bwd(*bwd)
                    torch.cuda.synchronize()
                    errs = _hold_all(name, label, outs,
                                     ck.fused_ln_mlp_partial_bwd_ref(*bwd),
                                     stats)
                    full = ck.fused_ln_mlp_bwd(*bwd)
                    same = torch.equal(do + outs[0], full[0]) and all(
                        torch.equal(a, b) for a, b in zip(outs[1:], full[1:]))
                    run = (lambda: ck.fused_ln_mlp_partial_bwd(*bwd),
                           lambda: ck.fused_ln_mlp_partial_bwd_ref(*bwd),
                           lambda: ck.fused_ln_mlp_bwd(*bwd))
                    del outs, full
                if not same:
                    raise AssertionError(f"{name} {label}: not the residual "
                                         "kernel's bits less the residual")
                line = ""
                if timed:
                    k_ms, p_ms, r_ms = (_median_ms(f, warmup=2, iters=10)
                                        for f in run)
                    stats[name].update(ms=k_ms, plain_ms=p_ms,
                                       shape=(batch, rows))
                    beside[name] = (k_ms, r_ms)
                    line = (f"; kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms; "
                            f"K2 with its residual {r_ms:.4f} (medians of 10)")
            print(f"  {name:32s} {label:22s} max|k-ref| [{' '.join(errs)}], "
                  "the residual kernel's bits less the residual: ok" + line,
                  flush=True)
            del t, do
            torch.cuda.empty_cache()
    return beside


def _mesh_launches(cfg, train):
    """The launches of a Res-ViT eval forward or train step under a mesh,
    vitax's dispatch (its fused attention halves decline for any mesh, its
    rect half too): every attention half, the teacher's and the compacted
    blocks' included, is the LN kernel and K9 (K9's backward and the LN
    backward in the student's backward), the MLP halves as one process
    runs them. That is the K10 path's count (`_resvit_launches` without
    fused_qkvo, whose halves are the LN kernel and K10 on all rows) with K9
    in K10's place."""
    counts = _resvit_launches(cfg.replace(fused_qkvo=False), train)
    k9 = {"fused_qkv_attention": "fused_qkvo_attention",
          "fused_qkv_attention_bwd": "fused_qkvo_attention_bwd"}
    out = _expect()
    for name, n in counts.items():
        out[k9.get(name, name)] += n
    return out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_resvit(mesh, exp_root):
    """Phase 16 (b): the b16 Res-ViT of ft_resvit.sh's flags under the
    (1, 1) mesh: serving b64 dense and at C 0.625, bf16 and --int8, through
    make_eval_step(mesh=) with exact launches a forward (12 K9, the LN
    kernel before each, no K1 or K8, no first-design piece) and one
    all-reduce; logits with the routing replayed within LOGIT_BAND of one
    process's path for the same function (K1, and K8 when compacted;
    int8_attn off, since it does not reach K9) and the routing maps'
    agreement; two b32 train steps of (a) through make_train_step(mesh=)
    with exact launches, no first-design piece, and three all-reduces a
    step (the active loss's mean, the grads, the metrics); the grads of
    every trainable tensor against the plain path (noise
    injected, routing replayed); resident b64 forwards and b32 steps beside
    one process's K1 path, in turns."""
    import torch
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import resvit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.parallel import all_reduce
    from vitax_torch.resvit_eval_cli import get_eval_config
    from vitax_torch.resvit_train_cli import (config_to_model_args,
                                              get_train_config)
    from vitax_torch.train.optim import tree_leaves
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_eval_step,
                                                make_train_step)
    from vitax_torch.utils.memory import named_leaves

    serve = {tier: config_to_model_args(get_eval_config(RESVIT_ARGS + extra),
                                        "cuda")
             for tier, extra in (("bf16", []), ("--int8", ["--int8"]))}
    with _random_router_biases():
        params = resvit.init_params(set_seed(0), serve["bf16"], "cuda")
    data = next(iter(get_dataloader("Synthetic", split="val", image_size=224,
                                    batch_size=64, num_samples=64, seed=0)))
    images = torch.from_numpy(data.images).cuda().bfloat16()
    labels = torch.from_numpy(data.labels).cuda()
    weight = torch.from_numpy(data.weight).cuda()
    counts, dist = {}, {}
    for tier, base in serve.items():
        for cap in (None, 0.625):
            cfg = base.replace(compact_capacity=cap)
            label = f"{tier} " + (f"C {cap}" if cap else "dense")
            ck.reset_launch_counts()
            all_reduce.launches = 0
            metrics, _ = make_eval_step(cfg, mesh=mesh)(params, images,
                                                       labels, weight)
            counts[label] = ck.launch_counts()
            # none: the attention halves are the LN kernel and K9, K1's
            # Hopper sequence; the MLP halves K2, K4 or plain products
            fd = ck.first_design_launch_counts()
            reduces = all_reduce.launches
            expect = _mesh_launches(cfg, False)
            log = _RouterLog(resvit)
            one = cfg.replace(int8_attn=False)
            with torch.inference_mode():
                with log.record():
                    lk, aux_k = resvit.apply(params, images, cfg, mesh=mesh)
                _, aux_r = resvit.apply(params, images, one)
                with log.replay():
                    lr, _ = resvit.apply(params, images, one)
            agree = [(aux_k["routing_maps"][k] == aux_r["routing_maps"][k])
                     .float().mean().item() for k in aux_k["routing_maps"]]
            d_log = (lk - lr).abs().max().item()
            band = LOGIT_BAND * max(1.0, lr.abs().max().item())
            dist[label] = (d_log, min(agree))
            print(f"mesh: make_eval_step(mesh) {label} b64: loss "
                  f"{float(metrics['loss']):.4f}; launches "
                  f"{_nonzero(counts[label])} (as derived: "
                  f"{counts[label] == expect}), all-reduces {reduces}; "
                  f"logits max|mesh - one process| (routing replayed) "
                  f"{d_log:.3e} <= {band:.3e}; routing maps agree "
                  f"{min(agree):.5f} >= {ROUTING_AGREE}; first-design "
                  f"pieces {fd}", flush=True)
            if (counts[label] != expect or reduces != 1 or any(fd.values())
                    or not torch.isfinite(lk).all() or d_log > band
                    or min(agree) < ROUTING_AGREE):
                raise AssertionError(f"mesh serving {label} failed")

    cfg = config_to_model_args(get_train_config(
        RESVIT_TRAIN_ARGS + ["--exp-root", exp_root]), "cuda")
    with _random_router_biases():
        tparams = resvit.init_params(set_seed(0), cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(16)
    images = torch.randn((TRAIN_BATCH, 224, 224, 3), generator=g,
                         device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 10, (TRAIN_BATCH,), generator=g, device="cuda")
    lam = Lambdas(*RESVIT_LAMBDAS)
    tx = make_adamw_for(cfg, tparams, lambda s: 1e-4)
    state = create_state(tparams, tx, torch.Generator(device="cuda")
                         .manual_seed(3))
    step = make_train_step(cfg, tx, lam, mesh=mesh)
    expect = _mesh_launches(cfg, True)
    for i in range(2):
        ck.reset_launch_counts()
        all_reduce.launches = 0
        state, m = step(state, images, labels)
        got = ck.launch_counts()
        fd = ck.first_design_launch_counts()
        counts[f"train step {i}"] = got
        print(f"mesh: make_train_step(mesh) step {i} b{TRAIN_BATCH} (a): "
              f"loss {float(m['loss']):.4f}; launches {_nonzero(got)} (as "
              f"derived: {got == expect}), all-reduces {all_reduce.launches}"
              f", first-design pieces {fd}", flush=True)
        if (got != expect or all_reduce.launches != 3 or any(fd.values())
                or not math.isfinite(float(m["loss"]))):
            raise AssertionError(f"mesh train step {i}: expected {expect}")
    del tx, state
    noise = _train_noise(cfg, TRAIN_BATCH, seed=17)
    replay = _RoutingReplay(resvit)
    plain = dict(fused_qkv=False, fused_qkvo=False, fused_mlp=False,
                 use_pallas=False)
    lk, g_k = _resvit_grads(tparams, images, labels, cfg, noise,
                            replay.record(), mesh=mesh)
    lp, g_p = _resvit_grads(tparams, images, labels, cfg.replace(**plain),
                            noise, replay.replay())
    names = [n for (n, _), k in zip(named_leaves(tparams), tree_leaves(
        resvit.trainable_mask(tparams, cfg))) if k]
    rels = sorted(((_rel(a, b), n) for a, b, n in zip(g_k, g_p, names)
                   if b.norm() > 0), reverse=True)
    d_log = (lk - lp).abs().max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in g_k)
    dist["grads"] = (rels[0][0], rels[0][1], d_log)
    print(f"mesh: grads b{TRAIN_BATCH} of {len(names)} trainable tensors, "
          f"worst |g_mesh - g_plain| / |g_plain|: " + ", ".join(
              f"{r:.3e} ({n})" for r, n in rels[:3])
          + f" <= {GRAD_BAND}; logits max|mesh - plain| {d_log:.3e}",
          flush=True)
    if not finite or rels[0][0] > GRAD_BAND or len(g_k) != len(names):
        raise AssertionError("mesh grads outside the band")
    del g_k, g_p
    torch.cuda.empty_cache()

    times = {"forward b64 mesh (LN + K9)": [], "forward b64 one (K1)": [],
             "step b32 mesh": [], "step b32 one": []}
    fwd_images = torch.randn((64, 224, 224, 3), generator=g, device="cuda",
                             dtype=torch.bfloat16)
    for turn in range(2):
        for on in ((True, False) if turn == 0 else (False, True)):
            msh = mesh if on else None
            key = "mesh (LN + K9)" if on else "one (K1)"
            with torch.inference_mode():
                times[f"forward b64 {key}"].append(_median_ms(
                    lambda: resvit.apply(params, fwd_images, serve["bf16"],
                                         mesh=msh), warmup=2, iters=5))
            tx = make_adamw_for(cfg, tparams, lambda s: 1e-4)
            state = create_state(tparams, tx, torch.Generator(device="cuda")
                                 .manual_seed(3))
            step = make_train_step(cfg, tx, lam, mesh=msh)
            times["step b32 " + ("mesh" if on else "one")].append(_median_ms(
                lambda: step(state, images, labels), warmup=2, iters=5))
            del tx, state
    print("mesh: resident b64 forwards (dense) and b32 steps (a), medians of "
          "5, two turns, the second in reverse order: " + "; ".join(
              f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
              for k, ms in times.items()), flush=True)
    del params, tparams
    torch.cuda.empty_cache()
    return counts, times, dist


def _tp_rank(rank, port, args, log_path, queue):
    """One of phase 16 (d)'s two processes: its own gloo group on
    localhost, then train_cli --n-gpu 2 --n-model 2 on cuda:0, its output to
    log_path; puts (rank, result or the error's text) on the queue."""
    import os
    import traceback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=2)
        from vitax_torch import train_cli
        from vitax_torch.ops import cuda_kernels as ck
        from vitax_torch.parallel import all_reduce
        ck.reset_launch_counts()
        all_reduce.launches = 0
        t0 = time.time()
        with open(log_path, "w") as f, contextlib.redirect_stdout(f):
            out = train_cli.main(args, device="cuda:0")
        seconds = time.time() - t0
        if rank == 0:
            shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)
        queue.put((rank, {
            "losses": [v for e in out["epochs"] for v in e["train"]["losses"]],
            "valid": out["epochs"][-1]["valid"],
            "counts": ck.launch_counts(), "reduces": all_reduce.launches,
            "seconds": seconds}))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


def run_mesh_slice(exp_root):
    """Phase 16, paths: (c0) ViT-B/16 through train_cli without a process
    group; then this process's NCCL group of one rank and its (1, 1) mesh:
    (b) the b16 Res-ViT (`_mesh_resvit`), (c) train_cli --n-gpu 1, whose
    losses must be (c0)'s to the bit (an all-reduce over one rank and a
    division by 1 are exact) and its launches (c0)'s; the group ends; (d)
    two spawned processes, each its own gloo rank on the card (NCCL takes
    one rank a card), through train_cli --n-gpu 2 --n-model 2: exact
    per-shard launches (K1 and K2 without its residual, 12 each a
    forward), and each step's loss within LOGIT_BAND of (c0)'s. Its time
    is no speed number: the two ranks share the card."""
    import os
    import torch
    import torch.distributed as dist
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.parallel import all_reduce, make_mesh

    args = MESH_TRAIN_ARGS + ["--exp-root", exp_root]
    forwards = MESH_STEPS + MESH_EVALS
    ck.reset_launch_counts()
    one_losses, one_valid, _ = _run_train(args, MESH_STEPS)
    one_counts = ck.launch_counts()
    print(f"mesh: (c0) train_cli b{TRAIN_BATCH} one process: losses "
          f"{[round(v, 4) for v in one_losses]}; launches "
          f"{_nonzero(one_counts)}", flush=True)

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        counts, times, dists = _mesh_resvit(mesh, exp_root)
        ck.reset_launch_counts()
        all_reduce.launches = 0
        losses, valid, _ = _run_train(args + ["--n-gpu", "1"], MESH_STEPS)
        got = ck.launch_counts()
        reduces = all_reduce.launches
    finally:
        dist.destroy_process_group()
    print(f"mesh: (c) train_cli --n-gpu 1 under NCCL: losses the same bits "
          f"as (c0): {losses == one_losses}; launches (c0)'s: "
          f"{got == one_counts}; all-reduces {reduces}", flush=True)
    if (losses != one_losses or got != one_counts
            or got["fused_ln_qkvo_attention"] != 12 * forwards
            or reduces != 2 * MESH_STEPS + MESH_EVALS):
        raise AssertionError("train_cli --n-gpu 1 is not one process's run")

    torch.cuda.empty_cache()
    results = _run_tp(args, one_losses, exp_root)
    counts["tp rank 0"] = results[0]["counts"]
    dists["tp loss"] = max(r["worst"] for r in results.values())
    return counts, times, dists


def _run_tp(args, one_losses, exp_root):
    """Phase 16 (d): train_cli --n-gpu 2 --n-model 2 in two spawned
    processes, each its own gloo rank on cuda:0, within TP_TIMEOUT; each
    rank's launches exact and each step's loss within LOGIT_BAND of
    `one_losses` (one process's run of `args`). Returns each rank's
    result."""
    import multiprocessing as mp
    import os
    forwards = MESH_STEPS + MESH_EVALS
    os.makedirs(exp_root, exist_ok=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    tp_args = args + ["--n-gpu", "2", "--n-model", "2"]
    procs = [ctx.Process(target=_tp_rank, args=(
        r, port, tp_args, os.path.join(exp_root, f"tp_rank{r}.log"), queue))
        for r in range(2)]
    t0 = time.time()
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < 2:
            left = TP_TIMEOUT - (time.time() - t0)
            rank, res = queue.get(timeout=max(1.0, left))
            results[rank] = res
        for p in procs:
            p.join(max(1.0, TP_TIMEOUT - (time.time() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(2):
        if not isinstance(results.get(r), dict):
            raise AssertionError(f"--n-model 2 rank {r} failed:\n"
                                 f"{results.get(r)}")
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"--n-model 2 exit codes "
                             f"{[p.exitcode for p in procs]}")
    expect = _expect(fused_ln_qkvo_attention=12 * forwards,
                     fused_ln_mlp_partial=12 * forwards,
                     fused_ln_qkvo_attention_bwd=12 * MESH_STEPS,
                     fused_ln_mlp_partial_bwd=12 * MESH_STEPS,
                     layer_norm=forwards, layer_norm_bwd=MESH_STEPS)
    for r in range(2):
        res = results[r]
        d = res["worst"] = max(abs(a - b) / max(1.0, abs(b))
                               for a, b in zip(res["losses"], one_losses))
        print(f"mesh: (d) train_cli --n-model 2 rank {r} (gloo, two ranks "
              f"on one card, {res['seconds']:.1f} s): losses "
              f"{[round(v, 4) for v in res['losses']]}, max |Δ| / max(1, "
              f"|loss|) against (c0) {d:.3e} <= {LOGIT_BAND}; launches "
              f"{_nonzero(res['counts'])} (as derived: "
              f"{res['counts'] == expect}); all-reduces {res['reduces']}",
              flush=True)
        if (res["counts"] != expect or len(res["losses"]) != MESH_STEPS
                or d > LOGIT_BAND):
            raise AssertionError(f"--n-model 2 rank {r} failed")
    return results


# ---------------------------------------------------------------- phase 17
# The int8, int4 and save-acts MLP halves without the residual (the
# residual=False branches of K4, K11-A/B and K12) and K2's wide backward
# without it (:1589), which vitax's tensor-parallel MLP half runs per model
# shard, and the ViT's tensor parallelism in every tier.
# residual wrapper -> (its residual=False counter, the tier whose band
# holds it)
PARTIAL17 = {
    "fused_ln_mlp_int8": ("fused_ln_mlp_int8_partial", "int8"),
    "fused_ln_mlp_int8_bwd": ("fused_ln_mlp_int8_partial_bwd", "int8"),
    "fused_ln_mlp_int8_dw_bwd": ("fused_ln_mlp_int8_partial_dw_bwd", "int8"),
    "fused_ln_mlp_int4": ("fused_ln_mlp_int4_partial", "int4"),
    "fused_ln_mlp_int4_bwd": ("fused_ln_mlp_int4_partial_bwd", "int4"),
    "fused_ln_mlp_int4_dw_bwd": ("fused_ln_mlp_int4_partial_dw_bwd", "int4"),
    "fused_ln_mlp_save": ("fused_ln_mlp_save_partial", "bf16"),
    "fused_ln_mlp_bwd_fast": ("fused_ln_mlp_bwd_fast_partial", "bf16"),
    "fused_ln_mlp_int8_save": ("fused_ln_mlp_int8_save_partial", "int8"),
    "fused_ln_mlp_int8_save_bwd": ("fused_ln_mlp_int8_save_partial_bwd",
                                   "int8"),
    "fused_ln_mlp_int8_save_dw_bwd": ("fused_ln_mlp_int8_save_partial_dw_bwd",
                                      "int8"),
    "fused_ln_mlp_bwd_wide": ("fused_ln_mlp_bwd_wide_partial", "bf16"),
}
PARTIAL17_KERNELS = tuple(p for p, _ in PARTIAL17.values())
# the share of rows an int4 xq code moved in, whose column codes cascade
CODE_SHARE_ROWS = 1e-3
TIER_FIELDS = ("int8_mlp", "int8_attn", "int8_mlp_grad", "int8_attn_grad",
               "int8_dw", "int4_mlp", "int4_attn", "int4_grad")
# (label, batch, rows, dims, timed): the table's ViT-B/16 b32 spq 200 at M
# 3072 and the TP shard's M 1536; K2's wide backward at ViT-H/14's b32 spq
# 264 on a TP shard's M 2560
PARTIAL17_CASES = [("b32 spq200 M3072", 32, 200, B16, True),
                   ("b32 spq200 M1536 (TP shard)", 32, 200, TP_SHARD, False)]
WIDE17_CASE = ("b32 spq264 D1280 M2560 (h14 shard)", 32, 264,
               (1280, 8, 80, 2560), True)
# (b) and (c): the flag sets of the slice, each with the per-shard kernels
# vitax's dispatch picks: (attention forward, its backward, MLP forward,
# its backward). --int4 alone keeps the attention half on K3 with K1's
# backward, as vitax's; --int8-grad --save-acts runs --int8-grad's kernels,
# vitax's tensor-parallel MLP half taking no save-acts; --int4-attn
# --int4-grad --int8-grad is phase 13's tier that runs K11-B without
# int8_dw
A8, A4 = "fused_ln_qkvo_attention_int8", "fused_ln_qkvo_attention_int4"
TP17_TIERS = {
    "--int8": (A8, "fused_ln_qkvo_attention_bwd",
               "fused_ln_mlp_int8_partial", "fused_ln_mlp_partial_bwd"),
    "--int8-grad": (A8, A8 + "_bwd", "fused_ln_mlp_int8_partial",
                    "fused_ln_mlp_int8_partial_bwd"),
    "--int8-dw": (A8, A8 + "_dw_bwd", "fused_ln_mlp_int8_partial",
                  "fused_ln_mlp_int8_partial_dw_bwd"),
    "--int4": (A8, "fused_ln_qkvo_attention_bwd", "fused_ln_mlp_int4_partial",
               "fused_ln_mlp_partial_bwd"),
    "--int4-attn --int4-grad --int8-grad": (
        A4, A4 + "_bwd", "fused_ln_mlp_int4_partial",
        "fused_ln_mlp_int4_partial_bwd"),
    "--int4-attn --int4-grad --int8-dw": (
        A4, A4 + "_dw_bwd", "fused_ln_mlp_int4_partial",
        "fused_ln_mlp_int4_partial_dw_bwd"),
    "--int8-grad --save-acts": (A8, A8 + "_bwd", "fused_ln_mlp_int8_partial",
                                "fused_ln_mlp_int8_partial_bwd"),
}
# (c): train_cli b32, one epoch of 2 steps on 64 Synthetic images and its 2
# eval batches; ViT-H/14 at b8 (2 steps, 2 eval batches: both ranks' shards
# and this process's whole model fit the card's 80 GB together)
TP17_STEPS = TP17_EVALS = 2
# (no loader worker processes: 64 images do not need them, and each run
# would start its own)
TP17_ARGS = [{"--synthetic-samples": "64", "--train-steps": "2"}.get(prev, a)
             for prev, a in zip([None] + TRAIN_ARGS, TRAIN_ARGS)] + [
                 "--num-workers", "0"]
TP17_H14_ARGS = [{"--synthetic-samples": "16", "--train-steps": "2",
                  "--batch-size": "8"}.get(prev, a)
                 for prev, a in zip([None] + H14_TRAIN_ARGS, H14_TRAIN_ARGS)
                 ] + ["--num-workers", "0"]
TP17_RUNS = [(f, TP17_ARGS + f.split()) for f in TP17_TIERS] + [
    ("h14", TP17_H14_ARGS), ("--no-fused-qkv", TP17_ARGS + ["--no-fused-qkv"])]
TP17_TIMEOUT = 300  # seconds the two gloo processes may take
TP17_LAYER_BATCH = 2  # (b): one layer at b2 (394 rows), its twin on the CPU


def _partial17_args(ck, name, t, do):
    """The residual wrapper's arguments on inputs t; a K12 backward's saved
    activations from its forward."""
    mlp = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"])
    if not name.endswith(("_bwd", "_fast", "_wide")):
        return mlp + (t["b2"], EPS)
    if name.endswith("_fast"):
        _, h1, gp = ck.fused_ln_mlp_save(*mlp, t["b2"], EPS)
        return (*mlp[:4], t["w2"], h1, gp, do, EPS)
    if "save" in name:
        _, *codes = ck.fused_ln_mlp_int8_save(*mlp, t["b2"], EPS)
        return (*mlp[:4], t["w2"], *codes, do, EPS)
    return mlp + (do, EPS)


def _check_partial17(ck, name, label, args, stats):
    """One residual=False launch: against its twin (bf16: TOL; int8 and
    int4: the codes within their bands, ‖k − t‖/‖t‖ within INT8_REL or
    INT4_REL, the bf16 stand-in outside it on every output a quantizer
    reaches) and against the residual kernel on the same inputs, exactly:
    its output bf16(x + partial) and its dx bf16(do + dx_partial), every
    other output the same bits. Returns the line's summary."""
    import torch
    part_name, tier = PARTIAL17[name]
    fn, twin = getattr(ck, name), getattr(ck, name + "_ref")
    kw = (lambda s: {}) if tier == "bf16" else (lambda s: {"scratch": s})
    sk, st = {}, {}
    part = fn(*args, residual=False, **kw(sk))
    full = fn(*args)
    torch.cuda.synchronize()
    ref = twin(*args, residual=False, **kw(st))
    part, full, ref = (o if isinstance(o, tuple) else (o,)
                       for o in (part, full, ref))
    fwd = not name.endswith(("_bwd", "_fast", "_wide"))
    res = args[0] if fwd else args[-2]
    if not (torch.equal(full[0], res + part[0])
            and all(torch.equal(a, b) for a, b in zip(full[1:], part[1:]))):
        raise AssertionError(f"{part_name} {label}: not the residual "
                             "kernel's bits less the residual")
    if tier == "bf16":
        errs = _hold_all(part_name, label, part, ref, stats)
        return f"max|k-ref| [{' '.join(errs)}]"
    rel, band = ((INT8_REL, CODE_BAND) if tier == "int8"
                 else (INT4_REL, INT4_CODE_BAND))
    with _bf16_stand_in(ck):
        stand = twin(*args, residual=False)
    stand = stand if isinstance(stand, tuple) else (stand,)
    moves = _code_moves(sk, st)
    if tier == "int4" and "xq" in st:
        # a moved xq code (one int4 step, 1/7 of its row's largest value, on
        # a .5 tie) moves its row's a1, and with it that row's h1 and dh1_32
        # column codes by several int8 steps: those rows are held by xq's
        # band, h1c's and dh1c's the other rows
        moved = (sk["xq"][0].long() != st["xq"][0].long()).any(dim=1)
        for key in ("h1c", "dh1c"):
            if key in st and bool(moved.any()):
                d = (sk[key][0].long() - st[key][0].long()).abs()[~moved]
                moves[key] = (d.max().item(), d.float().mean().item())
        moves["rows of moved xq codes"] = (0, moved.float().mean().item())
    r_k = [_rel(k, r) for k, r in zip(part, ref)]
    r_s = [_rel(s, r) for s, r in zip(stand, ref)]
    # Σ do is reached by no quantizer, nor is the int8 save backward's bf16
    # dW2 (its codes come saved from the forward), as in _check_int8
    skip = set() if fwd else {len(r_s) - 1}
    if name == "fused_ln_mlp_int8_save_bwd":
        skip.add(5)
    reached = [r for i, r in enumerate(r_s) if i not in skip]
    stats[part_name]["max_abs_err"] = max(
        stats[part_name]["max_abs_err"],
        *((k.float() - r.float()).abs().max().item()
          for k, r in zip(part, ref)))
    band = dict(band, **{"rows of moved xq codes": (0, CODE_SHARE_ROWS)})
    for key, (top, share) in moves.items():
        if top > band[key][0] or share > band[key][1]:
            raise AssertionError(f"{part_name} {label}: codes {key} moved "
                                 f"{share} (largest step {top})")
    if max(r_k) > rel or min(reached) <= rel:
        raise AssertionError(f"{part_name} {label}: {r_k} from the twin, the "
                             f"bf16 stand-in {r_s}, band {rel}")
    return ("codes moved " + " ".join(f"{k} {m[0]} {m[1]:.1e}"
                                      for k, m in moves.items())
            + f"; ‖k−t‖/‖t‖ [{' '.join(f'{r:.1e}' for r in r_k)}] <= {rel}; "
            f"stand-in [{' '.join(f'{r:.1e}' for r in r_s)}]")


def check_partial_kernels(stats):
    """Phase 17 (a): each residual=False launch of K4, K11-A/B, K12 and K2's
    wide backward against its twin and its residual kernel
    (`_check_partial17`) at PARTIAL17_CASES and WIDE17_CASE; at the timed
    case, CUDA-event medians of the partial and its residual kernel in turns
    (partial, residual, residual, partial) and the twin's."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    for name in PARTIAL17_KERNELS:
        stats[name] = {"max_abs_err": 0.0}
    beside = {}
    cases = [(n, c) for c in PARTIAL17_CASES for n in PARTIAL17
             if not n.endswith("_wide")]
    cases.append(("fused_ln_mlp_bwd_wide", WIDE17_CASE))
    inputs = {}
    for name, (label, batch, rows, dims, timed) in cases:
        if label not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            t = _inputs(batch, rows, 170, dims)
            g = torch.Generator(device="cuda").manual_seed(171)
            inputs[label] = (t, torch.randn(t["x"].shape, generator=g,
                                            device="cuda").to(torch.bfloat16))
        t, do = inputs[label]
        part_name = PARTIAL17[name][0]
        with torch.no_grad():
            args = _partial17_args(ck, name, t, do)
            line = _check_partial17(ck, name, label, args, stats)
            if timed:
                fn = getattr(ck, name)
                runs = [lambda: fn(*args, residual=False), lambda: fn(*args)]
                k1, r1, r2, k2 = (_median_ms(runs[i], warmup=2, iters=10)
                                  for i in (0, 1, 1, 0))
                p_ms = _median_ms(lambda: getattr(ck, name + "_ref")(
                    *args, residual=False), warmup=1, iters=3)
                stats[part_name].update(ms=min(k1, k2), plain_ms=p_ms,
                                        residual_ms=min(r1, r2),
                                        shape=(batch, rows), dims=dims)
                beside[part_name] = (k1, r1, r2, k2)
                line += (f"; partial / residual / residual / partial "
                         f"{k1:.4f} / {r1:.4f} / {r2:.4f} / {k2:.4f} ms "
                         f"(medians of 10), twin {p_ms:.4f}")
        print(f"  {part_name:38s} {label:28s} {line}; the residual "
              "kernel's bits less the residual: ok", flush=True)
    inputs.clear()
    torch.cuda.empty_cache()
    return beside


def run_save_partial_path():
    """Phase 17 (a'): the one caller of K12's partial pair, the library's
    `fused_ln_mlp(save_acts=True, residual=False)` (and `fused_ln_mlp_int8`'s
    with int8_grad, with and without int8_dw) under autograd at b32 spq
    200, counted from 0: each forward and backward partial launched once,
    the pair vitax's dispatch picks (pallas_kernels.py:2156-2166). No CLI
    reaches it: vitax's tensor-parallel MLP half passes no save-acts."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    t = _inputs(32, 200, 172)
    g = torch.Generator(device="cuda").manual_seed(173)
    do = torch.randn(t["x"].shape, generator=g, device="cuda").to(
        torch.bfloat16)
    leaves = [t[k].clone().requires_grad_() for k in
              ("x", "gamma", "beta", "w1", "b1", "w2", "b2")]
    ck.reset_launch_counts()
    ck.fused_ln_mlp(*leaves, EPS, save_acts=True, residual=False).backward(do)
    for dw in (False, True):
        ck.fused_ln_mlp_int8(*leaves, EPS, int8_grad=True, int8_dw=dw,
                             save_acts=True, residual=False).backward(do)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    expect = _expect(fused_ln_mlp_save_partial=1,
                     fused_ln_mlp_bwd_fast_partial=1,
                     fused_ln_mlp_int8_save_partial=2,
                     fused_ln_mlp_int8_save_partial_bwd=1,
                     fused_ln_mlp_int8_save_partial_dw_bwd=1)
    print(f"  fused_ln_mlp(save_acts=True, residual=False) and its int8 "
          f"tiers under autograd: launches {_nonzero(counts)} (as vitax's "
          f"dispatch: {counts == expect})", flush=True)
    if counts != expect:
        raise AssertionError(f"the save partial pair: expected {expect}")
    return counts


def _tp17_layer(rank, mesh, flags):
    """(b) on this rank: one full-width ViT-B/16 layer of `flags`' config
    at b2 (seq 197) through `vit._block` under the (1, 2) mesh: the kernel
    path on the card (its launches counted from 0), the twin path per shard
    on the CPU (the wrappers' plain versions), and one process's layer on
    the whole weights (the kernel path, mesh None), in the tier and in
    bf16. Returns the output's and every grad's ‖Δ‖/‖t‖ against the twin
    path and against one process's layer, one process's tier layer against
    its bf16 layer (the tier's own distance), and the kernel path's
    launches."""
    import torch
    from vitax_torch import cli, train_cli
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck
    from vitax_torch.parallel import shard_params
    from vitax_torch.parallel.mesh import MODEL_AXIS, vit_param_spec
    from vitax_torch.utils.memory import named_leaves
    cfg = train_cli.model_config_from_cli(cli.get_train_config(
        TP17_ARGS + flags.split()), True).replace(num_layers=1)
    whole = vit.init_params(torch.Generator().manual_seed(0), cfg)["layers"][0]
    shards = shard_params({"layers": [whole]}, mesh)["layers"][0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn((TP17_LAYER_BATCH, 197, D), generator=g).to(
        torch.bfloat16)
    dy = torch.randn(x.shape, generator=g).to(torch.bfloat16)

    def leaf(t, device):
        return t.detach().clone().to(device).requires_grad_()

    def run(lp, device, m, c=cfg):
        lp = {k: {n: (leaf(v, device) if torch.is_tensor(v)
                      else {a: leaf(b, device) for a, b in v.items()})
                  for n, v in d.items()} for k, d in lp.items()}
        xi = leaf(x, device)
        y = vit._block(xi, lp, c, mesh=m)
        y.backward(dy.to(device))
        grads = {"x": xi.grad, **{n: t.grad for n, t in named_leaves(lp)}}
        return (y - xi).detach().float().cpu(), {
            n: t.float().cpu() for n, t in grads.items()}

    ck.reset_launch_counts()
    out_k, g_k = run(shards, "cuda", mesh)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    out_t, g_t = run(shards, "cpu", mesh)
    out_1, g_1 = run(whole, "cuda", None)
    out_b, g_b = run(whole, "cuda", None,
                     cfg.replace(**dict.fromkeys(TIER_FIELDS, False)))

    def mine(name, t):  # this rank's slice of a whole grad
        spec = vit_param_spec("/" + name)
        if MODEL_AXIS not in spec:
            return t
        return t.chunk(mesh.n_model, spec.index(MODEL_AXIS))[rank]

    def dist(out, ref, grads, refs):
        """‖Δ‖/‖t‖ of the output and of each grad; the key bias's against
        the query bias's grad, its exact gradient being 0
        (`_grad_distances`)."""
        d = {"out": _rel(out, ref)}
        for n, g in grads.items():
            q = refs[n.replace("/key/", "/query/")]
            d[n] = (_rel(g, refs[n]) if not n.endswith("attn/key/bias")
                    else ((g - refs[n]).norm() / q.norm()).item())
        return d
    g_1, g_b = ({n: mine(n, g) for n, g in gs.items()} for gs in (g_1, g_b))
    return {"twin": dist(out_k, out_t, g_k, g_t),
            "one": dist(out_k, out_1, g_k, g_1),
            "quant": dist(out_1, out_b, g_1, g_b), "counts": counts}


def _tp17_rank(rank, port, exp_root, queue):
    """One of phase 17's two processes, its own gloo rank on cuda:0: (b)
    `_tp17_layer` for each flag set, then (c) `train_cli --n-gpu 2
    --n-model 2` for each of TP17_RUNS in sequence, launches counted from 0
    for each; puts (rank, results or the error's text) on the queue."""
    import os
    import traceback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.set_num_threads(3)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=2)
        from vitax_torch import train_cli
        from vitax_torch.ops import cuda_kernels as ck
        from vitax_torch.parallel import make_mesh
        t0 = time.time()
        mesh = make_mesh(1, 2)
        layers = {f: _tp17_layer(rank, mesh, f) for f in TP17_TIERS}
        layer_s = time.time() - t0
        runs = {}
        for label, args in TP17_RUNS:
            ck.reset_launch_counts()
            t1 = time.time()
            log = os.path.join(exp_root, f"tp17_{rank}_{len(runs)}.log")
            with open(log, "w") as f, contextlib.redirect_stdout(f):
                out = train_cli.main(args + [
                    "--exp-root", exp_root, "--n-gpu", "2", "--n-model", "2"],
                    device="cuda:0")
            if rank == 0:
                shutil.rmtree(out["checkpoint_dir"], ignore_errors=True)
            runs[label] = {
                "losses": [v for e in out["epochs"]
                           for v in e["train"]["losses"]],
                "counts": ck.launch_counts(), "s8": ck.s8_launch_counts(),
                "seconds": time.time() - t1}
        queue.put((rank, {"layers": layers, "layer_seconds": layer_s,
                          "runs": runs}))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


def _tp17_expect(label):
    """A rank's launches of a TP17_RUNS entry: per shard, each of the 12
    (h14: 32) layers' attention and MLP halves a forward and a backward;
    the LN kernel on the encoder norm (and, where the attention half is
    the plain one, each layer's LN1) a forward, its backward a step."""
    fwd = TP17_STEPS + TP17_EVALS
    if label in TP17_TIERS:
        attn, attn_bwd, mlp, mlp_bwd = TP17_TIERS[label]
        return _expect(**{attn: 12 * fwd, attn_bwd: 12 * TP17_STEPS,
                          mlp: 12 * fwd, mlp_bwd: 12 * TP17_STEPS,
                          "layer_norm": fwd, "layer_norm_bwd": TP17_STEPS})
    layers, mlp_bwd = ((32, "fused_ln_mlp_bwd_wide_partial") if label == "h14"
                       else (12, "fused_ln_mlp_partial_bwd"))
    return _expect(layer_norm=(layers + 1) * fwd,
                   layer_norm_bwd=(layers + 1) * TP17_STEPS,
                   flash_attention=layers * fwd,
                   flash_attention_bwd=layers * TP17_STEPS,
                   fused_ln_mlp_partial=layers * fwd,
                   **{mlp_bwd: layers * TP17_STEPS})


def _tp17_band(label):
    """A run's loss band against one process's: the int4 tiers'
    QUANT_LOGIT_BAND (per-shard int4 scales pick other codes than
    whole-tensor ones, 1/7 of a row's largest value each), else
    LOGIT_BAND."""
    return QUANT_LOGIT_BAND if "int4" in label else LOGIT_BAND


def run_tp_tiers_slice(exp_root):
    """Phase 17 (b), (c): two spawned processes, each its own gloo rank on
    the card (`_tp17_rank`), within TP17_TIMEOUT; meanwhile this process
    runs one process's train_cli of each TP17_RUNS entry (its output to a
    log under exp_root). (b) each flag set's layer within phase 13's layer
    bands of its twin path (the contribution out − x within LOGIT_BAND,
    every grad within INT8_GRAD_BAND), within INT8_GRAD_BAND of one
    process's layer (or twice the
    tier's own distance from the bf16 layer, where that is larger: int4),
    and exactly one launch of each of its four per-shard kernels; (c) each
    run's launches
    exact per shard (`_tp17_expect`) and each step's loss within its band
    of one process's. Two ranks share the card: no speed number."""
    import multiprocessing as mp
    import os
    os.makedirs(exp_root, exist_ok=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_tp17_rank, args=(r, port, exp_root, queue))
             for r in range(2)]
    t0 = time.time()
    for p in procs:
        p.start()
    one = {}
    results = {}
    try:
        with open(os.path.join(exp_root, "tp17_one.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            for label, args in TP17_RUNS:
                one[label] = _run_train(args + ["--exp-root", exp_root],
                                        TP17_STEPS)[0]
        while len(results) < 2:
            left = TP17_TIMEOUT - (time.time() - t0)
            rank, res = queue.get(timeout=max(1.0, left))
            results[rank] = res
        for p in procs:
            p.join(max(1.0, TP17_TIMEOUT - (time.time() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(2):
        if not isinstance(results.get(r), dict):
            raise AssertionError(f"phase 17 rank {r} failed:\n"
                                 f"{results.get(r)}")
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 17 exit codes "
                             f"{[p.exitcode for p in procs]}")
    dist = {}
    for r in range(2):
        res = results[r]
        for flags, lay in res["layers"].items():
            attn, attn_bwd, mlp, mlp_bwd = TP17_TIERS[flags]
            expect = _expect(**{attn: 1, attn_bwd: 1, mlp: 1, mlp_bwd: 1})
            # the layer bands of phase 13: the contribution within
            # LOGIT_BAND, every grad within INT8_GRAD_BAND
            twin_over = max((d / (LOGIT_BAND if n == "out"
                                  else INT8_GRAD_BAND), n)
                            for n, d in lay["twin"].items())
            worst_t = max(lay["twin"].items(), key=lambda kv: kv[1])
            worst_1 = max(lay["one"].items(), key=lambda kv: kv[1])
            # per-shard scales against whole-tensor ones: INT8_GRAD_BAND,
            # or twice the tier's own distance (one process's layer from
            # its bf16 layer), two draws of the same quantization noise
            over = max((d / max(INT8_GRAD_BAND, 2 * lay["quant"][n]), n)
                       for n, d in lay["one"].items())
            print(f"  (b) rank {r} {flags:36s} one layer b{TP17_LAYER_BATCH}"
                  f": kernel path vs twin path per shard, worst grad "
                  f"{worst_t[1]:.3e} ({worst_t[0]}), contribution "
                  f"{lay['twin']['out']:.3e}, {twin_over[0]:.2f} of the "
                  f"layer bands at worst; vs one process's layer, worst "
                  f"{worst_1[1]:.3e} ({worst_1[0]}; the tier's own distance "
                  f"there {lay['quant'][worst_1[0]]:.3e}), {over[0]:.2f} of "
                  f"its bound at worst ({over[1]}); launches "
                  f"{_nonzero(lay['counts'])}", flush=True)
            dist[f"(b) {flags}"] = (worst_t[1], worst_1[1])
            if twin_over[0] > 1 or over[0] > 1 or lay["counts"] != expect:
                raise AssertionError(f"phase 17 (b) rank {r} {flags}")
        for label, run in res["runs"].items():
            d = max(abs(a - b) / max(1.0, abs(b))
                    for a, b in zip(run["losses"], one[label]))
            expect = _tp17_expect(label)
            print(f"  (c) rank {r} train_cli --n-model 2 {label:36s} "
                  f"({run['seconds']:.1f} s): losses "
                  f"{[round(v, 4) for v in run['losses']]}, one process's "
                  f"{[round(v, 4) for v in one[label]]}, max |Δ| / max(1, "
                  f"|loss|) {d:.3e} <= {_tp17_band(label)}; launches "
                  f"{_nonzero(run['counts'])} (as derived: "
                  f"{run['counts'] == expect}), s8 products "
                  f"{_nonzero(run['s8'])} (as derived: "
                  f"{run['s8'] == _s8_expect(run['counts'])})", flush=True)
            dist[f"(c) {label}"] = max(dist.get(f"(c) {label}", 0.0), d)
            if (run["counts"] != expect or len(run["losses"]) != TP17_STEPS
                    or run["s8"] != _s8_expect(run["counts"])
                    or d > _tp17_band(label)):
                raise AssertionError(f"phase 17 (c) rank {r} {label}")
    return {label: run["counts"] for label, run in results[0]["runs"].items()
            }, dist, results[0]["layer_seconds"]


# ---------------------------------------------------------------- bounds
PEAK = {"bf16": 989e12, "s8": 1979e12, "f32": 67e12}  # H100 SXM, dense
HBM = 3.35e12  # bytes/s


def _work(name, batch, rows, extra=None, dims=None):
    """(bytes, {type: operations}) that `name` must move and do at x
    [batch, rows, D] (rows = spq, or the ragged row count) of the model
    `dims` (D, heads, head_dim, MLP; ViT-B/16's by default): each input
    read once, each output written once; the attention core over the padded
    rows. `extra`: K8's cpq (the gathered rows xc [batch, cpq, 768] in, the
    output on them), K7's kv heads. K6 and K2's backward at d > 1024 do
    K1's and K2's work, K11 K3's and K4's."""
    if name in (RESVIT_KERNELS + TRAIN_RESVIT_KERNELS + INT8_GQA_KERNELS
                + RESVIT_INT4_KERNELS):
        return _resvit_work(name, batch, rows, extra)
    D, HEADS, HEAD_DIM, MLP = dims or B16
    if name in K13_KERNELS:  # rows = seq; q, k, v, (out, dO) in, out(s)
        io = 2 * batch * HEADS * rows * HEAD_DIM  # one bf16 [B, H, S, Hd]
        core = 4 * batch * HEADS * rows * rows * HEAD_DIM
        if name == "flash_attention_bwd":
            return 8 * io, {"bf16": 2.5 * core}
        return 4 * io, {"bf16": core}
    # a residual=False launch does its residual kernel's work
    name = name.replace("_partial", "")
    name = {"fused_ln_qkvo_attention_flash": "fused_ln_qkvo_attention",
            "fused_ln_qkvo_attention_flash_bwd": "fused_ln_qkvo_attention_bwd",
            "fused_ln_mlp_bwd_wide": "fused_ln_mlp_bwd"}.get(name, name)
    # K11 does K3's and K4's work, its codes on the int4 grid in s8 products
    name = name.replace("_int4", "_int8")
    n = batch * rows
    hhd = HEADS * HEAD_DIM
    act, w_attn, w_mlp = 2 * n * D, 2 * 4 * D * hhd, 2 * 2 * D * MLP
    qkv, out = 2 * n * D * 3 * hhd, 2 * n * hhd * D
    core, mlp = 4 * batch * HEADS * rows * rows * HEAD_DIM, 4 * n * D * MLP
    vec_attn, vec_mlp = 4 * (4 * D + 3 * hhd), 4 * (4 * D + MLP)
    dw_attn, dw_mlp = 4 * 4 * D * hhd, 4 * 2 * D * MLP  # fp32 grads out
    w_qkv = 2 * D * 3 * hhd
    packed = n * D + 4 * n  # int8 codes and an fp32 scale a row
    table = {
        "layer_norm": (2 * act + 8 * D, {"f32": 8 * n * D}),
        "layer_norm_bwd": (3 * act + 12 * D, {"f32": 12 * n * D}),
        "fused_ln_qkvo_attention": (2 * act + w_attn + vec_attn,
                                    {"bf16": qkv + core + out}),
        "fused_ln_mlp": (2 * act + w_mlp + vec_mlp, {"bf16": mlp}),
        "fused_ln_qkvo_attention_bwd": (
            3 * act + w_attn + dw_attn + 2 * vec_attn,
            {"bf16": 3 * qkv + 2 * out + 3 * core}),
        "fused_ln_mlp_bwd": (3 * act + w_mlp + dw_mlp + 2 * vec_mlp,
                             {"bf16": 2.5 * mlp}),
        "fused_ln_qkvo_attention_int8": (2 * act + w_attn + vec_attn,
                                         {"s8": qkv + out, "bf16": core}),
        "fused_ln_mlp_int8": (2 * act + w_mlp + vec_mlp, {"s8": mlp}),
        "fused_ln_qkvo_attention_int8_bwd": (
            3 * act + w_attn + dw_attn + 2 * vec_attn,
            {"s8": 2 * qkv + out, "bf16": qkv + out + 3 * core}),
        "fused_ln_mlp_int8_bwd": (3 * act + w_mlp + dw_mlp + 2 * vec_mlp,
                                  {"s8": 1.5 * mlp, "bf16": mlp}),
        "fused_ln_qkvo_attention_int8_dw_bwd": (
            3 * act + w_attn + dw_attn + 2 * vec_attn,
            {"s8": 3 * qkv + 2 * out, "bf16": 3 * core}),
        "fused_ln_mlp_int8_dw_bwd": (3 * act + w_mlp + dw_mlp + 2 * vec_mlp,
                                     {"s8": 2.5 * mlp}),
        # K5: x (r1) and its pack in, r1 (r2) and its pack out
        "fused_ln_qkvo_attention_int8_ho": (
            2 * act + 2 * packed + w_attn + vec_attn,
            {"s8": qkv + out, "bf16": core}),
        "fused_ln_mlp_int8_ho": (2 * act + 2 * packed + w_mlp + vec_mlp,
                                 {"s8": mlp}),
        # K12: h1 and g' (bf16) or h1q, gpq (int8) and sh out of the
        # forward, into the backward, which does four products (8NDM)
        "fused_ln_mlp_save": (2 * act + w_mlp + vec_mlp + 4 * n * MLP,
                              {"bf16": mlp}),
        "fused_ln_mlp_bwd_fast": (3 * act + w_mlp + dw_mlp + 2 * vec_mlp
                                  + 4 * n * MLP, {"bf16": 2 * mlp}),
        "fused_ln_mlp_int8_save": (2 * act + w_mlp + vec_mlp + 2 * n * MLP
                                   + 4 * n, {"s8": mlp}),
        "fused_ln_mlp_int8_save_bwd": (
            3 * act + w_mlp + dw_mlp + 2 * vec_mlp + 2 * n * MLP + 4 * n,
            {"s8": mlp, "bf16": mlp}),
        "fused_ln_mlp_int8_save_dw_bwd": (
            3 * act + w_mlp + dw_mlp + 2 * vec_mlp + 2 * n * MLP + 4 * n,
            {"s8": 2 * mlp}),
        # K10: x̂ (and do on the heads' outputs) in, the heads' outputs (dx
        # and fp32 dW, db) out; vitax's CostEstimate (:2322, :2359):
        # 2·N·D·3HHd + 4·B·H·spq²·Hd forward, 6·N·D·3HHd + 10·B·H·spq²·Hd
        # backward
        "fused_qkv_attention": (act + 2 * n * hhd + w_qkv + 4 * 3 * hhd,
                                {"bf16": qkv + core}),
        "fused_qkv_attention_bwd": (
            2 * act + 2 * n * hhd + w_qkv + 2 * 4 * 3 * hhd
            + 4 * D * 3 * hhd, {"bf16": 3 * qkv + 2.5 * core}),
        # K9: K1's work without its LN (x̂ and the projected output, Wqkv,
        # Wo, bqkv and bo in; backward: x̂, dY in, dx, fp32 dW, db, dWo,
        # dbo out; the core's recompute and its four products, as K1's)
        "fused_qkvo_attention": (2 * act + w_attn + 4 * (D + 3 * hhd),
                                 {"bf16": qkv + core + out}),
        "fused_qkvo_attention_bwd": (
            3 * act + w_attn + dw_attn + 4 * 3 * hhd + 4 * (D + 3 * hhd),
            {"bf16": 3 * qkv + 2 * out + 3 * core}),
    }
    return table[name]


def _resvit_work(name, batch, spq, extra):
    """K7 and K8, forward and backward: the forward core is 2 products of
    query rows x keys x head_dim, the backward's 6 (its recompute and dp,
    dq, dk, dv); a projection's backward is its recompute, its dx-path and
    its weight grad (3 products), the out-projection's its dx-path and
    weight grad (2)."""
    hhd = HEADS * HEAD_DIM
    vec = 4 * (4 * D + 3 * hhd)
    core = 4 * batch * HEADS * spq * HEAD_DIM  # times the query rows
    # Res-ViT's int4 kernels do their int8 counterparts' work, their codes
    # on the int4 grid in s8 products
    name = name.replace("_int4", "_int8")
    if name.startswith("fused_ln_qkvo_attention_int8_gqa"):
        n, width = batch * spq, (HEADS + 2 * extra) * HEAD_DIM
        w_bytes = 2 * (D * width + hhd * D)
        qkv, out = 2 * n * D * width, 2 * n * hhd * D
        if name.endswith("_bwd"):  # x, do in; dx, fp32 grads out
            ops = ({"s8": 3 * qkv + 2 * out, "bf16": 3 * core * spq}
                   if name.endswith("_dw_bwd") else
                   {"s8": 2 * qkv + out, "bf16": qkv + out + 3 * core * spq})
            return (3 * 2 * n * D + w_bytes + 2 * w_bytes
                    + 2 * 4 * (3 * D + width), ops)
        return (2 * 2 * n * D + w_bytes + 4 * (3 * D + width),
                {"s8": qkv + out, "bf16": core * spq})
    if name.startswith("fused_ln_qkvo_attention_gqa"):
        n, width = batch * spq, (HEADS + 2 * extra) * HEAD_DIM
        w_bytes = 2 * (D * width + hhd * D)
        qkv, out = 2 * n * D * width, 2 * n * hhd * D
        if name.endswith("_bwd"):  # x, do in; dx, fp32 grads out
            return (3 * 2 * n * D + w_bytes + 2 * w_bytes
                    + 2 * 4 * (3 * D + width),
                    {"bf16": 3 * qkv + 2 * out + 3 * core * spq})
        return (2 * 2 * n * D + w_bytes + 4 * (3 * D + width),
                {"bf16": qkv + core * spq + out})
    nc, n = batch * extra, batch * spq
    w_bytes = 2 * 4 * D * hhd
    proj = 2 * nc * D * hhd + 2 * n * D * 2 * hhd  # Q from xc, KV from x
    out = 2 * nc * hhd * D
    if name.endswith("_bwd"):  # xc, x, do in; dxc, dx, fp32 grads out
        nbytes = 2 * (2 * nc * D + n * D) + 2 * (nc + n) * D + 3 * w_bytes \
            + 2 * vec
        bwd_core = 3 * core * extra
        if name == "fused_ln_qkvo_attention_rect_bwd":
            return nbytes, {"bf16": 3 * proj + 2 * out + bwd_core}
        if name == "fused_ln_qkvo_attention_rect_int8_bwd":
            return nbytes, {"s8": 2 * proj + out,
                            "bf16": proj + out + bwd_core}
        return nbytes, {"s8": 3 * proj + 2 * out, "bf16": bwd_core}
    nbytes = 2 * (2 * nc * D + n * D) + w_bytes + vec
    if name == "fused_ln_qkvo_attention_rect":
        return nbytes, {"bf16": proj + out + core * extra}
    return nbytes, {"s8": proj + out, "bf16": core * extra}


def _bound(name, shape, dims=None, work=None):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and the
    operations over their types' peaks (`work`: (bytes, operations) of the
    s8 products, which their check computes)."""
    nbytes, ops = work or _work(name, *shape, dims=dims)
    t_bytes = nbytes / HBM
    t_ops = sum(v / PEAK[k] for k, v in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vitax_torch.kernels import build
    t0 = time.time()
    fresh = not build.library_path().exists()
    build.load()
    print(f"build: {time.time() - t0:.1f} s ({'fresh' if fresh else 'cached'}"
          f") -> {build.library_path()}", flush=True)

    print("kernels vs plain (bf16):", flush=True)
    stats = check_kernels()
    check_bwd_kernels(stats)
    print("s8 products of gemm_sm90.cuh (K3's and K4's int8 forwards and "
          "backwards) vs twin:", flush=True)
    check_s8_products(stats)
    check_handoff_kernels(stats)
    check_resvit_kernels(stats)
    check_resvit_bwd_kernels(stats)
    check_h14_kernels(stats)
    print(f"int8 kernels vs twin, worst ‖k−t‖/‖t‖ of any output and case <= "
          f"{INT8_REL}; the bf16 stand-in's nearest (outputs quantization "
          f"reaches): " + ", ".join(
              f"{n} {stats[n]['worst_rel']:.3e} / {stats[n]['stand_in_min_rel']:.3e}"
              for n in INT8_KERNELS + ("fused_ln_qkvo_attention_rect_int8",)
              + RECT_BWD_KERNELS[1:])
          + "; the int8_grad kernel's bf16 dW "
          "against the int8_dw twin, nearest: " + ", ".join(
              f"{n} {stats[n]['bf16_dw_min_rel']:.3e}"
              for n in DW_KERNELS + RECT_BWD_KERNELS[2:]),
          flush=True)
    eval_counts, rate, rate_p = run_slice()
    print(f"eval img/s b16@224 bf16: kernels {rate:.0f}, plain {rate_p:.0f} "
          f"[{card}]", flush=True)
    exp_root = str(build.BUILD_DIR.parent / "smoke_experiments")
    try:
        counts, step_ms = run_train_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print(f"train step img/s b16@224 bf16 b32: kernels "
          f"{TRAIN_BATCH * 1e3 / step_ms['kernels']:.0f}, plain "
          f"{TRAIN_BATCH * 1e3 / step_ms['plain']:.0f} [{card}]", flush=True)
    try:
        counts_i8, step_i8 = run_int8_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("train step img/s b16@224 b32: " + ", ".join(
        f"{k} {TRAIN_BATCH * 1e3 / ms:.0f}" for k, ms in step_i8.items())
        + f" [{card}]", flush=True)
    try:
        counts_fast, step_fast = run_fast_recipe(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("fast recipe step (fwd+bwd+SGD, resident batch): " + ", ".join(
        f"{k} {ms:.2f} ms = {int(k.split()[0][1:]) * 1e3 / ms:.0f} img/s"
        for k, ms in step_fast.items()) + f" [{card}]", flush=True)

    counts_rv, rates_rv, fwd_rv = run_resvit_slice()
    print("resvit serving b64 img/s: resvit_eval_cli (host-fed) " + ", ".join(
        f"{k} {v:.0f}" for k, v in rates_rv.items()) + "; forward "
        "(resident batch) " + ", ".join(f"{k} {64e3 / ms:.0f}"
                                        for k, ms in fwd_rv.items())
        + f" [{card}]", flush=True)

    try:
        counts_rt, step_rt, grads_rt = run_resvit_train_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("resvit training step img/s (resident batch): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in step_rt.items()) + "; worst grad "
        "distance " + ", ".join(f"{k} {r:.3e}" for k, r in grads_rt)
        + f" [{card}]", flush=True)

    try:
        counts_h14, counts_h14_train, times_h14 = run_h14_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("h14: " + "; ".join(
        f"{k} " + (", ".join(f"{n} {v:.2f}" for n, v in t.items())
                   if isinstance(t, dict) else f"{t:.2f}")
        for k, t in times_h14.items()) + f" [{card}]", flush=True)

    print("phase 11, K13 and K7's int8 tier vs plain:", flush=True)
    check_core_kernels(stats)
    try:
        counts11, times11 = run_no_fused_qkv_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("k13: " + "; ".join(
        f"{k} " + (", ".join(f"{n} {v:.4g}" for n, v in t.items())
                   if isinstance(t, dict) else f"{t:.4g}")
        for k, t in times11.items()) + f" [{card}]", flush=True)

    print("phase 12, --save-acts (K12) vs plain:", flush=True)
    t12 = time.time()
    check_save_kernels(stats)
    try:
        counts12, steps12, grads12 = run_save_acts_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("save-acts: " + "; ".join(f"{k} {' / '.join(f'{v:.2f}' for v in ms)}"
                                    " ms" for k, ms in steps12.items())
          + "; worst grad distance " + ", ".join(
              f"{k} {r:.3e}" for k, r in grads12)
          + f"; phase 12 took {time.time() - t12:.1f} s [{card}]", flush=True)

    print("phase 13, int4 (K11) vs plain:", flush=True)
    t13 = time.time()
    check_int4_kernels(stats)
    try:
        counts13, steps13, dist13 = run_int4_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("int4: kernels vs twin, worst ‖k−t‖/‖t‖ of any output and case "
          f"<= {INT4_REL}, the bf16 kernel's nearest / the kernel's >= "
          f"{INT4_STAND_IN}: " + ", ".join(
              f"{n} {stats[n]['worst_rel']:.3e} / "
              f"{stats[n]['stand_in_ratio']:.1f}x" for n in INT4_KERNELS)
          + "; kernel / int8 counterpart b32 spq200 ms: " + ", ".join(
              f"{n} {stats[n]['ms']:.4f} / {stats[n]['int8_ms']:.4f}"
              for n in INT4_KERNELS)
          + "; steps b32 (resident batch, CUDA-event medians, in turns, the "
          "second in reverse order): " + "; ".join(
              f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
              for k, ms in steps13.items())
          + "; kernel path vs twin path (logits ‖Δ‖/‖t‖, the bf16 path's; "
          "worst and median grad distance, the bf16 path's median): " + "; ".join(
              f"{k} layer(s) {v[0]:.3e} / {v[1]:.3e}, {v[2]:.3e}, {v[3]:.3e} "
              f"/ {v[4]:.3e}" for k, v in dist13.items() if isinstance(k, int))
          + "; 12 layers fed, worst contribution {:.3e}, worst grad "
          "{:.3e}".format(max(r[0] for r in dist13["12, fed"]),
                          max(r[2] for r in dist13["12, fed"]))
          + f"; phase 13 took {time.time() - t13:.1f} s [{card}]", flush=True)

    print("phase 14, Res-ViT int4 (R-F, R-B, G-F, G-B) vs plain:", flush=True)
    t14 = time.time()
    check_resvit_int4_kernels(stats)
    try:
        counts14, steps14, dist14 = run_resvit_int4_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("resvit-int4: kernels vs twin, worst ‖k−t‖/‖t‖ of any output <= "
          f"{INT4_REL}, the bf16 stand-in's nearest: " + ", ".join(
              f"{n} {stats[n]['worst_rel']:.3e} / "
              f"{stats[n]['stand_in_min_rel']:.3e}"
              for n in RESVIT_INT4_KERNELS)
          + "; kernel / int8 counterpart ms (two turns): " + ", ".join(
              "{} {} against {}".format(n, *(
                  " / ".join(f"{v:.4f}" for v in stats[n][k])
                  for k in ("ms_turns", "int8_ms_turns")))
              for n in RESVIT_INT4_KERNELS)
          + "; steps b32: " + "; ".join(
              f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
              for k, ms in steps14.items())
          + "; one routed layer: logits max|Δ| {:.3e}, worst grad {:.3e} "
          "({})".format(*dist14["1 routed layer"])
          + "; 12 layers fed, worst contribution {:.3e}, worst grad "
          "{:.3e}".format(max(r[0] for r in dist14["12 layers, fed"]),
                          max(r[2] for r in dist14["12 layers, fed"]))
          + f"; phase 14 took {time.time() - t14:.1f} s [{card}]", flush=True)

    print("phase 15, K10 (fused_qkv_attention) vs plain:", flush=True)
    t15 = time.time()
    check_k10_kernels(stats)
    try:
        counts15, times15, dist15 = run_k10_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("k10: kernel / twin ms " + ", ".join(
        f"{n} {stats[n]['ms']:.4f} / {stats[n]['plain_ms']:.4f}"
        for n in K10_KERNELS) + "; serving (logits max|Δ|, routing "
        "agreement): " + ", ".join(
            f"{k} {v[0]:.3e} {v[1]:.5f}" for k, v in dist15.items()
            if k != "grads")
        + "; worst grad {:.3e} ({}); ".format(*dist15["grads"][:2])
        + "; ".join(f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
                    for k, ms in times15.items())
        + f"; phase 15 took {time.time() - t15:.1f} s [{card}]", flush=True)

    print("phase 16, K9 (fused_qkvo_attention), K2 without its residual and "
          "the parallel layer:", flush=True)
    t16 = time.time()
    beside16 = check_k9_kernels(stats)
    try:
        counts16, times16, dist16 = run_mesh_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("mesh: kernel / twin ms " + ", ".join(
        f"{n} {stats[n]['ms']:.4f} / {stats[n]['plain_ms']:.4f}"
        for n in K9_KERNELS + PARTIAL_KERNELS)
        + "; K9 / K10 / K1 / library forward b64 {:.4f} / {:.4f} / {:.4f} / "
        "{:.4f}, backward b32 {:.4f} / {:.4f} / {:.4f} / {:.4f}".format(
            *beside16["forward"], beside16["library forward"][0],
            *beside16["backward"], beside16["library backward"])
        + "; K2 without / with its residual: forward b64 {:.4f} / {:.4f}, "
        "backward b32 {:.4f} / {:.4f}".format(
            *beside16["fused_ln_mlp_partial"],
            *beside16["fused_ln_mlp_partial_bwd"])
        + "; serving under the mesh (logits max|Δ|, routing agreement): "
        + ", ".join(f"{k} {v[0]:.3e} {v[1]:.5f}" for k, v in dist16.items()
                    if k not in ("grads", "tp loss"))
        + "; worst grad {:.3e} ({})".format(*dist16["grads"][:2])
        + "; --n-model 2 losses within {:.3e} of one process's; ".format(
            dist16["tp loss"])
        + "; ".join(f"{k} {' / '.join(f'{v:.2f}' for v in ms)} ms"
                    for k, ms in times16.items())
        + f"; phase 16 took {time.time() - t16:.1f} s [{card}]", flush=True)

    print("phase 17, the int8, int4 and save-acts MLP halves without the "
          "residual, and tensor parallelism in every tier:", flush=True)
    t17 = time.time()
    beside17 = check_partial_kernels(stats)
    save17 = run_save_partial_path()
    try:
        counts17, dist17, layer_s = run_tp_tiers_slice(exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    print("tp tiers: partial / residual kernel ms (min of two turns) "
          + ", ".join(f"{n} {stats[n]['ms']:.4f} / "
                      f"{stats[n]['residual_ms']:.4f} "
                      f"({100 * (stats[n]['ms'] / stats[n]['residual_ms'] - 1):+.1f} %)"
                      for n in beside17)
          + "; (b) layers (worst against the twin path, one process's): "
          + ", ".join(f"{k} {v[0]:.3e} {v[1]:.3e}" for k, v in dist17.items()
                      if k.startswith("(b)"))
          + f" ({layer_s:.1f} s); (c) losses against one process's: "
          + ", ".join(f"{k} {v:.3e}" for k, v in dist17.items()
                      if k.startswith("(c)"))
          + f"; phase 17 took {time.time() - t17:.1f} s [{card}]", flush=True)

    # launches: the bf16 kernels' from the bf16 train slice, K3's and K4's
    # from the --int8-grad train slice, K5's, the int8_dw backwards' and
    # their s8 products' (s8_group, s8_residual_f32) from the fast recipe's
    # (each runs every kernel of its tier), K7's and K8's
    # from the Res-ViT serving runs that take them; the eval slices' forward
    # counts are printed in phases 4, 6, 7 and 8. Times at the main path's
    # shapes: forward b64 spq 200 (serving), backward b32 spq 200, K5 b32
    # spq 104 (the drop phase), K8 b64 spq 200 cpq 128 (capacity 0.625), K7
    # b64 spq 200 with 4 kv heads; K6 and K2's wide backward from phase 10
    # (K6 forward at b32 spq 736, its backward and K2's at b32 spq 264)
    resvit_runs = {"fused_ln_qkvo_attention_gqa": "compact 0.625 --n_kv_heads 4",
                   "fused_ln_qkvo_attention_rect": "compact 0.625",
                   "fused_ln_qkvo_attention_rect_int8": "compact 0.625 --int8"}
    # the backwards from the Res-ViT training run that takes them
    train_runs = {"fused_ln_qkvo_attention_rect_bwd": 1,
                  "fused_ln_qkvo_attention_rect_int8_dw_bwd": 2,
                  "fused_ln_qkvo_attention_rect_int8_bwd": 3,
                  "fused_ln_qkvo_attention_gqa_bwd": 4}

    # phase 11: K13's from eval_cli @384 (forward) and train_cli (backward)
    # --no-fused-qkv, K7's int8 tier from the Res-ViT runs that take it
    phase11_runs = {
        "flash_attention": "eval_cli", "flash_attention_bwd": "train_cli",
        "fused_ln_qkvo_attention_int8_gqa": "--int8 --n_kv_heads 4 dense",
        "fused_ln_qkvo_attention_int8_gqa_bwd":
            "(h) --int8-grad --n_kv_heads 4",
        "fused_ln_qkvo_attention_int8_gqa_dw_bwd":
            "(i) ft_resvit_fast.sh --n_kv_heads 4"}

    # phase 12: the bf16 pair from train_cli --save-acts, the int8 pair from
    # --int8-grad --save-acts, the int8_dw branch from the fast flags'
    save_runs = {"fused_ln_mlp_save": "--save-acts",
                 "fused_ln_mlp_bwd_fast": "--save-acts",
                 "fused_ln_mlp_int8_save": "--int8-grad --save-acts",
                 "fused_ln_mlp_int8_save_bwd": "--int8-grad --save-acts",
                 "fused_ln_mlp_int8_save_dw_bwd": "fast flags --save-acts"}

    # phase 13: A, C and the int8_dw backwards from train_cli --int4-attn
    # --int4-grad --int8-dw, the others from --int4-attn --int4-grad
    # --int8-grad
    int4_runs = dict.fromkeys(INT4_KERNELS,
                              "--int4-attn --int4-grad --int8-dw")
    int4_runs.update(dict.fromkeys(
        ("fused_ln_mlp_int4_bwd", "fused_ln_qkvo_attention_int4_bwd"),
        "--int4-attn --int4-grad --int8-grad"))

    # phase 14: R-F and R-B dw from resvit_train_cli --int4-attn --int4-grad
    # --int8-dw C 0.625, R-B from --int4-attn --int4-grad --int8-grad C
    # 0.625, G-F and G-B's from the same flags with 4 kv heads
    resvit_int4_runs = {
        "fused_ln_qkvo_attention_rect_int4": RESVIT_INT4_RUNS[3][0],
        "fused_ln_qkvo_attention_rect_int4_dw_bwd": RESVIT_INT4_RUNS[3][0],
        "fused_ln_qkvo_attention_rect_int4_bwd": RESVIT_INT4_RUNS[2][0],
        "fused_ln_qkvo_attention_int4_gqa": RESVIT_INT4_RUNS[7][0],
        "fused_ln_qkvo_attention_int4_gqa_dw_bwd": RESVIT_INT4_RUNS[7][0],
        "fused_ln_qkvo_attention_int4_gqa_bwd": RESVIT_INT4_RUNS[6][0]}

    # phase 15: K10's forward from the bf16 dense serving forward, its
    # backward from the first train step
    k10_runs = {"fused_qkv_attention": "bf16 dense",
                "fused_qkv_attention_bwd": "train step 0"}

    # phase 16: K9's forward from the bf16 dense serving forward under the
    # mesh, its backward from the first train step; K2's partial pair from
    # rank 0's run of train_cli --n-model 2
    mesh_runs = {"fused_qkvo_attention": "bf16 dense",
                 "fused_qkvo_attention_bwd": "train step 0",
                 "fused_ln_mlp_partial": "tp rank 0",
                 "fused_ln_mlp_partial_bwd": "tp rank 0"}

    # phase 17: each partial from rank 0's train_cli --n-model 2 run that
    # takes it, K12's partial pair from its library caller's run
    tier_runs = {"fused_ln_mlp_int8_partial": "--int8",
                 "fused_ln_mlp_int8_partial_bwd": "--int8-grad",
                 "fused_ln_mlp_int8_partial_dw_bwd": "--int8-dw",
                 "fused_ln_mlp_int4_partial": "--int4",
                 "fused_ln_mlp_int4_partial_bwd":
                     "--int4-attn --int4-grad --int8-grad",
                 "fused_ln_mlp_int4_partial_dw_bwd":
                     "--int4-attn --int4-grad --int8-dw",
                 "fused_ln_mlp_bwd_wide_partial": "h14"}

    def launches(name):
        if name in tier_runs:
            return counts17[tier_runs[name]][name]
        if name in PARTIAL17_KERNELS:
            return save17[name]
        if name in mesh_runs:
            return counts16[mesh_runs[name]][name]
        if name in k10_runs:
            return counts15[k10_runs[name]][name]
        if name in resvit_int4_runs:
            return counts14[resvit_int4_runs[name]][name]
        if name in int4_runs:
            return counts13[int4_runs[name]][name]
        if name == "gemm_sm90_s8:s8_group_rc":  # K11-D's int8_dw folds
            return counts13["--int4-attn --int4-grad --int8-dw"][name]
        if name in save_runs:
            return counts12[save_runs[name]][name]
        if name in phase11_runs:
            return counts11[phase11_runs[name]][name]
        if name in H14_KERNELS:  # phase 10: eval_cli's run, train_cli's
            return (counts_h14 if name == "fused_ln_qkvo_attention_flash"
                    else counts_h14_train)[name]
        if name in RESVIT_KERNELS:
            return counts_rv[resvit_runs[name]][name]
        if name in TRAIN_RESVIT_KERNELS:
            return counts_rt[RESVIT_TRAIN_RUNS[train_runs[name]][0]][name]
        if name in HO_KERNELS + DW_KERNELS or name.endswith(
                ("s8_group", "s8_residual_f32")):
            return counts_fast[name]
        return (counts_i8 if name in INT8_KERNELS + tuple(S8_INFO)
                else counts)[name]

    table = []
    for name, (src, rep) in {**KERNEL_INFO, **S8_INFO}.items():
        bound_ms, bound_by = _bound(name, stats[name]["shape"],
                                    stats[name].get("dims"),
                                    stats[name].get("work"))
        table.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches(name),
            **{k: stats[name][k] for k in ("max_abs_err", "ms", "plain_ms")},
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=stats[name].get("library_ms")))
    print("kernel table: " + "; ".join(
        f"{r['name']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by "
        f"{r['bound_by']}, x{r['ms'] / r['bound_ms']:.1f}) at "
        + ("{}x{}x{}" if r["name"] in S8_INFO else "b{} rows {}").format(
            *stats[r["name"]]["shape"][:3 if r["name"] in S8_INFO else 2])
        + (" ({})".format(stats[r["name"]]["shape"][2])
           if len(stats[r["name"]]["shape"]) > 2
           and r["name"] not in S8_INFO else "") for r in table),
        flush=True)
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
