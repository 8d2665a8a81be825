"""vitax_torch's Res-ViT training forward against vitax's on the routes
past dense and compacted routing: tests/test_torch_resvit_train.py's check
of `apply(train=True)` (logits, distill loss, keep bits, soft
probabilities, every trainable grad, with vitax's noise and kept tokens
injected) on compaction overflow, token dropping, GQA, --no-fused-qkv and
--save-acts. Its setup, tolerances and fixtures are that file's; the cases
live here so that `--dist loadfile` runs the two halves on two workers
(it orders files by their number of tests, so the two hold 11 each).
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from tests.test_torch_resvit_train import (  # noqa: E402,F401
    INT8_GRAD, check_apply_train, interpret_mode,
    vitax_path_ids_from_the_keep_bits)

APPLY_CASES = [
    # (dtype, path, overrides)
    # capacity 0.3 (6 of 17 tokens) overflows: demotion clears path bits
    ("float32", "fused", dict(compact_capacity=0.3)),
    ("float32", "fused", dict(token_keep=0.5, compact_capacity=0.625)),
    # GQA: the rect half declines, the square K7 runs and is gathered
    ("float32", "fused", dict(n_kv_heads=1, compact_capacity=0.625)),
    ("float32", "plain", dict(n_kv_heads=1, use_lora=False)),
    # --no-fused-qkv: K13's twins under autograd, teacher and student
    ("float32", "k13", {}),
    ("bfloat16", "k13", {}),
    ("float32", "k13", dict(n_kv_heads=1, use_lora=False)),
    # --save-acts: K12's twins in the student, K2's or K4's forward in the
    # teacher (no grad); the int8 tier as vitax's _ln_mlp_2d_int8s, int8_dw
    # off and on (one group of the 68 rows in both packages)
    ("float32", "fused", dict(fused_mlp_save=True)),
    ("bfloat16", "fused", dict(fused_mlp_save=True)),
    ("float32", "fused", dict(INT8_GRAD, fused_mlp_save=True)),
    ("float32", "fused", dict(INT8_GRAD, int8_dw=True, fused_mlp_save=True)),
]


@pytest.mark.parametrize("dtype,path,kw", APPLY_CASES)
def test_apply_train_matches_vitax(dtype, path, kw):
    """apply(train=True) with vitax's noise and kept tokens injected: the
    logits, the distill loss, the keep bits, the soft probabilities and the
    grads of the 3-term loss for every trainable leaf."""
    check_apply_train(dtype, path, kw)
