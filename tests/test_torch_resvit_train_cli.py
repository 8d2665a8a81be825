"""vitax_torch.resvit_train_cli.main against vitax.resvit_train_cli.main on
a tiny Res-ViT (the tiny preset: D 96, 3 heads of 32, 3 layers; LoRA rank 4,
block size 2 from layer 1, 2 reserved tokens; image 32) on Synthetic data,
with `device="cpu"`.

Both CLIs start from the same weights (vitax's init at the CLI's seed,
handed to the port through `params_from_jax`, the routers' biases drawn so
that routing is not all-keep) and train at lr 0, so the weights stay put and
each epoch's validation metrics are comparable; vitax's train steps are
replaced by recorders (the step math is tests/test_torch_resvit_train.py's),
so what is held here is the loop: which config each step runs (the
compaction warmup, the capacity anneal, the token-keep switch), the epochs,
the partial-batch skip, the JSON diagnostics, the per-epoch validation and
the checkpoints. The val split holds whole batches (24 images at b8): vitax
counts a padded last batch's pad rows in its active ratio and router
entropy, the port does not (ROADMAP Queue 3).
Tolerance (fp32): vitax's validation metrics are read off its printed lines
(4 decimals), so each port value is within 5e-5 (plus fp32 noise) of them.
"""

import json
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from vitax import resvit_train_cli as j_train  # noqa: E402
from vitax.core import config as j_config  # noqa: E402
from vitax.models import resvit as jr  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch import resvit_eval_cli as t_eval  # noqa: E402
from vitax_torch import resvit_train_cli as t_train  # noqa: E402
from vitax_torch.core import config as t_config  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

TINY = ["--dataset", "Synthetic", "--model-arch", "tiny", "--image-size",
        "32", "--batch-size", "8", "--synthetic-samples", "24",
        "--num-workers", "0", "--use_lora", "True", "--lora_rank", "4",
        "--use_reslr", "True", "--block_size", "2", "--dynamic_start_layer",
        "1", "--dynamic_reserve_initials", "2", "--dynamic_router_hdim", "32",
        "--low_rank_dim", "8", "--seed", "5"]
# the training flags (the eval CLI takes TINY alone)
TRAIN = TINY + ["--print-freq", "1000", "--initial-lambda-active", "10",
                "--initial-lambda-distill", "1"]
# 9 steps over 3 epochs of 3 batches: the dense compaction warmup (2 steps),
# the capacity anneal at 0.9 (2 steps), then 0.5; keep 0.5 for the first
# epoch of three (schedule 0.34), dense after
PLAN = ["--train-steps", "9", "--warmup-steps", "2", "--compact-capacity",
        "0.5", "--compact-warmup", "2", "--compact-capacity-start", "0.9",
        "--compact-capacity-anneal", "2", "--token-keep", "0.5",
        "--token-keep-schedule", "0.34"]


@pytest.fixture
def same_weights(monkeypatch):
    """Both packages' init_params return vitax's init at the CLI's seed, the
    routers' final layers redrawn (random routing, not all-keep)."""
    monkeypatch.setenv("VITAX_NO_CACHE", "1")
    j_init = jr.init_params
    state = {}

    def numpy_init(cfg_j):
        if "p" not in state:
            p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(5), cfg_j))
            rng = np.random.default_rng(4)
            for lp in p["layers"]:
                if "router" in lp:
                    out3 = lp["router"]["out3"]
                    out3["kernel"] = (3.0 * rng.standard_normal(
                        out3["kernel"].shape)).astype(np.float32)
                    out3["bias"] = rng.uniform(-0.3, 0.3, out3["bias"].shape
                                               ).astype(np.float32)
            state["p"] = p
        return state["p"]

    monkeypatch.setattr(jr, "init_params", lambda key, cfg: jax.tree.map(
        jax.numpy.asarray, numpy_init(cfg)))
    monkeypatch.setattr(tr, "init_params", lambda gen, cfg, device="cpu":
                        tr.params_from_jax(numpy_init(_jax_cfg(cfg)),
                                           device))


def _jax_cfg(tcfg):
    import dataclasses

    import jax.numpy as jnp
    from vitax.core.config import ResViTConfig
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["dtype"] = jnp.bfloat16 if tcfg.dtype == torch.bfloat16 else \
        jnp.float32
    kw["param_dtype"] = jnp.float32
    return ResViTConfig(**kw)


def _vitax_main(argv, monkeypatch, capsys):
    """vitax's main with its train steps replaced by recorders of the config
    each step runs; returns (plan, per-epoch validation metrics parsed from
    its print lines)."""
    plan = []

    def make_train_step(cfg, tx, lambdas, donate=True, mesh=None):
        def step(state, images, labels):
            plan.append((cfg.compact_capacity, cfg.token_keep))
            return state, {}
        return step

    monkeypatch.setattr(j_train, "make_train_step", make_train_step)
    j_train.main(argv)
    out = capsys.readouterr().out
    valid = [dict((k, float(v)) for k, v in re.findall(r"(\w+)=([-\d.e]+)",
                                                      line))
             for line in re.findall(r"epoch \d+ valid: (.*)", out)]
    return plan, valid


def test_step_plan_json_and_validation_match_vitax(same_weights, tmp_path,
                                                   monkeypatch, capsys):
    argv = TRAIN + PLAN + ["--lr", "0", "--dtype", "float32"]
    t_out = t_train.main(argv + ["--exp-root", str(tmp_path / "t")],
                         device="cpu")
    capsys.readouterr()
    j_plan, j_valid = _vitax_main(argv + ["--exp-root", str(tmp_path / "j")],
                                  monkeypatch, capsys)
    # the step plan: which config ran each step, epoch by epoch
    t_plan = [(c, k) for _, c, k in t_out["plan"]]
    assert t_plan == j_plan
    assert t_plan[:2] == [(None, 0.5)] * 2  # the dense compaction warmup
    # the anneal, then the dense epochs, whose config overrides it
    assert t_plan[2:4] == [(0.9, 0.5), (0.5, 1.0)]
    assert [e for e, _, _ in t_out["plan"]] == [0] * 3 + [1] * 3 + [2] * 3
    # per-epoch validation on unchanged weights (lr 0)
    assert len(t_out["epochs"]) == len(j_valid) == 3
    for t, j in zip(t_out["epochs"], j_valid):
        assert set(t) == set(j)
        for k in j:
            assert t[k] == pytest.approx(j[k], abs=5.1e-5), k
    assert 0 < t_out["epochs"][0]["non_low_rank_ratio"] < 1
    # the JSON diagnostics: the same files and keys, numpy dtype names
    j_dir = next((tmp_path / "j").rglob("model_structure.json")).parent
    t_dir = tmp_path / "t"
    for name in ("model_structure.json", "weight_mapping_log.json",
                 "trainable_weights_info.json"):
        t_json = json.loads(next(t_dir.rglob(name)).read_text())
        j_json = json.loads((j_dir / name).read_text())
        assert t_json == j_json, name
    # the store: current and best each epoch; best loads in resvit_eval_cli
    best = t_out["checkpoint_dir"] + "/best"
    served = t_eval.main(TINY + ["--checkpoint-path", best, "--dtype",
                                 "float32"], device="cpu")
    np.testing.assert_allclose(served["loss"], t_out["epochs"][0]["loss"],
                               rtol=1e-5)


# D 128 (4 heads of 32): both packages' fused gates take it (vitax's needs
# D % 128 == 0), so both run their fused int8 kernels with kv_heads
GQA_TINY = dict(patch=16, emb_dim=128, mlp_dim=256, num_heads=4,
                num_layers=3)


@pytest.mark.parametrize("flags,int8_dw", [
    (["--int8-grad"], False),
    (["--int8-dw", "--compact-capacity", "0.625", "--compact-warmup", "1",
      "--token-keep", "0.5"], True)], ids=["int8-grad", "fast"])
def test_int8_gqa_training_runs_k7s_int8_tier(flags, int8_dw, same_weights,
                                              tmp_path, monkeypatch, capsys):
    """--n_kv_heads 2 with --int8-grad, and with ft_resvit_fast.sh's flags
    (--int8-dw, compaction, keep 0.5): every student backward of the port's
    steps takes K7's int8 tier (its twin, 2 kv groups, int8_dw as asked),
    and each epoch's validation (lr 0) equals vitax's through its int8
    kernel with kv_heads, within the print rounding."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    for presets in (t_config.ARCH_PRESETS, j_config.ARCH_PRESETS):
        monkeypatch.setitem(presets, "tiny", GQA_TINY)
    seen = []
    fn = ck.fused_ln_qkvo_attention_int8_bwd_ref
    monkeypatch.setattr(
        ck, "fused_ln_qkvo_attention_int8_bwd_ref",
        lambda *a, **k: seen.append((a[11], k.get("int8_dw", False)))
        or fn(*a, **k))
    argv = TRAIN + flags + ["--fused-qkv", "--n_kv_heads", "2",
                            "--train-steps", "3", "--warmup-steps", "0",
                            "--lr", "0", "--dtype", "float32"]
    t_out = t_train.main(argv + ["--exp-root", str(tmp_path / "t")],
                         device="cpu")
    # 3 steps of 3 layers (the plain layer and 2 routed students)
    assert seen == [(2, int8_dw)] * 9
    capsys.readouterr()
    _, j_valid = _vitax_main(argv + ["--exp-root", str(tmp_path / "j")],
                             monkeypatch, capsys)
    assert len(t_out["epochs"]) == len(j_valid) == 1
    for k, v in j_valid[0].items():
        assert t_out["epochs"][0][k] == pytest.approx(v, abs=5.1e-5), k


def test_training_moves_the_trainable_weights_only(tmp_path):
    """A real run (lr 1e-3, two epochs): the LoRA adapters, routers,
    approximators, cls token and classifier move; the frozen base weights
    and every LayerNorm stay bit for bit; losses finite; the routing viz
    PNGs written."""
    argv = TRAIN + ["--train-steps", "6", "--warmup-steps", "2", "--lr",
                   "1e-3", "--save-routing-viz", "--exp-root", str(tmp_path)]
    cfg = t_train.config_to_model_args(t_train.get_train_config(argv), "cpu")
    before = tr.init_params(torch.Generator().manual_seed(5), cfg)
    out = t_train.main(argv, device="cpu")
    after = out["state"].params
    mask = tr.trainable_mask(after, cfg)
    moved = {}
    for (path, a), (_, b), (_, m) in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: t.detach(), after,
                             is_leaf=torch.is_tensor))[0],
            jax.tree_util.tree_flatten_with_path(
                before, is_leaf=torch.is_tensor)[0],
            jax.tree_util.tree_flatten_with_path(mask)[0]):
        moved[jax.tree_util.keystr(path)] = (bool(m), not torch.equal(a, b))
    assert all(not mv for tm, mv in moved.values() if not tm)
    assert any(mv for tm, mv in moved.values() if tm)
    assert moved["['classifier']['kernel']"] == (True, True)
    assert all(np.isfinite(v) for e in out["epochs"] for v in e.values())
    assert list((tmp_path).rglob("routing_viz/*.png"))


def test_scan_layers_trains_the_stacked_tree(tmp_path):
    """--scan-layers keeps vitax's stacked layout through training (the loop
    runs it); with compaction it raises, as vitax's apply does."""
    argv = TRAIN + ["--train-steps", "3", "--warmup-steps", "0",
                   "--scan-layers", "--exp-root", str(tmp_path)]
    out = t_train.main(argv, device="cpu")
    assert tr.is_stacked(out["state"].params)
    assert np.isfinite(out["epochs"][-1]["loss"])
    with pytest.raises(ValueError, match="unrolled loop"):
        t_train.main(argv + ["--compact-capacity", "0.5", "--compact-warmup",
                             "0"], device="cpu")


@pytest.mark.parametrize("extra,match", [
    (["--checkpoint-path", "w.pth"], "Queue 1 item 4"),
    (["--remat"], "Queue 1 item 6")])
def test_unported_options_raise(extra, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        t_train.main(TRAIN + extra + ["--exp-root", str(tmp_path)],
                     device="cpu")


def test_main_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main() would train on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_train.main(TRAIN + ["--exp-root", str(tmp_path)])
