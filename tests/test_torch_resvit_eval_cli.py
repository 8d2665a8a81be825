"""vitax_torch.resvit_eval_cli against vitax.resvit_eval_cli: flags, model
arguments and metrics.

Both CLIs evaluate the same Synthetic split with random weights; the port's
parameters are vitax's (its `init_params` at the CLI's seed, through
`params_from_jax`), handed over by replacing the port's `init_params`. Runs
on the tiny preset (D 96, 3 heads of 32), dense and compacted (the legacy
`apply_compact` and the fused compact path), fp32 and bf16, with
`device="cpu"`. vitax's Pallas gates take no D 96, so its side runs its XLA
attention where the port's takes K1's and K8's twins; the model-level
kernel parity, int8 included, is tests/test_torch_resvit.py's. The int8
tier here: the port's CLI serves `--int8` through the int8 twins (K3 on the
plain layer, K8's on the compacted rows).
Tolerances: loss and router entropy 1e-4 in fp32, 2e-2 in bf16; the
accuracies and the active ratio exactly.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from vitax import resvit_eval_cli as j_eval  # noqa: E402
from vitax import resvit_train_cli as j_train  # noqa: E402
from vitax.core import config as j_config  # noqa: E402
from vitax.models import resvit as jr  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch import resvit_eval_cli as t_eval  # noqa: E402
from vitax_torch import resvit_train_cli as t_train  # noqa: E402
from vitax_torch.core import config as t_config  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402


def _fields(cfg):
    def norm(v):
        if isinstance(v, torch.dtype):
            return str(v).replace("torch.", "")
        return np.dtype(v).name if isinstance(v, type) else v
    return {f.name: norm(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


ARGVS = [
    [],
    ["--dataset", "Synthetic", "--model-arch", "b16", "--image-size", "224",
     "--batch-size", "64", "--use_lora", "True", "--lora_rank", "48",
     "--use_reslr", "True", "--block_size", "4", "--dynamic_start_layer", "1",
     "--dynamic_reserve_initials", "2", "--dynamic_active_target", "0.4",
     "--compact-capacity", "0.625", "--int8"],
    ["--no-pallas", "--no-fused-qkv", "--dtype", "float32", "--n_heads", "6",
     "--n_kv_heads", "2", "--legacy-compact", "--compact-overflow",
     "identity", "--use_lora", "False", "--checkpoint-path", "x", "--n_gpu",
     "2", "--seed", "3"],
]
TINY = ["--dataset", "Synthetic", "--model-arch", "tiny", "--image-size",
        "32", "--batch-size", "8", "--synthetic-samples", "20",
        "--num-workers", "0", "--use_lora", "True", "--lora_rank", "4",
        "--use_reslr", "True", "--block_size", "2", "--dynamic_start_layer",
        "1", "--dynamic_reserve_initials", "2", "--dynamic_router_hdim", "32",
        "--low_rank_dim", "8", "--seed", "5"]


@pytest.mark.parametrize("argv", ARGVS)
def test_eval_namespace_equals_vitax(argv):
    assert vars(t_eval.get_eval_config(argv)) == \
        vars(j_eval.get_eval_config(argv))


@pytest.mark.parametrize("argv", [[], ["--int8-dw", "--compact-capacity",
                                       "0.5", "--n_heads", "4",
                                       "--remat", "--no-fused-qkv"]])
def test_train_namespace_equals_vitax(argv, tmp_path, monkeypatch):
    monkeypatch.setenv("VITAX_NO_CACHE", "1")
    argv = argv + ["--exp-root", str(tmp_path)]
    t = vars(t_train.get_train_config(argv))
    j = vars(j_train.get_train_config(argv))
    # the experiment paths carry a timestamp each
    paths = {k for k, v in j.items() if str(tmp_path) in str(v)}
    assert paths and set(t) == set(j)
    assert {k: v for k, v in t.items() if k not in paths} == \
        {k: v for k, v in j.items() if k not in paths}


@pytest.mark.parametrize("argv", ARGVS[:2] + [
    ARGVS[2][:8] + ["--compact-overflow", "identity", "--use_lora", "False"],
    ["--int8-grad", "--fused-mlp", "--save-acts"]])
def test_model_args_equal_vitaxs_off_the_card(argv, tmp_path):
    """On the CPU (vitax's backend "cpu", the port's device "cpu") the
    model arguments are the same, field by field; on the card the port
    turns the fused kernels on as vitax does on the TPU."""
    j_cfg = j_train.get_train_config(argv + ["--exp-root", str(tmp_path)])
    t_cfg = t_train.get_train_config(argv + ["--exp-root", str(tmp_path)])
    a = j_train.config_to_model_args(j_cfg)
    b = t_train.config_to_model_args(t_cfg, torch.device("cpu"))
    assert _fields(a) == _fields(b)
    card = t_train.config_to_model_args(t_cfg, torch.device("cuda"))
    int8 = "--int8" in argv or "--int8-grad" in argv
    fused = "--no-fused-qkv" not in argv
    assert (card.fused_qkv, card.fused_qkvo) == (fused, fused)
    assert card.fused_mlp == (int8 or "--fused-mlp" in argv)


@pytest.fixture
def vitax_weights(monkeypatch):
    """The port's CLI builds its model from vitax's init_params at the same
    seed (numpy arrays through params_from_jax)."""
    monkeypatch.setenv("VITAX_NO_CACHE", "1")
    j_init = jr.init_params

    def init(gen, cfg, device="cpu"):
        seed = int(gen.initial_seed())
        p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed),
                                            _jax_cfg(cfg)))
        for lp in p["layers"]:  # non-trivial routing (see test_torch_resvit)
            if "router" in lp:
                rng = np.random.default_rng(len(lp["router"]["out3"]["bias"]))
                lp["router"]["out3"]["kernel"] = (0.5 * rng.standard_normal(
                    lp["router"]["out3"]["kernel"].shape)).astype(np.float32)
                lp["router"]["out3"]["bias"] = rng.uniform(
                    -0.3, 0.3, lp["router"]["out3"]["bias"].shape).astype(
                    np.float32)
        init.last = p
        return tr.params_from_jax(p, device)

    monkeypatch.setattr(tr, "init_params", init)
    monkeypatch.setattr(jr, "init_params",
                        lambda key, cfg: jax.tree.map(jax.numpy.asarray,
                                                      init.last))
    return init


def _jax_cfg(tcfg):
    import jax.numpy as jnp
    from vitax.core.config import ResViTConfig
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["dtype"] = jnp.bfloat16 if tcfg.dtype == torch.bfloat16 else \
        jnp.float32
    kw["param_dtype"] = jnp.float32
    return ResViTConfig(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [[], ["--compact-capacity", "0.5"],
                                   ["--compact-capacity", "0.5",
                                    "--fused-qkv"],
                                   ["--compact-capacity", "0.3",
                                    "--compact-overflow", "identity",
                                    "--fused-qkv"]],
                         ids=["dense", "legacy-compact", "compact",
                              "compact-identity"])
def test_metrics_match_vitax(vitax_weights, dtype, extra):
    argv = TINY + ["--dtype", dtype] + extra
    out = t_eval.main(argv, device="cpu")  # builds the weights first
    ref = j_eval.main(argv)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for k in ("loss", "c_loss", "router_entropy"):
        np.testing.assert_allclose(out[k], ref[k], rtol=tol, atol=tol)
    for k in ("acc1", "acc5", "non_low_rank_ratio"):
        assert out[k] == pytest.approx(ref[k], abs=1e-6), k
    assert 0 < out["non_low_rank_ratio"] < 1
    assert set(out) == set(ref)


def test_int8_compact_serves_through_the_int8_twins(monkeypatch):
    # D 128: vitax's fused gate takes D % 128 == 0 only, and the port picks
    # its fused halves where it does
    monkeypatch.setitem(t_config.ARCH_PRESETS, "tiny", GQA_TINY)
    seen = {}
    for name in ("fused_ln_qkvo_attention_int8_ref",
                 "fused_ln_qkvo_attention_rect_int8_ref",
                 "fused_ln_qkvo_attention_rect_ref",
                 "fused_ln_qkvo_attention_ref"):
        fn = getattr(ck, name)
        monkeypatch.setattr(
            ck, name, lambda *a, _f=fn, _n=name, **k:
            seen.__setitem__(_n, seen.get(_n, 0) + 1) or _f(*a, **k))
    out = t_eval.main(TINY + ["--dtype", "bfloat16", "--fused-qkv", "--int8",
                              "--compact-capacity", "0.5"], device="cpu")
    # 3 batches; layer 0 plain (K3), layers 1 and 2 compacted (K8 int8)
    assert seen == {"fused_ln_qkvo_attention_int8_ref": 3,
                    "fused_ln_qkvo_attention_rect_int8_ref": 6}
    assert np.isfinite(out["loss"])


def test_gqa_compact_takes_the_square_gqa_kernel(monkeypatch):
    monkeypatch.setitem(t_config.ARCH_PRESETS, "tiny", GQA_TINY)
    seen = []
    fn = ck.fused_ln_qkvo_attention_gqa_ref
    monkeypatch.setattr(ck, "fused_ln_qkvo_attention_gqa_ref",
                        lambda *a: seen.append(a[-1]) or fn(*a))
    out = t_eval.main(TINY + ["--fused-qkv", "--n_kv_heads", "1",
                              "--compact-capacity", "0.5"], device="cpu")
    assert seen == [1] * 9 and np.isfinite(out["loss"])


# D 128 (4 heads of 32): wide enough for vitax's fused gate (D % 128 == 0)
# and the port's, so both serve --int8 through their fused int8 kernels
GQA_TINY = dict(patch=16, emb_dim=128, mlp_dim=256, num_heads=4,
                num_layers=3)


@pytest.fixture
def gqa_preset(monkeypatch):
    """The tiny preset at D 128 in both packages, vitax's kernels in
    interpret mode; returns the kv_heads of each call of the port's int8
    attention twin."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    for presets in (t_config.ARCH_PRESETS, j_config.ARCH_PRESETS):
        monkeypatch.setitem(presets, "tiny", GQA_TINY)
    seen = []
    fn = ck.fused_ln_qkvo_attention_int8_ref
    monkeypatch.setattr(ck, "fused_ln_qkvo_attention_int8_ref",
                        lambda *a, **k: seen.append(a[11]) or fn(*a, **k))
    return seen


@pytest.mark.parametrize("extra", [[], ["--compact-capacity", "0.5"]],
                         ids=["dense", "compact"])
def test_int8_gqa_metrics_match_vitax(vitax_weights, gqa_preset, extra):
    """--fused-qkv --int8 --n_kv_heads 2 (K7's int8 tier) against vitax's
    int8 kernel with kv_heads, dense and compacted (GQA declines the rect
    half: the square kernel runs in every layer). fp32; the same tolerances
    as the bf16-free metrics above, and the accuracies exactly."""
    argv = TINY + ["--dtype", "float32", "--fused-qkv", "--int8",
                   "--n_kv_heads", "2"] + extra
    out = t_eval.main(argv, device="cpu")
    ref = j_eval.main(argv)
    for k in ("loss", "c_loss", "router_entropy"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4)
    for k in ("acc1", "acc5", "non_low_rank_ratio"):
        assert out[k] == pytest.approx(ref[k], abs=1e-6), k
    # 3 batches of 3 layers, each through the twin with 2 kv groups
    assert gqa_preset == [2] * 9


def test_store_checkpoint_directory_loads(tmp_path):
    """A checkpoint directory of the port's store: its parameters replace
    the random ones."""
    cfg = t_train.config_to_model_args(
        t_eval.get_eval_config(TINY), torch.device("cpu"))
    params = tr.init_params(torch.Generator().manual_seed(11), cfg)
    params["classifier"]["bias"] += 3.0
    ckpt = tmp_path / "best"
    ckpt.mkdir()
    torch.save({"params": params}, ckpt / "state.pt")
    out = t_eval.main(TINY + ["--checkpoint-path", str(ckpt)], device="cpu")
    base = t_eval.main(TINY, device="cpu")
    assert out["loss"] != base["loss"]


@pytest.mark.parametrize("extra,match", [
    (["--checkpoint-path", "model.pth"], "Queue 1 item 4")])
def test_unported_options_raise(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        t_eval.main(TINY + extra, device="cpu")


def test_n_gpu_is_parsed_and_not_read_as_vitax(vitax_weights, tmp_path):
    """vitax's resvit_eval_cli parses --n_gpu and never reads it (it builds
    no mesh), and so does the port's: with --n_gpu 2 the namespace, the
    model arguments and the metrics are vitax's, and the port's metrics
    are its own without the flag, to the bit."""
    argv = TINY + ["--dtype", "float32", "--n_gpu", "2"]
    t_cfg, j_cfg = t_eval.get_eval_config(argv), j_eval.get_eval_config(argv)
    assert vars(t_cfg) == vars(j_cfg) and t_cfg.n_gpu == 2
    assert _fields(j_train.config_to_model_args(j_cfg)) == _fields(
        t_train.config_to_model_args(t_cfg, torch.device("cpu")))
    out = t_eval.main(argv, device="cpu")  # builds the weights first
    ref = j_eval.main(argv)
    for k in ("loss", "c_loss", "router_entropy"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4)
    for k in ("acc1", "acc5", "non_low_rank_ratio"):
        assert out[k] == pytest.approx(ref[k], abs=1e-6), k
    assert t_eval.main(argv[:-2], device="cpu") == out


def test_train_main_names_the_training_item(tmp_path):
    """resvit_train_cli.main trains (tests/test_torch_resvit_train_cli.py
    holds it against vitax's); what it has not ported names its item."""
    out = t_train.main(TINY + ["--train-steps", "2", "--warmup-steps", "0",
                               "--exp-root", str(tmp_path)], device="cpu")
    assert len(out["plan"]) == 2 and np.isfinite(out["epochs"][-1]["loss"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        t_train.main(TINY + ["--checkpoint-path", "x.pth", "--exp-root",
                             str(tmp_path)], device="cpu")


def test_main_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main() would evaluate on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_eval.main(TINY)
