"""vitax_torch.train_cli on CPU: its epoch plan against vitax's, a tiny
two-epoch run that writes `current`/`best`, exact resume, the .npz head
re-init, the flags whose paths are not ported yet, and the int4 flags.

vitax's plan is read from the line its train_cli prints before it builds the
optimizer (the run is stopped there); the port's comes from `plan_epochs`.
"""

import argparse
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vitax_torch import train_cli  # noqa: E402
from vitax_torch.checkpointing.npz import save_npz_params  # noqa: E402
from vitax_torch.checkpointing.store import CheckpointStore  # noqa: E402
from vitax_torch.core.config import ARCH_PRESETS, arch_config  # noqa: E402
from vitax_torch.models import vit  # noqa: E402
from vitax_torch.train import param_leaves  # noqa: E402

TINY = ["--dataset", "Synthetic", "--model-arch", "tiny", "--image-size", "32",
        "--num-workers", "0", "--dtype", "float32"]
PLAN = re.compile(r"training (\d+) epochs \((\d+) x (\d+) steps"
                  r"(?: \+ (\d+) x (\d+) dense-tail steps)?; schedule total "
                  r"(\d+)\)")


class _PlanReached(Exception):
    pass


def _vitax_plan(argv, monkeypatch, capsys):
    jax = pytest.importorskip("jax")  # noqa: F841
    from vitax import train_cli as j_cli
    monkeypatch.setenv("VITAX_NO_CACHE", "1")

    def stop(*a, **k):
        raise _PlanReached

    monkeypatch.setattr(j_cli, "sgd_momentum", stop)
    capsys.readouterr()
    with pytest.raises(_PlanReached):
        j_cli.main(argv)
    m = PLAN.search(capsys.readouterr().out)
    assert m is not None
    epochs, dense_from, _, tail, _, total = m.groups()
    return int(epochs), int(dense_from), int(total), tail is not None


@pytest.mark.parametrize("flags", [
    ["--batch-size", "8", "--train-steps", "20"],
    ["--batch-size", "8", "--train-steps", "32", "--token-keep", "0.5",
     "--token-keep-schedule", "0.5"],
    ["--batch-size", "8", "--train-steps", "30", "--token-keep", "0.5",
     "--token-keep-schedule", "0.75", "--dense-batch-size", "16"],
])
def test_epoch_plan_matches_vitax(flags, tmp_path, monkeypatch, capsys):
    argv = TINY + ["--synthetic-samples", "64", "--exp-root",
                   str(tmp_path)] + flags
    epochs, dense_from, total, has_tail = _vitax_plan(argv, monkeypatch,
                                                      capsys)
    opt = dict(zip(flags[::2], flags[1::2]))
    steps = math.ceil(64 / int(opt["--batch-size"]))
    dense = (math.ceil(64 / int(opt["--dense-batch-size"]))
             if "--dense-batch-size" in opt else None)
    sched = (float(opt["--token-keep-schedule"])
             if "--token-keep-schedule" in opt else None)
    plan = train_cli.plan_epochs(int(opt["--train-steps"]), steps, dense,
                                 sched, float(opt.get("--token-keep", 1.0)))
    assert plan == (epochs, dense_from, total)
    assert has_tail == (dense is not None)


def _run(tmp_path, name, extra=()):
    return train_cli.main(TINY + [
        "--batch-size", "8", "--synthetic-samples", "16", "--train-steps", "4",
        "--lr", "0.01", "--warmup-steps", "2", "--fused-qkv", "--fused-mlp",
        "--exp-name", name, "--exp-root", str(tmp_path / name), *extra],
        device="cpu")


def test_two_epoch_run_writes_current_and_best(tmp_path):
    out = _run(tmp_path, "two")
    assert [e["epoch"] for e in out["epochs"]] == [0, 1]
    for e in out["epochs"]:
        assert len(e["train"]["losses"]) == 2
        assert all(math.isfinite(v) for v in e["train"]["losses"])
        assert 0.0 <= e["valid"]["acc1"] <= 1.0
    store = CheckpointStore(out["checkpoint_dir"])
    assert store.exists("current") and store.exists("best")
    meta = store.metadata("current")
    assert meta["epoch"] == 1 and meta["best_acc"] == out["best_acc"]
    assert out["state"].step == 4


def test_resume_after_epoch_0_equals_the_uninterrupted_run(tmp_path,
                                                           monkeypatch):
    full = _run(tmp_path, "full")

    save = CheckpointStore.save_model

    def save_then_stop(self, state, epoch, **kw):
        save(self, state, epoch, **kw)
        if epoch == 0:
            raise _PlanReached

    monkeypatch.setattr(CheckpointStore, "save_model", save_then_stop)
    with pytest.raises(_PlanReached):
        _run(tmp_path, "cut")
    monkeypatch.setattr(CheckpointStore, "save_model", save)
    (ckpt,) = (tmp_path / "cut" / "save").glob("*/checkpoints")
    resumed = _run(tmp_path, "resumed", ["--resume", str(ckpt)])

    assert [e["epoch"] for e in resumed["epochs"]] == [1]
    assert resumed["epochs"][0]["train"]["losses"] == \
        full["epochs"][1]["train"]["losses"]
    assert resumed["best_acc"] == full["best_acc"]
    assert resumed["state"].step == full["state"].step == 4
    for a, b in zip(param_leaves(resumed["state"].params),
                    param_leaves(full["state"].params)):
        assert torch.equal(a, b)
    assert resumed["state"].scheduler.last_epoch == \
        full["state"].scheduler.last_epoch


def test_npz_checkpoint_with_another_head_is_reinitialized(tmp_path, capsys):
    cfg = arch_config("tiny", 32, 10)
    params = vit.init_params(torch.Generator().manual_seed(0), cfg)

    def to_numpy(t):
        if isinstance(t, dict):
            return {k: to_numpy(v) for k, v in t.items()}
        return t.numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    tree = {k: to_numpy(v) for k, v in params.items() if k != "layers"}
    tree["layers"] = stack([to_numpy(lp) for lp in params["layers"]])
    path = str(tmp_path / "w.npz")
    save_npz_params(path, tree)
    out = train_cli.main(TINY + [
        "--batch-size", "8", "--synthetic-samples", "8", "--train-steps", "1",
        "--warmup-steps", "0", "--num-classes", "12", "--checkpoint-path", path,
        "--exp-root", str(tmp_path)], device="cpu")
    assert "re-initializing classifier head for 12 classes" in \
        capsys.readouterr().out
    head = out["state"].params["classifier"]["kernel"]
    assert head.shape == (96, 12)


@pytest.mark.parametrize("flags", [
    ["--export-pth"], ["--n-gpu", "2"], ["--n-model", "2"], ["--device-prep"],
    ["--remat", "full"], ["--remat", "selective"],
    ["--checkpoint-path", "weights/model.pth"],
])
def test_unported_flags_raise(flags, tmp_path):
    """Each names its ROADMAP item; --n-gpu 2 is ported, and in one process
    it says to launch one process per card with torchrun (--n-model 2 on
    the tiny preset raises tensor parallelism's item: its fused halves are
    off on the CPU)."""
    error, match = ((ValueError, "torchrun --nproc_per_node")
                    if flags == ["--n-gpu", "2"]
                    else (NotImplementedError, "ROADMAP"))
    with pytest.raises(error, match=match):
        train_cli.main(TINY + ["--synthetic-samples", "8", "--exp-root",
                               str(tmp_path)] + flags, device="cpu")


@pytest.mark.parametrize("flags,twins", [
    (["--int4-attn"], ("fused_ln_mlp_int4_ref",
                       "fused_ln_qkvo_attention_int4_ref")),
    (["--int4"], ("fused_ln_mlp_int4_ref",
                  "fused_ln_qkvo_attention_int8_ref"))])
def test_int4_flags_train_through_the_int4_twins(flags, twins, tmp_path,
                                                 monkeypatch):
    """`--int4` and `--int4-attn`, which raised before K11 was ported, train
    with the fused halves on: their forwards are the A4W4 twins (the
    attention half's only with `--int4-attn`, else K3's), 3 layers x (a
    step and an eval batch)."""
    from vitax_torch.ops import cuda_kernels as ck
    calls = dict.fromkeys(twins, 0)
    for name in twins:
        fn = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, _f=fn, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    # D 128: vitax's fused gates take D % 128 == 0 only, and the port picks
    # its fused halves where they do
    monkeypatch.setitem(ARCH_PRESETS, "tiny", dict(
        patch=16, emb_dim=128, mlp_dim=256, num_heads=2, num_layers=3))
    out = train_cli.main(TINY + [
        "--fused-qkv", "--fused-mlp", "--batch-size", "8",
        "--synthetic-samples", "8", "--train-steps", "1", "--warmup-steps",
        "0", "--exp-root", str(tmp_path)] + flags, device="cpu")
    assert np.isfinite(out["epochs"][0]["train"]["losses"]).all()
    assert calls == dict.fromkeys(twins, 6)


def test_model_config_from_cli_defaults_the_kernels_to_the_card():
    ns = argparse.Namespace(model_arch="b16", image_size=224, num_classes=10,
                            dtype="bfloat16", fused_qkv=None, fused_mlp=None,
                            token_keep=0.5, no_pallas=False)
    gpu = train_cli.model_config_from_cli(ns, on_gpu=True)
    cpu = train_cli.model_config_from_cli(ns, on_gpu=False)
    assert gpu.fused_qkv and gpu.fused_mlp and gpu.token_keep == 0.5
    assert not (cpu.fused_qkv or cpu.fused_mlp)
    assert gpu.dtype == torch.bfloat16 and gpu.remat is False
    ns.no_pallas, ns.fused_qkv = True, False
    plain = train_cli.model_config_from_cli(ns, on_gpu=True)
    assert plain.use_pallas is False and not plain.fused_qkv


def test_main_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    """No silent CPU fallback: without a card `main` raises, unless the
    caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main() would train on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_cli.main(TINY + ["--synthetic-samples", "8", "--exp-root",
                               str(tmp_path)])
