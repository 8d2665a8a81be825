"""vitax_torch's data and tensor parallelism (parallel/) on the CPU, in gloo
worlds of 2 spawned processes (tests/torch_parallel_workers.py runs each
rank's side; every spawn joins within its own timeout, so that a hung
collective fails the test):

* the three wrappers of parallel/tp_kernels.py on a (1, 2) mesh against
  vitax's on `make_mesh(n_data=1, n_model=2)` of the conftest's fake CPU
  devices (its Pallas kernels in interpret mode): outputs, and the grads of
  x, γ, β, the output bias and every shard; the attention and MLP wrappers
  also in each of vitax's six int8/int4 flag sets;
* three SGD steps of a 2-layer D 128 ViT under (1, 2) and (2, 1), three
  AdamW steps of the small Res-ViT (dense and compacted) under (2, 1),
  `eval_cli --n-gpu 2` and `train_cli --n-gpu 2 [--n-model 2]` against one
  process on the global batch;
* three SGD steps under (1, 2) against vitax's `make_train_step` under the
  fake (1, 2) mesh with train_cli's `--int8`, `--int8-grad`, `--int4`,
  `--int4-attn` and `--int8-dw` (each half per shard in its tier),
  `--no-fused-qkv` (the plain attention on the gathered weights) and
  dropout (the plain MLP on the gathered weights; the same masks injected
  into both packages); `train_cli --n-gpu 2 --n-model 2` with the first
  four flags against one process's run of the same flags;
* the shard specs against vitax's on every parameter path, and what
  raises: a world size other than --n-gpu.

Tolerances, |port - ref| <= tol·max(1, |ref|), fp32 throughout: losses,
logits and metrics 1e-5 (each rank sums its rows, or each shard its heads
or hidden units, and the sums meet in another order than one process's);
parameters after SGD steps 1e-5 absolute; after AdamW steps 2e-5 absolute
(test_torch_resvit_train.py's: an update is lr·m/(√v + eps)); the wrappers
against vitax as tests/test_torch_kernels_ref.py holds the kernels' twins,
1e-4 for outputs and small grads, 1e-3 for the weight grads (sums over every
row); in the int8/int4 flag sets the same, the twins and vitax's kernels
quantizing on one grid, per shard alike. The int8/int4 steps against
vitax's: params 2e-3·max(1, |p|), test_torch_int8.py's band for its train
steps (a code on a rounding tie moves one step); losses 2e-2 relative and
logits 2e-2·max(1, |logit|), since this model's loss is steep (2.59 to
0.85 in three steps at lr 0.003) and the parameter distance that the
moved codes leave (<= 4.3e-4 scaled) moves the loss by up to 1.6e-2
relative: one process of each package, measured on the same steps
without a mesh. The bf16 steps 1e-4 (losses, logits) and 1e-3 (params),
test_torch_train.py's. The tier CLI runs under (1, 2) against one
process's, where per-shard quantization scales stand in for whole-tensor
ones: losses 2e-2 relative with int8 (6.6e-3 measured), 1.5e-1 with int4
(8.7e-2 measured: an int4 code is 1/7 of its row's largest value, and
other scales pick other codes). Both CLIs run the
D 128 preset injected as "tiny" in fp32.
"""

import multiprocessing as mp
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests import torch_parallel_workers as W  # noqa: E402
from vitax.models import resvit as jr  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax import cli as j_cli  # noqa: E402
from vitax import train_cli as j_train  # noqa: E402
from vitax.core import config as jconf  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.parallel import mesh as jmesh  # noqa: E402
from vitax.parallel import tp_kernels as jtp  # noqa: E402
from vitax.train import (create_train_state as j_state,  # noqa: E402
                         make_train_step as j_step, onecycle_lr as j_lr,
                         onecycle_momentum as j_mom, sgd_momentum as j_sgd)
from vitax_torch import eval_cli as t_eval  # noqa: E402
from vitax_torch import train_cli as t_train  # noqa: E402
from vitax_torch.core import config as tconf  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.parallel import mesh as tmesh  # noqa: E402
from vitax_torch.utils.memory import named_leaves  # noqa: E402

SPAWN_TIMEOUT = 120  # seconds a world of 2 processes may take


def _spawn(scenario, tmp):
    """Runs `scenario` in a gloo world of 2 processes; their results."""
    ctx = mp.get_context("spawn")
    init = os.path.join(tmp, f"{scenario}.init")
    procs = [ctx.Process(target=W.entry,
                         args=(r, 2, init, scenario, str(tmp)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, f"{scenario}: the world did not end in {SPAWN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0, 0], scenario
    return [torch.load(os.path.join(tmp, f"{scenario}_rank{r}.pt"),
                       weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    return _spawn("tp", tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    return _spawn("dp", tmp_path_factory.mktemp("dp"))


@pytest.fixture
def preset(monkeypatch):
    monkeypatch.setitem(tconf.ARCH_PRESETS, "tiny", W.PRESET)


def _close(ref, out, tol, what):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if torch.is_tensor(out) else \
        np.asarray(out, np.float32)
    assert out.shape == ref.shape, what
    bound = tol * max(1.0, float(np.abs(ref).max())) if ref.size else 0.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _close_trees(ref, out, atol, what):
    ref, out = dict(named_leaves(ref)), dict(named_leaves(out))
    assert set(ref) == set(out)
    for name, r in ref.items():
        err = float((out[name] - r).abs().max())
        assert err <= atol, f"{what} {name}: {err:.3e} > {atol}"


# ------------------------------------------------------------ the wrappers

def _vitax_wrappers(which):
    """vitax's wrapper on a (1, 2) mesh of the fake CPU devices, its Pallas
    kernel in interpret mode: (output, {input: grad}) under the workers'
    inputs and cotangent. `which`: "attn", "qkvo" or "mlp", the first and
    the last optionally with a tier of W.TIERS ("attn int8", ...)."""
    a = {k: jnp.asarray(v) for k, v in W.tp_wrapper_inputs().items()}
    mesh = jmesh.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    which, _, tier = which.partition(" ")
    tier = W.TIERS[tier] if tier else ()
    if which == "attn":
        names = ("x", "gamma", "beta", "wq", "wk", "wv", "bq", "bk", "bv",
                 "wo", "bo")
        fn = lambda *t: jtp.fused_ln_qkvo_attention_tp(  # noqa: E731
            *t, mesh, 1e-6, 21, 4, 32, *tier)
        args = [a[k] for k in names]
    elif which == "qkvo":
        names = ("x", "wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo")
        fn = lambda *t: jtp.fused_qkvo_attention_tp(  # noqa: E731
            *t, mesh, 21, 4, 32)
        args = [a["x"]] + [a["r" + k] for k in ("wq", "wk", "wv")] + \
            [a["rb" + k] for k in "qkv"] + [a["rwo"], a["bo"]]
    else:
        names = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
        fn = lambda *t: jtp.fused_ln_mlp_tp(*t, mesh, 1e-6,  # noqa: E731
                                            *tier)
        args = [a[k] for k in names]
    y, vjp = jax.vjp(jax.jit(fn), *args)
    grads = vjp(a[f"dy_{which}"])
    return np.asarray(y), {k: np.asarray(g) for k, g in zip(names, grads)}


# the axis of each sharded input (vitax's in_specs)
SHARD_AXIS = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
              "wo": 0, "w1": 1, "b1": 0, "w2": 0}


@pytest.mark.parametrize("which", ["attn", "qkvo", "mlp"] + [
    f"{half} {tier}" for tier in W.TIERS for half in ("attn", "mlp")])
def test_tp_wrappers_match_vitax(which, tp_world, monkeypatch):
    """fused_ln_qkvo_attention_tp (K1; K3, K11-C with a tier),
    fused_qkvo_attention_tp (K9) and fused_ln_mlp_tp (K2, K4, K11-A
    without the residual) per shard on a (1, 2) mesh, each tier with the
    backward vitax's dispatch picks: each rank's output and grads of the
    whole inputs are vitax's, its shards' grads vitax's slices of the whole
    grads. The MLP's 48 rows are one int8_dw group in both packages."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    y, grads = _vitax_wrappers(which)
    for r, res in enumerate(tp_world):
        out = res["wrappers"][which]
        _close(y, out["y"], 1e-4, f"{which} out (rank {r})")
        for name, g in grads.items():
            if name in SHARD_AXIS:
                g = np.split(g, 2, axis=SHARD_AXIS[name])[r]
            tol = 1e-3 if name.startswith("w") else 1e-4
            _close(g, out[name], tol, f"{which} d{name} (rank {r})")


def _vitax_layout(tree):
    """The port's parameters (numpy) in vitax's layout, layers stacked."""
    conv = lambda t: ({k: conv(v) for k, v in t.items()}  # noqa: E731
                      if isinstance(t, dict) else t.detach().float().numpy())
    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: np.stack(a),
                                 *[conv(lp) for lp in tree["layers"]])
    return out


def _vitax_steps(case, over, lr, monkeypatch):
    """vitax's three SGD steps of W.vit_sgd_steps's model, config and batch
    under its fake (1, 2) mesh (interpret mode), from the port's initial
    weights; with "dropout" the masks of W.dropout_mask in vitax's
    _dropout. Returns (losses, logits, params in the port's layout)."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    if case == "dropout":
        calls = [0]
        embed = jvit.embed

        def counted_embed(*a, **k):
            calls[0] = 0
            return embed(*a, **k)

        def masked(x, rate, rng, deterministic):
            if deterministic or rate <= 0.0 or rng is None:
                return x
            keep = W.dropout_mask(calls[0], x.shape, rate)
            calls[0] += 1
            return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)
        monkeypatch.setattr(jvit, "embed", counted_embed)
        monkeypatch.setattr(jvit, "_dropout", masked)
    kw = {k: v for k, v in {**W.VIT, **over}.items() if k != "dtype"}
    jc = jconf.ViTConfig(**kw, dtype=jnp.float32)
    params = tvit.init_params(torch.Generator().manual_seed(0),
                              tconf.ViTConfig(**W.VIT))
    mesh = jmesh.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    tx = j_sgd(j_lr(lr, 10, 0.2), momentum_schedule=j_mom(10, 0.2))
    images, labels = (jnp.asarray(t.numpy()) for t in W.vit_batch())
    with mesh:
        state = j_state(jax.tree.map(jnp.asarray, _vitax_layout(params)), tx,
                        jax.random.PRNGKey(1))
        step = j_step(jc, tx, donate=False, mesh=mesh)
        losses = []
        for _ in range(W.STEPS):
            state, m = step(state, images, labels.astype(jnp.int32))
            losses.append(float(m["loss"]))
        logits = jax.jit(lambda p, x: jvit.apply(p, x, jc, mesh=mesh))(
            state.params, images)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                     state.params)
    whole = {k: v for k, v in p.items() if k != "layers"}
    whole["layers"] = [jax.tree.map(lambda a, i=i: a[i], p["layers"])
                       for i in range(W.VIT["num_layers"])]
    return losses, np.asarray(logits), whole


def _hold_steps(case, tp_world, monkeypatch):
    """Each rank's three steps of STEP_CASES[case] under (1, 2) against
    vitax's under its (1, 2) mesh (the bands of the module docstring)."""
    over, lr = W.step_overrides(case)
    quant = lr == W.TIER_LR
    losses, logits, params = _vitax_steps(case, over, lr, monkeypatch)
    for r, res in enumerate(tp_world):
        got = res["steps"][case]
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=2e-2 if quant else 1e-4,
                                   atol=0 if quant else 1e-4)
        _close(logits, got["logits"], 2e-2 if quant else 1e-4,
               f"{case} logits (rank {r})")
        flat = dict(named_leaves(got["params"]))
        assert len(flat) == len(list(named_leaves(params)))
        for name, ref in named_leaves(params):
            ref = ref.numpy()
            bound = (2e-3 * max(1.0, float(np.abs(ref).max())) if quant
                     else 1e-3)
            err = float(np.abs(flat[name].numpy() - ref).max())
            assert err <= bound, f"{case} {name} (rank {r}): {err:.3e}"


@pytest.mark.parametrize("case", ["--int8-dw", "--no-fused-qkv", "dropout"])
def test_tp_sgd_steps_match_vitax(case, tp_world, monkeypatch):
    """Three SGD steps under (1, 2) against vitax's: `--int8-dw` (K3 and K4
    per shard with their int8 weight grads; the MLP's 68 rows one int8_dw
    group in both packages), `--no-fused-qkv` (the plain attention, K13's
    twin, on the weights gathered over the model axis; K2 per shard), and
    dropout 0.1 (K1 per shard, the plain MLP on the gathered weights)."""
    _hold_steps(case, tp_world, monkeypatch)


# ------------------------------------------------------------- the steps

@pytest.mark.parametrize("layout", ["tp", "dp"])
def test_vit_sgd_steps_match_one_process(layout, tp_world, dp_world):
    """Three SGD steps of the 2-layer ViT under (1, 2) (K1 and K2 per model
    shard, params sharded) and (2, 1) (each rank two of the four rows):
    every step's loss, the logits of each rank's rows and the whole params
    after the steps are one process's on the global batch."""
    one = W.vit_sgd_steps(None)
    for r, res in enumerate(tp_world if layout == "tp" else dp_world):
        v = res["vit"]
        _close(one["losses"], v["losses"], 1e-5, f"losses (rank {r})")
        _close(one["logits"][v["rows"]], v["logits"], 1e-5,
               f"logits (rank {r})")
        _close_trees(one["params"], v["params"], 1e-5, f"rank {r}")


@pytest.mark.parametrize("compact", [None, 0.625])
def test_resvit_adamw_steps_match_one_process(compact, dp_world):
    """Three AdamW steps of the small Res-ViT (K9 in every attention half
    under the mesh, the compacted blocks' included) under (2, 1), the
    global noise injected: every step's metrics (the active loss, a square
    of the global mean, included) and the params after the steps are one
    process's. One process runs K1 and K8 where the mesh runs K9: the same
    function at the kernels' rounding points."""
    one = W.resvit_adamw_steps(None, compact)
    key = "resvit" if compact is None else "resvit_compact"
    for r, res in enumerate(dp_world):
        got = res[key]
        for i, (m1, m2) in enumerate(zip(one["metrics"], got["metrics"])):
            assert set(m1) == set(m2)
            for k in m1:
                _close(m1[k].numpy(), m2[k], 1e-5, f"step {i} {k} (rank {r})")
        _close_trees(one["params"], got["params"], 2e-5, f"rank {r}")


@pytest.mark.parametrize("batch", [4, 8])
def test_eval_cli_data_parallel_matches_one_process(batch, dp_world,
                                                    preset):
    """eval_cli --n-gpu 2: each rank two (four) rows of every batch, the
    weighted sums added up over the ranks; at batch 8 the last batch has 4
    pad rows, all on rank 1. The metrics are one process's."""
    one = t_eval.main(W.cli_args(batch), device="cpu")
    for r, res in enumerate(dp_world):
        got = res["eval_cli"][batch]
        for k in ("loss", "acc1", "acc5"):
            _close(one[k], got[k], 1e-5, f"{k} (rank {r})")


@pytest.mark.parametrize("layout", ["tp", "dp"])
def test_train_cli_matches_one_process(layout, tp_world, dp_world, preset,
                                       tmp_path):
    """train_cli --n-gpu 2, with --n-model 2 and without: every step's loss
    and the validation metrics are one process's; rank 0 alone wrote the
    run's files, and its checkpoint holds whole parameters."""
    one = t_train.main(W.cli_args(4, [
        "--train-steps", "5", "--warmup-steps", "2", "--lr", "0.05", "--wd",
        "0", "--exp-root", str(tmp_path)]), device="cpu")
    world = tp_world if layout == "tp" else dp_world
    for r, res in enumerate(world):
        got = res["train_cli"]
        _close(one["epochs"][0]["train"]["losses"], got["losses"], 1e-5,
               f"losses (rank {r})")
        for k in ("loss", "acc1", "acc5"):
            _close(one["epochs"][0]["valid"][k], got["valid"][k], 1e-5,
                   f"valid {k} (rank {r})")
    written = world[0]["train_cli"]["checkpoint_dir"]
    runs = os.listdir(os.path.dirname(os.path.dirname(written)))
    assert len(runs) == 1, runs  # rank 1 made no experiment directory
    blob = torch.load(os.path.join(written, "current", "state.pt"),
                      weights_only=False)
    whole = dict(named_leaves(one["state"].params))
    for name, t in named_leaves(blob["params"]):
        assert t.shape == whole[name].shape, name
    for i, buf in blob["optimizer"]["state"].items():
        assert buf["momentum_buffer"].shape == \
            one["state"].optimizer.state_dict()["state"][i][
                "momentum_buffer"].shape


# ------------------------------------------------------------- the specs

def _spec(p):
    """A PartitionSpec (or the port's tuple) without its trailing Nones."""
    t = tuple(p)
    while t and t[-1] is None:
        t = t[:-1]
    return t


@pytest.mark.parametrize("model", ["vit", "resvit"])
def test_shard_specs_are_vitaxs(model):
    """The port's spec of every parameter path is vitax's
    (_vit_param_spec on its layer-stacked leaves, whose leading layer axis
    the port's per-layer dicts do not have; _resvit_param_spec)."""
    if model == "vit":
        cfg = jconf.ViTConfig(image_size=(32, 32), patch_size=(8, 8),
                              emb_dim=128, mlp_dim=256, num_heads=2,
                              num_layers=2, num_classes=10)
        jp = jax.eval_shape(lambda: jvit.init_params(jax.random.PRNGKey(0),
                                                     cfg))
        tp = tvit.init_params(torch.Generator().manual_seed(0),
                              tconf.ViTConfig(**{**W.VIT, "num_layers": 2}))
        spec, jspec = tmesh.vit_param_spec, jmesh._vit_param_spec
    else:
        kw = {k: v for k, v in W.RESVIT.items()
              if k not in ("dtype", "param_dtype")}
        jc = jconf.ResViTConfig(**kw)
        jp = jax.eval_shape(lambda: jr.init_params(jax.random.PRNGKey(0),
                                                   jc))
        tp = tr.init_params(torch.Generator().manual_seed(0),
                            tconf.ResViTConfig(**W.RESVIT))
        spec, jspec = tmesh.resvit_param_spec, jmesh._resvit_param_spec
    jpaths = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        jpaths[name] = _spec(jspec(jmesh._path_str(path)))
    n_sharded = 0
    for name, t in named_leaves(tp):
        parts = name.split("/")
        if model == "vit" and parts[0] == "layers":
            jname = "/".join(parts[:1] + parts[2:])
            want = jpaths[jname][1:] if jpaths[jname] else ()
        else:
            want = jpaths[name]
        got = _spec(spec("/" + name))
        assert got == want, name
        n_sharded += tmesh.MODEL_AXIS in got
    assert n_sharded == 10 * len(tp["layers"])  # 10 sharded leaves a layer


# ---------------------------------------------------------------- raises

@pytest.mark.parametrize("tier", ["--int8", "--int8-grad", "--int4",
                                  "--int4-attn"])
def test_tensor_parallel_int_tiers_match_vitax(tier, tp_world, preset,
                                               monkeypatch, tmp_path):
    """Tensor parallelism with a low-precision tier, per shard as vitax's:
    train_cli maps the flag to vitax's config; three SGD steps under (1, 2)
    in that config match vitax's under its (1, 2) mesh; and train_cli
    --n-gpu 2 --n-model 2 with the flag runs its epoch near one process's
    run of the flag (per-shard scales in place of whole-tensor ones)."""
    monkeypatch.setitem(jconf.ARCH_PRESETS, "tiny", W.PRESET)
    argv = W.cli_args(4, [tier])
    j_cfg = j_train.model_config_from_cli(j_cli.get_train_config(argv))
    over, _ = W.step_overrides(tier)
    assert over == {k: getattr(j_cfg, k) for k in W.TIER_FIELDS}
    _hold_steps(tier, tp_world, monkeypatch)
    one = t_train.main(W.cli_args(4, [
        "--train-steps", "5", "--warmup-steps", "2", "--lr", "0.05", "--wd",
        "0", "--exp-root", str(tmp_path), tier]), device="cpu")
    ref = np.asarray(one["epochs"][0]["train"]["losses"])
    band = 1.5e-1 if "int4" in tier else 2e-2
    for r, res in enumerate(tp_world):
        dist = np.abs(np.asarray(res["train_cli_tiers"][tier]["losses"])
                      - ref) / np.abs(ref)
        assert dist.max() <= band, f"{tier} rank {r}: {dist.max():.3e}"


@pytest.mark.parametrize("cli,flags", [
    ("train", ["--n-gpu", "2"]), ("train", ["--n-model", "2"]),
    ("eval", ["--n-gpu", "2"])])
def test_world_size_other_than_n_gpu_raises(cli, flags, preset, tmp_path):
    """One process asked for a mesh of 2: the CLIs say to launch one
    process per card with torchrun."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        if cli == "train":
            t_train.main(W.cli_args(4, [*flags, "--exp-root",
                                        str(tmp_path)]), device="cpu")
        else:
            t_eval.main(W.cli_args(4, flags), device="cpu")
