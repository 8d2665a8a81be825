"""vitax_torch.eval_cli against vitax.eval_cli: flags and metrics.

Both CLIs evaluate the same vitax-written npz on the same Synthetic split.
The batch size is a multiple of 8 because vitax's eval shards the batch over
the 8 fake CPU devices of conftest.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from vitax import cli as jcli  # noqa: E402
from vitax import eval_cli as j_eval  # noqa: E402
from vitax.checkpointing.npz import save_npz_params  # noqa: E402
from vitax.core.config import arch_config  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax_torch import cli as tcli  # noqa: E402
from vitax_torch import eval_cli as t_eval  # noqa: E402

ARGVS = [
    [],
    ["--dataset", "Synthetic", "--model-arch", "b16", "--image-size", "224",
     "--batch-size", "64", "--num-classes", "10", "--synthetic-samples",
     "256"],
    ["--no-pallas", "--no-fused-qkv", "--fused-mlp", "--dtype", "float32",
     "--n-gpu", "1", "--checkpoint-path", "w.npz", "--seed", "3"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_eval_namespace_equals_vitax(argv):
    assert vars(tcli.get_eval_config(argv)) == vars(jcli.get_eval_config(argv))


@pytest.fixture
def npz_path(tmp_path, monkeypatch):
    monkeypatch.setenv("VITAX_NO_CACHE", "1")
    cfg = arch_config("tiny", image_size=32, num_classes=10)
    params = jvit.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape), params)
    path = str(tmp_path / "w.npz")
    save_npz_params(path, params)
    return path


def test_both_eval_clis_agree_on_an_npz(npz_path):
    argv = ["--dataset", "Synthetic", "--model-arch", "tiny",
            "--image-size", "32", "--batch-size", "8",
            "--synthetic-samples", "20", "--num-workers", "0",
            "--dtype", "float32", "--checkpoint-path", npz_path]
    ref = j_eval.main(argv)
    out = t_eval.main(argv)
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-4,
                               atol=1e-4)
    assert out["acc1"] == pytest.approx(ref["acc1"], abs=1e-6)
    assert out["acc5"] == pytest.approx(ref["acc5"], abs=1e-6)


@pytest.mark.parametrize("extra", [["--int8"], ["--n-gpu", "2"],
                                   ["--checkpoint-path", "w.pth"]])
def test_unported_options_raise(extra):
    argv = ["--dataset", "Synthetic", "--model-arch", "tiny",
            "--image-size", "32", "--batch-size", "8",
            "--synthetic-samples", "8"] + extra
    with pytest.raises(NotImplementedError):
        t_eval.main(argv)
