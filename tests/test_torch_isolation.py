"""The port stands alone: it imports neither JAX nor the JAX package
(directly or transitively), and its entry points never fall back to the
CPU when no card is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import stark_tpu_torch
from stark_tpu_torch import (
    chees_sample,
    consensus_sample,
    prepare_model_data,
    sample,
    sample_until_converged,
    sghmc_sample,
    supervised_sample,
    tempered_sample,
)
from stark_tpu_torch.models import (
    BayesianMLP,
    FusedHierLogisticGrouped,
    FusedLinearMixedModelGrouped,
    FusedLinearRegression,
    FusedLMM,
    FusedLogistic,
    FusedPoissonRegression,
    GaussianMixture,
    synth_bnn_data,
    synth_gmm_data,
    synth_linreg_data,
    synth_lmm_data,
    synth_logistic_data,
    synth_poisson_data,
)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "stark_tpu_torch"


def _forbidden(mod: str) -> bool:
    root = mod.split(".")[0]
    return root in ("jax", "jaxlib", "stark_tpu")


def test_import_leaves_jax_and_reference_out_of_sys_modules():
    code = (
        "import sys, stark_tpu_torch, stark_tpu_torch.interop, "
        "stark_tpu_torch.ops.hier_fused, stark_tpu_torch.ops.logistic_fused, "
        "stark_tpu_torch.models, stark_tpu_torch.models.lmm, stark_tpu_torch._build, "
        "stark_tpu_torch.runner, stark_tpu_torch.supervise, stark_tpu_torch.checkpoint, "
        "stark_tpu_torch.drawstore, stark_tpu_torch.backends, "
        "stark_tpu_torch.backends.cuda_backend, stark_tpu_torch.kernels, "
        "stark_tpu_torch.kernels.nuts, stark_tpu_torch.kernels.hmc, "
        "stark_tpu_torch.models.eight_schools, stark_tpu_torch.parallel, "
        "stark_tpu_torch.parallel.consensus, stark_tpu_torch.sghmc, "
        "stark_tpu_torch.kernels.sghmc, stark_tpu_torch.models.bnn, "
        "stark_tpu_torch.models.gmm, stark_tpu_torch.parallel.tempering, "
        "stark_tpu_torch.models.glm, stark_tpu_torch.ops.glm_fused, "
        "stark_tpu_torch.ops.lmm_fused, stark_tpu_torch.ops.precision\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stark_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_no_jax_or_reference_import_in_package_or_chip_smoke():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{p.relative_to(REPO)}:{line}: {mod}"
        for p in files
        for line, mod in _imports(p)
        if _forbidden(mod)
    ]
    assert bad == []


_ENTRY_MODELS = {
    "flagship": lambda: (FusedHierLogisticGrouped(2, 3),
                         synth_logistic_data(0, 300, 2, num_groups=3)[0]),
    "lmm": lambda: (FusedLinearMixedModelGrouped(2, 3), synth_lmm_data(0, 300, 2, 3)[0]),
    "consensus": lambda: (FusedLogistic(2), synth_logistic_data(0, 300, 2)[0]),
    "bnn": lambda: (BayesianMLP(2, hidden=3), synth_bnn_data(0, 300, 2)[0]),
    "gmm": lambda: (GaussianMixture(3), synth_gmm_data(0, 300, 3)[0]),
    "linreg": lambda: (FusedLinearRegression(2), synth_linreg_data(0, 300, 2)[0]),
    "poisson": lambda: (FusedPoissonRegression(2), synth_poisson_data(0, 300, 2)[0]),
    "fused_lmm": lambda: (FusedLMM(2, 3), synth_lmm_data(0, 300, 2, 3)[0]),
}


@pytest.mark.parametrize("family", list(_ENTRY_MODELS))
def test_entry_points_raise_without_a_card(monkeypatch, family):
    """No device argument means the card; with none present, raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, raw = _ENTRY_MODELS[family]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chees_sample(model, raw, chains=2, num_warmup=2, num_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample(model, raw, kernel="chees", chains=2, num_warmup=2, num_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_model_data(model, raw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        consensus_sample(model, raw, num_shards=2, chains=2, kernel="chees", num_warmup=2,
                         num_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sghmc_sample(model, raw, batch_size=10, chains=2, num_warmup=2, num_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tempered_sample(model, raw, chains=2, num_temps=2, num_warmup=2, num_samples=2)
    # explicit CPU is the one way to run here
    data = prepare_model_data(model, raw, device="cpu")
    assert all(v.device.type == "cpu" for v in data.values() if isinstance(v, torch.Tensor))


@pytest.mark.parametrize("family", list(_ENTRY_MODELS))
def test_runner_entry_points_raise_without_a_card(monkeypatch, tmp_path, family):
    """The adaptive runner and the supervisor take the card by default
    too, and raise before they write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, raw = _ENTRY_MODELS[family]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_until_converged(model, raw, kernel="chees", chains=2, num_warmup=2,
                               max_blocks=1, metrics_path=str(tmp_path / "m.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        supervised_sample(model, raw, workdir=str(tmp_path / "w"), kernel="chees", chains=2,
                          num_warmup=2, max_blocks=1)
    assert list(tmp_path.iterdir()) == []


def test_unported_kernels_raise(monkeypatch):
    """NUTS and HMC are ported; the JAX package's ragged NUTS is not."""
    raw, _ = synth_logistic_data(0, 300, 2, num_groups=3)
    monkeypatch.setenv("STARK_RAGGED_NUTS", "1")
    with pytest.raises(NotImplementedError, match="A8, ragged NUTS"):
        sample(FusedHierLogisticGrouped(2, 3), raw, kernel="nuts", device="cpu")


def test_precision_stance_set_at_import():
    assert stark_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_zoo_modules_leave_jax_and_reference_out_of_sys_modules():
    """The rest of the zoo's models and fused ops import neither JAX nor
    the JAX package."""
    code = (
        "import sys, stark_tpu_torch.models.irt, stark_tpu_torch.models.ordinal, "
        "stark_tpu_torch.models.robust, stark_tpu_torch.models.survival, "
        "stark_tpu_torch.models.timeseries, stark_tpu_torch.ops.irt_fused, "
        "stark_tpu_torch.ops.ordinal_fused, stark_tpu_torch.ops.robust_fused\n"
        "from stark_tpu_torch.models import (CoxPH, FusedIRT2PL, FusedOrderedLogistic, "
        "FusedStudentTRegression, HorseshoeRegression, IRT2PL, NegBinomialRegression, "
        "OrderedLogistic, StochasticVolatility, StudentTRegression, synth_horseshoe_data, "
        "synth_irt_data, synth_negbinom_data, synth_ordinal_data, synth_studentt_data, "
        "synth_survival_data, synth_sv_data)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stark_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("xdt", ["bf16", "int8", "fp8e4m3", "fp8e5m2"])
def test_narrow_x_leaves_jax_reference_and_ml_dtypes_out_of_sys_modules(xdt):
    """Packing X, preparing a model's data under a narrow
    STARK_FUSED_X_DTYPE and a fused call on it, in a fresh interpreter,
    import neither JAX, nor the JAX package, nor ml_dtypes (which the
    card's machine does not have)."""
    code = (
        "import sys, numpy as np, torch\n"
        "from stark_tpu_torch.ops import quantize\n"
        "from stark_tpu_torch.model import flatten_model, prepare_model_data\n"
        "from stark_tpu_torch.models import FusedHierLogisticGrouped, FusedPoissonRegression, "
        "synth_logistic_data, synth_poisson_data\n"
        "x = np.random.default_rng(0).standard_normal((200, 4)).astype(np.float32)\n"
        "quantize.pack_slab(x.T, torch.int8, pct=99.0)\n"
        "quantize.fake_quant(x, 'fp8e4m3')\n"
        "for m, raw in ((FusedHierLogisticGrouped(4, 6), synth_logistic_data(0, 500, 4, "
        "num_groups=6)[0]), (FusedPoissonRegression(4), synth_poisson_data(0, 500, 4)[0])):\n"
        "    d = prepare_model_data(m, raw, device='cpu')\n"
        "    fm = flatten_model(m)\n"
        "    fm.potential_and_grad(torch.zeros(2, fm.ndim), d)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stark_tpu', 'ml_dtypes'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["STARK_FUSED_X_DTYPE"] = xdt
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _zoo_entry(family):
    from stark_tpu_torch import models as m

    return {
        "irt": lambda: (m.FusedIRT2PL(20, 5), m.synth_irt_data(0, 20, 5)[0],
                        "STARK_FUSED_IRT"),
        "ordinal": lambda: (m.FusedOrderedLogistic(2, 3),
                            m.synth_ordinal_data(0, 300, 2, num_categories=3)[0],
                            "STARK_FUSED_ORDINAL"),
        "robust": lambda: (m.FusedStudentTRegression(2), m.synth_studentt_data(0, 300, 2)[0],
                           "STARK_FUSED_ROBUST"),
        "negbinom": lambda: (m.NegBinomialRegression(2), m.synth_negbinom_data(0, 300, 2)[0],
                             None),
        "horseshoe": lambda: (m.HorseshoeRegression(6), m.synth_horseshoe_data(0, 300, 6)[0],
                              None),
        "coxph": lambda: (m.CoxPH(2), m.synth_survival_data(0, 300, 2)[0], None),
        "sv": lambda: (m.StochasticVolatility(64), m.synth_sv_data(0, 64)[0], None),
    }[family]()


@pytest.mark.parametrize("family", ["irt", "ordinal", "robust", "negbinom", "horseshoe",
                                    "coxph", "sv"])
def test_zoo_models_default_to_the_card(monkeypatch, family):
    """Each of the rest of the zoo's models is built at its default
    device, the card: with none present, preparing its data and sampling
    raise; the CPU is taken only when asked for."""
    model, raw, knob = _zoo_entry(family)
    if knob:
        monkeypatch.setenv(knob, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_model_data(model, raw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample(model, raw, chains=2, num_warmup=2, num_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tempered_sample(model, raw, chains=2, num_temps=2, num_warmup=2, num_samples=2)
    data = prepare_model_data(model, raw, device="cpu")
    assert all(v.device.type == "cpu" for v in data.values())
    post = sample(model, raw, chains=2, num_warmup=3, num_samples=3, max_tree_depth=3,
                  device="cpu")
    assert np.all(np.isfinite(post.draws_flat))


def test_adaptation_reuse_and_the_pipeline_stand_alone(monkeypatch, tmp_path):
    """The runner's adaptation-reuse exports are the package's, its
    worker thread is plain threading, and with adaptation reuse and the
    pipelined loop asked for, no card still means a raise before any
    file is written (the fingerprint reads the caller's data only)."""
    from stark_tpu_torch import runner

    assert stark_tpu_torch.data_fingerprint is runner.data_fingerprint
    assert stark_tpu_torch.load_adapt_state is runner.load_adapt_state
    assert {"data_fingerprint", "load_adapt_state"} <= set(stark_tpu_torch.__all__)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, raw = _ENTRY_MODELS["flagship"]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_until_converged(model, raw, kernel="chees", chains=2, num_warmup=2,
                               max_blocks=1, sync_blocks=False,
                               adapt_path=str(tmp_path / "a.npz"),
                               metrics_path=str(tmp_path / "m.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        supervised_sample(model, raw, workdir=str(tmp_path / "w"), kernel="chees", chains=2,
                          num_warmup=2, max_blocks=1, adapt_path=str(tmp_path / "a.npz"),
                          adapt_touchup_frac=0.5)
    assert list(tmp_path.iterdir()) == []
