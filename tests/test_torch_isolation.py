"""The port stands alone: it imports neither JAX nor the JAX package
(directly or transitively), and its entry points never fall back to the
CPU when no card is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import stark_tpu_torch
from stark_tpu_torch import (
    chees_sample,
    prepare_model_data,
    sample,
    sample_until_converged,
    supervised_sample,
)
from stark_tpu_torch.models import (
    FusedHierLogisticGrouped,
    FusedLinearMixedModelGrouped,
    synth_lmm_data,
    synth_logistic_data,
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
        "stark_tpu_torch.backends.cuda_backend\n"
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
}


@pytest.mark.parametrize("family", list(_ENTRY_MODELS))
def test_entry_points_raise_without_a_card(monkeypatch, family):
    """No device argument means the card; with none present, raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, raw = _ENTRY_MODELS[family]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chees_sample(model, raw, chains=2, num_warmup=2, num_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample(model, raw, chains=2, num_warmup=2, num_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_model_data(model, raw)
    # explicit CPU is the one way to run here
    data = prepare_model_data(model, raw, device="cpu")
    assert data["xT"].device.type == "cpu"


@pytest.mark.parametrize("family", list(_ENTRY_MODELS))
def test_runner_entry_points_raise_without_a_card(monkeypatch, tmp_path, family):
    """The adaptive runner and the supervisor take the card by default
    too, and raise before they write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, raw = _ENTRY_MODELS[family]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_until_converged(model, raw, chains=2, num_warmup=2, max_blocks=1,
                               metrics_path=str(tmp_path / "m.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        supervised_sample(model, raw, workdir=str(tmp_path / "w"), chains=2, num_warmup=2,
                          max_blocks=1)
    assert list(tmp_path.iterdir()) == []


def test_unported_kernels_raise():
    raw, _ = synth_logistic_data(0, 300, 2, num_groups=3)
    with pytest.raises(NotImplementedError, match="A8"):
        sample(FusedHierLogisticGrouped(2, 3), raw, kernel="nuts", device="cpu")


def test_precision_stance_set_at_import():
    assert stark_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
