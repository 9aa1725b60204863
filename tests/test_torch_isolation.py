"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and not the port's tools import JAX or the reference
package, and the entry
points default to the card and refuse to run without one."""
import ast
import inspect
import os

import pytest
import torch

from repro_torch import convert
from repro_torch.core.predictor import predictor_init
from repro_torch.core.predictor_train import train_predictor
from repro_torch.configs import get_reduced
from repro_torch.configs.base import PredictorConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.serving.engine import DecodeCore, OffloadEngine
from repro_torch.serving.scheduler import BatchedOffloadEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
ENTRY_POINTS = [Model.init, Model.init_decode_state,
                BatchedOffloadEngine.__init__,
                OffloadEngine.__init__, DecodeCore.__init__, predictor_init,
                train_predictor, convert.backbone_from_jax,
                convert.predictor_from_jax, resolve_device]


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "examples", "pipeline_torch.py"),
             os.path.join(REPO, "examples", "serve_batched_torch.py")] + [
        os.path.join(REPO, "tools", n)
        for n in ("kernel_phase2.py", "profile_mamba_torch.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("deepseek-v2-lite")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    mamba = build_model(get_reduced("mamba2-130m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        mamba.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        mamba.init_decode_state(1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        predictor_init(torch.Generator().manual_seed(0), PredictorConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_predictor([], [], PredictorConfig())
    params = model.init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedOffloadEngine(model, params, None, 48, host_bw=100e9)
    with pytest.raises(RuntimeError, match="CUDA"):
        OffloadEngine(model, params, None, 48, host_bw=100e9)
    assert resolve_device("cpu").type == "cpu"
