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
from repro_torch.launch import train as launch_train
from repro_torch.models.model import EncDecModel, Model, build_model
from repro_torch.serving.engine import DecodeCore, OffloadEngine
from repro_torch.serving.scheduler import BatchedOffloadEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
ENTRY_POINTS = [Model.init, Model.init_decode_state, EncDecModel.init,
                EncDecModel.init_decode_state,
                BatchedOffloadEngine.__init__,
                OffloadEngine.__init__, DecodeCore.__init__, predictor_init,
                train_predictor, convert.backbone_from_jax,
                convert.predictor_from_jax,
                convert.predictor_from_jax_checkpoint, resolve_device,
                launch_train.train]


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "examples", f"{n}_torch.py")
        for n in ("pipeline", "serve_batched", "collect_traces",
                  "train_predictor", "train_backbone", "serve_with_cache")] + [
        os.path.join(REPO, "tools", n)
        for n in ("kernel_phase2.py", "profile_mamba_torch.py",
                  "gloo_collectives_probe.py", "mesh_memory_probe.py")]
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
    seamless = build_model(get_reduced("seamless-m4t-large-v2"))
    with pytest.raises(RuntimeError, match="CUDA"):
        seamless.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        seamless.init_decode_state(1, 8)
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
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "deepseek-v2-lite", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.predictor_from_jax_checkpoint("unread.npz")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("module", ["repro_torch.serving.workload",
                                    "repro_torch.serving.prefixcache",
                                    "repro_torch.serving.scheduler",
                                    "repro_torch.serving.expertstore",
                                    "repro_torch.launch.roofline",
                                    "repro_torch.configs.deepseek_v2_236b",
                                    "repro_torch.configs.yi_6b",
                                    "repro_torch.configs.internlm2_1_8b",
                                    "repro_torch.configs.phi3_mini_3_8b",
                                    "repro_torch.configs.gemma3_27b",
                                    "repro_torch.configs.pixtral_12b",
                                    "repro_torch.configs.recurrentgemma_9b",
                                    "repro_torch.configs."
                                    "seamless_m4t_large_v2",
                                    "repro_torch.models.rglru",
                                    "repro_torch.models.encdec",
                                    "repro_torch.training.checkpoint",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.sharding",
                                    "repro_torch.launch.train",
                                    "repro_torch.analysis.retrace_guard",
                                    "repro_torch.analysis.sanitize"])
def test_serving_modules_import_with_jax_and_reference_blocked(module):
    """The prefix index, the workload generator, the tiered expert store,
    the roofline terms, the scheduler that drives them and the configs
    copied from the reference import in a process where ``jax`` and
    ``repro`` cannot be imported at all."""
    import subprocess
    import sys
    path = os.path.join(PORT, *module.split(".")[1:]) + ".py"
    assert os.path.isfile(path)
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"import {module}\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("dispatch", ["ship", "auto"])
def test_dispatch_needs_a_roofline(dispatch):
    """Compute dispatch prices a ship with the computing device's peak
    rate and memory bandwidth: no TPU default stands in for them."""
    from repro_torch.serving.expertstore import TierConfig
    model = build_model(get_reduced("deepseek-v2-lite"))
    params = model.init(device="cpu")
    tiers = TierConfig(num_shards=2, dispatch=dispatch)
    with pytest.raises(TypeError, match="roofline"):
        DecodeCore(model, params, 48, host_bw=100e9, tiers=tiers,
                   device="cpu")
    with pytest.raises(TypeError, match="roofline"):
        OffloadEngine(model, params, None, 48, host_bw=100e9, tiers=tiers,
                      device="cpu")
    core = DecodeCore(model, params, 48, host_bw=100e9, tiers=tiers,
                      roofline=(989e12, 3.35e12), device="cpu")
    assert core.planner is not None and core.planner.mode == dispatch
    fetch = DecodeCore(model, params, 48, host_bw=100e9,
                       tiers=TierConfig(num_shards=2), device="cpu")
    assert fetch.planner is None and fetch.slots.ship_slots == 0


@pytest.mark.parametrize("clock", ["roofline", "measured"])
def test_clock_needs_a_roofline(clock):
    """The string compute clocks price each layer with the device's peak
    rate and memory bandwidth: no TPU default stands in for them, and an
    unknown clock is refused."""
    from repro_torch.serving.config import ServeConfig
    model = build_model(get_reduced("deepseek-v2-lite"))
    params = model.init(device="cpu")
    for make in (
            lambda **kw: DecodeCore(model, params, 48, host_bw=100e9,
                                    layer_compute_s=clock, device="cpu",
                                    **kw),
            lambda **kw: OffloadEngine(model, params, None, 48,
                                       host_bw=100e9, layer_compute_s=clock,
                                       device="cpu", **kw),
            lambda **kw: BatchedOffloadEngine(
                model, params, None, 48, host_bw=100e9, device="cpu",
                serve=ServeConfig(layer_compute_s=clock), **kw)):
        with pytest.raises(TypeError, match="roofline"):
            make()
        core = make(roofline=(989e12, 3.35e12))
        core = getattr(core, "core", core)
        assert len(core._layer_s) == model.cfg.num_layers
        assert core._measure == (clock == "measured")
    with pytest.raises(ValueError, match="'roofline' or 'measured'"):
        DecodeCore(model, params, 48, host_bw=100e9,
                   layer_compute_s=clock[:4], roofline=(989e12, 3.35e12),
                   device="cpu")
