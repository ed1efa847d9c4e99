"""Rules of the port: isolation from JAX and explicit devices.

viai_tpu_torch (and chip_smoke.py, which drives it on the card) imports
torch and numpy, never jax, flax or any module of viai_tpu; its entry
points run on the card unless the caller asks for the CPU, and raise
when there is no card rather than fall back quietly.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "chex", "optax", "orbax", "clu",
             "tensorboard", "tensorflow", "viai_tpu")

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import viai_tpu_torch
names = [m.name for m in pkgutil.walk_packages(viai_tpu_torch.__path__,
                                               "viai_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              sys.argv[1] + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
print(json.dumps({"modules": names, "forbidden": bad}))
""" % (FORBIDDEN,)


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "viai_tpu_torch.signal.gl_cuda" in res["modules"]
    assert "viai_tpu_torch.serving" in res["modules"]
    for mod in ("train.step", "model", "cli.train", "cli.test",
                "nn.refiner", "train.diffusion", "train.preprocess",
                "utils.metrics", "cli.train_refiner", "native",
                "data.audio", "data.av", "data.avi", "data.loader",
                "data.prefetch", "utils.tensorboard", "utils.compile_cache",
                "utils.cost", "scripts._quality", "scripts.quality_report",
                "scripts.av_ablation", "scripts.quality_long",
                "scripts.grid_diag", "scripts.bayes_ceiling",
                "scripts.cost_analysis", "scripts.prepare_dataset"):
        assert f"viai_tpu_torch.{mod}" in res["modules"]
    assert res["forbidden"] == []


def test_no_forbidden_import_statements():
    files = sorted((ROOT / "viai_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from viai_tpu_torch import InpaintService, TrainConfig, define_G

    with pytest.raises(RuntimeError, match="device='cpu'"):
        define_G(ngf=8)
    G = define_G(ngf=8, device="cpu")
    assert next(G.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InpaintService(G, TrainConfig())


def test_training_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from viai_tpu_torch.cli.train import main
    from viai_tpu_torch.config import TrainOptions
    from viai_tpu_torch.model import VIAIModel
    from viai_tpu_torch.nn import define_D

    with pytest.raises(RuntimeError, match="device='cpu'"):
        define_D(3, 8, 2)
    assert next(define_D(3, 8, 2, device="cpu").parameters()).device.type \
        == "cpu"
    args = ["--ngf", "8", "--ndf", "8", "--checkpoints_dir", str(tmp_path),
            "--niter", "1", "--niter_decay", "0", "--steps_per_epoch", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VIAIModel(TrainOptions().parse(args, save=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


@pytest.mark.parametrize("script,argv", [
    ("quality_report", []), ("av_ablation", []), ("quality_long", []),
    ("grid_diag", ["name", "ckpt", "latest"]), ("bayes_ceiling", []),
    ("cost_analysis", []),
])
def test_scripts_default_to_the_card(script, argv):
    """Each script's --device is the card; without one it raises before
    any work rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import importlib

    mod = importlib.import_module(f"viai_tpu_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
