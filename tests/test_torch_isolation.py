"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and it never drops to the CPU on its own."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    import repro_torch

    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    for m in ("repro_torch.core.serving", "repro_torch.core.federation",
              "repro_torch.kernels.blendavg.ops",
              "repro_torch.kernels.slstm_cell.ops",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.mlstm_scan.ops",
              "repro_torch.models.recurrent", "repro_torch.models.backbone",
              "repro_torch.configs.xlstm_350m", "repro_torch.launch.serve_lm",
              "repro_torch.checkpoint.store", "repro_torch.core.state",
              "repro_torch.core.schedule", "repro_torch.core.engine",
              "repro_torch.core.federation_sharded",
              "repro_torch.data.pipeline", "repro_torch.data.scenario",
              "repro_torch.data.store", "repro_torch.launch.train_federated",
              "repro_torch.core.baselines", "repro_torch.launch.serve"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py",
                                       ROOT / "tools" / "torch_wire_flips.py",
                                       ROOT / "tools" / "torch_flash_ablation.py",
                                       ROOT / "tools" / "torch_slstm_ablation.py",
                                       ROOT / "tools" / "torch_mlstm_ablation.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_entry_points_need_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from repro_torch import resolve_device
    from repro_torch.core.encoders import EncoderConfig, init_client_models
    from repro_torch.core.inference import InferenceRequest, predict
    from repro_torch.core.serving import ServingEngine
    from repro_torch.data.synthetic import make_task
    from repro_torch.launch import serve_federated

    spec = make_task("smnist")
    ecfg = EncoderConfig(d_hidden=8, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_client_models(torch.Generator(), spec, ecfg)
    models = init_client_models(torch.Generator(), spec, ecfg, device="cpu")
    x = np.zeros((2, spec.seq_a, spec.feat_a), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        predict(models, InferenceRequest(x, None), ecfg, spec.kind)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(models, ecfg, spec.kind)
    with pytest.raises(RuntimeError, match="CUDA"):  # the driver's default
        serve_federated.main(["--selftest"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_federated.main(["--selftest", "--train-rounds", "0"])
    from repro_torch.core.federation import FedConfig, Federation
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import train_val_test

    tr, va, _ = train_val_test(spec, 40, 20, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Federation.init(torch.Generator(), FedConfig(rounds=1), spec, ecfg,
                        partition(tr, 3), va)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import backbone

    cfg = get_config("xlstm_350m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        backbone.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        backbone.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):  # the LM driver's default
        serve_lm.main(["--batch", "1", "--prompt-len", "2", "--gen", "1"])
    from repro_torch.core.federation_sharded import ShardedFedSpec, init_round_state
    from repro_torch.launch import train_federated

    small = ["--clients", "3", "--n-train", "60", "--rows-cap", "4",
             "--d-hidden", "8", "--n-val", "8", "--rounds", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):  # the training CLI's default
        train_federated.main(small)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_federated.main(small + ["--selftest-resume", "--rounds", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_round_state(torch.Generator(), ShardedFedSpec(n_clients=2, d_hidden=4))
    args = train_federated.parse_args(small + ["--device", "cpu"])
    _, batcher, _, _ = train_federated.build_federation(args)
    batcher.device = None  # the batcher's own default
    with pytest.raises(RuntimeError, match="CUDA"):
        batcher.put(batcher.build(0))
    from repro_torch.core import baselines

    eye = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):  # FedMA's matcher
        baselines._greedy_match(eye, eye)
    for name, run in baselines.BASELINES.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            run(torch.Generator(), spec, ecfg, partition(tr, 3), va, va,
                FedConfig(rounds=1))
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_launcher_raises_on_cpu_tensor():
    """No silent fallback: the CUDA launcher raises on a CPU tensor
    before it builds or launches anything."""
    from repro_torch.kernels.wire_codec import wire_codec

    before = wire_codec.launches
    with pytest.raises(ValueError, match="CUDA"):
        wire_codec.wire_codec_cuda(torch.ones(2, 4), torch.ones(2, 2),
                                   quantize=False)
    assert wire_codec.launches == before


def test_missing_nvcc_raises(monkeypatch):
    """The kernels are built from source or not at all: with no nvcc to
    be found, the build raises instead of falling back."""
    from repro_torch.kernels import _build

    assert [p.name for p in _build.sources()] == [
        "blendavg.cu", "flash_attention.cu", "mlstm_scan.cu", "slstm_cell.cu",
        "wire_codec.cu"]
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def _fake_nvcc(tmp_path, body):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_runs_nvcc_once_per_source_version(tmp_path, monkeypatch):
    """One nvcc per source, named by the source's hash: a built source is
    reused, an edited one is rebuilt, a failing compile raises with the
    compiler's output."""
    from repro_torch.kernels import _build

    log = tmp_path / "calls"
    home = _fake_nvcc(tmp_path, (
        f'echo "$@" >> {log}\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo lib > "$out"\n'))
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "sources", lambda: [src])

    (first,) = _build.build_all()
    assert first.exists() and first.name.startswith("k-")
    assert "arch=compute_90a,code=sm_90a" in log.read_text()
    assert "--use_fast_math" not in log.read_text()
    assert _build.build_all() == [first]  # reused, not rebuilt
    assert len(log.read_text().splitlines()) == 1
    src.write_text("// v2\n")
    (second,) = _build.build_all()
    assert second != first and second.exists()
    assert len(log.read_text().splitlines()) == 2
    assert not list((tmp_path / "build").glob("*.tmp"))

    bad = _fake_nvcc(tmp_path / "bad", "echo 'error: boom' >&2\nexit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(bad))
    src.write_text("// v3\n")
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_all()
