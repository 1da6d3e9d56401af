"""The port stands alone: it never imports JAX or the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import proteinbert_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "proteinbert_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "proteinbert_tpu", "flax", "optax", "orbax"}


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (an image may import jax at start-up, so the
    check is on what the port's imports ADD)."""
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(len(before), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def _forbidden_imports(path):
    """(line, module) of every absolute import of a FORBIDDEN package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    assert not _forbidden_imports(path), (path.name,
                                          _forbidden_imports(path))


def test_the_check_covers_data_and_train_and_catches_an_offender(tmp_path):
    mods = _port_modules()
    for m in ("data.dataset", "data.corruption", "data.transforms",
              "data.synthetic", "train.loss", "train.schedule",
              "train.train_state", "train.metrics", "train.trainer",
              "kernels.autograd", "utils.h5", "data.prefetch",
              "data.finetune_data", "models.finetune", "train.finetune",
              "heads", "heads.registry", "heads.apply", "heads.eval",
              "mapper", "mapper.store", "mapper.faults", "mapper.engine",
              "index", "index.store", "index.scorer"):
        assert f"proteinbert_tpu_torch.{m}" in mods
    bad = tmp_path / "offender.py"
    bad.write_text("import torch\nimport optax\n"
                   "from proteinbert_tpu.train import loss\n"
                   "def f():\n    import jax.numpy as jnp\n"
                   "    from flax import struct\n")
    assert [m for _, m in _forbidden_imports(bad)] == [
        "optax", "proteinbert_tpu.train", "jax.numpy", "flax"]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")


def test_device_none_means_cuda_and_raises_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        proteinbert_tpu_torch.resolve_device(None)
    assert proteinbert_tpu_torch.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        proteinbert_tpu_torch.resolve_device("meta")


def test_entry_points_without_device_raise():
    _no_cuda()
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.dispatch import BucketDispatcher
    from proteinbert_tpu_torch.serve.server import Server
    from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat

    cfg = get_preset("tiny")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError):
        init(cfg.model, gen)
    params = init(cfg.model, gen, device="cpu")
    with pytest.raises(RuntimeError):
        params_from_flat(params_to_flat(params), cfg.model)
    for fn in (inference.embed, inference.predict_go,
               inference.predict_residues):
        with pytest.raises(RuntimeError):
            fn(params, cfg, ["MKT"])
    with pytest.raises(RuntimeError):
        next(inference.embed_batches(params, cfg, ["MKT"]))
    with pytest.raises(RuntimeError):
        Server(params, cfg)
    with pytest.raises(RuntimeError):
        BucketDispatcher(params, cfg)
    # Asked for explicitly, the CPU path runs.
    out = inference.embed(params, cfg, ["MKT"], device="cpu")
    assert np.isfinite(out["global"]).all()


def test_finetune_entry_points_without_device_raise():
    _no_cuda()
    from proteinbert_tpu_torch.configs import FinetuneConfig, TaskConfig
    from proteinbert_tpu_torch.models import finetune as ft_model
    from proteinbert_tpu_torch.train import finetune as ft_train

    cfg = FinetuneConfig(task=TaskConfig(epochs=1))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError):
        ft_model.head_init(gen, cfg.model, cfg.task)
    with pytest.raises(RuntimeError):
        ft_train.create_finetune_state(gen, cfg)
    with pytest.raises(RuntimeError):
        ft_train.finetune(cfg, lambda epoch: iter(()))
    head = ft_model.head_init(gen, cfg.model, cfg.task, device="cpu")
    assert head["out"]["kernel"].device.type == "cpu"
