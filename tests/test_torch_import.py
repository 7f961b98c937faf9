"""The port stands alone: no jax and nothing of ``repro`` inside it, and its
entry points never fall back to the CPU on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import resolve_device

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n == 'repro'\n"
        "             or n.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# every module of the serving, training, sparse-embedding, MoE, rwkv6 and
# async-DP / elastic / data slices, so the walks below cannot go vacuous
SLICE_MODULES = (
    "cache_layout.py", "convert.py", "kernels/_build.py",
    "kernels/decode_attention.py", "kernels/flash_attention.py",
    "kernels/ops.py", "kernels/ref.py", "models/attention.py",
    "models/kvquant.py", "models/transformer.py", "serving/block_pool.py",
    "serving/engine.py", "serving/roofline.py", "launch/serve.py",
    "config.py", "tree.py", "optimizer/adamw.py", "optimizer/schedule.py",
    "models/layers.py", "embeddings/table.py", "embeddings/lookup.py",
    "recsys/model.py", "recsys/dataset.py", "recsys/metrics.py",
    "kernels/grad_compress.py", "kernels/topk_sparsify.py",
    "core/hierarchical.py", "core/compression.py", "runtime/trainer.py",
    "launch/train_recsys.py", "kernels/embedding_ops.py",
    "kernels/fused_adamw.py", "embeddings/update.py",
    "embeddings/__init__.py", "kernels/moe_router.py", "models/moe.py",
    "configs/moonshot_v1_16b_a3b.py", "configs/qwen3_moe_30b_a3b.py",
    "kernels/wkv6.py", "models/ssm.py", "configs/rwkv6_1_6b.py",
    "core/async_dp.py", "runtime/straggler.py", "runtime/elastic.py",
    "data/pipeline.py", "data/tokenizer.py",
    "core/sharding.py", "core/hybrid.py", "launch/train.py",
)


def test_walk_covers_the_slice_modules():
    walked = {str(p.relative_to(ROOT / "src" / "repro_torch"))
              for p in PORT_FILES if p.name != "chip_smoke.py"}
    assert set(SLICE_MODULES) <= walked, set(SLICE_MODULES) - walked


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from repro_torch import convert
    from repro_torch.config import get_arch, reduced
    from repro_torch.serving import engine
    cfg = reduced(get_arch("recllm-base"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.init_params(cfg, torch.Generator())
    params = convert.init_params(cfg, torch.Generator(), device="cpu")
    for build in (lambda: engine.make_backend(cfg, params),
                  lambda: engine.NativeBackend(cfg, params),
                  lambda: engine.serve(cfg, params, [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_training_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.config import get_arch, reduced
    from repro_torch.launch import train_recsys
    from repro_torch.recsys import model
    cfg = reduced(get_arch("recllm-base"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_recllm(cfg, 40, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_recsys.main(["--steps", "1"])
