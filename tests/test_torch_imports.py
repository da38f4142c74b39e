"""The port stands alone: dynamo_tpu_torch and chip_smoke.py import nothing
of JAX, nothing of the JAX package, and none of the JAX package's runtime
dependencies the card's machine lacks (among them `safetensors`,
`tokenizers`, `jinja2`, `ml_dtypes` and `regex`, which the checkpoint,
tokenizer and chat-template modules replace). Its entry points default to
the card and raise where there is none."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dynamo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu", "msgpack", "aiohttp", "xxhash",
             "zmq", "prometheus_client", "jinja2", "safetensors",
             "tokenizers", "ml_dtypes", "regex")


# Modules of the quantized-serving slice, which must be among the checked
# sources and import cleanly on their own.
QUANTIZED_MODULES = ("dynamo_tpu_torch.ops.q8_linear",
                     "dynamo_tpu_torch.ops.q4_linear",
                     "dynamo_tpu_torch.models.quantize",
                     "dynamo_tpu_torch.models.convert")


# Modules of the serving edge: each must be among the checked sources and
# import cleanly on its own.
SERVING_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "runtime.msgpack", "runtime.codec", "runtime.config",
    "runtime.discovery", "runtime.request_plane", "runtime.component",
    "runtime.push_router", "runtime.metrics", "runtime.distributed",
    "runtime.http", "runtime.status", "runtime.signals", "llm.model_card",
    "llm.tokenizer", "llm.validate", "llm.preprocessor", "llm.engine",
    "llm.manager", "llm.http_service", "frontend.service", "engine.worker"))


# Modules of the KV-aware routing slice: each must be among the checked
# sources and import cleanly on its own.
KV_ROUTING_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "kv_router", "kv_router.protocols", "kv_router.tinylfu",
    "kv_router.indexer", "kv_router.local_indexer", "kv_router.sequences",
    "kv_router.scheduler", "kv_router.queue", "runtime.events",
    "runtime.zmtp"))


# Modules of the logits-processor slice: each must be among the checked
# sources and import cleanly on its own.
LOGITS_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "llm.logits_processing", "llm.guided", "parsers", "parsers.tool_calls",
    "parsers.reasoning"))


# Modules of the resilience and admission slice: each must be among the
# checked sources and import cleanly on its own.
RESILIENCE_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "runtime.resilience", "runtime.admission", "runtime.health_check"))


# Modules of the checkpoint slice (and the sampler's noise): each must be
# among the checked sources and import cleanly on its own.
CHECKPOINT_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "models.safetensors", "models.checkpoint", "llm.hf_tokenizer",
    "llm.chat_template", "ops.gumbel"))


# Modules of the disaggregation and drain slice: each must be among the
# checked sources and import cleanly on its own.
DISAGG_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "ops.block_copy", "llm.kv_transfer", "llm.prefill_router",
    "engine.drain"))


# Modules of the co-located disaggregation and observability slice: each
# must be among the checked sources and import cleanly on its own.
OBSERVABILITY_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "engine.ici_transfer", "perf", "perf.steptrace", "profiler",
    "profiler.chips", "profiler.timing_model", "runtime.flight_recorder"))


# Modules of the KVBM tiers slice: each must be among the checked sources
# and import cleanly on its own.
KVBM_MODULES = tuple(f"dynamo_tpu_torch.{m}" for m in (
    "block_manager", "block_manager.state", "block_manager.layout",
    "block_manager.pool", "block_manager.storage", "block_manager.offload",
    "block_manager.manager"))


# Modules of the MoE slice: each must be among the checked sources and
# import cleanly on its own.
MOE_MODULES = ("dynamo_tpu_torch.models.moe",
               "dynamo_tpu_torch.models.transformer")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "scripts" /
                                          "torch_decode_profile.py",
                                          ROOT / "scripts" /
                                          "torch_kvbm_phases.py"]
    assert len(files) > 10
    return files


def test_sources_cover_the_quantized_modules():
    files = set(_sources())
    for module in QUANTIZED_MODULES:
        assert ROOT / (module.replace(".", "/") + ".py") in files


def test_sources_cover_the_serving_modules():
    files = set(_sources())
    for module in SERVING_MODULES:
        assert ROOT / (module.replace(".", "/") + ".py") in files
    for package in ("frontend", "worker"):
        assert PORT / package / "__main__.py" in files


def test_sources_cover_the_kv_routing_modules():
    files = set(_sources())
    for module in KV_ROUTING_MODULES:
        path = ROOT / module.replace(".", "/")
        assert (path.with_suffix(".py") in files
                or path / "__init__.py" in files), module


def test_sources_cover_the_checkpoint_modules():
    files = set(_sources())
    for module in CHECKPOINT_MODULES:
        assert ROOT / (module.replace(".", "/") + ".py") in files
    assert PORT / "ops" / "gumbel_triton.py" in files


def test_sources_cover_the_resilience_modules():
    files = set(_sources())
    for module in RESILIENCE_MODULES:
        assert ROOT / (module.replace(".", "/") + ".py") in files


def test_sources_cover_the_disagg_modules():
    files = set(_sources())
    for module in DISAGG_MODULES:
        assert ROOT / (module.replace(".", "/") + ".py") in files


def test_sources_cover_the_observability_modules():
    files = set(_sources())
    for module in OBSERVABILITY_MODULES:
        path = ROOT / module.replace(".", "/")
        assert (path.with_suffix(".py") in files
                or path / "__init__.py" in files), module


def test_sources_cover_the_kvbm_modules():
    files = set(_sources())
    for module in KVBM_MODULES:
        path = ROOT / module.replace(".", "/")
        assert (path.with_suffix(".py") in files
                or path / "__init__.py" in files), module


def test_sources_cover_the_moe_modules():
    files = set(_sources())
    for module in MOE_MODULES:
        assert ROOT / (module.replace(".", "/") + ".py") in files


def test_sources_cover_the_logits_modules():
    files = set(_sources())
    for module in LOGITS_MODULES:
        path = ROOT / module.replace(".", "/")
        assert (path.with_suffix(".py") in files
                or path / "__init__.py" in files), module


@pytest.mark.parametrize("module", SERVING_MODULES + KV_ROUTING_MODULES
                         + LOGITS_MODULES + CHECKPOINT_MODULES
                         + RESILIENCE_MODULES + DISAGG_MODULES
                         + OBSERVABILITY_MODULES + KVBM_MODULES
                         + MOE_MODULES)
def test_serving_module_imports_on_its_own(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_import_leaves_jax_out():
    code = ("import sys, dynamo_tpu_torch.engine, dynamo_tpu_torch.ops, "
            + ", ".join(QUANTIZED_MODULES) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_the_card():
    """No card here: every entry point asked for the default device raises
    before it builds anything, and never falls back to the CPU."""
    import torch

    from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig, TorchWorker
    from dynamo_tpu_torch.models import get_config, init_params

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchWorker()
    with pytest.raises(RuntimeError, match="cuda"):
        ModelRunner(get_config("tiny-test"), RunnerConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(get_config("tiny-test"))


def test_worker_cli_defaults_to_the_card(run, tmp_path, monkeypatch):
    """`python -m dynamo_tpu_torch.worker` without --device asks for the card
    and raises here before it starts a runtime or builds a model."""
    from dynamo_tpu_torch.engine.worker import build_arg_parser, main

    monkeypatch.setenv("DYNT_DISCOVERY_PATH", str(tmp_path))
    assert build_arg_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run(main(["--model", "tiny-test"]))
    assert not any(tmp_path.iterdir())  # no discovery tree was written


def test_frontend_cli_runs_without_the_card():
    """The frontend holds no model: its CLI takes no device, and it takes
    the reference's router modes (and refuses any other)."""
    from dynamo_tpu_torch.frontend.service import build_arg_parser

    args = build_arg_parser().parse_args([])
    assert not hasattr(args, "device") and args.router_mode == "round_robin"
    for mode in ("round_robin", "random", "kv", "p2c"):
        assert build_arg_parser().parse_args(
            ["--router-mode", mode]).router_mode == mode
    with pytest.raises(SystemExit):
        build_arg_parser().parse_args(["--router-mode", "least_loaded"])


def test_kernels_build_for_sm90a(monkeypatch):
    from dynamo_tpu_torch.ops import _build

    assert _build.sources() == ["paged_decode_pool", "q4_matmul", "q8_matmul"]
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    for name in _build.sources():
        out = _build.library_path(name)
        cmd = _build.nvcc_command(name, out)
        assert cmd[0] == "nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
        assert "-shared" in cmd and str(out) in cmd
        # the build lands under the checkout's build/, which git ignores
        assert out.parent == ROOT / "build" / "dynamo_tpu_torch"


def test_build_key_covers_the_shared_header(monkeypatch, tmp_path):
    """Editing csrc/dequant_gemm.cuh must rebuild the GEMM libraries."""
    from dynamo_tpu_torch.ops import _build

    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("q4_matmul")
    header = tmp_path / "dequant_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("q4_matmul") != before
