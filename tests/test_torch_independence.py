"""paddle_tpu_torch stands alone: it imports neither jax, paddle_tpu nor
the repository's tools/, and its entry points run on the card unless the
caller asks for the CPU.

`paddle_tpu_torch` starts with `paddle_tpu`, so the checks match the exact
name or the `paddle_tpu.` prefix, never a bare prefix."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "tools")


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matcher_does_not_catch_the_port():
    assert _forbidden("paddle_tpu") and _forbidden("paddle_tpu.ops.pallas")
    assert _forbidden("jax.numpy") and _forbidden("tools.fused_block_pallas")
    assert not _forbidden("paddle_tpu_torch") and not _forbidden("paddle_tpu_torch.io")
    assert not _forbidden("toolsmith")


def test_import_loads_neither_jax_nor_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.inference.server\n"
        "import paddle_tpu_torch.models.bert, paddle_tpu_torch.ops.fused_ops\n"
        "import paddle_tpu_torch.optimizer, paddle_tpu_torch.backward\n"
        "import paddle_tpu_torch.ops.prng, paddle_tpu_torch.ops.optimizer_ops\n"
        "import paddle_tpu_torch.ops.kernels.layer_norm, paddle_tpu_torch.layers.tensor\n"
        "import paddle_tpu_torch.models.resnet, paddle_tpu_torch.ops.misc_ops\n"
        "import paddle_tpu_torch.contrib.mixed_precision\n"
        "import paddle_tpu_torch.ops.kernels.fused_block\n"
        "import paddle_tpu_torch.clip, paddle_tpu_torch.regularizer, paddle_tpu_torch.layers.ops\n"
        "import paddle_tpu_torch.decoding, paddle_tpu_torch.profiler\n"
        "import paddle_tpu_torch.models.transformer\n"
        "import paddle_tpu_torch.resilience, paddle_tpu_torch.resilience.faults\n"
        "import paddle_tpu_torch.resilience.preempt, paddle_tpu_torch.resilience.snapshot\n"
        "import paddle_tpu_torch.inference.kv_cache, paddle_tpu_torch.inference.decode_model\n"
        "import paddle_tpu_torch.inference.handoff, paddle_tpu_torch.inference.registry\n"
        "import paddle_tpu_torch.streaming.export_int8, paddle_tpu_torch.inference.fleet\n"
        "import paddle_tpu_torch.dygraph, paddle_tpu_torch.dygraph.jit\n"
        "import paddle_tpu_torch.ops.vision_ops, paddle_tpu_torch.ops.sequence_ops\n"
        "import paddle_tpu_torch.reader, paddle_tpu_torch.reader.stager\n"
        "import paddle_tpu_torch.data_feeder, paddle_tpu_torch.dataset\n"
        "import paddle_tpu_torch.datasets, paddle_tpu_torch.incubate.data_generator\n"
        "import paddle_tpu_torch.contrib.trainer, paddle_tpu_torch.contrib.reader\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_of_the_port_imports_jax_or_paddle_tpu():
    """Not jax, paddle_tpu or tools, by import or by path."""
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if _forbidden(m)]
    assert bad == []
    # nor loads a module of tools/ (or anything else) by path
    assert [str(f.relative_to(ROOT)) for f in files
            if "spec_from_file_location" in f.read_text()] == []


def test_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    from paddle_tpu_torch.inference.server import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.Executor(fluid.CUDAPlace(0))
    assert AnalysisConfig().use_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_paddle_predictor(AnalysisConfig(str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model-dir", str(tmp_path)])
    from paddle_tpu_torch.inference.decode_model import ToyDecodeModel, make_toy_decode_weights
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ToyDecodeModel(make_toy_decode_weights())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(4, 4, 1, 1, 4)
    # a registry on a card server builds its runtimes on the card: with no
    # card the server, and a runtime built for a card server, raise
    from types import SimpleNamespace

    from paddle_tpu_torch.inference.registry import ModelRuntime
    from paddle_tpu_torch.inference.server import InferenceServer

    manifest = {"models": [{"name": "alt", "version": "v1", "bundle_dir": str(tmp_path)}]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(str(tmp_path), registry=manifest)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRuntime("alt", "v1", str(tmp_path), server=SimpleNamespace(device="cuda"))
    assert fluid.Executor(fluid.CPUPlace()).device == torch.device("cpu")
    # a fleet's workers run on the card by default: with no card its start
    # and its CLI raise before any worker is spawned
    import signal

    from paddle_tpu_torch.inference import fleet

    spawned = []
    monkeypatch.setattr(fleet.subprocess, "Popen", lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.ServingFleet(str(tmp_path), replicas=2).start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.main(["--model-dir", str(tmp_path), "--replicas", "2"])
    assert spawned == []
    # the DataLoader stages onto CUDAPlace(0) by default and the contrib
    # Trainer runs there: with no card both raise, naming CPUPlace()
    from paddle_tpu_torch import contrib, reader

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [2])
    loader = reader.DataLoader.from_generator([x])
    loader.set_sample_generator(lambda: iter([(np.zeros(2, "float32"),)] * 4), 2)
    with pytest.raises(RuntimeError, match=r"no CUDA device.*CPUPlace\(\)"):
        iter(loader)
    with pytest.raises(RuntimeError, match=r"no CUDA device.*CPUPlace\(\)"):
        iter(loader.set_sample_generator(lambda: iter([]), 2, places=[fluid.CUDAPlace(0)]))
    assert [f["x"].shape for f in loader.set_sample_generator(
        lambda: iter([(np.zeros(2, "float32"),)] * 4), 2, places=fluid.CPUPlace())] == [
        torch.Size([2, 2])] * 2
    assert contrib.trainer.check_and_get_place(None) == fluid.CUDAPlace(0)

    def train_func():
        return fluid.layers.mean(fluid.layers.fc(fluid.layers.data("x", [2]), 1))

    with pytest.raises(RuntimeError, match="no CUDA device"):
        contrib.Trainer(train_func, lambda: fluid.optimizer.SGD(0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contrib.Inferencer(train_func, str(tmp_path))


def test_data_modules_load_neither_jax_nor_paddle_tpu():
    """reader/, data_feeder.py, dataset.py, datasets/, incubate/ and the
    contrib Trainer, Inferencer and reader: their own copies of the JAX
    package's pure-numpy modules, importing neither package."""
    pkg = ROOT / "paddle_tpu_torch"
    files = (sorted((pkg / "reader").glob("*.py")) + sorted((pkg / "datasets").glob("*.py"))
             + sorted((pkg / "incubate").rglob("*.py")) + sorted((pkg / "contrib").rglob("*.py"))
             + [pkg / "data_feeder.py", pkg / "dataset.py", pkg / "io" / "__init__.py",
                pkg / "layers" / "io.py"])
    mods = sorted({"paddle_tpu_torch." + ".".join(
        f.relative_to(pkg).with_suffix("").parts).removesuffix(".__init__") for f in files})
    assert len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m)] == []
    # no native library of the JAX package is loaded by path either
    assert [str(f.relative_to(ROOT)) for f in files
            if "slot_parser" in f.read_text() or "ctypes" in f.read_text()] == []


def test_dygraph_loads_neither_jax_nor_paddle_tpu(monkeypatch):
    """Each module of paddle_tpu_torch.dygraph, and the lowerings its
    graph-op classes run; its guard runs on the card or raises."""
    mods = [f"paddle_tpu_torch.dygraph.{p.stem}"
            for p in sorted((ROOT / "paddle_tpu_torch" / "dygraph").glob("*.py"))
            if p.stem != "__init__"] + ["paddle_tpu_torch.dygraph",
                                        "paddle_tpu_torch.ops.vision_ops",
                                        "paddle_tpu_torch.ops.sequence_ops",
                                        "paddle_tpu_torch.ops.misc_ops"]
    assert len(mods) == 11
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    files = sorted((ROOT / "paddle_tpu_torch" / "dygraph").glob("*.py"))
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m)] == []
    from paddle_tpu_torch import dygraph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with dygraph.guard():
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dygraph.to_variable([1.0])


def test_passes_and_compiler_load_neither_jax_nor_paddle_tpu():
    """The pass manager, each pass and BuildStrategy: pure IR code with the
    port's own copies of what the JAX package's passes import."""
    mods = ["paddle_tpu_torch.compiler", "paddle_tpu_torch.passes"] + [
        f"paddle_tpu_torch.passes.{p.stem}"
        for p in sorted((ROOT / "paddle_tpu_torch" / "passes").glob("*.py"))
        if p.stem != "__init__"]
    assert len(mods) == 11  # shard_propagation is the eleventh
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    files = sorted((ROOT / "paddle_tpu_torch" / "passes").glob("*.py")) + [
        ROOT / "paddle_tpu_torch" / "compiler.py"]
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m)] == []


def test_fleet_spawns_the_port_server_only(tmp_path, monkeypatch):
    """The fleet's workers are `python -m paddle_tpu_torch.inference.server`:
    no string in fleet.py names a module of the JAX package, and the
    command handed to Popen names the port's server."""
    from paddle_tpu_torch.inference import fleet

    src = ROOT / "paddle_tpu_torch" / "inference" / "fleet.py"
    consts = [n.value for n in ast.walk(ast.parse(src.read_text()))
              if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert "paddle_tpu_torch.inference.server" in consts
    assert [c for c in consts if _forbidden(c.strip())] == []
    seen = []

    def fake_popen(cmd, **kw):
        seen.append(list(cmd))
        raise OSError("no spawn in this test")

    monkeypatch.setattr(fleet.subprocess, "Popen", fake_popen)
    sup = fleet.FleetSupervisor(str(tmp_path), worker_device="cpu")
    try:
        with pytest.raises(OSError):
            sup._spawn(sup.replicas[0])
    finally:
        sup.stop()
    module = seen[0][seen[0].index("-m") + 1]
    assert module == "paddle_tpu_torch.inference.server" and not _forbidden(module)


def test_resilience_modules_load_neither_jax_nor_paddle_tpu(tmp_path, monkeypatch):
    """resilience/, distributed/ and autoshard/: the port's own copies,
    importing neither package; the trainer supervisor runs its workers on
    the card by default, and with no card raises before any spawn."""
    pkg = ROOT / "paddle_tpu_torch"
    files = [p for d in ("resilience", "distributed", "autoshard")
             for p in sorted((pkg / d).glob("*.py"))]
    mods = sorted({"paddle_tpu_torch." + ".".join(
        f.relative_to(pkg).with_suffix("").parts).removesuffix(".__init__") for f in files})
    assert len(mods) == 17  # with the planner's modules, __main__ among them
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m)] == []
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.resilience import trainer_fleet

    spawned = []
    monkeypatch.setattr(launch.subprocess, "Popen", lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sup = trainer_fleet.TrainSupervisor(["train.py"], workdir=str(tmp_path))
    assert sup.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sup.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_fleet.main(["--started_port", "7330", "train.py"])
    assert spawned == []
    with pytest.raises(ValueError, match="device"):
        trainer_fleet.TrainSupervisor(["train.py"], device="tpu")


def test_parallel_and_compiler_load_neither_jax_nor_paddle_tpu():
    """parallel/ (the mesh, its api, the mesh step's plan and the
    tensor-parallel layout plan) and compiler.py (CompiledProgram): the
    port's own copies, importing neither package; a CompiledProgram's
    entry points run on the card unless the caller asks for the CPU."""
    pkg = ROOT / "paddle_tpu_torch"
    files = sorted((pkg / "parallel").glob("*.py")) + [pkg / "compiler.py"]
    mods = sorted({"paddle_tpu_torch." + ".".join(
        f.relative_to(pkg).with_suffix("").parts).removesuffix(".__init__") for f in files})
    assert mods == ["paddle_tpu_torch.compiler", "paddle_tpu_torch.parallel",
                    "paddle_tpu_torch.parallel.api", "paddle_tpu_torch.parallel.mesh",
                    "paddle_tpu_torch.parallel.moe", "paddle_tpu_torch.parallel.step",
                    "paddle_tpu_torch.parallel.tensor_parallel",
                    "paddle_tpu_torch.parallel.ulysses"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import paddle_tpu_torch\n"
        "assert paddle_tpu_torch.CompiledProgram is paddle_tpu_torch.compiler.CompiledProgram\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m)] == []


def test_sequence_and_expert_modules_load_neither_jax_nor_paddle_tpu():
    """Ring attention, Ulysses, mixture of experts and the moe_ffn op: the
    port's own copies, importing neither package; a ring or Ulysses given
    CPU tensors runs the kernels' plain versions."""
    pkg = ROOT / "paddle_tpu_torch"
    files = [pkg / "ops" / "ring_attention.py", pkg / "parallel" / "ulysses.py",
             pkg / "parallel" / "moe.py", pkg / "ops" / "moe_ops.py"]
    mods = ["paddle_tpu_torch.ops.ring_attention", "paddle_tpu_torch.parallel.ulysses",
            "paddle_tpu_torch.parallel.moe", "paddle_tpu_torch.ops.moe_ops"]
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from paddle_tpu_torch.ops.ring_attention import ring_attention\n"
        "q = torch.randn(1, 2, 8, 4)\n"
        "assert ring_attention(q, q, q, axis_size=2).shape == q.shape\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m)] == []


def test_static_step_loads_neither_jax_nor_paddle_tpu_nor_the_dygraph_jit():
    """static_step.py (Executor.run_repeated's static step), the executor and
    the seed slots import neither package, nor anything of
    paddle_tpu_torch.dygraph (the JIT bridge's graph capture is its own);
    a run_repeated on the CPU loads neither package."""
    pkg = ROOT / "paddle_tpu_torch"
    files = [pkg / "static_step.py", pkg / "executor.py", pkg / "ops" / "registry.py"]
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m) or m.startswith("paddle_tpu_torch.dygraph")] == []
    # relative imports too: the static step's source names no dygraph module
    assert "dygraph" not in (pkg / "static_step.py").read_text()
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as fluid, paddle_tpu_torch.static_step\n"
        "main, startup = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(main, startup), fluid.unique_name.guard():\n"
        "    x = fluid.layers.data('x', [4, 3], append_batch_size=False)\n"
        "    h = fluid.layers.dropout(fluid.layers.fc(x, 5), 0.5)\n"
        "    loss = fluid.layers.mean(h)\n"
        "    fluid.optimizer.SGD(0.1).minimize(loss)\n"
        "exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()\n"
        "exe.run(startup, scope=scope)\n"
        "(l,) = exe.run_repeated(main, feed={'x': np.ones((4, 3), 'float32')},\n"
        "                        fetch_list=[loss], steps=3, scope=scope)\n"
        "assert l.shape == (3, 1)\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_fleet_analysis_and_autoshard_load_neither_jax_nor_paddle_tpu_nor_cuda():
    """incubate/fleet/ (role makers, the collective fleet), analysis/,
    autoshard/ and the shard_propagation pass import neither package; and
    importing paddle_tpu_torch.autoshard and planning a Program leaves
    torch.cuda uninitialized (the JAX package's no-device-in-autoshard
    rule)."""
    pkg = ROOT / "paddle_tpu_torch"
    files = (sorted((pkg / "incubate" / "fleet").rglob("*.py"))
             + sorted((pkg / "analysis").glob("*.py")) + sorted((pkg / "autoshard").glob("*.py"))
             + [pkg / "passes" / "shard_propagation.py"])
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if _forbidden(m)] == []
    assert [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
            if m.startswith("torch.cuda")] == []
    code = (
        "import sys\n"
        "import torch\n"
        "import paddle_tpu_torch.autoshard as autoshard\n"
        "import paddle_tpu_torch.incubate.fleet.collective\n"
        "from paddle_tpu_torch.autoshard.__main__ import build_program\n"
        "program, feeds = build_program('bert')\n"
        "plan = autoshard.plan_program(program, autoshard.Topology(chips=8), feeds=feeds)\n"
        "assert plan.cost.feasible\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'paddle_tpu', 'tools')"
        " or m.startswith(('jax.', 'jaxlib.', 'paddle_tpu.', 'tools.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
