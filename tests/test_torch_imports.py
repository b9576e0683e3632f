"""Package rules of the PyTorch port: src/repro_torch and chip_smoke.py
import neither JAX nor the reference package (an AST scan of every
import), and the entry points never fall back to the CPU on their own."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"params.py", "simulator.py", "engine.py", "fused.py",
            "chip_smoke.py", "interop.py", "lm.py", "attention.py",
            "decode_attention.py", "flash_attention.py", "serve.py",
            "steps.py", "qwen3_14b.py", "ssm.py", "moe.py",
            "selective_scan.py", "addr_map.py",
            "jamba_v01_52b.py", "effective_bw.py", "sweep_stream.py",
            "exec_cache.py", "store.py", "train.py", "pipeline.py",
            "adamw.py", "schedules.py", "compression.py", "analytic.py",
            "specs.py", "partition.py", "shard.py", "mesh.py"} <= names
    paths = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/core/sweep_stream.py",
            "src/repro_torch/core/exec_cache.py",
            "src/repro_torch/checkpoint/store.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/optim/__init__.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/schedules.py",
            "src/repro_torch/optim/compression.py",
            "src/repro_torch/perfmodel/analytic.py",
            "src/repro_torch/launch/specs.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/distributed/partition.py",
            "src/repro_torch/distributed/shard.py"} <= paths


def test_training_entry_points_are_exported_and_raise_without_a_card():
    """``repro_torch.optim`` exports what ``repro.optim`` exports; the
    train step and the training CLI default to the card, and raise
    without one unless given ``device="cpu"`` (``--device cpu``)."""
    import repro_torch.optim as optim
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step

    assert optim.__all__ == ["AdamWConfig", "adamw_init", "adamw_update",
                             "global_norm", "schedules", "compression"]
    cfg = ARCHS["minicpm-2b"].tiny()
    assert callable(make_train_step(cfg, device="cpu"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    for call in (lambda: make_train_step(cfg),
                 lambda: train.main(["--arch", "minicpm-2b", "--tiny",
                                     "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """No silent detach: K5, K7 and K6's plain launch fill their outputs
    through raw pointers, so while grad mode is on they refuse an input
    that requires grad (before any other check), and accept it under
    ``torch.no_grad()`` (where they go on to refuse CPU tensors)."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_cuda)

    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    x = torch.zeros((1, 4, 8), requires_grad=True)
    calls = (lambda: flash_attention_cuda(q, q, q),
             lambda: decode_attention_cuda(q[:, :, 0], q, q,
                                           torch.ones(1, dtype=torch.int32)),
             lambda: selective_scan_cuda(x, x, x[..., :4], x[..., :4],
                                         torch.zeros((8, 4))))
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_streaming_entry_points_are_exported_and_raise_without_a_card():
    """``repro_torch.core`` exports the two names it lacked against
    ``repro.core`` (``stream_sweep``, ``aot_cache_stats``); the streaming
    sweep, like every entry point, defaults to the card, and a sweep the
    threshold routes to it raises there too, before any work."""
    import repro_torch.core as core
    from repro_torch.traces import trace_example

    assert {"stream_sweep", "aot_cache_stats"} <= set(core.__all__)
    assert set(core.aot_cache_stats()) == {"memory", "disk"}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    cfg, tr = core.MemSimConfig(), trace_example(n=4)
    for call in (lambda: core.stream_sweep(cfg, tr, {"tCL": [14]}, 10),
                 lambda: core.sweep_grid(cfg, tr, {"tCL": [14]}, 10,
                                         stream=True),
                 lambda: core.sweep_topologies(cfg, tr, {"ranks": [1]}, 10,
                                               stream=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("entry", ["simulate", "simulate_fast",
                                   "simulate_ideal"])
def test_entry_points_raise_without_a_card(entry):
    import repro_torch.core as core
    from repro_torch.traces import trace_example

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    args = () if entry == "simulate_ideal" else (10,)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(core, entry)(core.MemSimConfig(), trace_example(n=4), *args)


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA kernel wrappers take CUDA tensors only; CPU tensors go to
    the plain versions through the dispatching entry points."""
    from repro_torch.core.params import MemSimConfig, ParamSchedule
    from repro_torch.kernels.bank_fsm.bank_fsm import bank_fsm_step_cuda
    from repro_torch.kernels.addr_map.addr_map import addr_map_cuda
    from repro_torch.kernels.bank_fsm.fused import fused_step_cuda
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_cuda)

    topo = MemSimConfig().topology()
    z = torch.zeros((10, 32), dtype=torch.int32)
    bounds, rp = ParamSchedule.constant(MemSimConfig().runtime()).pack()
    with pytest.raises(ValueError, match="CUDA tensor"):
        bank_fsm_step_cuda(topo, z, z[:3], z[:4], rp, bounds,
                           torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_step_cuda(topo, torch.zeros((23, 32), dtype=torch.int32),
                        torch.zeros((64, 4), dtype=torch.int32), rp, bounds,
                        torch.zeros((1, 9), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        addr_map_cuda(topo, torch.zeros((8,), dtype=torch.int32))
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan_cuda(x, x, x[..., :4], x[..., :4], torch.zeros((8, 4)))


def test_batch_entry_points_are_exported_and_raise_without_a_card():
    """The batched calls are exported from ``repro_torch.core`` and, like
    the single-lane ones, default to the card."""
    import repro_torch.core as core
    from repro_torch.traces import trace_example

    names = ("simulate_batch", "stack_traces", "sweep_queue_sizes",
             "GRID_AXES", "lane_schedule", "grid_points", "sweep_grid")
    assert set(names) <= set(core.__all__)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    cfg, tr = core.MemSimConfig(), trace_example(n=4)
    for call in (lambda: core.simulate_batch(cfg, [tr], 10),
                 lambda: core.sweep_queue_sizes(cfg, tr, [4], 10),
                 lambda: core.sweep_grid(cfg, tr, {"tCL": [14]}, 10)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_batch_wrapper_rejects_cpu_tensors():
    """The lane-batched K3 wrapper takes states on the card only."""
    from repro_torch.core.params import MemSimConfig, ParamSchedule
    from repro_torch.core.simulator import ScheduleView, init_state
    from repro_torch.kernels.bank_fsm.fused import fused_run_batch_cuda
    from repro_torch.traces import trace_example

    cfg = MemSimConfig()
    topo = cfg.topology()
    view = ScheduleView(topo, ParamSchedule.constant(cfg.runtime()), "cpu")
    tr = trace_example(n=4)
    state = init_state(topo, view, tr.num_requests, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_run_batch_cuda(topo, [view], [tr], [state], 10)


def test_session_and_serving_entry_points_are_exported_and_raise_without_a_card():
    """The windowed sessions and the closed-loop serving drivers are
    exported as the reference exports them and, like every entry point,
    default to the card."""
    import repro_torch.core as core
    import repro_torch.serving as serving
    from repro_torch.traces import llm_workload

    assert {"SimSession", "WindowReport", "SessionBatch",
            "SessionLane"} <= set(core.__all__)
    assert {"ContinuousBatchScheduler", "KVPager", "PageState", "Request",
            "ServingConfig", "ServingResult", "generate_request_batch",
            "generate_requests", "observe_batch", "plan_window_batch",
            "run_serving", "run_serving_batched",
            "spawn_seeds"} == set(serving.__all__)
    assert callable(llm_workload.decode_serving_trace)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    cfg = core.MemSimConfig()
    reqs = serving.generate_requests(horizon=2_000, seed=1)
    for call in (lambda: core.SimSession.open(cfg),
                 lambda: core.SessionBatch.open(cfg, 2),
                 lambda: serving.run_serving(cfg, reqs),
                 lambda: serving.run_serving_batched(cfg, [reqs])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernel_ops_are_exported_and_build_nothing():
    """``repro_torch.kernels`` exports the five ops the reference's
    ``repro.kernels`` exports; importing them compiles no kernel."""
    import subprocess
    import sys

    import repro_torch.kernels as kernels

    assert kernels.__all__ == ["bank_fsm_step", "addr_map", "attention",
                               "decode_attention", "selective_scan"]
    assert all(callable(getattr(kernels, n)) for n in kernels.__all__)
    assert kernels.addr_map.__module__ == "repro_torch.kernels.addr_map.ops"
    # in a fresh process: the import alone loads no kernel library
    probe = ("from repro_torch.kernels import *; "
             "from repro_torch.kernels import build; "
             "assert build.build_count() == 0 and not build._libs")
    subprocess.run([sys.executable, "-c", probe], check=True,
                   cwd=ROOT / "src")


def test_topology_sweep_and_studies_are_exported_and_raise_without_a_card():
    """The multi-topology sweep is exported from ``repro_torch.core`` and
    ``perfmodel.effective_bw`` has every public name of the reference's
    module; like every entry point they default to the card."""
    import repro_torch.core as core
    from repro_torch.perfmodel import effective_bw
    from repro_torch.traces import llm_workload, trace_example

    assert {"TOPO_AXES", "topo_grid_points", "TopoGridResult",
            "sweep_topologies"} <= set(core.__all__)
    names = {"EffectiveBW", "measure", "grid_study", "topo_grid_study",
             "topo_llm_grid_study", "dvfs_study", "dvfs_llm_study",
             "cxl_tier_point", "cxl_tier_study", "saturation_knee",
             "serving_row", "serving_study", "llm_grid_study",
             "decode_efficiency", "train_efficiency"}
    assert names <= {n for n in vars(effective_bw) if not n.startswith("_")}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    cfg, tr = core.MemSimConfig(), trace_example(n=4)
    decode = [("decode", llm_workload.decode_step_traffic("qwen3-14b", 1e9,
                                                          1e8))]
    for call in (
            lambda: core.sweep_topologies(cfg, tr, {"ranks": [1, 2]}, 10),
            lambda: effective_bw.grid_study(decode, {"tCL": [14]},
                                            target_requests=8),
            lambda: effective_bw.topo_grid_study(decode, {"ranks": [1]},
                                                 target_requests=8),
            lambda: effective_bw.cxl_tier_study(tokens=2, chunks=2),
            lambda: effective_bw.decode_efficiency("qwen3-14b", 1e9, 1e8,
                                                   target_requests=8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
