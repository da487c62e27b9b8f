"""Rules of the PyTorch port: it imports neither JAX nor the reference
package; its entry points run on the card unless the caller asks for the
CPU; the ``"cuda"`` backend never runs on CPU tensors; unported cells
(the sharded topology, traced or not) and options raise naming their
ROADMAP item; the megakernel cell runs the
plain fused drain on CPU tensors; ``chip_smoke.py`` fails, and prints no
result, away from the repository."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.graph as tg
from repro.runtime import POLICY_GRID as J_POLICY_GRID
from repro.runtime import parse_policy as j_parse
from repro_torch.convert import graph_from_numpy
from repro_torch.core import (BACKENDS, SchedulerConfig, expand_merge_path,
                              make_queue, resolve_backend)
from repro_torch.runtime import (POLICY_GRID, build_program, config_for,
                                 parse_policy)
from repro_torch.runtime.api import execute

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: tg.rmat(4),
    lambda: tg.grid2d(3, 3),
    lambda: tg.erdos(10, 20),
    lambda: tg.from_edges(3, [0, 1], [1, 2]),
    lambda: make_queue(8),
    lambda: graph_from_numpy(np.array([0, 1, 1]), np.array([1])),
    lambda: tg.grid2d(3, 3, device="cpu").to("cuda"),
])
def test_default_device_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cuda_backend_refuses_cpu_tensors():
    g = tg.grid2d(4, 4, device="cpu")
    items = torch.tensor([0, 5], dtype=torch.int32)
    valid = torch.tensor([True, True])
    assert resolve_backend("auto", items) == "torch"
    assert BACKENDS == ("torch", "cuda", "auto")
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_backend("cuda", items)
    with pytest.raises(ValueError, match="CUDA tensors"):
        expand_merge_path(items, valid, g.row_ptr, g.col_idx, 16,
                          backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        make_queue(8, device="cpu").push(items, valid, backend="cuda")
    cfg = SchedulerConfig(num_workers=2, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        execute(build_program("bfs", g, cfg), g, cfg)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas", items)


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda)
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda

    with pytest.raises(ValueError, match="CUDA"):
        lbs_cuda(torch.zeros(4, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="CUDA"):
        compact_cuda(torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        stream_row_slices_cuda(torch.zeros(4, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), 3)
    g = tg.grid2d(3, 3, device="cpu")
    cfg = config_for(SchedulerConfig(num_workers=2),
                     parse_policy("single.megakernel"))
    from repro_torch.runtime.api import drain_setup

    setup = drain_setup(build_program("bfs", g, cfg), g, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        bfs_drain_cuda(setup.carry, g.row_ptr, g.col_idx, wavefront=2,
                       budget=8, max_rounds=10)
    from repro_torch.kernels.drain_loop.coloring_drain import (
        coloring_drain_cuda)
    from repro_torch.kernels.drain_loop.pagerank_drain import (
        pagerank_drain_cuda)

    setup = drain_setup(build_program("pagerank", g, cfg), g, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        pagerank_drain_cuda(setup.carry, g.row_ptr, g.col_idx, wavefront=2,
                            budget=8, n_check=4, damping=0.85, eps=1e-6,
                            max_rounds=10)
    setup = drain_setup(build_program("coloring", g, cfg), g, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        coloring_drain_cuda(setup.carry, g.row_ptr, g.col_idx, wavefront=2,
                            max_degree=4, max_rounds=10)


def test_policy_matrix_parses_like_jax():
    assert [str(p) for p in POLICY_GRID] == [str(p) for p in J_POLICY_GRID]
    for name in ("single.persistent", "fused.discrete.g4",
                 "sharded.persistent.g2", "single.megakernel.g8"):
        assert str(parse_policy(name)) == str(j_parse(name))
    with pytest.raises(ValueError):
        parse_policy("sharded.megakernel")


@pytest.mark.parametrize("policy,item", [
    ("sharded.persistent.g4", "A12"), ("sharded.discrete", "A12"),
    ("sharded.persistent", "A12")])
def test_unported_cells_name_their_roadmap_item(policy, item):
    g = tg.grid2d(3, 3, device="cpu")
    cfg = config_for(SchedulerConfig(num_workers=2), parse_policy(policy))
    with pytest.raises(NotImplementedError, match=item):
        execute(build_program("bfs", g, SchedulerConfig(num_workers=2)), g,
                cfg)


def test_cpu_megakernel_is_the_plain_fused_drain_in_one_launch():
    """On CPU tensors ``single.megakernel`` runs no kernel: the plain fused
    drain over the megakernel body, equal to the persistent cell, reported
    as one launch; asking for the kernels on CPU tensors raises."""
    from repro_torch.core import persistent_drive
    from repro_torch.kernels.drain_loop.kernel import fused_drain_ref
    from repro_torch.runtime.api import drain_setup

    g = tg.rmat(6, 8, seed=2, device="cpu")
    cfg = config_for(SchedulerConfig(num_workers=8, fetch_size=2),
                     parse_policy("single.megakernel"))
    program = build_program("bfs", g, cfg, params={"source": 1})
    state, stats, info = execute(program, g, cfg)
    setup = drain_setup(program, g, cfg)
    assert setup.kernel is None
    queue, plain, rounds, processed = fused_drain_ref(setup.step, setup.cond,
                                                      setup.carry)
    assert torch.equal(state.dist, plain.dist)
    assert [int(x) for x in stats] == [int(rounds), int(processed),
                                       int(queue.dropped)]
    assert info["launches"] == 1 and info["rounds"] == int(rounds) > 1
    pcfg = config_for(SchedulerConfig(num_workers=8, fetch_size=2),
                      parse_policy("single.persistent"))
    psetup = drain_setup(program, g, pcfg)
    pq, ps, pr, pp = persistent_drive(psetup.step, psetup.cond, psetup.carry)
    assert torch.equal(pq.buf, queue.buf) and torch.equal(ps.dist, plain.dist)
    assert [int(x) for x in (pq.head, pq.tail, pr, pp)] == \
        [int(x) for x in (queue.head, queue.tail, rounds, processed)]
    cuda_cfg = config_for(SchedulerConfig(num_workers=8, backend="cuda"),
                          parse_policy("single.megakernel"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        execute(build_program("bfs", g, cuda_cfg), g, cuda_cfg)


def test_unported_algorithms_and_trace_raise():
    from repro_torch.obs import Trace

    g = tg.grid2d(3, 3, device="cpu")
    cfg = SchedulerConfig(num_workers=2)
    sharded = config_for(cfg, parse_policy("sharded.persistent"))
    with pytest.raises(NotImplementedError, match="A12"):
        execute(build_program("bfs", g, cfg), g, sharded, trace=Trace())
    with pytest.raises(ValueError, match="unknown bfs params"):
        build_program("bfs", g, cfg, params={"sorce": 0})


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--scale", "4",
                           "--grid-side", "4"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
