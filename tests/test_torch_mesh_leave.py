"""Leaving a mesh's world (``Mesh.close`` on rank 0, ``serve`` on the
others): every rank destroys the graphs it holds, waits through the store
until every rank has, and only then leaves the process group; rank 0 then
joins the worker processes. A rank that never leaves bounds the close at
the world's timeout: rank 0 raises and ends the worker.

Two gloo CPU ranks; a graph here is a stand-in that records its ``reset``.
"""

import time

import pytest
import torch.distributed as dist

from video_transformer_tpu_torch.parallel import mesh as mesh_module
from video_transformer_tpu_torch.parallel.mesh import build_mesh

TIMEOUT_S = 6.0


class HeldGraph:
    """What ``Mesh.hold`` keeps: a graph whose ``reset`` destroys it."""

    resets = 0

    def reset(self) -> None:
        HeldGraph.resets += 1


def hold_graphs(mesh, n: int) -> int:
    """On this rank: hold ``n`` graphs on ``mesh`` (kept alive until the
    leave) and return how many this process holds."""
    graphs = [HeldGraph() for _ in range(n)]
    for graph in graphs:
        mesh.hold(graph)
    mesh._test_graphs = graphs
    return len(mesh_module._GRAPHS)


def never_leave(rank: int) -> None:
    """On rank ``rank`` only: a leave that never ends (its graphs never released)."""
    if dist.get_rank() == rank:
        mesh_module._leave = lambda proc: time.sleep(3600)


def test_every_rank_releases_its_graphs_then_leaves():
    HeldGraph.resets = 0
    mesh = build_mesh({"data": 1, "model": 2}, devices=["cpu", "cpu"], timeout_s=TIMEOUT_S)
    procs = list(mesh_module._PROCESS.procs)
    assert mesh.run_all(hold_graphs, mesh, 3) == [3, 3]
    start = time.perf_counter()
    mesh.close()
    seconds = time.perf_counter() - start
    assert HeldGraph.resets == 3 and not mesh_module._GRAPHS
    assert not dist.is_initialized() and mesh_module._PROCESS is None
    assert [p.exitcode for p in procs] == [0]  # the worker left serve() and its world
    assert seconds < TIMEOUT_S


def test_a_rank_that_does_not_leave_bounds_the_close():
    mesh = build_mesh({"data": 2, "model": 1}, devices=["cpu", "cpu"], timeout_s=TIMEOUT_S)
    procs = list(mesh_module._PROCESS.procs)
    mesh.run_all(never_leave, 1)
    start = time.perf_counter()
    try:
        with pytest.raises(Exception, match="(?i)timeout"):
            mesh.close()
        seconds = time.perf_counter() - start
    finally:
        if dist.is_initialized():  # rank 0 waited for rank 1 and never left
            dist.destroy_process_group()
    assert mesh_module._PROCESS is None
    procs[0].join(timeout=TIMEOUT_S)
    assert not procs[0].is_alive() and procs[0].exitcode != 0  # ended by rank 0
    assert seconds < 3 * TIMEOUT_S
