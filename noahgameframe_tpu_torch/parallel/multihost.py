"""Multi-process bootstrap: the Master role as the rendezvous, and a mesh
across processes.

Counterpart of ``noahgameframe_tpu/parallel/multihost.py``.  The JAX
package joins ``jax.distributed`` and meshes ``jax.devices()`` of the
whole pod; here the processes join one ``torch.distributed`` group (gloo
on the CPU, NCCL across cards), and :func:`global_mesh` lists every
process's shards as (rank, local device).  The collectives of
parallel/collectives.py then cross processes through the group: a shard's
blocks stay in its process, gathers and sums go through the group.  Gloo
carries host tensors only, so a CUDA tensor bound for a gloo group is
staged through the host; NCCL refuses two ranks on one card, so two
processes sharing a card run over gloo.

- :func:`init_distributed`: joins the group (idempotent), from arguments
  or the ``NF_COORDINATOR_ADDRESS`` / ``NF_NUM_PROCESSES`` /
  ``NF_PROCESS_ID`` variables; a no-op for one process.
- :func:`global_mesh`: the mesh over every process's shards.
- Master-backed rendezvous: ``serve_dist`` mounts ``/dist`` on a
  MasterRole's HTTP server, and :func:`rendezvous_via_master` polls it
  until every expected process has registered, returning (coordinator,
  num_processes, process_id) for :func:`init_distributed`.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from typing import Dict, Optional, Sequence, Tuple

import torch

from .mesh import SHARD_AXIS, Mesh


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join the process group of ``num_processes`` at ``coordinator``
    (``host:port`` of rank 0's rendezvous).  ``backend`` defaults to NCCL
    when this process has a card and gloo otherwise.  Returns True when a
    multi-process group was joined (or already is)."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("NF_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NF_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("NF_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator is None:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def global_mesh(axis: str = SHARD_AXIS, local_devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over EVERY process's shards, in rank order.  This process
    contributes ``local_devices`` (default: its cards, else the CPU; a
    device may repeat, for several shards on one device).  Without a
    joined group it is this process's mesh."""
    import torch.distributed as dist

    if local_devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_devices = ([torch.device("cuda", i) for i in range(n)] if n
                         else [torch.device("cpu")])
    local = [str(torch.device(d)) for d in local_devices]
    if not dist.is_initialized():
        return Mesh(local, axis)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    devices, ranks = [], []
    for r, devs in enumerate(every):
        devices += devs
        ranks += [r] * len(devs)
    return Mesh(devices, axis, ranks=ranks, rank=dist.get_rank())


class DistRendezvous:
    """Host-side assignment table the Master serves at /dist.

    The first registrant's announced endpoint becomes the coordinator;
    process ids are dense in arrival order; ``expected`` is the process
    count."""

    def __init__(self, expected: int) -> None:
        self.expected = int(expected)
        self._procs: Dict[str, int] = {}
        self._coordinator: Optional[str] = None

    def register(self, host_key: str, coord_endpoint: str) -> dict:
        if host_key not in self._procs:
            if len(self._procs) >= self.expected:
                return {"error": "pod full", "expected": self.expected}
            self._procs[host_key] = len(self._procs)
            if self._coordinator is None:
                self._coordinator = coord_endpoint
        return self.view(host_key)

    def view(self, host_key: Optional[str] = None) -> dict:
        out = {
            "coordinator": self._coordinator,
            "num_processes": self.expected,
            "registered": len(self._procs),
            "ready": len(self._procs) >= self.expected,
        }
        if host_key is not None and host_key in self._procs:
            out["process_id"] = self._procs[host_key]
        return out


def serve_dist(master_role, expected: int) -> DistRendezvous:
    """Attach the /dist rendezvous endpoint to a MasterRole's HTTP server:
    GET /dist?host=<key>&coord=<ip:port> registers and returns the
    assignment; GET /dist reports status."""
    rz = DistRendezvous(expected)

    def handler(_path: str, params: Dict[str, str]) -> dict:
        host = params.get("host")
        coord = params.get("coord", "")
        if host:
            return rz.register(host, coord)
        return rz.view()

    master_role.http.route("/dist", handler)
    return rz


def rendezvous_via_master(master_http: str, host_key: str, coord_endpoint: str,
                          timeout_s: float = 60.0, poll_s: float = 0.5) -> Tuple[str, int, int]:
    """Register with the master's /dist endpoint and wait until every
    expected process has arrived; returns (coordinator, num_processes,
    process_id) for :func:`init_distributed`."""
    base = f"http://{master_http}/dist?host={host_key}&coord={coord_endpoint}"
    deadline = time.monotonic() + timeout_s
    assignment = None
    while time.monotonic() < deadline:
        with urllib.request.urlopen(base, timeout=5) as r:
            assignment = json.loads(r.read())
        if "error" in assignment:
            raise RuntimeError(f"dist rendezvous refused: {assignment}")
        if assignment.get("ready"):
            return (assignment["coordinator"], int(assignment["num_processes"]),
                    int(assignment["process_id"]))
        time.sleep(poll_s)
    raise TimeoutError(f"dist rendezvous incomplete after {timeout_s}s: {assignment}")
