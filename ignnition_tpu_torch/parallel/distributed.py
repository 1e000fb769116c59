"""Multi-process initialization and mesh construction (counterpart of
`ignnition_tpu/parallel/distributed.py`).

Every rank runs the same program. `initialize()` joins the ranks into one
`torch.distributed` default group, after which the ('data', 'model') mesh
of `make_pod_mesh` keeps the edge-partition ('model') axis within a node,
whose collectives run once per aggregation, and lays the data axis across
nodes, where only the step's gradient all-reduce travels.

Typical launch, one process per GPU (`torchrun --nproc-per-node=8
train.py` on every node):

    from ignnition_tpu_torch.parallel import distributed
    distributed.initialize()              # torchrun's environment
    mesh = distributed.make_pod_mesh(model_axis_per_host=2)
    runner = igt.Runner(model, mesh=mesh)
    runner.train_and_evaluate()

The backend is NCCL on the GPU and gloo for `device="cpu"`. NCCL refuses
two ranks on one card: several ranks that share a card pass
`backend="gloo"`, whose collectives take device tensors through the host.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> None:
    """Initialize the default process group.

    With no address, world size or rank, torchrun's environment gives them
    (`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`, `RANK`); otherwise all
    three are given, the address as "host:port" (or a full init URL such as
    "tcp://localhost:29500"). device: "cpu" chooses gloo; by default the
    ranks run on the GPU, each on card `LOCAL_RANK` (else its rank modulo
    the cards of the machine), which becomes the current CUDA device, over
    NCCL. backend overrides the choice (gloo for ranks sharing one card)."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if coordinator_address is None and num_processes is None and process_id is None:
        rank = int(os.environ.get("RANK", "0"))
        kwargs = {}
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "pass coordinator_address, num_processes and process_id together, "
                "or none of them (torchrun's environment)"
            )
        url = coordinator_address if "://" in coordinator_address else (
            f"tcp://{coordinator_address}")
        rank = process_id
        kwargs = dict(init_method=url, world_size=num_processes, rank=process_id)
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and none was asked for: the ranks "
                'run on the GPU by default; pass device="cpu" to run on the CPU'
            )
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, **kwargs)


def make_pod_mesh(model_axis_per_host: int = 1) -> Mesh:
    """The ('data', 'model') mesh over every rank of the initialized group,
    the model axis kept within each node (torchrun numbers a node's ranks
    consecutively, so each data row is `model_axis_per_host` consecutive
    ranks of one node: torchrun's `LOCAL_WORLD_SIZE`, else the whole world)
    and the data axis over the rest."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if model_axis_per_host > local or local % model_axis_per_host != 0:
        raise ValueError(
            f"model_axis_per_host={model_axis_per_host} must divide the "
            f"ranks of a node ({local})"
        )
    n = dist.get_world_size()
    return make_mesh(data=n // model_axis_per_host, model=model_axis_per_host)


def host_shard_iter(it: Iterator, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> Iterator:
    """Deal every num_processes-th item to this rank (simple input sharding:
    each rank sees a distinct stream)."""
    pid = dist.get_rank() if process_id is None else process_id
    n = dist.get_world_size() if num_processes is None else num_processes
    for i, item in enumerate(it):
        if i % n == pid:
            yield item
