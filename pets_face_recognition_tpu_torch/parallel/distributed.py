"""Multi-process set-up (counterpart of the JAX ``parallel/distributed.py``).

One process drives one device. ``init_distributed`` joins the processes into
one ``torch.distributed`` group from the JAX package's env names
(``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``);
with none of them set it is a world of one and does nothing. The backend is
NCCL on the card and ``gloo`` only when the caller asks for the CPU; a failed
NCCL set-up raises, it never falls back to ``gloo`` or to the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

ENV_ADDRESS, ENV_PROCESSES, ENV_PROCESS_ID = "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def process_device(device: str | torch.device = "cuda", rank: int | None = None) -> torch.device:
    """This process's device: ``device`` itself on the CPU or with an index,
    else card ``rank % device_count`` (one process a card)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device: str | torch.device = "cuda") -> bool:
    """Join the process group; returns whether there is one. The arguments
    default from ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``;
    with neither an address nor a count it returns ``False`` (a world of one).
    A group already joined is kept."""
    address = coordinator_address or os.environ.get(ENV_ADDRESS)
    num = num_processes or _int_env(ENV_PROCESSES)
    pid = process_id if process_id is not None else _int_env(ENV_PROCESS_ID)
    if address is None and num is None:
        return False
    if dist.is_initialized():
        return True
    if address is None:
        raise ValueError(f"{ENV_PROCESSES}={num} needs {ENV_ADDRESS}=host:port")
    num, pid = num or 1, pid or 0
    dev = process_device(device, pid)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{address}", world_size=num, rank=pid, **kw)
    return True


def device_info() -> dict:
    """The JAX ``device_info`` keys: this process's index and the count of
    processes, the visible devices, the devices of the whole group (one a
    process in a group) and the platform (``gpu`` or ``cpu``)."""
    cuda = torch.cuda.is_available()
    local = [str(torch.device("cuda", i)) for i in range(torch.cuda.device_count())] \
        if cuda else ["cpu"]
    grouped = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if grouped else 0,
        "process_count": dist.get_world_size() if grouped else 1,
        "local_devices": local,
        "global_device_count": dist.get_world_size() if grouped else len(local),
        "platform": "gpu" if cuda else "cpu",
    }
