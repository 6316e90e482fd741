"""The NCCL all-gather of the slab over the mesh's ranks
(parallel/distributed.py::all_gather_rows), by its kernel's name."""


def matches(name: str) -> bool:
    name = name.lower()
    return "nccl" in name and "allgather" in name
