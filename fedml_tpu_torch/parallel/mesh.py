"""Device meshes over `torch.distributed` ranks (port of
`fedml_tpu/parallel/mesh.py`).

A JAX mesh is a grid of devices inside one process; PyTorch's idiom is one
process per device, so the port's mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, with the JAX axis names as `mesh_dim_names`: `clients`
(the federated axis), `silos` and `intra` (the hierarchical round),
`data` (inside a silo). Every code path that takes a mesh runs SPMD, the
same call in every rank of the mesh.

`make_mesh` and `mesh_from_file` accept the JAX package's shapes and
raise its errors word for word, with "devices" read as ranks. They never
start a process group: without an initialised `torch.distributed` they
raise and say so (`parallel/launch.py` starts ranks). A mesh smaller than
the world takes a prefix of the ranks, as a JAX mesh takes a prefix of the
devices; every rank of the world must still make the call, since building
a mesh's groups is collective over the world.

`client_share` is the counterpart of `client_sharding`: the rows of an
[m]-client cohort a rank holds under `P(clients)`, a contiguous block of
m / d. The counterpart of `replicated` needs no helper: every rank holds
the whole value (the server state, the stacked client table). The
collectives below take a mesh axis; gloo's are staged through the host
for CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def check_mesh(mesh, what: str = "mesh") -> None:
    """None, or a DeviceMesh that holds this rank. Anything else is a
    TypeError; a mesh that leaves this rank out (a prefix mesh smaller
    than the world) is a ValueError, since only its ranks run its SPMD
    paths."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"{what} must be a torch.distributed DeviceMesh (see "
            f"parallel/mesh.make_mesh); got {type(mesh).__name__}")
    if not in_mesh(mesh):
        raise ValueError(
            f"{what}: rank {dist.get_rank()} is not one of its ranks "
            f"{mesh.mesh.flatten().tolist()}; a mesh smaller than the world "
            "leaves the other ranks out, and only its own ranks may run it "
            "(parallel/mesh.in_mesh)")


def _world_ranks() -> list:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs torch.distributed initialised in this "
            "process (one rank per device: torchrun, or "
            "fedml_tpu_torch.parallel.launch.RankPool / local_world); "
            "make_mesh does not start a process group itself")
    return list(range(dist.get_world_size()))


def mesh_sizes(axes: dict, n_devices: int) -> list:
    """The axis sizes of `axes` ({name: size}, -1 = every remaining
    device) over `n_devices`, with JAX's validation and messages."""
    wild = None
    for name, size in axes.items():
        if isinstance(size, bool) or not isinstance(size, int):
            raise ValueError(
                f"mesh axis {name!r} size must be an integer (or -1 for "
                f"'all remaining devices'); got {size!r}")
        if size == -1:
            if wild is not None:
                raise ValueError(
                    f"mesh axes {wild!r} and {name!r} are both -1; only "
                    "one axis can absorb the remaining devices")
            wild = name
        elif size < 1:
            raise ValueError(
                f"mesh axis {name!r} size must be >= 1 or -1; got {size}")
    sizes = list(axes.values())
    if wild is not None:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known > n_devices or n_devices % known:
            raise ValueError(
                f"mesh {axes}: the fixed axes multiply to {known}, which "
                f"does not divide the {n_devices} available devices — "
                f"axis {wild!r} (-1) cannot be sized")
        sizes[sizes.index(-1)] = n_devices // known
    total = int(np.prod(sizes))
    if total > n_devices:
        big = max(axes, key=lambda k: axes[k] if axes[k] != -1 else 0)
        raise ValueError(
            f"mesh {axes} needs {total} devices, have {n_devices} "
            f"(largest axis: {big!r}={axes[big]})")
    return sizes


def make_mesh(axes: Optional[dict] = None, devices: Optional[Sequence[int]]
              = None):
    """axes: ordered {name: size}; size -1 means 'all remaining ranks'.
    Default: a 1-D mesh over every rank on axis `clients`. `devices` are
    ranks of the default process group (default: all of them, in order);
    explicit sizes smaller than their count use a prefix. Bad shapes fail
    here, naming the offending axis. The mesh's device type follows the
    default group's backend: cuda for NCCL, cpu for gloo (whose
    collectives the port stages through the host)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    devices = list(devices) if devices is not None else _world_ranks()
    axes = dict(axes or {"clients": len(devices)})
    sizes = mesh_sizes(axes, len(devices))
    world = _world_ranks()
    bad = [r for r in devices[:int(np.prod(sizes))] if r not in world]
    if bad:
        raise ValueError(
            f"mesh names ranks {bad} outside the world of {len(world)}")
    arr = torch.tensor(devices[:int(np.prod(sizes))]).reshape(sizes)
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, arr, mesh_dim_names=tuple(axes))


def mesh_from_file(path: str, devices: Optional[Sequence[int]] = None):
    """Device-mapping file -> mesh (the reference's gpu_mapping.yaml
    analog): named axes and, optionally, an explicit rank order

        mesh:               # ordered {axis: size}; -1 = all remaining
          silos: 2
          intra: -1
        device_ids: [0, 2, 1, 3]     # optional reorder

    Configs reach it through device_args.extra.mesh_mapping_file; inline
    device_args.mesh_shape wins when both are set."""
    import yaml

    with open(path) as f:
        spec = yaml.safe_load(f) or {}
    if "mesh" not in spec or not isinstance(spec["mesh"], dict):
        raise ValueError(
            f"mesh mapping file {path!r} needs a 'mesh: {{axis: size}}' "
            "section")
    devices = list(devices) if devices is not None else _world_ranks()
    ids = spec.get("device_ids")
    if ids is not None:
        if len(set(ids)) != len(ids):
            dupes = sorted({i for i in ids if ids.count(i) > 1})
            raise ValueError(
                f"mesh mapping file repeats device ids {dupes} — a mesh "
                "aliasing one chip twice fails much later with an opaque "
                "sharding error")
        missing = [i for i in ids if i not in devices]
        if missing:
            raise ValueError(
                f"mesh mapping file names device ids {missing} not present "
                f"(have {sorted(devices)})")
        devices = list(ids)
    return make_mesh(spec["mesh"], devices=devices)


def in_mesh(mesh) -> bool:
    """Whether this rank is one of the mesh's (a prefix mesh leaves the
    world's other ranks out; they must not run its SPMD paths)."""
    return mesh.get_coordinate() is not None


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (it must be in the mesh)."""
    return int(mesh.get_local_rank(axis))


def client_share(mesh, m: int, axis: str = "clients") -> slice:
    """The rows of an [m]-client cohort this rank holds: block k of d
    contiguous blocks, k its coordinate along `axis`. m must divide."""
    d = axis_size(mesh, axis)
    if m % d:
        raise ValueError(
            f"a cohort of {m} clients does not split over the {d} ranks "
            f"of mesh axis {axis!r}: pad it to a multiple of {d} with "
            "zero-weight duplicates (the Simulator does)")
    k = axis_index(mesh, axis)
    return slice(k * (m // d), (k + 1) * (m // d))


# ------------------------------------------------------------ collectives
def _staged(t: torch.Tensor, group) -> bool:
    """Gloo reduces host memory: a CUDA tensor on a gloo group is copied
    to the host and back."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(tensors: list, mesh, axis: str) -> None:
    """Sum each tensor across the ranks of `axis`, in place: one
    all-reduce per dtype over the tensors flattened into one buffer."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        buf = flat.cpu() if _staged(flat, group) else flat
        dist.all_reduce(buf, group=group)
        if buf is not flat:
            flat.copy_(buf)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def all_gather_rows(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """[n, ...] per rank -> [d * n, ...], the ranks' rows in coordinate
    order (every rank holds the same n)."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    src = t.contiguous()
    src = src.cpu() if _staged(src, group) else src
    out = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(out, src, group=group)
    return torch.cat(out).to(t.device)


def all_gather_tree(tree, mesh, axis: str):
    """Each leaf's [n, ...] rows gathered over `axis` into [d * n, ...]:
    the leaves of one dtype travel as one [n, D] matrix."""
    from ..ops.tree import tree_leaves, tree_map

    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    gathered: dict = {}
    for dt in dict.fromkeys(x.dtype for x in leaves):
        group = [x for x in leaves if x.dtype == dt]
        flat = torch.cat([x.reshape(n, -1) for x in group], dim=1)
        g = all_gather_rows(flat, mesh, axis)
        off = 0
        for x in group:
            w = x[0].numel()
            gathered[id(x)] = g[:, off:off + w].reshape(
                (g.shape[0],) + tuple(x.shape[1:]))
            off += w
    return tree_map(lambda x: gathered[id(x)], tree)


def agree_max(value: float, mesh, axis: str) -> float:
    """The largest of every rank's `value` (host timings that must agree
    across ranks before they steer a placement)."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def _host_buf(t: torch.Tensor, group) -> torch.Tensor:
    """What a collective moves: `t` itself, or, on a gloo group, a host
    copy of a CUDA tensor, a low-precision float widened to f32 (the sum
    of two bf16 values rounded once is the same either way)."""
    if not _staged(t, group):
        return t
    if t.is_floating_point() and t.element_size() < 4:
        return t.float().cpu()
    return t.cpu()


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of `t` over the ranks of `axis`, as a new tensor."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    src = t.contiguous()
    buf = _host_buf(src, group)
    if buf.data_ptr() == src.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def all_gather_dim(t: torch.Tensor, mesh, axis: str,
                   dim: int = -1) -> torch.Tensor:
    """Each rank's `t` concatenated along `dim` in coordinate order (every
    rank holds the same shape)."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    src = _host_buf(t.contiguous(), group)
    out = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(out, src, group=group)
    return torch.cat(out, dim=dim).to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The value `t` has on the axis's first rank (coordinate 0), on
    every rank of the axis, as a new tensor."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    src = t.contiguous()
    buf = _host_buf(src, group)
    if buf.data_ptr() == src.data_ptr():
        buf = buf.clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def broadcast_object(obj, mesh, axis: str):
    """A picklable object from the axis's first rank, on every rank of
    the axis (what the others pass is ignored). CUDA tensors inside it
    must be moved to the host first."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    box = [obj]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else None)
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group, device=dev)
    return box[0]


def barrier(mesh) -> None:
    """Every rank of the mesh has reached this call."""
    for ax in mesh.mesh_dim_names:
        agree_max(0.0, mesh, ax)
