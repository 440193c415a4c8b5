"""Device meshes for placed synthesis, from the JAX package's
``launch/mesh.py``.

As in the reference, a mesh is single-controller: one process holds a
named grid of devices and places work on them; there are no processes
and no collectives (a window's rows are independent and the DiT's
weights replicate, so nothing needs one).  ``Mesh`` holds an ndarray of
``torch.device``, the ``axis_names`` and a ``shape`` mapping.  Devices are
the CUDA cards (``torch.cuda.device_count()``), or the one CPU device when
the caller passes ``device="cpu"``.

The SERVING mesh is ``("hosts", "data", "model")``: a host placement axis
ahead of each host's compute axes.  ``hosts`` is not a sharding axis
(``mesh_axes`` leaves it out of the data axes); it partitions the devices
into the per-host submeshes (``host_submesh``) that
``serve/topology.py::HostTopology.from_mesh`` places waves over.

The PRODUCTION mesh is the reference's LM layout, ``(data, model)`` =
(16, 16), or ``(pod, data, model)`` = (2, 16, 16) over two pods: the
layouts ``sharding/rules.py`` partitions parameters over.  One card cannot
hold it, so it refuses there as the reference refuses on a small host;
``device="meta"`` builds it of meta devices (up to ``META_DEVICES``), the
dry run's counterpart of the reference's forced 512 host devices.

``place(tree, shardings)`` puts each leaf of a spec'd tree on its
sharding's first data device: the single controller's one copy (on the
card's 1×1 mesh, the card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sharding.rules import MeshAxes, splits_rows
from repro_torch.utils import resolve_device


class Mesh:
    """A named grid of devices: ``devices`` an ndarray of
    ``torch.device`` with one dimension per name in ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dimensions named "
                             f"{axis_names}")
        if devices.size < 1:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        names = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, {names})"


# meta devices a mesh may take: the reference's dry run forces 512 host
# devices, two pods of 16 × 16
META_DEVICES = 512


def visible_devices(device) -> list:
    """The devices a mesh may take: every CUDA card, the one CPU, or
    ``META_DEVICES`` meta devices."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type == "meta":
        return [torch.device("meta")] * META_DEVICES
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _validate_device_count(shape: tuple, axes: tuple, have: int,
                           kind: str):
    """Fail fast, and say what to do, when the mesh needs more devices than
    there are (a surplus is fine: the mesh takes a prefix)."""
    need = int(np.prod(shape))
    if need > have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} devices but only "
            f"{have} {kind} device(s) are visible; build a mesh sized to "
            f"the devices there are with make_host_mesh(data, model) or "
            f"make_serving_mesh(hosts=..., data=..., model=...)")


def _make(shape: tuple, axes: tuple, device) -> Mesh:
    devs = visible_devices(device)
    _validate_device_count(shape, axes, len(devs), devs[0].type)
    grid = np.empty(int(np.prod(shape)), dtype=object)
    for i in range(grid.size):
        grid[i] = devs[i]
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's training/decode mesh: (data, model) = (16, 16), or
    (pod, data, model) = (2, 16, 16).  Refuses when fewer devices are
    visible (one card, the CPU); ``device="meta"`` builds it of meta
    devices for the dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device)


def make_serving_mesh(*, hosts: int = 1, data: int = 1, model: int = 1,
                      device=None) -> Mesh:
    """Serving mesh: ``hosts`` placement groups, each a (data, model)
    compute submesh; ``hosts * data * model`` must not exceed the visible
    device count.  ``device="cpu"`` builds it on the CPU."""
    if min(hosts, data, model) < 1:
        raise ValueError(f"make_serving_mesh: hosts={hosts} data={data} "
                         f"model={model} must all be >= 1")
    return _make((hosts, data, model), ("hosts", "data", "model"), device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh over the visible devices."""
    return _make((data, model), ("data", "model"), device)


def mesh_axes(mesh: Mesh) -> MeshAxes:
    """The (data, model) view of any mesh: ``model`` is tensor-parallel,
    every other axis batch-parallel except the serving mesh's ``hosts``
    axis, which is placement, never sharding."""
    names = mesh.axis_names
    data = tuple(n for n in names if n not in ("model", "hosts"))
    return MeshAxes(data=data, model="model")


def host_submesh(mesh: Mesh, host: int) -> Mesh:
    """Host ``host``'s compute mesh: the ``hosts`` axis sliced away,
    leaving that host's own (data, model) device block."""
    if "hosts" not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {mesh.axis_names} carry no 'hosts' axis; build "
            f"one with make_serving_mesh(hosts=...)")
    n_hosts = int(mesh.shape["hosts"])
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} out of range for a {n_hosts}-host "
                         f"serving mesh")
    axis = mesh.axis_names.index("hosts")
    return Mesh(np.take(mesh.devices, host, axis=axis),
                tuple(n for n in mesh.axis_names if n != "hosts"))


def data_devices(mesh: Mesh) -> tuple:
    """The devices a mesh's rows split over, in row order: the first
    device of each model group (index 0 on the ``model`` axis), the data
    axes flattened in their order."""
    devs = mesh.devices
    if "model" in mesh.axis_names:
        devs = np.take(devs, 0, axis=mesh.axis_names.index("model"))
    return tuple(devs.reshape(-1))


class NamedSharding:
    """Where one operand lies on a mesh, after jax's class of that name:
    ``spec`` (a ``sharding/rules.py`` spec) splits its rows over the mesh's
    data devices (``data_devices``) or replicates it on each."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    @property
    def devices(self) -> tuple:
        return data_devices(self.mesh)

    @property
    def split(self) -> bool:
        return splits_rows(self.spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec})"


def place(tree, shardings):
    """Each leaf of ``tree`` on its sharding's first data device (the
    single controller holds one copy), in a tree of the same structure:
    dicts, lists and NamedTuples of tensors, non-tensor leaves (a step
    count) kept.  An ``nn.Module`` takes ``shardings`` by state name and
    has its parameters moved in place; it is returned."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                p.data = p.data.to(shardings[name].devices[0])
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(shardings.devices[0])
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(v, s) for v, s in zip(tree, shardings)))
    if isinstance(tree, list):
        return [place(v, s) for v, s in zip(tree, shardings)]
    return tree
