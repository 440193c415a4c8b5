"""Host topology + wave placement: the multi-host serving substrate, the
JAX package's ``serve/topology.py`` for the port (plain Python and numpy).

OSCAR's one-round protocol makes the SERVER the scaling bottleneck — one
burst of D_syn generation for every client — so a drain must be able to
run across the H hosts of a production pod instead of one monolithic
process.  This module is the placement layer the engine schedules
against:

* ``HostTopology`` describes the serving fleet: how many hosts, each
  host's device count (its share of a wave is proportional), and each
  host's ROW GRANULE (windows are rounded up so a host's rows divide its
  data-parallel device count).  Built from a mesh
  (``launch/mesh.py::make_serving_mesh``, or any (data, model) mesh whose
  data axis is partitioned into H contiguous host groups — the same
  trick ``make_host_mesh`` uses) or ``simulated`` without devices, which
  is how CI exercises H ∈ {1, 2, 4} in one process.

* ``WavePlacement`` maps the rows each host packed into CONTIGUOUS
  PER-HOST WINDOWS of one merged wave: window ``w`` covers wave rows
  ``[w.offset, w.offset + w.rows)``, padding is per-window (a host never
  pads for another host's tail), and ``w.offset`` is exactly the
  ``row_offset`` the segment-offset ``cfg_fuse`` path uses to read the
  window's per-row (ᾱ_t, ᾱ_prev, s, active) scalars out of the wave-
  resident table — no per-host sliced copies of the table.

The load-bearing invariant lives one layer down (``serve/synthesis.py``):
row noise is keyed by REQUEST IDENTITY, so D_syn is bit-identical
regardless of host count, placement, or arrival order — topology only
moves rows between hosts, never changes their values.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np

from repro_torch.serve.faults import AllHostsLostError


@dataclass(frozen=True)
class HostWindow:
    """One host's contiguous slice of a placed wave."""
    host: int
    offset: int            # first wave row (== the kernel row_offset)
    rows: int              # padded window size (host-granule multiple)
    real: int              # rows actually packed (rows - real is padding)

    def __post_init__(self):
        if not (0 < self.real <= self.rows):
            raise ValueError(f"window real={self.real} rows={self.rows}: "
                             f"need 0 < real <= rows")
        if self.offset < 0 or self.host < 0:
            raise ValueError(f"window host={self.host} offset={self.offset} "
                             f"must be non-negative")

    @property
    def span_attrs(self) -> dict:
        """Attributes a trace span carries for this window — ``host``
        routes the span onto the host's timeline track."""
        return {"host": self.host, "offset": self.offset,
                "rows": self.rows, "real": self.real}


@dataclass(frozen=True)
class HostTopology:
    """The serving fleet a drain is placed over.

    ``device_counts[h]`` weights host h's share of every wave;
    ``granules[h]`` is the row multiple its windows are rounded to (its
    data-parallel device count on a real mesh, the engine granule when
    simulated).  ``mesh`` (optional, identity-irrelevant) is the mesh the
    topology was derived from — ``launch/mesh.py::host_submesh`` carves
    out host h's compute mesh from it.
    """
    device_counts: tuple
    granules: tuple
    mesh: Any = field(default=None, compare=False, repr=False)
    failed: frozenset = frozenset()

    def __post_init__(self):
        if len(self.device_counts) < 1:
            raise ValueError("HostTopology: need at least one host")
        if len(self.granules) != len(self.device_counts):
            raise ValueError(
                f"HostTopology: {len(self.device_counts)} device counts vs "
                f"{len(self.granules)} granules")
        if any(d < 1 for d in self.device_counts) or \
                any(g < 1 for g in self.granules):
            raise ValueError("HostTopology: device counts and granules "
                             "must be >= 1")
        object.__setattr__(self, "failed", frozenset(self.failed))
        if any(not 0 <= h < len(self.device_counts) for h in self.failed):
            raise ValueError(f"failed hosts {sorted(self.failed)} out of "
                             f"range for {len(self.device_counts)} hosts")
        if len(self.failed) >= len(self.device_counts):
            raise AllHostsLostError(
                f"all {len(self.device_counts)} hosts failed")

    @property
    def num_hosts(self) -> int:
        return len(self.device_counts)

    @property
    def live_hosts(self) -> tuple:
        """Hosts still serving, in host order."""
        return tuple(h for h in range(self.num_hosts)
                     if h not in self.failed)

    def mark_failed(self, host: int) -> "HostTopology":
        """Elastic membership: the topology with ``host`` removed from
        service.  Dead hosts keep their index (per-host stats stay
        aligned) but get zero wave quota and no ingress traffic; raises
        ``AllHostsLostError`` when no survivor would remain.  Marking an
        already-dead host is a no-op."""
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} out of range for "
                             f"{self.num_hosts} hosts")
        if host in self.failed:
            return self
        return replace(self, failed=self.failed | {host})

    @classmethod
    def simulated(cls, hosts: int, *, granule: int = 1) -> "HostTopology":
        """Device-less topology: H equal-weight hosts in one process —
        per-host ingress queues, per-host windows, per-host stats, but
        every window sampled locally.  This is what CI runs; outputs are
        bit-identical to any real placement because row noise is keyed by
        request identity."""
        if not isinstance(hosts, int) or isinstance(hosts, bool) or hosts < 1:
            raise ValueError(f"simulated topology: hosts={hosts!r} must be "
                             f"an int >= 1")
        return cls(device_counts=(1,) * hosts, granules=(granule,) * hosts)

    @classmethod
    def from_mesh(cls, mesh, hosts: int | None = None) -> "HostTopology":
        """Derive the topology from a mesh.

        A serving mesh (explicit ``hosts`` axis — ``make_serving_mesh``)
        declares its own host count and per-host (data, model) submesh
        shape.  Any other mesh is partitioned into ``hosts`` contiguous
        groups along its data axes, so ``hosts`` must divide the data-
        parallel device count.
        """
        from repro_torch.launch.mesh import mesh_axes
        if "hosts" in mesh.axis_names:
            declared = int(mesh.shape["hosts"])
            if hosts is not None and hosts != declared:
                raise ValueError(
                    f"mesh declares hosts={declared}; got hosts={hosts}")
            hosts = declared
        if hosts is None:
            raise ValueError("from_mesh: pass hosts=H for a mesh without a "
                             "'hosts' axis")
        if not isinstance(hosts, int) or isinstance(hosts, bool) or hosts < 1:
            raise ValueError(f"from_mesh: hosts={hosts!r} must be an "
                             f"int >= 1")
        ax = mesh_axes(mesh)
        dsize = int(np.prod([mesh.shape[n] for n in ax.data])) if ax.data \
            else 1
        msize = int(mesh.shape.get("model", 1))
        if "hosts" not in mesh.axis_names:
            lead = int(mesh.shape[ax.data[0]]) if ax.data else 1
            if lead % hosts:
                raise ValueError(
                    f"cannot place {hosts} hosts on a mesh with a "
                    f"{lead}-wide leading data axis ({dict(mesh.shape)}): "
                    f"hosts must divide it (each host takes a contiguous "
                    f"block) — use make_serving_mesh(hosts={hosts}, ...) "
                    f"or pick hosts in "
                    f"{[h for h in range(1, lead + 1) if lead % h == 0]}")
            dsize //= hosts
        return cls(device_counts=(dsize * msize,) * hosts,
                   granules=(dsize,) * hosts, mesh=mesh)

    def assign(self, rid: int) -> int:
        """Ingress routing: which host's queue a request lands on.  Keyed
        by the request's identity (rid), NOT arrival order, so replaying
        a trace in any order routes every request identically.  Only live
        hosts take traffic; routing is identity-keyed within the
        survivor set (the ROWS a rerouted request produces are unchanged
        — row noise is identity-keyed, not host-keyed)."""
        live = self.live_hosts
        return live[rid % len(live)]

    def host_mesh(self, host: int):
        """Host ``host``'s compute mesh, or None for a simulated
        topology.  A serving mesh slices its ``hosts`` axis away
        (``launch/mesh.py::host_submesh``); a plain (data, model) mesh is
        partitioned into contiguous blocks along its leading data axis —
        the same trick ``make_host_mesh`` plays with the local devices."""
        if self.mesh is None:
            return None
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} out of range for "
                             f"{self.num_hosts} hosts")
        if "hosts" in self.mesh.axis_names:
            from repro_torch.launch.mesh import host_submesh
            return host_submesh(self.mesh, host)
        from repro_torch.launch.mesh import Mesh, mesh_axes
        lead = mesh_axes(self.mesh).data[0]
        axis = self.mesh.axis_names.index(lead)
        per = int(self.mesh.shape[lead]) // self.num_hosts
        idx = [slice(None)] * self.mesh.devices.ndim
        idx[axis] = slice(host * per, (host + 1) * per)
        return Mesh(self.mesh.devices[tuple(idx)], self.mesh.axis_names)

    def wave_quotas(self, wave_size: int) -> tuple:
        """Per-host row targets for one wave: ``wave_size`` split
        proportional to LIVE device counts, each rounded up to the
        host's granule (never below one granule — a live host always
        gets a packable window).  Dead hosts get quota 0, so the wave
        re-spreads over survivors through the same proportional split —
        failover IS a re-quota, nothing more."""
        total = sum(d for h, d in enumerate(self.device_counts)
                    if h not in self.failed)
        quotas = []
        for h, (d, g) in enumerate(zip(self.device_counts, self.granules)):
            if h in self.failed:
                quotas.append(0)
                continue
            share = -(-wave_size * d // total)          # ceil split
            quotas.append(max(-(-share // g) * g, g))
        return tuple(quotas)


@dataclass(frozen=True)
class WavePlacement:
    """Contiguous per-host windows of one merged wave.  Window order is
    host order; concatenating the windows IS the wave, and each window's
    ``offset`` doubles as the kernel ``row_offset`` into the wave-resident
    scalar table."""
    windows: tuple

    def __post_init__(self):
        off = 0
        for w in self.windows:
            if w.offset != off:
                raise ValueError(
                    f"placement windows must tile the wave contiguously: "
                    f"host {w.host} starts at {w.offset}, expected {off}")
            off += w.rows

    @classmethod
    def plan(cls, host_rows, granules, pad_to=None) -> "WavePlacement":
        """Place the rows each host packed: host h's window holds its own
        ``host_rows[h]`` rows padded up to ``granules[h]``; hosts with no
        rows contribute no window (and no padding).  ``pad_to`` (optional,
        per-host row counts) pads each NON-EMPTY window further, up to
        ``pad_to[h]`` — the drain uses it to give a tail wave the same
        window geometry as the full waves before it, so the tail reuses
        their compiled executables instead of compiling its own (padding
        rows duplicate a real row and are discarded at scatter, so the
        promotion is invisible in D_syn)."""
        if len(host_rows) != len(granules):
            raise ValueError(f"{len(host_rows)} hosts vs "
                             f"{len(granules)} granules")
        windows, off = [], 0
        for h, (n, g) in enumerate(zip(host_rows, granules)):
            if n == 0:
                continue
            rows = -(-n // g) * g
            if pad_to is not None:
                rows = max(rows, pad_to[h])
            windows.append(HostWindow(host=h, offset=off, rows=rows, real=n))
            off += rows
        return cls(windows=tuple(windows))

    @property
    def total_rows(self) -> int:
        return sum(w.rows for w in self.windows)

    @property
    def real_rows(self) -> int:
        return sum(w.real for w in self.windows)

    @property
    def padded(self) -> int:
        return self.total_rows - self.real_rows
